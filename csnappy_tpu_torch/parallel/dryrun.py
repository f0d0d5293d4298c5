"""Multi-rank dry run of the scale-out: the counterpart of
``__graft_entry__.dryrun_multichip``.

    python -m csnappy_tpu_torch.parallel.dryrun --nprocs N [--device cpu]

starts N ranks (NCCL on the card, one card a rank; gloo with ``--device
cpu``), each of which runs :func:`dryrun_multichip`: the sharded compress
decodes by the oracle to its input, and the sharded decompress of the
oracle's fragments joins to it.
"""
from __future__ import annotations

import sys

import numpy as np
import torch.distributed as dist

from ..models import pymodel
from . import mesh, multihost

BS = 1024          # the JAX dry run's block: its fused encoder's smallest granule


def dryrun_input(n: int, bs: int = BS) -> bytes:
    """The input of ``__graft_entry__.dryrun_multichip(n)`` (:59-62)."""
    rng = np.random.default_rng(0)
    base = rng.integers(0, 64, size=bs // 2, dtype=np.uint8).tobytes()
    return (base * (4 * n + 1))[: bs * (2 * n) + 123]


def dryrun_multichip(n_devices: int, device=None) -> None:
    """Both sharded paths over the first ``n_devices`` ranks of the
    initialized group (every rank of the world calls it; ranks past the
    first ``n_devices`` take no part).  Raises ``AssertionError`` on a
    wrong answer."""
    group = mesh.default_mesh(n=n_devices)
    if dist.get_rank(group) < 0:
        return
    data = dryrun_input(n_devices)
    comp = mesh.compress_sharded(data, group, bs=BS, device=device)
    if pymodel.decompress(comp) != data:
        raise AssertionError("sharded compress roundtrip failed")
    frags = [pymodel.compress_fragment(data[i : i + BS]) for i in range(0, len(data), BS)]
    outs = mesh.decompress_fragments_sharded(
        frags, [min(BS, len(data) - i) for i in range(0, len(data), BS)], group, device=device)
    if b"".join(outs) != data:
        raise AssertionError("sharded decompress mismatch")


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nprocs", type=int, default=2)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--rank", type=int, default=None, help="run as this rank (set by the launch)")
    ap.add_argument("--port", type=int, default=None)
    a = ap.parse_args(argv)
    if a.rank is None:
        port = a.port or multihost.free_port()
        multihost.launch([["-m", "csnappy_tpu_torch.parallel.dryrun", "--nprocs", str(a.nprocs),
                           "--device", a.device, "--rank", str(r), "--port", str(port)]
                          for r in range(a.nprocs)], 2 * multihost.TIMEOUT_S)
        print(f"dryrun: {a.nprocs} ranks ({a.device}) ok", flush=True)
        return 0
    device = None if a.device == "cuda" else "cpu"
    multihost.init(f"localhost:{a.port}", a.nprocs, a.rank, device=device,
                   timeout=multihost.TIMEOUT_S)
    try:
        dryrun_multichip(a.nprocs, device)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
