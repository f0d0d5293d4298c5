"""Multi-process scale-out — ``torch.distributed`` bring-up, local-data
compress and the in-order offsets.

Port of ``csnappy_tpu/parallel/multihost.py``.  Each process is one rank and
holds its own contiguous slice of the global block sequence.  The codec's
only cross-rank traffic is the all-gather of the per-block compressed
lengths: from it every rank learns the global offset table and can write
its own blocks' payloads at their final positions, with no payload shuffle
(the distributed analog of the block container's length table,
block_compressor.c:298-333).

One process a card under NCCL; gloo on the CPU (``device="cpu"``, the plain
versions) or, for several ranks on one card, gloo with the lengths copied to
the host (``mesh.comm_device``).  The loopback selftest runs the same code
path in separate processes:

    python -m csnappy_tpu_torch.parallel.multihost --worker --rank R \\
        --nprocs N --port P --out F [--nbytes K] [--device cpu] [--backend gloo]
"""
from __future__ import annotations

import datetime
import os
import pathlib
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from ..config import resolve_device
from ..ops import encode_fused
from . import mesh as pmesh

ROOT = pathlib.Path(__file__).resolve().parents[2]
TIMEOUT_S = 60.0     # seconds a collective of the selftests may wait before it fails


def init(coordinator_address: str, num_processes: int, process_id: int, backend=None,
         device=None, timeout: float | None = None) -> None:
    """Join the process group as rank ``process_id`` of ``num_processes``,
    over ``tcp://coordinator_address`` (rank 0 serves it).

    ``backend`` None: ``"nccl"`` for the card (``device`` None or cuda),
    ``"gloo"`` for ``device="cpu"``.  On the card the process takes card
    ``process_id % torch.cuda.device_count()`` as its current device.
    ``timeout``: seconds a collective may wait before it fails (None:
    torch's default)."""
    dev = resolve_device(device)
    backend = backend or ("gloo" if dev.type == "cpu" else "nccl")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("NCCL runs on the card: pass device=None or 'cuda'")
        if not dist.is_nccl_available():
            raise RuntimeError("this torch has no NCCL")
    elif backend != "gloo":
        raise ValueError(f"unsupported backend {backend!r}")
    if dev.type == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    kw = {} if timeout is None else {"timeout": datetime.timedelta(seconds=timeout)}
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id, **kw)


def global_mesh():
    """The group of every rank (``mesh.default_mesh()``)."""
    return pmesh.default_mesh()


def compress_blocks_multihost(local_pages, local_lens, mesh=None, device=None):
    """Compress this rank's blocks; learn every block's global offset.

    local_pages: uint8[nb_local, bs] — this rank's contiguous slice of the
    global block sequence (the same ``nb_local`` and ``bs`` on every rank);
    local_lens: int[nb_local].  One ``encode_blocks`` launch on ``device``
    (None: the current card).  Returns (comp_local uint8[nb_local,
    encode_fused.ocap(bs)] and clens_local int32[nb_local] on ``device``,
    offsets int64[nb_local * world] on the host), where offsets[i] is the
    payload offset of global block i, the same on every rank."""
    group = mesh if mesh is not None else global_mesh()
    dev, comm = resolve_device(device), pmesh.comm_device(group)
    shape = tuple(local_pages.shape)
    lshape = tuple(local_lens.shape if isinstance(local_lens, torch.Tensor) else np.shape(local_lens))
    ok = len(shape) == 2 and lshape == shape[:1]
    pmesh.agree(group, comm, list(shape) if ok else [0, 0],
                None if ok else "local_pages must be [nb_local, bs] and local_lens [nb_local]")
    comp, clens = encode_fused.encode_blocks(local_pages, local_lens, device=dev)
    lens = pmesh.all_gather(clens, group, comm).reshape(-1).cpu().to(torch.int64)
    return comp, clens, torch.cumsum(lens, 0) - lens


def free_port() -> int:
    """A TCP port on localhost that is free now, for a coordinator address."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(argvs: list[list[str]], timeout: float) -> list[str]:
    """Run ``python <argv>`` for each argv at once (one rank each) from the
    package's root and wait for all, at most ``timeout`` seconds in all.
    A rank that fails or outlives the time raises ``RuntimeError``, after
    every rank still running was killed.  Returns each rank's output."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [str(ROOT), env.get("PYTHONPATH")]))
    with tempfile.TemporaryDirectory() as tmp:
        logs = [(open(f"{tmp}/{r}.out", "w+"), open(f"{tmp}/{r}.err", "w+"))
                for r in range(len(argvs))]
        procs = [subprocess.Popen([sys.executable, *argv], cwd=ROOT, env=env,
                                  stdout=so, stderr=se, text=True)
                 for argv, (so, se) in zip(argvs, logs)]
        deadline = time.monotonic() + timeout
        try:
            while any(p.poll() is None for p in procs):
                failed = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
                if failed or time.monotonic() > deadline:
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            outs = []
            for f in (f for pair in logs for f in pair):
                f.seek(0)
                outs.append(f.read())
                f.close()
    # a rank that failed first, then one killed (at the time limit, or after another failed)
    for r in sorted(range(len(procs)), key=lambda r: procs[r].returncode < 0):
        rc = procs[r].returncode
        if rc:
            why = f"exited {rc}" if rc > 0 else "was killed"
            raise RuntimeError(f"rank {r} ({' '.join(argvs[r])}) {why}: {outs[2 * r + 1][-3000:]}")
    return outs[::2]


def _worker(rank: int, nprocs: int, port: int, out_path: str, n_bytes: int, device=None,
            backend=None) -> None:
    init(f"localhost:{port}", nprocs, rank, backend, device, TIMEOUT_S)
    try:
        data = (ROOT / "tests" / "data" / "urls.10K").read_bytes()[:n_bytes]
        bs = 4096
        nb = (len(data) + bs - 1) // bs
        nb += (-nb) % nprocs                      # pad to equal shards
        pages = np.zeros((nb, bs), np.uint8)
        pages.reshape(-1)[: len(data)] = np.frombuffer(data, np.uint8)
        lens = np.zeros((nb,), np.int32)
        full = (len(data) + bs - 1) // bs
        lens[:full] = bs
        lens[full - 1] = len(data) - (full - 1) * bs
        per = nb // nprocs
        lc, ll, offs = compress_blocks_multihost(
            pages[rank * per : (rank + 1) * per], lens[rank * per : (rank + 1) * per],
            device=device)
        np.savez(out_path, comp=lc.cpu().numpy(), clens=ll.cpu().numpy(),
                 offsets=offs.numpy(), nb=nb, per=per)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="loopback selftest of the multi-process compress")
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--nprocs", type=int, default=2)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--nbytes", type=int, default=65536)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="default: nccl on the card, gloo with --device cpu")
    a = ap.parse_args(argv)
    _worker(a.rank, a.nprocs, a.port, a.out, a.nbytes, None if a.device == "cuda" else "cpu",
            a.backend)
    return 0


if __name__ == "__main__":
    sys.exit(main())
