"""Benchmark-table generator — userspace_benchmark.txt parity (C14/C17);
port of ``csnappy_tpu/tools/benchtable.py`` with the same table format.

Reproduces the reference's published table format (file, in->out bytes,
ratio, compress MB/s, decompress MB/s) per backend.  The reference produced
its table with Google snappy's patched snappy_unittest
(snappy_tester.patch:44-117); here the harness is built in.

The torch backend measures the *serving path* — batched 32 KiB blocks
through ``encode_blocks`` and ``decode_blocks`` on the card — with slope
timing on a synchronised host clock (tools/timing.py), and verifies the
roundtrip; its first line names the device (the card's name and power
limit, or cpu).  py/native backends are host code and use best-of-N wall
timing.

Usage:
  python -m csnappy_tpu_torch.tools.benchtable [-b torch|py|native] FILES...
  python -m csnappy_tpu_torch.tools.benchtable --corpus   # generated corpus
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from .. import api
from ..config import BACKENDS

BS = 32768


def _timed(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return max(time.perf_counter() - t0, 1e-9)


def _measure_host(data: bytes, backend: str, reps: int = 3) -> dict:
    comp = api.compress(data, backend=backend)
    t_c = min(_timed(lambda: api.compress(data, backend=backend)) for _ in range(reps))
    out = api.decompress(comp, backend=backend)
    assert out == data, "roundtrip mismatch"
    t_d = min(_timed(lambda: api.decompress(comp, backend=backend)) for _ in range(reps))
    return dict(n_in=len(data), n_out=len(comp), t_c=t_c, t_d=t_d)


def _measure_torch(data: bytes, device=None) -> dict:
    import torch

    from ..config import resolve_device
    from ..models import wire
    from ..ops import decode_fused, encode_fused
    from .timing import slope_time_keyed

    dev = resolve_device(device)
    n = len(data)
    nb = max(1, (n + BS - 1) // BS)
    pages = np.zeros((nb, BS), np.uint8)
    pages.reshape(-1)[:n] = np.frombuffer(data, np.uint8)
    blens = np.full((nb,), BS, np.int32)
    blens[nb - 1] = n - (nb - 1) * BS
    pages_dev = torch.from_numpy(pages).to(dev)

    def enc_step(k, pg):
        c, ln = encode_fused.encode_blocks(pg, blens, device=dev)
        return ln.sum(), (c, ln)

    t_c, (comp, clens) = slope_time_keyed(("bt-enc", nb, BS), enc_step, (pages_dev,),
                                          device=dev)
    clens = clens.cpu().numpy()
    n_out = int(clens.sum()) + len(wire.varint_encode(n))

    P = (max(int(clens.max()), 1) + 1023) // 1024 * 1024
    comp_dev = comp[:, :P].contiguous()

    def dec_step(k, cp):
        o, prod, status = decode_fused.decode_blocks(cp, clens, BS, device=dev)
        return prod.sum(), (o, prod, status)

    t_d, (out, prod, status) = slope_time_keyed(("bt-dec", nb, P), dec_step, (comp_dev,),
                                                device=dev)
    status, prod = status.cpu().numpy(), prod.cpu().numpy()
    assert (status == 0).all(), status
    outb = out.cpu().numpy()
    got = b"".join(outb[i, : prod[i]].tobytes() for i in range(nb))
    assert got == data, "roundtrip mismatch"
    return dict(n_in=n, n_out=n_out, t_c=t_c, t_d=t_d)


def measure(data: bytes, backend: str, device=None) -> dict:
    m = _measure_torch(data, device) if backend == "torch" else _measure_host(data, backend)
    m["ratio"] = 100.0 * m["n_out"] / max(m["n_in"], 1)
    m["c_mbps"] = m["n_in"] / m["t_c"] / 1e6
    m["d_mbps"] = m["n_in"] / m["t_d"] / 1e6
    return m


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-b", "--backend", default="torch", choices=list(BACKENDS))
    ap.add_argument("--device", default=None,
                    help="where -b torch runs (default: the card; cpu = plain versions)")
    ap.add_argument("--corpus", action="store_true", help="run the generated corpus")
    ap.add_argument("files", nargs="*")
    args = ap.parse_args(argv)
    items: list[tuple[str, bytes]] = []
    if args.corpus:
        from .corpus import corpus

        items += sorted(corpus().items())
    for path in args.files:
        with open(path, "rb") as f:
            items.append((path.rsplit("/", 1)[-1], f.read()))
    if not items:
        ap.error("no files (pass paths or --corpus)")
    if args.backend == "torch":                 # the run names what it measured
        from .timing import card

        print(f"backend=torch device={card(args.device)}")
    else:
        print(f"backend={args.backend}")
    print(f"{'file':<14} {'in->out bytes':>21} {'ratio':>7} {'comp':>12} {'decomp':>12}")
    for name, data in items:
        m = measure(data, args.backend, args.device)
        print(
            f"{name:<14} {m['n_in']:>9} -> {m['n_out']:>8} {m['ratio']:>6.1f}% "
            f"{m['c_mbps']:>9.1f}MB/s {m['d_mbps']:>9.1f}MB/s",
            flush=True,
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
