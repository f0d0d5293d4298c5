"""Data-movement strategy microbenchmark — the ``unaligned_test.c`` analog.

Port of ``csnappy_tpu/tools/movebench.py``.  The reference benchmarks six
1-4-byte load strategies to pick its portability primitive
(unaligned_test.c:45-120); this tool measures the data-movement strategies
the codec's kernels are built from, on the card.  Each strategy, with the
TPU strategy it stands in for:

  torch_gather  — arbitrary-index gather ``tbl.view(-1)[idx]``, one PyTorch
                  call (``xla_gather``, the jnp gather XLA:TPU serializes)
  gather_kernel — :func:`gather_flat`, ``csrc/movebench.cu``: clip, load and
                  mask, one thread an element (``onehot_mxu``, the one-hot
                  limb matmul gather ``kernel_lib.gather_rows_multi``,
                  movebench.py:62)
  sort          — ``torch.sort`` keys/s (``sort``, the encoder's match index)
  dense         — elementwise ops/s, the ceiling (``dense_vpu``)
  scan_kernel   — :func:`scan_max`, ``csrc/movebench.cu``: inclusive
                  max-scan (``scan_mxu``, the permutation-matmul scan
                  ``kernel_lib.scan2d_mm``, movebench.py:92)

Run:  python -m csnappy_tpu_torch.tools.movebench [N] [--device cpu]
Prints one JSON line per strategy in elements/s.

The two kernels' wrappers take an int32 tensor: on a CUDA tensor they launch
the kernel and count the launch on ``<wrapper>.launches``; on a CPU tensor
they run the plain version (:func:`gather_flat_plain`,
:func:`scan_max_plain`); a CUDA tensor with ``device="cpu"`` raises.
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import json
import sys

import numpy as np
import torch

from ..config import refuse_card_tensors, resolve_device
from ..ops import _build


def _mask(bits: int) -> int:
    """The bits the JAX gather keeps: whole 8-bit limbs, all 32 from 4 limbs on."""
    if bits < 1:
        raise ValueError("bits must be positive")
    limbs = (bits + 7) // 8
    return 0xFFFFFFFF if limbs >= 4 else (1 << (8 * limbs)) - 1


def _i32(x, dev: torch.device, what: str) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
    if t.dtype != torch.int32:
        raise TypeError(f"{what} must be int32, got {t.dtype}")
    return t.to(dev).contiguous()


def gather_flat_plain(tbl: torch.Tensor, idx: torch.Tensor, bits: int = 16) -> torch.Tensor:
    """Plain version of the gather kernel: ``tbl.flat[clip(idx)]``, masked."""
    got = torch.take(tbl, idx.clamp(0, tbl.numel() - 1).long())
    mask = _mask(bits)
    return got if mask == 0xFFFFFFFF else got & mask


def gather_flat(tbl, idx, bits: int = 16, device=None) -> torch.Tensor:
    """y[i] = tbl.flat[clip(idx.flat[i], 0, tbl.numel() - 1)], keeping the low
    8 * ceil(bits / 8) bits (all 32 from bits = 25 on), shaped like ``idx``.

    Row 12 of the kernel table (``csnappy_tpu/tools/movebench.py:62``)."""
    dev = resolve_device(device)
    refuse_card_tensors(dev, tbl, idx)
    tbl, idx = _i32(tbl, dev, "tbl"), _i32(idx, dev, "idx")
    if tbl.numel() == 0:
        raise ValueError("empty table")
    if dev.type == "cpu":
        return gather_flat_plain(tbl, idx, bits)
    out = torch.empty_like(idx)
    launch, check = _gather_kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        check(launch(tbl.data_ptr(), tbl.numel(), idx.data_ptr(), out.data_ptr(), idx.numel(),
                     _mask(bits), stream))
    gather_flat.launches += 1
    return out


gather_flat.launches = 0


def scan_max_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of the scan kernel: the inclusive max-scan of ``x`` in
    row-major flat order by doubling (log2 n rounds of a shifted maximum)."""
    s = x.reshape(-1).clone()
    k = 1
    while k < s.numel():
        prev = s.clone()
        s[k:] = torch.maximum(prev[k:], prev[:-k])
        k <<= 1
    return s.reshape(x.shape)


def scan_max(x, device=None) -> torch.Tensor:
    """Inclusive max-scan of int32 ``x`` in row-major flat order, shaped like ``x``.

    Row 13 of the kernel table (``csnappy_tpu/tools/movebench.py:92``)."""
    dev = resolve_device(device)
    refuse_card_tensors(dev, x)
    x = _i32(x, dev, "x")
    if dev.type == "cpu":
        return scan_max_plain(x)
    out = torch.empty_like(x)
    launch, check, scratch_len = _scan_kernel()
    scratch = torch.empty((max(int(scratch_len(x.numel())), 1),), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        check(launch(x.data_ptr(), out.data_ptr(), x.numel(), scratch.data_ptr(), stream))
    scan_max.launches += 1
    return out


scan_max.launches = 0


@functools.cache
def _gather_kernel():
    launch, check = _build.kernel("movebench", "gather")
    vp = ctypes.c_void_p
    launch.argtypes = [vp, ctypes.c_longlong, vp, vp, ctypes.c_longlong, ctypes.c_uint, vp]
    return launch, check


@functools.cache
def _scan_kernel():
    launch, check = _build.kernel("movebench", "scan")
    vp = ctypes.c_void_p
    launch.argtypes = [vp, vp, ctypes.c_longlong, vp, vp]
    scratch_len = _build.load("movebench").movebench_scan_scratch
    scratch_len.restype = ctypes.c_longlong
    scratch_len.argtypes = [ctypes.c_longlong]
    return launch, check, scratch_len


def inputs(n: int, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """movebench's seeded inputs: tbl in [0, 2^15) and idx in [0, n), both
    int32 [n / 128, 128], on ``device``."""
    rng = np.random.default_rng(0)
    tbl = rng.integers(0, 1 << 15, (n // 128, 128), dtype=np.int32)
    idx = rng.integers(0, n, (n // 128, 128), dtype=np.int32)
    dev = resolve_device(device)
    return torch.from_numpy(tbl).to(dev), torch.from_numpy(idx).to(dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("n", nargs="?", type=int, default=32768, help="elements (a multiple of 128)")
    ap.add_argument("--device", default=None, help="default: the card; cpu = plain versions")
    args = ap.parse_args(argv)
    from .timing import slope_time

    n, dev = args.n, resolve_device(args.device)
    tbl, idx = inputs(n, dev)
    flat_tbl, flat_idx = tbl.reshape(-1), idx.reshape(-1)

    def per_s(make_step, k_lo=2, k_hi=8):
        return n / slope_time(make_step, k_lo=k_lo, k_hi=k_hi, device=dev)

    def dense(k):
        x = flat_tbl + k
        return ((x * 3) ^ (x >> 1)).sum()

    out = {
        "torch_gather": per_s(lambda k: flat_tbl[(flat_idx + k) % n].sum()),
        "gather_kernel": per_s(lambda k: gather_flat(tbl, (idx + k) % n, 16, dev).sum()),
        "sort": per_s(lambda k: torch.sort(flat_idx + k).values.sum()),
        "dense": per_s(dense, 8, 64),
        "scan_kernel": per_s(lambda k: scan_max(tbl + k, dev).sum()),
    }
    for name, v in out.items():
        print(json.dumps({"strategy": name, "elem_per_s": round(float(v), 1)}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
