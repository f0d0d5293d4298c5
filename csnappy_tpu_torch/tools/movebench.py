"""Data-movement strategy microbenchmark — the ``unaligned_test.c`` analog.

Port of ``csnappy_tpu/tools/movebench.py``.  The reference benchmarks six
1-4-byte load strategies to pick its portability primitive
(unaligned_test.c:45-120); this tool measures the data-movement strategies
the codec's kernels are built from, on the card.  Each strategy, with the
TPU strategy it stands in for:

  torch_gather  — arbitrary-index gather ``tbl.view(-1)[idx]``, one PyTorch
                  call (``xla_gather``, the jnp gather XLA:TPU serializes)
  gather_kernel — :func:`gather_flat`, ``lane_gather`` of
                  ``csrc/primitives.cu`` with one row: clip, load and mask,
                  four elements a lane (``onehot_mxu``, the one-hot limb
                  matmul gather ``kernel_lib.gather_rows_multi``,
                  movebench.py:62)
  sort          — ``torch.sort`` keys/s (``sort``, the encoder's match index)
  dense         — elementwise ops/s, the ceiling (``dense_vpu``)
  scan_kernel   — :func:`scan_max`, ``csrc/movebench.cu``: inclusive
                  max-scan in one pass, tiles chained by a decoupled
                  look-back (``scan_mxu``, the permutation-matmul scan
                  ``kernel_lib.scan2d_mm``, movebench.py:92)

Run:  python -m csnappy_tpu_torch.tools.movebench [N] [--device cpu]
Prints one JSON line per strategy in elements/s.  :func:`primitive_inputs`
makes the six ``ops/primitives.py`` functions' seeded arguments at the main
path's batch, for ``chip_smoke.py`` and ``tools/torch_profile.py``.

The two kernels' wrappers take an int32 tensor: on a CUDA tensor they launch
the kernel on the raw current stream (no device context for operands on the
current card) and count the launch on ``<wrapper>.launches``; on a CPU
tensor they run the plain version (:func:`gather_flat_plain`,
:func:`scan_max_plain`); a CUDA tensor with ``device="cpu"`` raises.  A
``scan_max`` call is one allocation (the output with the kernel's workspace
behind it), one memset of the workspace and one kernel.
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import json
import sys

import numpy as np
import torch

from ..config import resolve_device
from ..ops import _build
from ..ops.primitives import L, as_int32, card_device, launch_lane_gather, launch_on, limb_mask


def _mask(bits: int) -> int:
    """The bits the JAX gather keeps: whole 8-bit limbs, all 32 from 4 limbs on."""
    if bits < 1:
        raise ValueError("bits must be positive")
    return limb_mask(min((bits + 7) // 8, 4))


def gather_flat_plain(tbl: torch.Tensor, idx: torch.Tensor, bits: int = 16) -> torch.Tensor:
    """Plain version of the gather kernel: ``tbl.flat[clip(idx)]``, masked."""
    got = torch.take(tbl, idx.clamp(0, tbl.numel() - 1).long())
    mask = _mask(bits)
    return got if mask == 0xFFFFFFFF else got & mask


def gather_flat(tbl, idx, bits: int = 16, device=None) -> torch.Tensor:
    """y[i] = tbl.flat[clip(idx.flat[i], 0, tbl.numel() - 1)], keeping the low
    8 * ceil(bits / 8) bits (all 32 from bits = 25 on), shaped like ``idx``.

    Row 12 of the kernel table (``csnappy_tpu/tools/movebench.py:62``); on
    the card ``lane_gather`` of ``csrc/primitives.cu`` with one row, the
    kernel of ``primitives.table_gather``."""
    dev = card_device(device, tbl, idx)
    tbl, idx = as_int32(tbl, dev, "tbl"), as_int32(idx, dev, "idx")
    if tbl.numel() == 0:
        raise ValueError("empty table")
    if dev.type == "cpu":
        return gather_flat_plain(tbl, idx, bits)
    if idx.numel() == 0:
        return torch.empty_like(idx)
    out = launch_lane_gather(tbl, tbl.numel(), idx, 1, _mask(bits), dev)
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


SCAN_TILE = 8192                  # elements a tile of the scan kernel (movebench_scan_tile)


def scan_words(n: int) -> int:
    """int32 elements of a scan call's buffer: the output padded to 16
    bytes, then the workspace (the ticket and one 64-bit word a tile)."""
    return ((n + 3) & ~3) + 2 * (1 + -(-n // SCAN_TILE))


def scan_max(x, device=None) -> torch.Tensor:
    """Inclusive max-scan of int32 ``x`` in row-major flat order, shaped like ``x``.

    Row 13 of the kernel table (``csnappy_tpu/tools/movebench.py:92``).  An
    empty ``x`` returns an empty result without a launch."""
    dev = card_device(device, x)
    x = as_int32(x, dev, "x")
    if dev.type == "cpu":
        return scan_max_plain(x)
    n = x.numel()
    if n == 0:
        return torch.empty_like(x)
    buf = x.new_empty((scan_words(n),))
    launch, check = _scan_kernel()
    launch_on(dev, launch, check, x.data_ptr(), buf.data_ptr(), n)
    scan_max.launches += 1
    return buf.as_strided(x.shape, x.stride())


scan_max.launches = 0


@functools.cache
def _scan_kernel():
    launch, check = _build.kernel("movebench", "scan")
    vp = ctypes.c_void_p
    launch.argtypes = [vp, vp, ctypes.c_longlong, vp]
    lib = _build.load("movebench")
    lib.movebench_scan_tile.restype = lib.movebench_scan_words.restype = ctypes.c_longlong
    lib.movebench_scan_tile.argtypes, lib.movebench_scan_words.argtypes = [], [ctypes.c_longlong]
    if lib.movebench_scan_tile() != SCAN_TILE or lib.movebench_scan_words(5000) != scan_words(5000):
        raise RuntimeError("movebench.cu's tile differs from SCAN_TILE")
    return launch, check


def inputs(n: int, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """movebench's seeded inputs: tbl in [0, 2^15) and idx in [0, n), both
    int32 [n / 128, 128], on ``device``."""
    rng = np.random.default_rng(0)
    tbl = rng.integers(0, 1 << 15, (n // 128, 128), dtype=np.int32)
    idx = rng.integers(0, n, (n // 128, 128), dtype=np.int32)
    dev = resolve_device(device)
    return torch.from_numpy(tbl).to(dev), torch.from_numpy(idx).to(dev)


BLOCK = 32768                     # a block of the main path, as 256 rows of 128 lanes


def primitive_inputs(blocks: int = 64, seed: int = 0) -> dict[str, tuple[np.ndarray, ...]]:
    """Seeded int32 arguments of each primitive at the main path's batch of
    ``blocks`` blocks of 32 KiB, laid out as the JAX decoder lays out its
    output ([blocks, 256, 128]); the limbs are the defaults.

    local_gather, local_scatter_or, compose_round: [blocks, 256, 128]
    (compose_round's F a position in its block, chunk_end the end of the
    position's 128-lane row); row_gather: a [256, 128] table and
    ``blocks * 256`` rows; table_gather: a 32768-entry table of values below
    2^16 and ``blocks * 32768`` indices; rowwise_gather: [blocks, 32768]
    tables and indices.  Indices reach past both ends of their range."""
    rng = np.random.default_rng(seed)
    shape = (blocks, BLOCK // L, L)

    def ints(lo, hi, shape):
        return rng.integers(lo, hi, shape, dtype=np.int64).astype(np.int32)

    pos = np.arange(BLOCK, dtype=np.int32).reshape(BLOCK // L, L)
    chunk_end = np.broadcast_to(((pos >> 7) + 1) << 7, shape).copy()
    return {
        "local_gather": (ints(-(1 << 31), 1 << 31, shape), ints(-5, L + 12, shape)),
        "local_scatter_or": (ints(0, 2, shape), ints(-5, 200, shape)),
        "compose_round": (ints(0, BLOCK, shape), ints(0, 1 << 15, shape), ints(0, 2, shape),
                          chunk_end),
        "row_gather": (ints(0, 1 << 24, (BLOCK // L, L)),
                       ints(-3, BLOCK // L + 3, (blocks * BLOCK // L,))),
        "table_gather": (ints(0, 1 << 16, (BLOCK,)), ints(-9, BLOCK + 9, (blocks * BLOCK,))),
        "rowwise_gather": (ints(0, 1 << 24, (blocks, BLOCK)),
                           ints(-4, BLOCK + 4, (blocks, BLOCK))),
    }


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
