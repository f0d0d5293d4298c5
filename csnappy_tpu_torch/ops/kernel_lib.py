"""In-block helpers over (R, 128) int32 tiles (port of ``csnappy_tpu/ops/kernel_lib.py``).

The JAX module's helpers are jnp code run inside Pallas TPU kernels: shifts
by rolls or 0/1 permutation products, scans by doubling rounds, gathers and
scatters by one-hot products, with values split into 8-bit (or 7-bit)
limbs because the TPU's matrix unit rounds to bf16.  Here each helper is
one launch of a harness kernel of ``csrc/kernel_lib.cu`` on the card, over
four device functions of ``csrc/kernel_lib.cuh`` (shift, scan, gather,
scatter), and a plain version in torch ops on the CPU.  ``HELPERS`` lists
the 19 helpers with the JAX function, the JAX test that runs it (rows 15a
and 15b of the kernel table in ``PERF.md``), the kind of device function
and so the CUDA entry ``kernel_lib_<kind>_launch`` it launches.

The answers are the JAX helpers' answers, outside their contracts too:

* the limbs keep a value's low ``8 * ceil(bits / 8)`` bits (``7 * ceil(bits
  / 7)`` in ``scatter_rows_multi``), all 32 from four 8-bit limbs;
* ``gather_flat`` gives 0 for an index outside the table, ``gather_rows_multi``
  clips the index to it; ``local_gather_rows`` gives 0 for a lane outside
  [0, 128), ``lane_gather`` (``take_along_axis``) counts lanes -128..-1 from
  the end and gives INT32_MIN for any other lane outside [0, 128);
* ``scan2d_mm`` and ``fill_max_rows`` apply their mask at every lane round
  and to the row totals, ``scan2d_tril`` to the input and the row totals,
  so a sum past ``2^(8 limbs)`` differs from the true sum exactly as the
  JAX answer does; ``scan2d`` and every sum wrap at 32 bits;
* duplicate scatter positions sum (``scatter_rows_multi``) or OR their 8-bit
  limb sums (``scatter_sum_tile``); out-of-range positions scatter nowhere.

Shift amounts are static arguments, as in JAX: ``stream_shift_up`` at
``d >= R * 128`` raises as the JAX helper's roll does; the ``_mm`` stream
shifts take ``0 <= d < 128`` and raise outside it (the JAX helpers sum two
lane shifts there); the lane shifts take ``k % 128`` and mask unless
``k == 0``, as JAX's permutation products do.  ``row_iota``, ``limb_f``,
``onehot_rows_t``, ``onehot_lanes_t``, ``perm_apply`` and ``_widen_rows``
are TPU encodings (iotas, limbs, one-hot and permutation matrices) and
have no counterpart.

Each helper takes int32 tensors or arrays and a ``device`` (None = the
card, on the device its CUDA operands lie on): on the card it launches its
kernels on torch's current stream and counts the call in
``launches[helper]``; on the CPU it runs the plain version; a CUDA tensor
with ``device="cpu"`` raises.  On the card every helper takes any tile
while int32 indexing holds.  The shifts are one grid kernel that reads
the tile in place.  The scans are two grid kernels, one warp a row, with
the row rounds in the second one's blocks (or, past 6,144 rows of totals,
as a grid pass each between them; the entry chooses and reports its
kernels in ``scan_kernels``).  The gathers
read their 1 to 8 tables in place, one thread an index.  The two scatters
take any ``out_rows`` and rows, 1 to 8 value tiles and limbs 0-4: their
blocks each own a slice of one table's output (``scatter_plan``).
``scatter_sum_tile`` takes its mask as bool, uint8, int8 or int32 without
a conversion.
"""
from __future__ import annotations

import ctypes
import functools
import json
from math import prod
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..config import refuse_card_tensors, resolve_device
from . import _build
from .primitives import _stream, as_int32

L = 128
NEG = -(1 << 31)                # kernel_lib.NEG
SAT = 1 << 23                   # kernel_lib.SAT, the saturating add's ceiling
BIGV = 1 << 20                  # kernel_lib.BIGV, the min scan's fill
FULL = 0xFFFFFFFF
SCATTER_SLICE = 1024            # output positions a scatter block owns: at 4 limbs 16 KB of shared memory
ALL_ROUNDS = 30                 # row rounds: every one while 2^r < R
OPS = {"max": 0, "min": 1, "add": 2, "addsat": 3}
FILLS = {"max": NEG, "min": BIGV, "add": 0, "addsat": 0}
GATHER_MODES = {"flat_zero": 0, "flat_clip": 1, "row_zero": 2, "row_take": 3}


def bits_mask(bits: int, limb: int = 8) -> int:
    """The bits that ``ceil(bits / limb)`` limbs of ``limb`` bits keep, as an unsigned mask."""
    if not 1 <= bits <= 32:
        raise ValueError(f"bits must be in 1..32, got {bits}")
    width = limb * -(-bits // limb)
    return FULL if width >= 32 else (1 << width) - 1


def _keep(x: torch.Tensor, mask: int) -> torch.Tensor:
    return x if mask == FULL else x & mask


def _wrap(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 modulo 2^32, as XLA's int32 arithmetic wraps."""
    return (((x + (1 << 31)) & FULL) - (1 << 31)).to(torch.int32)


def _tile(x, dev: torch.device, what: str) -> torch.Tensor:
    t = as_int32(x, dev, what)
    if t.ndim != 2 or t.shape[1] != L or t.shape[0] == 0:
        raise ValueError(f"{what} must be a (rows >= 1, {L}) tile, got {tuple(t.shape)}")
    return t


def _operands(device, *xs) -> torch.device:
    """The call's device, with its index: ``device``; for None, the card the
    first CUDA operand lies on, else the current card (raising without one)."""
    if device is None:
        for x in xs:
            if isinstance(x, torch.Tensor) and x.is_cuda:
                return x.device
    dev = resolve_device(device)
    refuse_card_tensors(dev, *xs)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


# ------------------------------------------------------------ plain versions


def _shift_plain(x: torch.Tensor, span: int, off: int, fill: int, vmask: int) -> torch.Tensor:
    """y[f] = x[f + off] & vmask inside f's segment of ``span`` elements, else fill."""
    flat = x.reshape(-1).long()
    n = flat.numel()
    f = torch.arange(n)
    seg, src = f - f % span, f + off
    ok = (src >= seg) & (src < seg + span)
    return _wrap(torch.where(ok, _keep(flat[src.clamp(0, n - 1)], vmask), fill)).reshape(x.shape)


def _combine(op: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if op == "max":
        return torch.maximum(a, b)
    if op == "min":
        return torch.minimum(a, b)
    s = _wrap(a + b).long()
    return s if op == "add" else s.clamp(max=SAT)


def _scan_plain(x: torch.Tensor, op: str, in_mask: int, lane_mask: int, tot_mask: int,
                fill: int, row_rounds: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The JAX scans round by round: seven doubling lane rounds (the shifted
    operand masked; lanes l < k take the fill, or 0 for the adds), the row
    totals masked, ``row_rounds`` doubling row rounds, then each row
    combined with the row before's total.  Returns (result, s, t)."""
    rows = x.shape[0]
    s = _keep(x.long(), in_mask)
    low = fill if op in ("max", "min") else 0
    k = 1
    while k < L:
        sh = torch.full_like(s, low)
        sh[:, k:] = _keep(s[:, :-k], lane_mask)
        s = _combine(op, s, sh)
        k <<= 1
    t = _keep(s[:, -1], tot_mask)
    for rd in range(row_rounds):
        k = 1 << rd
        if k >= rows:
            break
        t = _combine(op, t, torch.cat([torch.full((k,), fill), t[:-k]]))
    excl = torch.cat([torch.full((1,), fill), t[:-1]])
    return (_combine(op, s, excl[:, None]).int(), s.int(),
            t[:, None].expand(rows, L).int().contiguous())


def _gather_plain(table: torch.Tensor, idx: torch.Tensor, vmask: int, mode: str) -> torch.Tensor:
    """A gather of each index of ``idx`` from ``table`` (flat, or along the
    row of the index), in one of ``GATHER_MODES``."""
    ix = idx.long()
    if mode.startswith("flat"):
        flat = table.reshape(-1).long()
        n = flat.numel()
        v = _keep(flat[ix.clamp(0, n - 1)], vmask)
        return _wrap(v if mode == "flat_clip" else torch.where((ix >= 0) & (ix < n), v, 0))
    if mode == "row_take":
        ix = torch.where(ix < 0, ix + L, ix)
    v = _keep(torch.gather(table.long(), 1, ix.clamp(0, L - 1)), vmask)
    return _wrap(torch.where((ix >= 0) & (ix < L), v, NEG if mode == "row_take" else 0))


def _scatter_plain(pos: torch.Tensor, vals: list[torch.Tensor], vmasks: list[int], n_out: int,
                   limbs: int) -> list[torch.Tensor]:
    """H[pos] += val & vmask for pos in [0, n_out); limbs 0: sums; else the
    OR over limbs k of each 8-bit limb's sums shifted back by 8k."""
    p = pos.reshape(-1).long()
    ok = (p >= 0) & (p < n_out)
    outs = []
    for v, m in zip(vals, vmasks):
        v = _keep(v.reshape(-1).long(), m)[ok]
        if limbs == 0:
            h = torch.zeros(n_out, dtype=torch.int64).index_add_(0, p[ok], v)
        else:
            h = torch.zeros(n_out, dtype=torch.int64)
            for k in range(limbs):
                hk = torch.zeros(n_out, dtype=torch.int64).index_add_(0, p[ok], (v >> 8 * k) & 0xFF)
                h |= hk << 8 * k
        outs.append(_wrap(h).reshape(n_out // L, L))
    return outs


# ------------------------------------------------------------------ the card

launches: dict[str, int] = {}
scan_kernels: dict[str, int] = {}      # a scan's kernels on its last call on the card (its entry's count)


@functools.cache
def _entry(kind: str):
    launch, check = _build.kernel("kernel_lib", kind)
    vp, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    launch.argtypes = {
        "shift": [vp, i, i, i, i, u, vp, vp],
        "scan": [vp, i, i, i, u, u, u, i, i, vp, vp, vp, vp, ctypes.POINTER(i), vp],
        "gather": [vp, vp, i, i, vp, i, i, i, vp, vp],
        "scatter": [vp, vp, i, i, vp, vp, i, i, i, i, vp, vp],
    }[kind]
    return launch, check


def _run(helper: str, dev: torch.device, *args) -> None:
    """Launch ``helper``'s entry on ``dev`` (torch's current stream there),
    raise on a CUDA error, count the call."""
    launch, check = _entry(HELPERS[helper].kind)
    if dev.index == torch.cuda.current_device():
        rc = launch(*args, _stream(dev.index))
    else:                                           # operands on another card: launch there
        with torch.cuda.device(dev):
            rc = launch(*args, _stream(dev.index))
    check(rc)
    launches[helper] += 1


_PTRS = ctypes.c_void_p * 8                         # the pointer slots of up to 8 tables


@functools.cache
def _uints(values: tuple[int, ...]) -> ctypes.Array:
    """A C array of ``values`` (tables' masks), made once: the launch only reads it."""
    return (ctypes.c_uint * len(values))(*values)


def _int32_tile(helper: str, x: torch.Tensor) -> None:
    if x.numel() >= 1 << 31:
        raise ValueError(f"{helper}: a tile of {x.numel()} elements, outside int32 indexing")


def _shift(helper: str, x, device, params: Callable[[int], tuple[int, int, int, int]]):
    dev = _operands(device, x)
    x = _tile(x, dev, "x")
    span, off, fill, vmask = params(x.shape[0])
    if dev.type == "cpu":
        return _shift_plain(x, span, off, fill, vmask)
    _int32_tile(helper, x)
    out = torch.empty_like(x)
    off = max(-span, min(off, span))                # past the segment: all fill, in an int
    _run(helper, dev, x.data_ptr(), x.numel(), span, off, fill, vmask, out.data_ptr())
    return out


def _scan(helper: str, x, device, op: str, rounds: bool, in_mask: int, lane_mask: int,
          tot_mask: int, fill: int, row_rounds: int, parts: bool = False):
    if op not in OPS:
        raise ValueError(f"{helper}: op must be one of {tuple(OPS)}, got {op!r}")
    dev = _operands(device, x)
    x = _tile(x, dev, "x")
    if dev.type == "cpu":
        got = _scan_plain(x, op, in_mask, lane_mask, tot_mask, fill, row_rounds)
        return got if parts else got[0]
    rows = x.shape[0]
    _int32_tile(helper, x)
    outs = [torch.empty_like(x) for _ in range(3 if parts else 1)]
    ptrs = [o.data_ptr() for o in outs] + [None] * (3 - len(outs))
    tot = x.new_empty(2 * rows)                     # the row totals, twice for grid passes
    kernels = ctypes.c_int(0)
    _run(helper, dev, x.data_ptr(), rows, OPS[op], int(rounds), in_mask, lane_mask, tot_mask,
         fill, row_rounds, *ptrs, tot.data_ptr(), ctypes.byref(kernels))
    scan_kernels[helper] = kernels.value
    return tuple(outs) if parts else outs[0]


def _gather(helper: str, dev: torch.device, tables: list[torch.Tensor], vmasks: tuple[int, ...],
            idx: torch.Tensor | None, mode: str, r0: int = 0,
            nrows: int | None = None) -> torch.Tensor:
    """Each of ``tables`` (one shape) at the indices of ``idx`` (None:
    n - 1 - e, flip2d; with ``nrows``, only its 128-lane rows r0 ..
    r0 + nrows - 1), in one of ``GATHER_MODES``: the kernel on the card, the
    plain version on the CPU; returns one tensor of the indices' shape, or
    for several tables one (tables, *shape) tensor."""
    n = tables[0].numel()
    shape = (tables[0].shape if idx is None else idx.shape if nrows is None
             else (nrows, *idx.shape[1:]))
    if dev.type == "cpu":
        ix = (torch.arange(n - 1, -1, -1, dtype=torch.int32).reshape(shape) if idx is None
              else idx if nrows is None else idx[r0 : r0 + nrows])
        outs = [_gather_plain(t, ix, m, mode) for t, m in zip(tables, vmasks)]
        return outs[0] if len(outs) == 1 else torch.stack(outs)
    nidx = prod(shape)
    if n >= 1 << 31 or len(tables) * nidx >= 1 << 31:
        raise ValueError(f"{helper}: {len(tables)} x {nidx} outputs from tables of {n} entries, "
                         "outside int32 indexing")
    out = tables[0].new_empty(shape if len(tables) == 1 else (len(tables), *shape))
    if nidx:
        _run(helper, dev, _PTRS(*[t.data_ptr() for t in tables]), _uints(vmasks), len(tables),
             n, None if idx is None else idx.data_ptr() + 4 * L * r0, nidx, shape[-1],
             GATHER_MODES[mode], out.data_ptr())
    return out


class ScatterPlan(NamedTuple):
    """The blocks of a scatter: block (x, j) owns output positions
    [x * slice, min((x + 1) * slice, n_out)) of table j."""
    slice: int                  # output positions a block owns (the last of a table may own fewer)
    grid: tuple[int, int]       # (slices, tables)
    smem: int                   # bytes of shared memory a block takes: slice * max(limbs, 1) int32


@functools.cache
def scatter_plan(ntab: int, n_out: int, limbs: int) -> ScatterPlan:
    """The blocks of a scatter into ``ntab`` tables of ``n_out`` positions
    (limbs 0: sums; else one histogram a limb); a block's histograms stay
    within the 48 KB of shared memory a launch takes unasked."""
    if not 1 <= ntab <= 8:
        raise ValueError(f"scatter: 1 to 8 value tiles, got {ntab}")
    if not 0 <= limbs <= 4:
        raise ValueError(f"scatter: limbs must be in 0..4, got {limbs}")
    if not 1 <= n_out < 1 << 31:
        raise ValueError(f"scatter: {n_out} output positions, outside int32 indexing")
    s = min(SCATTER_SLICE, n_out)
    return ScatterPlan(s, (-(-n_out // s), ntab), 4 * s * max(limbs, 1))


def _scatter(helper: str, pos: torch.Tensor, off: int, npos: int, mask: torch.Tensor | None,
             vals: list[torch.Tensor], vmasks: tuple[int, ...], n_out: int,
             limbs: int) -> torch.Tensor:
    """The scatter kernel on card tensors: ``npos`` positions of ``pos`` and
    values of ``vals`` from byte ``off`` on, where ``mask`` (None: everywhere)
    is set; returns one (n_out / 128, 128) histogram, or for several value
    tiles one (tiles, n_out / 128, 128) tensor."""
    if npos >= 1 << 31:
        raise ValueError(f"{helper}: {npos} positions, outside int32 indexing")
    plan = scatter_plan(len(vals), n_out, limbs)
    out = pos.new_empty((n_out // L, L) if len(vals) == 1 else (len(vals), n_out // L, L))
    _run(helper, pos.device, pos.data_ptr() + off, None if mask is None else mask.data_ptr(),
         0 if mask is None else mask.element_size(), npos,
         _PTRS(*(v.data_ptr() + off for v in vals)), _uints(vmasks), len(vals), limbs, n_out,
         plan.slice, out.data_ptr())
    return out


# ------------------------------------------------------------------- shifts


def _whole(rows: int, off: int, fill: int = 0, vmask: int = FULL) -> tuple[int, int, int, int]:
    return rows * L, off, fill, vmask


def _mm_d(d: int) -> int:
    if not 0 <= d < L:
        raise ValueError(f"d must be in [0, {L}), got {d} (the JAX helper sums two lane shifts "
                         f"outside it)")
    return d


def _nonneg(k: int, what: str = "d") -> int:
    if k < 0:
        raise ValueError(f"{what} must be >= 0, got {k}")
    return k


def stream_shift_down(x, d: int, fill: int = 0, device=None) -> torch.Tensor:
    """y[flat f] = x[flat f - d] over the row-major tile; the head filled
    (``kernel_lib.py:35``).  d >= R * 128 fills everything, as in JAX."""
    _nonneg(d)
    return _shift("stream_shift_down", x, device, lambda rows: _whole(rows, -d, fill))


def stream_shift_up(x, d: int, fill: int = 0, device=None) -> torch.Tensor:
    """y[flat f] = x[flat f + d]; the tail filled (``kernel_lib.py:52``).
    d >= R * 128 raises, as the JAX helper's roll does."""
    _nonneg(d)

    def params(rows: int):
        if d >= rows * L:
            raise ValueError(f"stream_shift_up: d = {d} >= rows * {L} (the JAX helper's roll "
                             "raises 'shift must be non-negative.')")
        return _whole(rows, d, fill)

    return _shift("stream_shift_up", x, device, params)


def stream_shift_up_mm(x, d: int, bits: int = 31, device=None) -> torch.Tensor:
    """y[flat f] = x[flat f + d] (zero fill), 0 <= d < 128, values keeping
    their low 8 * ceil(bits / 8) bits unless d == 0 (``kernel_lib.py:250``)."""
    m = FULL if _mm_d(d) == 0 else bits_mask(bits)
    return _shift("stream_shift_up_mm", x, device, lambda rows: _whole(rows, d, 0, m))


def stream_shift_down_mm(x, d: int, bits: int = 31, device=None) -> torch.Tensor:
    """y[flat f] = x[flat f - d] (zero fill), 0 <= d < 128, masked as
    ``stream_shift_up_mm`` (``kernel_lib.py:259``)."""
    m = FULL if _mm_d(d) == 0 else bits_mask(bits)
    return _shift("stream_shift_down_mm", x, device, lambda rows: _whole(rows, -d, 0, m))


def lane_shift_down(x, k: int, bits: int = 31, device=None) -> torch.Tensor:
    """y[r, l] = x[r, l - k % 128] (zero fill), masked unless k == 0 (``kernel_lib.py:220``)."""
    m = FULL if k == 0 else bits_mask(bits)
    return _shift("lane_shift_down", x, device, lambda rows: (L, -(k % L), 0, m))


def lane_shift_up(x, k: int, bits: int = 31, device=None) -> torch.Tensor:
    """y[r, l] = x[r, l + k % 128] (zero fill), masked unless k == 0 (``kernel_lib.py:225``)."""
    m = FULL if k == 0 else bits_mask(bits)
    return _shift("lane_shift_up", x, device, lambda rows: (L, k % L, 0, m))


def row_shift_down(x, k: int, fill: int = 0, device=None) -> torch.Tensor:
    """y[r] = x[r - k], fill rows at the top (``kernel_lib.py:230``)."""
    _nonneg(k, "k")
    return _shift("row_shift_down", x, device, lambda rows: _whole(rows, -k * L, fill))


def row_shift_up(x, k: int, fill: int = 0, device=None) -> torch.Tensor:
    """y[r] = x[r + k], fill rows at the bottom (``kernel_lib.py:240``)."""
    _nonneg(k, "k")
    return _shift("row_shift_up", x, device, lambda rows: _whole(rows, k * L, fill))


# -------------------------------------------------------------------- scans


def scan2d(x, op: str = "max", device=None) -> torch.Tensor:
    """Inclusive row-major scan, op "max" or "add" (wrapping at 32 bits)
    (``kernel_lib.py:87``)."""
    if op not in ("max", "add"):
        raise ValueError(f"scan2d: op must be 'max' or 'add', got {op!r}")
    return _scan("scan2d", x, device, op, False, FULL, FULL, FULL, FILLS[op], ALL_ROUNDS)


def scan2d_mm(x, op: str = "max", bits: int = 31, fill: int | None = None,
              device=None) -> torch.Tensor:
    """Inclusive row-major scan by the JAX rounds, each lane round's shifted
    operand and the row totals keeping their low 8 * ceil(bits / 8) bits;
    op "max", "min", "add" or "addsat" (``kernel_lib.py:268``)."""
    m = bits_mask(bits)
    fill = FILLS.get(op, 0) if fill is None else fill
    return _scan("scan2d_mm", x, device, op, True, FULL, m, m, fill, ALL_ROUNDS)


def scan2d_tril(x, bits: int = 31, device=None) -> torch.Tensor:
    """Inclusive row-major add-scan of the input's and the row totals' low
    8 * ceil(bits / 8) bits, wrapping at 32 bits (``kernel_lib.py:311``)."""
    m = bits_mask(bits)
    return _scan("scan2d_tril", x, device, "add", False, m, FULL, m, 0, ALL_ROUNDS)


def fill_max_rows(x, bits: int, rounds: int, device=None):
    """The max scan of ``scan2d_mm`` with only ``rounds`` row-doubling rounds;
    returns (result, s, t): the in-row scan and the row totals after those
    rounds, broadcast over the row (``kernel_lib.py:342``)."""
    m = bits_mask(bits)
    return _scan("fill_max_rows", x, device, "max", True, FULL, m, m, NEG,
                 _nonneg(rounds, "rounds"), parts=True)


# ------------------------------------------------------------------ gathers


def gather_flat(table, idx, bits: int, device=None) -> torch.Tensor:
    """y (1, E) = table[flat idx] keeping the low 8 * ceil(bits / 8) bits; an
    index outside [0, R * 128) gives 0 (``kernel_lib.py:139``).  idx: one row
    (1, E >= 1), as in JAX, whose one-hot products refuse any other shape."""
    m = bits_mask(bits)
    dev = _operands(device, table, idx)
    table, idx = _tile(table, dev, "table"), as_int32(idx, dev, "idx")
    if idx.ndim != 2 or idx.shape[0] != 1 or idx.shape[1] == 0:
        raise ValueError(f"gather_flat: the index must be one row (1, E >= 1), got "
                         f"{tuple(idx.shape)}")
    return _gather("gather_flat", dev, [table], (m,), idx, "flat_zero")


def local_gather_rows(vals, li, device=None) -> torch.Tensor:
    """y[r, e] = vals[r, li[r, e]], all 32 bits; a lane outside [0, 128)
    gives 0 (``kernel_lib.py:164``).  li: (R, E), or (1, E) broadcast over
    the R rows as in JAX."""
    return _row_gather("local_gather_rows", vals, li, "row_zero", device)


def lane_gather(x, lane_idx, device=None) -> torch.Tensor:
    """y[r, e] = x[r, lane_idx[r, e]] as ``take_along_axis``: lanes -128..-1
    count from the end, any other lane outside [0, 128) gives INT32_MIN
    (``kernel_lib.py:300``).  lane_idx: (R, E), or (1, E) broadcast over the
    R rows as in JAX."""
    return _row_gather("lane_gather", x, lane_idx, "row_take", device)


def _row_gather(helper: str, vals, li, mode: str, device) -> torch.Tensor:
    dev = _operands(device, vals, li)
    vals, li = _tile(vals, dev, "vals"), as_int32(li, dev, "li")
    if li.ndim != 2 or li.shape[0] not in (1, vals.shape[0]) or li.shape[1] == 0:
        raise ValueError(f"{helper}: the index must be ({vals.shape[0]}, E >= 1) or (1, E), "
                         f"got {tuple(li.shape)}")
    if li.shape[0] != vals.shape[0]:                # one row, broadcast over the tile's rows
        li = li.expand(vals.shape[0], li.shape[1]).contiguous()
    return _gather(helper, dev, [vals], (FULL,), li, mode)


def flip2d(x, bits: int = 16, device=None) -> torch.Tensor:
    """The row-major flat order reversed, keeping the low 8 * ceil(bits / 8)
    bits (``kernel_lib.py:367``)."""
    m = bits_mask(bits)
    dev = _operands(device, x)
    return _gather("flip2d", dev, [_tile(x, dev, "x")], (m,), None, "flat_zero")


def gather_rows_multi(tables_bits, idx, r0: int, nrows: int = 8, pre=None,
                      device=None) -> list[torch.Tensor]:
    """Each (R, 128) table of ``tables_bits`` ([(table, bits), ...], one R)
    at the flat indices of rows r0 .. r0 + nrows - 1 of ``idx`` (``pre``, a
    torch function, applied to those rows first), clipped to [0, R * 128 - 1],
    keeping the low 8 * ceil(bits / 8) bits; a list of (nrows, 128)
    (``kernel_lib.py:405``)."""
    tables_bits = list(tables_bits)
    if not 1 <= len(tables_bits) <= 8:
        raise ValueError(f"gather_rows_multi: 1 to 8 tables, got {len(tables_bits)}")
    masks = _masks(tuple([b for _, b in tables_bits]))
    dev = _operands(device, idx, *(t for t, _ in tables_bits))
    first = _tile(tables_bits[0][0], dev, "table")     # the others must have its shape
    tables = [first] + [as_int32(t, dev, "table") for t, _ in tables_bits[1:]]
    idx = _tile(idx, dev, "idx")
    shape = first.shape
    if any([t.shape != shape for t in tables]):
        raise ValueError("gather_rows_multi: tables differ in shape: "
                         f"{[tuple(t.shape) for t in tables]}")
    if r0 < 0 or nrows < 1 or r0 + nrows > idx.shape[0]:
        raise ValueError(f"gather_rows_multi: rows {r0}..{r0 + nrows - 1} outside idx's "
                         f"{idx.shape[0]}")
    if pre is None:                                 # rows r0.. of the contiguous tile, in place
        out = _gather("gather_rows_multi", dev, tables, masks, idx, "flat_clip", r0, nrows)
    else:
        rows = as_int32(pre(idx[r0 : r0 + nrows]), dev, "pre(idx)")
        out = _gather("gather_rows_multi", dev, tables, masks, rows, "flat_clip")
    return [out] if len(tables) == 1 else list(out.unbind(0))


# ----------------------------------------------------------------- scatters


def scatter_rows_multi(pos, vals_bits, r0: int, out_rows: int, nrows: int = 8,
                       device=None) -> list[torch.Tensor]:
    """H[flat pos] += val over rows r0 .. r0 + nrows - 1 of ``pos`` and of each
    value tile of ``vals_bits`` ([(vals, bits), ...]), values keeping their
    low 7 * ceil(bits / 7) bits; positions outside [0, out_rows * 128)
    scatter nowhere, duplicates sum; a list of (out_rows, 128)
    (``kernel_lib.py:459``)."""
    vals_bits = list(vals_bits)
    if not 1 <= len(vals_bits) <= 8:
        raise ValueError(f"scatter_rows_multi: 1 to 8 value tiles, got {len(vals_bits)}")
    masks = _masks(tuple([b for _, b in vals_bits]), 7)
    vals = [v for v, _ in vals_bits]
    dev = _operands(device, pos, *vals)
    pos = _tile(pos, dev, "pos")
    vals = [_tile(v, dev, "vals") for v in vals]
    shape = pos.shape
    if any([v.shape != shape for v in vals]):
        raise ValueError("scatter_rows_multi: value tiles must have pos's shape")
    if r0 < 0 or nrows < 1 or r0 + nrows > shape[0] or out_rows < 1:
        raise ValueError(f"scatter_rows_multi: rows {r0}..{r0 + nrows - 1} outside pos's "
                         f"{shape[0]}, or out_rows {out_rows} < 1")
    if dev.type == "cpu":
        sl = slice(r0, r0 + nrows)
        return _scatter_plain(pos[sl], [v[sl] for v in vals], list(masks), out_rows * L, 0)
    out = _scatter("scatter_rows_multi", pos, 4 * L * r0, nrows * L, None, vals, masks,
                   out_rows * L, 0)                 # from row r0 of contiguous tiles
    return [out] if out.ndim == 2 else list(out.unbind(0))


@functools.cache
def _masks(bits: tuple[int, ...], limb: int = 8) -> tuple[int, ...]:
    return tuple(bits_mask(b, limb) for b in bits)


_MASK_BYTES = {torch.bool: 1, torch.uint8: 1, torch.int8: 1, torch.int32: 4}


def _mask(mask_row, dev: torch.device) -> torch.Tensor:
    """``scatter_sum_tile``'s mask on ``dev``: bool, uint8, int8 or int32 as
    it comes (nonzero = set), any other dtype as int32."""
    t = torch.as_tensor(mask_row)
    if t.dtype not in _MASK_BYTES:
        t = t.to(torch.int32)
    if t.device != dev or not t.is_contiguous():
        t = t.to(dev).contiguous()
    return t


def scatter_sum_tile(pos_row, val_row, mask_row, out_rows: int, bits: int,
                     device=None) -> torch.Tensor:
    """H (out_rows, 128): H[flat pos[e]] += val[e] where mask[e] (nonzero),
    each 8-bit limb of ceil(bits / 8) summed alone and the sums OR-ed back
    together; positions outside [0, out_rows * 128) scatter nowhere
    (``kernel_lib.py:504``).  pos_row, val_row, mask_row: one shape."""
    limbs = bits_mask(bits).bit_length() // 8
    dev = _operands(device, pos_row, val_row, mask_row)
    pos, val = as_int32(pos_row, dev, "pos_row"), as_int32(val_row, dev, "val_row")
    mask = _mask(mask_row, dev)
    if not pos.shape == val.shape == mask.shape or out_rows < 1:
        raise ValueError("scatter_sum_tile: pos, val and mask must have one shape, out_rows >= 1")
    n_out = out_rows * L
    if dev.type == "cpu":
        return _scatter_plain(torch.where(mask != 0, pos, n_out), [val], [FULL], n_out, limbs)[0]
    return _scatter("scatter_sum_tile", pos, 0, pos.numel(), mask, [val], (FULL,), n_out, limbs)


def call(name: str, arrays: dict, params: dict, device=None) -> list[torch.Tensor]:
    """Helper ``name`` on a case as the fixtures store it: ``arrays`` in call
    order (``gather_rows_multi``: the tables, then the index;
    ``scatter_rows_multi``: the positions, then the value tiles) and its
    static ``params`` (``bits`` a list for those two).  Returns the outputs
    as a list."""
    w, a = HELPERS[name].wrapper, list(arrays.values())
    if name == "gather_rows_multi":
        got = w(list(zip(a[:-1], params["bits"])), a[-1], params["r0"], params["nrows"],
                device=device)
    elif name == "scatter_rows_multi":
        got = w(a[0], list(zip(a[1:], params["bits"])), params["r0"], params["out_rows"],
                params["nrows"], device=device)
    else:
        got = w(*a, **params, device=device)
    return list(got) if isinstance(got, (list, tuple)) else [got]


def read_cases(path) -> list[tuple[str, str, dict, dict, list[np.ndarray]]]:
    """The cases of a fixture file in ``call``'s form (``kernel_lib.npz``,
    written by ``tools/make_torch_fixtures.py --group kernel_lib``):
    (case, helper, arrays, params, the JAX helper's outputs)."""
    with np.load(path) as z:
        out = []
        for case, helper, names, params in zip(z["cases"], z["helpers"], z["args"], z["params"]):
            case = str(case)
            arrays = {a: z[f"{case}__{a}"] for a in str(names).split(",")}
            outs = [z[k] for k in sorted((k for k in z.files if k.startswith(f"{case}__out")),
                                         key=lambda k: int(k.rsplit("out", 1)[1]))]
            out.append((case, str(helper), arrays, json.loads(str(params)), outs))
    return out


def traffic(name: str, arrays: dict, params: dict) -> tuple[int, int]:
    """(bytes, operations) that helper ``name`` needs on a case in ``call``'s
    form, counted on this case's data: each int32 it must read once (of a
    shift, the elements that reach the output; of a table, the distinct
    entries its in-range indices reach; of a scatter, the positions, and the
    values that land; of the ``_multi`` helpers, rows r0 .. r0 + nrows - 1
    only), each output written once; one operation an output element of a
    shift or gather, a combine of a scan, a limb sum of a landing value."""
    a = [np.asarray(v).astype(np.int64) for v in arrays.values()]
    kind = HELPERS[name].kind
    if kind == "shift":
        n = a[0].size
        d = params.get("d", params.get("k", 0))
        if name.startswith("lane"):
            span, off = L, d % L
        else:
            span, off = n, d * L if name.startswith("row") else d
        return 4 * (n // span * max(span - off, 0) + n), n
    if kind == "scan":
        n = a[0].size
        return 4 * (n + n * (3 if name == "fill_max_rows" else 1)), n
    if kind == "gather":
        if name == "flip2d":
            return 4 * 2 * a[0].size, a[0].size
        if name == "gather_rows_multi":
            tables, idx = a[:-1], a[-1][params["r0"] : params["r0"] + params["nrows"]]
            flat = np.clip(idx, 0, tables[0].size - 1)
        elif name == "gather_flat":
            tables, idx = a[:1], a[1]
            flat = idx[(idx >= 0) & (idx < a[0].size)]
        else:                                   # local_gather_rows, lane_gather: along the row
            tables, idx = a[:1], np.broadcast_to(a[1], (a[0].shape[0], a[1].shape[1]))
            li = np.where(idx < 0, idx + L, idx) if name == "lane_gather" else idx
            row = np.arange(idx.shape[0])[:, None].repeat(idx.shape[1], 1)
            ok = (li >= 0) & (li < L)
            flat = row[ok] * L + li[ok]
        reached, nt = np.unique(flat).size, len(tables)
        return 4 * (nt * reached + idx.size + nt * idx.size), nt * idx.size
    n_out = params["out_rows"] * L
    if name == "scatter_rows_multi":
        sl = slice(params["r0"], params["r0"] + params["nrows"])
        pos, ntab, limbs = a[0][sl], len(a) - 1, 1
        land = int(((pos >= 0) & (pos < n_out)).sum())
        nread = pos.size + ntab * land
    else:                                       # scatter_sum_tile: pos and val where the mask is set
        pos, mask, ntab, limbs = a[0], a[2] != 0, 1, bits_mask(params["bits"]).bit_length() // 8
        land = int((mask & (pos >= 0) & (pos < n_out)).sum())
        nread = mask.size + int(mask.sum()) + land
    return 4 * (nread + ntab * n_out), ntab * land * limbs


# -------------------------------------------------------------------- table


class Helper(NamedTuple):
    """One helper of csnappy_tpu/ops/kernel_lib.py and the JAX test that runs it."""
    wrapper: Callable
    kind: str                   # its device function in csrc/kernel_lib.cuh (shift, scan, gather, scatter)
    jax: str                    # the JAX helper, file:line
    test: str | None            # its test in tests/test_kernel_lib.py, or None: no JAX test runs it
    row: str                    # the kernel-table row of the pallas_call that runs it: 15a or 15b


_K, _T = "csnappy_tpu/ops/kernel_lib.py", "tests/test_kernel_lib.py"
HELPERS: dict[str, Helper] = {
    "stream_shift_down": Helper(stream_shift_down, "shift", f"{_K}:35", f"{_T}:26", "15a"),
    "stream_shift_up": Helper(stream_shift_up, "shift", f"{_K}:52", f"{_T}:40", "15a"),
    "scan2d": Helper(scan2d, "scan", f"{_K}:87", f"{_T}:54", "15a"),
    "gather_flat": Helper(gather_flat, "gather", f"{_K}:139", f"{_T}:67", "15a"),
    "local_gather_rows": Helper(local_gather_rows, "gather", f"{_K}:164", f"{_T}:79", "15a"),
    "stream_shift_up_mm": Helper(stream_shift_up_mm, "shift", f"{_K}:250", f"{_T}:92", "15a"),
    "scan2d_mm": Helper(scan2d_mm, "scan", f"{_K}:268", f"{_T}:106", "15a"),
    "gather_rows_multi": Helper(gather_rows_multi, "gather", f"{_K}:405", f"{_T}:120", "15b"),
    "scatter_rows_multi": Helper(scatter_rows_multi, "scatter", f"{_K}:459", f"{_T}:149", "15a"),
    "scatter_sum_tile": Helper(scatter_sum_tile, "scatter", f"{_K}:504", f"{_T}:169", "15a"),
    "lane_gather": Helper(lane_gather, "gather", f"{_K}:300", None, "15a"),
    "stream_shift_down_mm": Helper(stream_shift_down_mm, "shift", f"{_K}:259", None, "15a"),
    "lane_shift_down": Helper(lane_shift_down, "shift", f"{_K}:220", None, "15a"),
    "lane_shift_up": Helper(lane_shift_up, "shift", f"{_K}:225", None, "15a"),
    "row_shift_down": Helper(row_shift_down, "shift", f"{_K}:230", None, "15a"),
    "row_shift_up": Helper(row_shift_up, "shift", f"{_K}:240", None, "15a"),
    "scan2d_tril": Helper(scan2d_tril, "scan", f"{_K}:311", None, "15a"),
    "fill_max_rows": Helper(fill_max_rows, "scan", f"{_K}:342", None, "15a"),
    "flip2d": Helper(flip2d, "gather", f"{_K}:367", None, "15a"),
}
launches.update({name: 0 for name in HELPERS})

# every shift and scan helper with arguments that make each part of its
# kernels count: a fill that differs from the data, masks that bite, row
# rounds stopped short, rounds past a tile's rows; the configurations the
# card checks run on wide tiles (tests/test_torch_cuda.py, chip_smoke.py)
SHIFT_SCAN_RUNS: list[tuple[str, tuple, dict]] = [
    ("stream_shift_down", (5000,), {"fill": 3}), ("stream_shift_up", (129,), {"fill": -2}),
    ("stream_shift_up_mm", (77,), {"bits": 24}), ("stream_shift_down_mm", (3,), {"bits": 8}),
    ("lane_shift_down", (5,), {"bits": 16}), ("lane_shift_up", (300,), {"bits": 8}),
    ("row_shift_down", (40,), {"fill": -1}), ("row_shift_up", (1,), {}),
    ("scan2d", (), {"op": "add"}), ("scan2d", (), {"op": "max"}),
    ("scan2d_mm", (), {"op": "addsat", "bits": 20}), ("scan2d_mm", (), {"op": "min", "bits": 24}),
    ("scan2d_tril", (), {"bits": 24}), ("fill_max_rows", (18, 5), {}),
    ("fill_max_rows", (31, 30), {}),
]
