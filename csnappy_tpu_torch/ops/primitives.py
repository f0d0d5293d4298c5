"""Data-movement primitives over int32 tensors (port of ``csnappy_tpu/ops/primitives.py``).

Six functions, each the counterpart of one Pallas kernel of the JAX module
(rows 6-11 of the kernel table in ``PERF.md``):

  local_gather     y[..., c, e] = v[..., c, clip(i[..., c, e], 0, 127)]
  local_scatter_or out[..., c, q] = max(any_e(m[c, e] > 0 & t[c, e] == q), m[c, q])
  compose_round    one Jacobi round of in-chunk pointer jumping over (F, S, E)
  row_gather       y[m, :] = T[clip(rows[m], 0, CI - 1), :]
  table_gather     y[i] = T[clip(idx[i], 0, T - 1)]
  rowwise_gather   y[g, n] = T[g, clip(idx[g, n], 0, W - 1)]

The answers are the Pallas kernels', not the JAX module's jnp fallback: the
three table gathers rebuild each value from ``limbs`` 8-bit limbs, so they
keep only its low ``8 * limbs`` bits (all 32 at ``limbs = 4``), negative
values included.  Inside the JAX contract (``0 <= v < 2^(8 * limbs)``) the
two JAX paths agree.  The three local ops are exact over all of int32;
``compose_round`` wraps ``S + S[li]`` at 32 bits, as XLA does.

Each wrapper takes int32 tensors or arrays and a ``device`` (None = the card):
on the card it launches its kernel from ``csrc/primitives.cu`` on torch's
current stream and counts the launch on ``<wrapper>.launches``; on the CPU it
runs the plain version (``<name>_plain``); a CUDA tensor with
``device="cpu"`` raises.  An empty batch or index returns an empty result
without a launch.  The JAX module's shape policies are not semantics and are
not copied: any row count (no ``RC = 8`` tiling), any ``M`` for
``row_gather`` (no ``M % 8 == 0``) and any table length for
``table_gather`` (no ``T % 128 == 0``).  ``force_pallas``,
``register_trace_cache``, ``interpret_mode`` and ``bucket_pow2`` are JAX
trace and shape machinery and have no counterpart.

``PRIMITIVES`` lists each wrapper with its array arguments, the kernel
that serves it and the TPU kernel it replaces.  ``tools/movebench.py``'s
flat gather launches ``lane_gather`` through :func:`launch_lane_gather`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..config import refuse_card_tensors, resolve_device
from . import _build

L = 128
S_CAP = 1 << 23                   # compose_round's saturation of S


def limb_mask(limbs: int) -> int:
    """The bits a gather of ``limbs`` 8-bit limbs keeps, as an unsigned 32-bit mask."""
    if not 1 <= limbs <= 4:
        raise ValueError(f"limbs must be in 1..4, got {limbs}")
    return (1 << (8 * limbs)) - 1


def _keep(x: torch.Tensor, limbs: int) -> torch.Tensor:
    """``x`` with only its low ``8 * limbs`` bits (the int32 bit pattern at 4)."""
    m = limb_mask(limbs)
    return x if m == 0xFFFFFFFF else x & m


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 modulo 2^32, as XLA's int32 arithmetic wraps."""
    return (((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def as_int32(x, dev: torch.device, what: str) -> torch.Tensor:
    """``x`` (a tensor or array) as a contiguous int32 tensor on ``dev``; any
    other dtype raises.  A tensor that is one already is taken as it is,
    with no torch call."""
    if (isinstance(x, torch.Tensor) and x.dtype == torch.int32 and x.device == dev
            and x.is_contiguous()):
        return x
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
    if t.dtype != torch.int32:
        raise TypeError(f"{what} must be int32, got {t.dtype}")
    return t.to(dev).contiguous()


def _lanes(what: str, *xs: torch.Tensor) -> None:
    """The local ops' operands: one shape, last axis 128."""
    if xs[0].ndim < 1 or xs[0].shape[-1] != L:
        raise ValueError(f"{what}: last axis must be {L}, got shape {tuple(xs[0].shape)}")
    if any(x.shape != xs[0].shape for x in xs[1:]):
        raise ValueError(f"{what}: operands differ in shape: {[tuple(x.shape) for x in xs]}")


def _stream(index: int | None) -> int:
    """The handle of torch's current stream on card ``index`` (None: the
    current card), with no Stream object built."""
    return torch._C._cuda_getCurrentRawStream(torch.cuda.current_device() if index is None
                                              else index)


# ------------------------------------------------------------ plain versions


def local_gather_plain(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of ``local_gather`` (row 6)."""
    return torch.gather(values, -1, idx.clamp(0, L - 1).long())


def local_scatter_or_plain(mask: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
    """Plain version of ``local_scatter_or`` (row 7)."""
    m2, t2 = mask.reshape(-1, L), tgt.reshape(-1, L)
    hit = torch.zeros_like(m2)
    ok = (m2 > 0) & (t2 >= 0) & (t2 < L)
    rows = torch.arange(m2.shape[0]).unsqueeze(1).expand_as(t2)
    hit[rows[ok], t2[ok].long()] = 1
    return torch.maximum(hit, m2).reshape(mask.shape)


def compose_round_plain(F, S, E, chunk_end):
    """Plain version of ``compose_round`` (row 8): every lane reads the old values."""
    local = F < chunk_end
    li = torch.where(local, F & (L - 1), 0).long()
    gF, gS, gE = (torch.gather(x, -1, li) for x in (F, S, E))
    s_new = _wrap32(S.long() + gS.long()).clamp_max(S_CAP)
    return (torch.where(local, gF, F), torch.where(local, s_new, S),
            torch.where(local, E | gE, E))


def row_gather_plain(table2d: torch.Tensor, rows: torch.Tensor, limbs: int = 3) -> torch.Tensor:
    """Plain version of ``row_gather`` (row 9)."""
    return _keep(table2d[rows.clamp(0, table2d.shape[0] - 1).long()], limbs)


def table_gather_plain(table: torch.Tensor, idx: torch.Tensor, limbs: int = 2) -> torch.Tensor:
    """Plain version of ``table_gather`` (row 10)."""
    return _keep(table[idx.clamp(0, table.shape[0] - 1).long()], limbs)


def rowwise_gather_plain(tables: torch.Tensor, idx: torch.Tensor, limbs: int = 3) -> torch.Tensor:
    """Plain version of ``rowwise_gather`` (row 11)."""
    return _keep(torch.gather(tables, 1, idx.clamp(0, tables.shape[1] - 1).long()), limbs)


# ------------------------------------------------------------------ wrappers


def launch_lane_gather(tbl: torch.Tensor, width: int, idx: torch.Tensor, groups: int,
                       mask: int, dev: torch.device) -> torch.Tensor:
    """Launch ``lane_gather`` on card tensors: ``groups`` rows of
    ``idx.numel() / groups`` outputs, each row reading its own ``width``-wide
    slice of ``tbl``, masked with ``mask``.  Counts no launch: the caller's
    wrapper does."""
    out = torch.empty_like(idx)
    launch, check = _kernels()["lane_gather"]
    with torch.cuda.device(dev):
        check(launch(tbl.data_ptr(), width, idx.data_ptr(), out.data_ptr(), groups,
                     idx.numel() // groups, mask, _stream(dev.index)))
    return out


def local_gather(values, idx, device=None) -> torch.Tensor:
    """y[..., c, e] = values[..., c, clip(idx[..., c, e], 0, 127)], all 32 bits.

    values, idx: int32 [..., C, 128] of one shape.  Row 6 of the kernel table
    (``csnappy_tpu/ops/primitives.py:94``); on the card ``lane_gather`` with
    W = N = 128."""
    dev = resolve_device(device)
    refuse_card_tensors(dev, values, idx)
    values, idx = as_int32(values, dev, "values"), as_int32(idx, dev, "idx")
    _lanes("local_gather", values, idx)
    if dev.type == "cpu":
        return local_gather_plain(values, idx)
    if idx.numel() == 0:
        return torch.empty_like(idx)
    out = launch_lane_gather(values, L, idx, idx.numel() // L, 0xFFFFFFFF, dev)
    local_gather.launches += 1
    return out


local_gather.launches = 0


def local_scatter_or(mask, tgt, device=None) -> torch.Tensor:
    """out[..., c, q] = max(any_e(mask[..., c, e] > 0 and tgt[..., c, e] == q), mask[..., c, q]).

    mask, tgt: int32 [..., C, 128] of one shape; a target outside [0, 128)
    scatters nowhere.  Row 7 (``csnappy_tpu/ops/primitives.py:132``); on the
    card ``scatter_or``."""
    dev = resolve_device(device)
    refuse_card_tensors(dev, mask, tgt)
    mask, tgt = as_int32(mask, dev, "mask"), as_int32(tgt, dev, "tgt")
    _lanes("local_scatter_or", mask, tgt)
    if dev.type == "cpu":
        return local_scatter_or_plain(mask, tgt)
    out = torch.empty_like(mask)
    if mask.numel() == 0:
        return out
    launch, check = _kernels()["scatter_or"]
    with torch.cuda.device(dev):
        check(launch(mask.data_ptr(), tgt.data_ptr(), out.data_ptr(), mask.numel() // L,
                     _stream(dev.index)))
    local_scatter_or.launches += 1
    return out


local_scatter_or.launches = 0


def compose_round(F, S, E, chunk_end, device=None):
    """One in-chunk composition round (the decoder's phase A2), returned as (F', S', E').

    Where F < chunk_end, with li = F & 127 in the same 128-lane row:
    F' = F[li], S' = min(S + S[li], 1 << 23) (the sum wraps at 32 bits),
    E' = E | E[li]; elsewhere unchanged.  Every lane reads the values before
    the round.  F, S, E, chunk_end: int32 [..., CI, 128] of one shape.  Row 8
    (``csnappy_tpu/ops/primitives.py:187``); on the card ``compose_round``."""
    dev = resolve_device(device)
    refuse_card_tensors(dev, F, S, E, chunk_end)
    F, S, E, ce = (as_int32(x, dev, w) for x, w in ((F, "F"), (S, "S"), (E, "E"),
                                                 (chunk_end, "chunk_end")))
    _lanes("compose_round", F, S, E, ce)
    if dev.type == "cpu":
        return compose_round_plain(F, S, E, ce)
    outs = tuple(torch.empty_like(F) for _ in range(3))
    if F.numel() == 0:
        return outs
    launch, check = _kernels()["compose_round"]
    with torch.cuda.device(dev):
        check(launch(F.data_ptr(), S.data_ptr(), E.data_ptr(), ce.data_ptr(),
                     *(o.data_ptr() for o in outs), F.numel() // L, _stream(dev.index)))
    compose_round.launches += 1
    return outs


compose_round.launches = 0


def row_gather(table2d, rows, limbs: int = 3, device=None) -> torch.Tensor:
    """y[m, :] = table2d[clip(rows[m], 0, CI - 1), :], keeping the low 8 * limbs bits.

    table2d: int32 [CI, 128], CI > 0; rows: int32 [M], any M.  Row 9
    (``csnappy_tpu/ops/primitives.py:231``); on the card ``row_gather``."""
    mask = limb_mask(limbs)
    dev = resolve_device(device)
    refuse_card_tensors(dev, table2d, rows)
    table2d, rows = as_int32(table2d, dev, "table2d"), as_int32(rows, dev, "rows")
    if table2d.ndim != 2 or table2d.shape[1] != L or table2d.shape[0] == 0:
        raise ValueError(f"row_gather: table must be [CI > 0, {L}], got {tuple(table2d.shape)}")
    if rows.ndim != 1:
        raise ValueError(f"row_gather: rows must be 1-D, got {tuple(rows.shape)}")
    if dev.type == "cpu":
        return row_gather_plain(table2d, rows, limbs)
    out = torch.empty((rows.numel(), L), dtype=torch.int32, device=dev)
    if rows.numel() == 0:
        return out
    launch, check = _kernels()["row_gather"]
    with torch.cuda.device(dev):
        check(launch(table2d.data_ptr(), table2d.shape[0], rows.data_ptr(), out.data_ptr(),
                     rows.numel(), mask, _stream(dev.index)))
    row_gather.launches += 1
    return out


row_gather.launches = 0


def table_gather(table, idx, limbs: int = 2, device=None) -> torch.Tensor:
    """y[i] = table[clip(idx[i], 0, T - 1)], keeping the low 8 * limbs bits.

    table: int32 [T], T > 0 (any T); idx: int32 [N].  Row 10
    (``csnappy_tpu/ops/primitives.py:283``); on the card ``lane_gather`` with
    one row."""
    mask = limb_mask(limbs)
    dev = resolve_device(device)
    refuse_card_tensors(dev, table, idx)
    table, idx = as_int32(table, dev, "table"), as_int32(idx, dev, "idx")
    if table.ndim != 1 or table.numel() == 0:
        raise ValueError(f"table_gather: table must be [T > 0], got {tuple(table.shape)}")
    if idx.ndim != 1:
        raise ValueError(f"table_gather: idx must be 1-D, got {tuple(idx.shape)}")
    if dev.type == "cpu":
        return table_gather_plain(table, idx, limbs)
    if idx.numel() == 0:
        return torch.empty_like(idx)
    out = launch_lane_gather(table, table.numel(), idx, 1, mask, dev)
    table_gather.launches += 1
    return out


table_gather.launches = 0


def rowwise_gather(tables, idx, limbs: int = 3, device=None) -> torch.Tensor:
    """y[g, n] = tables[g, clip(idx[g, n], 0, W - 1)], keeping the low 8 * limbs bits.

    tables: int32 [G, W], W > 0; idx: int32 [G, N].  Row 11
    (``csnappy_tpu/ops/primitives.py:328``); on the card ``lane_gather``."""
    mask = limb_mask(limbs)
    dev = resolve_device(device)
    refuse_card_tensors(dev, tables, idx)
    tables, idx = as_int32(tables, dev, "tables"), as_int32(idx, dev, "idx")
    if tables.ndim != 2 or tables.shape[1] == 0:
        raise ValueError(f"rowwise_gather: tables must be [G, W > 0], got {tuple(tables.shape)}")
    if idx.ndim != 2 or idx.shape[0] != tables.shape[0]:
        raise ValueError(f"rowwise_gather: idx must be [{tables.shape[0]}, N], "
                         f"got {tuple(idx.shape)}")
    if dev.type == "cpu":
        return rowwise_gather_plain(tables, idx, limbs)
    if idx.numel() == 0:
        return torch.empty_like(idx)
    out = launch_lane_gather(tables, tables.shape[1], idx, tables.shape[0], mask, dev)
    rowwise_gather.launches += 1
    return out


rowwise_gather.launches = 0


class Primitive(NamedTuple):
    """One row of the kernel table served by this module."""
    wrapper: Callable
    args: tuple[str, ...]         # its array arguments, in call order
    entry: str                    # the kernel of csrc/primitives.cu that serves it
    replaces: str                 # the TPU kernel's pallas_call


PRIMITIVES = {
    "local_gather": Primitive(local_gather, ("values", "idx"), "lane_gather",
                              "csnappy_tpu/ops/primitives.py:94"),
    "local_scatter_or": Primitive(local_scatter_or, ("mask", "tgt"), "scatter_or",
                                  "csnappy_tpu/ops/primitives.py:132"),
    "compose_round": Primitive(compose_round, ("F", "S", "E", "chunk_end"), "compose_round",
                               "csnappy_tpu/ops/primitives.py:187"),
    "row_gather": Primitive(row_gather, ("table2d", "rows"), "row_gather",
                            "csnappy_tpu/ops/primitives.py:231"),
    "table_gather": Primitive(table_gather, ("table", "idx"), "lane_gather",
                              "csnappy_tpu/ops/primitives.py:283"),
    "rowwise_gather": Primitive(rowwise_gather, ("tables", "idx"), "lane_gather",
                                "csnappy_tpu/ops/primitives.py:328"),
}


@functools.cache
def _kernels() -> dict:
    """The four launch functions of ``csrc/primitives.cu``, each as (launch, check)."""
    vp, ll, u = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_uint
    argtypes = {
        "lane_gather": [vp, ll, vp, vp, ll, ll, u, vp],
        "row_gather": [vp, ll, vp, vp, ll, u, vp],
        "scatter_or": [vp, vp, vp, ll, vp],
        "compose_round": [vp, vp, vp, vp, vp, vp, vp, ll, vp],
    }
    out = {}
    for entry, types in argtypes.items():
        launch, check = _build.kernel("primitives", entry)
        launch.argtypes = types
        out[entry] = (launch, check)
    return out
