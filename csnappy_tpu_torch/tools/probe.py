"""Latency and capacity probes on the card (port of ``tools/mosaic_probe.py``,
``mosaic_probe2.py``, ``mosaic_probe5.py``, ``mosaic_probe3.py``,
``mosaic_probe3b.py``, ``mosaic_probe3c.py``, ``mosaic_probe4.py`` and
``mosaic_probe6.py``).

The JAX tools measure, on the TPU, what one step of the constructs the
fused kernels are built from costs: a dependent load per step from vector
or scalar memory, with and without a store, at 1, 2 and 4 interleaved
chains; dynamic row reads and writes; a small matrix product; one-hot row
gathers; dense vector work; lane rolls; gather and scatter loops; the
largest on-chip scratch that runs; then the walk forms of the decoder and
encoder over a 1-D walk table (plain, unrolled, interleaved, pair-table,
with the real checks, with and without a branch), matrix products beside a
scalar walk, int8 and bf16 products, wide gathers by table height and
limbs, scatter-adds, triangular and saturating scans, lane gathers
(``take_along_axis``) and an in-row pointer-jumping round; then the
decoder's resolve-phase building blocks: a 4,096-wide gather whose indices
depend on the last gather, by table height and limbs, a lane gather,
pointer-jumping rounds with and without a convergence check, a window read
at a dynamic base, and flat gathers at the resolve shape.  Each probe loops
K times inside one kernel, so the cost of a step is the slope between two
values of K.

Here each probe is a kernel of ``csrc/probe.cu``, ``csrc/probe3.cu`` or
``csrc/probe4.cu`` that computes what the TPU kernel computes (the same
int32 (8, 128) ``o_ref`` for the same K, input and second input), written
for Hopper: the scalar walks are one thread walking a table in shared or
global memory, the vector probes 128 or 1024 threads, the products
tensor-core ``wmma`` products, the rolls a 128-lane rotate through shared
memory, the window copy a ``cp.async.bulk`` into shared memory, the wide
gathers 1024 threads gathering by address from a table in shared memory,
the lane gathers one thread a chain; ``csrc/probe4.cu`` builds its probes on
the gather of ``csrc/kernel_lib.cuh``.  ``PROBES`` names each probe by its
JAX name (``"mosaic_probe.walk_load"``, ..., ``"mosaic_probe6.el_i16"``)
with its plain version, its CUDA source and entry, its TPU site and its
(k_lo, k_hi).  ``mosaic_probe6.taa_4096x128`` fails to trace in JAX (a
``broadcast_to`` of (8, 128) to (4096, 128), ``mosaic_probe6.py:138``), so
it has no kernel and no plain version: :func:`probe` raises the JAX
``ValueError`` for it; ``TIMED`` lists the probes that are timed by slope.

* :func:`probe` — one probe's output at K on the card (``device=None``) or,
  with ``device="cpu"``, its plain version: torch ops (Python ints for the
  scalar walks) in a Python loop over K, wrapping at 32 bits as the JAX
  kernels do.  A plain version may compute only what reaches the output and
  hoist what does not depend on the iteration (the kernels do neither).
  Scratch that a TPU kernel reads before writing holds INT32_MIN, as the
  Pallas interpreter fills it; the kernels fill it the same.  The probes of
  mosaic_probe3.py and mosaic_probe3b.py take their walk table beside the
  input, those of mosaic_probe6.py a (32, 128) index (:func:`second_input`
  draws either as their ``main()``s do).
* :func:`measure` — ns and SM cycles per iteration on the card: the
  CUDA-event slope between launches at k_lo and k_hi (as the JAX ``slope``,
  which drops the launch cost), and the ``clock64()`` slope of the loop
  inside the kernel; the result at k_hi held against the plain version.
* :func:`smem_cap` / :func:`smem_capacity` — whether a (rows, 128) int32
  shared-memory scratch launches, and the largest dynamic shared memory in
  bytes that a block launches with, found by bisection.

Run:  python -m csnappy_tpu_torch.tools.probe [names] [--smem] [--device cpu]
prints one JSON line per probe, then one JSON line of all.  Each launch is
counted in ``probe.launches[name]``.  There is no fallback: without a card
``device=None`` raises, and a kernel that fails to build or launch raises.
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import json
import subprocess
import sys
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..config import refuse_card_tensors, resolve_device
from ..ops import _build
from .timing import BF16_PER_S, HBM_BYTES_PER_S, INT8_PER_S, OPS_PER_S

L = 128
ROWS = 304                      # mosaic_probe.py:40, mosaic_probe2.py:19
INT_MIN = -(1 << 31)            # the Pallas interpreter's fill of unwritten int32 scratch
OUT_SHAPE = (8, L)
SMEM_ROWS = (256, 512, 768, 1024, 1536, 2048)     # mosaic_probe5.py:135


def _i32(x: int) -> int:
    """A Python int modulo 2^32, as a signed 32-bit value."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _wrap(x: torch.Tensor) -> torch.Tensor:
    """int64 holding int32 values: the sum taken modulo 2^32, sign-extended."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _full(x: int) -> torch.Tensor:
    return torch.full(OUT_SHAPE, _i32(x), dtype=torch.int32)


# ------------------------------------------------ plain versions, mosaic_probe.py


def _walk(t: list, k: int, mod: int, store: int = 0) -> int:
    """The dependent walk of mosaic_probe.py:59-63: ``acc + p`` after k steps
    of ``p = (p + (v & 63) + 1) % mod``, plus ``scr[0]`` of a ``store``-entry
    scratch written ``scr[i % store] = v`` each step when ``store``."""
    p = acc = 0
    scr0 = INT_MIN
    for i in range(k):
        v = t[p]
        if store and i % store == 0:
            scr0 = v
        p = (p + (v & 63) + 1) % mod
        acc += v
    return acc + p + (scr0 if store else 0)


def walk_load_plain(k: int, d: torch.Tensor) -> torch.Tensor:
    """mosaic_probe.py:58 ``k_walk_load`` (and ``k_walk_while``, :90)."""
    return _full(_walk(d.reshape(-1).tolist(), k, ROWS * L))


def walk_ldst_plain(k: int, d: torch.Tensor) -> torch.Tensor:
    """mosaic_probe.py:68 ``k_walk_ldst``: a store to a 2048-entry scratch a
    step (and ``k_walk_vst``, :79, the same store into (16, 128))."""
    return _full(_walk(d.reshape(-1).tolist(), k, ROWS * L, store=2048))


def walk_smem_plain(k: int, d: torch.Tensor) -> torch.Tensor:
    """mosaic_probe.py:104 ``k_walk_smem``: the walk over rows 0-15."""
    return _full(_walk(d[:16].reshape(-1).tolist(), k, 16 * L))


def row_read_plain(k: int, d: torch.Tensor) -> torch.Tensor:
    """mosaic_probe.py:118 ``k_row_read``: row ``r`` added each step, r += 7."""
    acc = torch.zeros((L,), dtype=torch.int64)
    r = 0
    for _ in range(k):
        acc = _wrap(acc + d[r].long())
        r = (r + 7) % ROWS
    return _wrap(acc + r).int().expand(OUT_SHAPE).clone()


def row_write_plain(k: int, d: torch.Tensor) -> torch.Tensor:
    """mosaic_probe.py:128 ``k_row_write``: ``scr[r % 64] = d[r] + i``."""
    scr = torch.full((64, L), INT_MIN, dtype=torch.int64)
    r = 0
    for i in range(k):
        scr[r % 64] = _wrap(d[r].long() + i)
        r = (r + 7) % ROWS
    return _wrap(scr[0] + r).int().expand(OUT_SHAPE).clone()


def mm_small_plain(k: int, d: torch.Tensor) -> torch.Tensor:
    """mosaic_probe.py:138 ``k_mm_small``: a bf16 (128,128) @ (128,128)
    product a step with float32 sums, rows 0-7 scaled by 1e-9 and added in
    bf16 to the carry; the output is the carry cast to int32."""
    a = (d[:128] & 1).to(torch.bfloat16)
    b = (d[:128] & 3).to(torch.bfloat16).float()
    acc = torch.zeros(OUT_SHAPE, dtype=torch.bfloat16)
    for _ in range(k):
        c = (a + acc[0, 0]).float() @ b
        acc = acc + (c[:8] * 1e-9).to(torch.bfloat16)
    return acc.to(torch.int32)


def onehot_row_plain(k: int, d: torch.Tensor) -> torch.Tensor:
    """mosaic_probe.py:150 ``k_onehot_row``: the one-hot product picks row
    ``(d[r, 0] & 255) + i) % 256`` of ``d & 255`` for rows r = 0-7."""
    idx = (d[:8, 0] & 255).long()
    limb = (d[:256] & 255).long()
    acc = torch.zeros(OUT_SHAPE, dtype=torch.int64)
    for i in range(k):
        acc = _wrap(acc + limb[(idx + i) % 256])
    return acc.int()


def vpu_dense_plain(k: int, d: torch.Tensor) -> torch.Tensor:
    """mosaic_probe.py:164 ``k_vpu_dense``: ``acc = (acc + x) ^ (acc >> 1)``."""
    x = d[:8].long()
    acc = torch.zeros(OUT_SHAPE, dtype=torch.int64)
    for _ in range(k):
        acc = _wrap(acc + x) ^ (acc >> 1)
    return acc.int()


def roll_static_plain(k: int, d: torch.Tensor) -> torch.Tensor:
    """mosaic_probe.py:173 ``k_roll_static``: ``acc += roll(x + acc[0, 0], 5)``
    along the lanes (``jnp.roll``'s direction: lane c takes lane c - 5)."""
    x = d[:8].long()
    acc = torch.zeros(OUT_SHAPE, dtype=torch.int64)
    for _ in range(k):
        acc = _wrap(acc + torch.roll(_wrap(x + acc[0, 0]), 5, 1))
    return acc.int()


def roll_dyn_plain(k: int, d: torch.Tensor) -> torch.Tensor:
    """mosaic_probe.py:182 ``k_roll_dyn``: ``acc += roll(x, i & 127)``."""
    x = d[:8].long()
    acc = torch.zeros(OUT_SHAPE, dtype=torch.int64)
    for i in range(k):
        acc = _wrap(acc + torch.roll(x, i & 127, 1))
    return acc.int()


# ----------------------------------------------- plain versions, mosaic_probe2.py


def roll_static_min_plain(k: int, d: torch.Tensor) -> torch.Tensor:
    """mosaic_probe2.py:37 ``k_roll_static_min``: ``acc = roll(acc, 5) + x``."""
    x = d[:8].long()
    acc = torch.zeros(OUT_SHAPE, dtype=torch.int64)
    for _ in range(k):
        acc = _wrap(torch.roll(acc, 5, 1) + x)
    return acc.int()


def walk_smem_st_plain(k: int, d: torch.Tensor) -> torch.Tensor:
    """mosaic_probe2.py:46 ``k_walk_smem_st``: the 16-row walk, masked, with
    ``tags[i & 1023] = p`` and ``tags[1024 + (i & 1023)] = acc`` a step."""
    t = d[:16].reshape(-1).tolist()
    p = acc = 0
    tag0 = INT_MIN
    for i in range(k):
        v = t[p]
        if i & 1023 == 0:
            tag0 = p
        p = (p + (v & 63) + 1) & (16 * L - 1)
        acc += v
    return _full(acc + p + tag0)


def walk_smem_big_plain(k: int, d: torch.Tensor) -> torch.Tensor:
    """mosaic_probe2.py:62 ``k_walk_smem_big``: the walk over rows 0-127."""
    return _full(_walk(d[:128].reshape(-1).tolist(), k, 128 * L))


def smem_window_dma_plain(k: int, d: torch.Tensor) -> torch.Tensor:
    """mosaic_probe2.py:76 ``k_smem_window_dma``: the 16-row walk over a
    window that is copied afresh from rows ``base + 16`` (mod 288) at every
    step i with i % 256 == 255; before the first copy it reads the unwritten
    scratch (INT32_MIN)."""
    rows = d.reshape(ROWS, L).tolist()
    win = [INT_MIN] * (16 * L)
    p = acc = base = 0
    for i in range(k):
        if i % 256 == 255:
            base = (base + 16) % (ROWS - 16)
            win = [v for row in rows[base : base + 16] for v in row]
        v = win[p]
        p = (p + (v & 63) + 1) & (16 * L - 1)
        acc += v
    return _full(acc + p)


def row_write_al_plain(k: int, d: torch.Tensor) -> torch.Tensor:
    """mosaic_probe2.py:97 ``k_row_write_al``: aligned 8-row writes
    ``scr[r8:r8 + 8] = d[r8:r8 + 8] + i`` with r8 = (i % 8) * 8."""
    scr = torch.full((64, L), INT_MIN, dtype=torch.int64)
    for i in range(k):
        r8 = (i % 8) * 8
        scr[r8 : r8 + 8] = _wrap(d[r8 : r8 + 8].long() + i)
    return _wrap(scr[:8] + k).int()


def gather_loop_plain(k: int, d: torch.Tensor) -> torch.Tensor:
    """mosaic_probe2.py:108 ``k_gather_loop``: row ``i & 7`` of the carry
    becomes the low 16 bits of ``d[0:256].flat[d[i % 304] & 32767]``."""
    table = (d[:256].reshape(-1) & 0xFFFF).long()
    acc = torch.zeros(OUT_SHAPE, dtype=torch.int64)
    for i in range(k):
        acc[i & 7] = table[(d[i % ROWS] & (256 * L - 1)).long()]
    return _wrap(acc + k).int()


def scatter_loop_plain(k: int, d: torch.Tensor) -> torch.Tensor:
    """mosaic_probe2.py:136 ``k_scatter_loop``: the scatter-sum of
    ``scatter_sum_tile`` read at row 0, which the one-hot products reduce
    to ``h[c] = sum over lanes with pos == c of (val & 255) + ((val >> 8) & 255)``
    with ``pos = d[i % 304] & 32767`` and ``val = d[(i + 1) % 304] & 0x7FFF``."""
    acc = torch.zeros((L,), dtype=torch.int64)
    for i in range(k):
        pos = (d[i % ROWS] & (256 * L - 1)).long()
        val = (d[(i + 1) % ROWS] & 0x7FFF).long()
        hit = pos < L
        h = torch.zeros((L,), dtype=torch.int64)
        h.index_add_(0, pos[hit], ((val & 255) + ((val >> 8) & 255))[hit])
        acc = _wrap(acc + h)
    return _wrap(acc + k).int().expand(OUT_SHAPE).clone()


# ----------------------------------------------- plain versions, mosaic_probe5.py


def walk_plain(chains: int, rows: int, k: int, d: torch.Tensor) -> torch.Tensor:
    """mosaic_probe5.py:54 ``walk_kern``: ``chains`` interleaved walks
    ``p = (p + (v & 0x1FFFF)) % (rows * 128)`` from 0, M/2 (or 0, M/4, M/2,
    3M/4); the output is the sum of every value read."""
    t = d.reshape(-1).tolist()
    m = rows * L
    ps = [c * (m // chains) for c in range(chains)]
    acc = 0
    for _ in range(k):
        for c in range(chains):
            v = t[ps[c]]
            ps[c] = (ps[c] + (v & 0x1FFFF)) % m
            acc += v
    return _full(acc)


def smem_cap_plain(rows: int, kvec: torch.Tensor) -> torch.Tensor:
    """mosaic_probe5.py:39 ``smem_cap``'s kernel: write ``k[0]`` and
    ``k[0] + 1`` at the first and last entries of a (rows, 128) scratch and
    return the last.  The host has no capacity to probe: any rows run."""
    scr = torch.full((rows, L), INT_MIN, dtype=torch.int64)
    scr[0, 0] = int(kvec[0])
    scr[rows - 1, L - 1] = _i32(int(kvec[0]) + 1)
    return scr[rows - 1, L - 1].int().expand(OUT_SHAPE).clone()


# ----------------------------------------------- plain versions, mosaic_probe3.py

N1D, NBIG = 16384, 36864        # mosaic_probe3.py:28-29: walk-table entries
NT = 36864                      # mosaic_probe3b.py:31
SAT = 1 << 23                   # csnappy_tpu/ops/kernel_lib.py:66, the saturating add's ceiling


def _srl(v: int, s: int) -> int:
    """``lax.shift_right_logical`` of an int32 value."""
    return (v & 0xFFFFFFFF) >> s


def _step_walk(t: list, steps: int, adv: int, mask: int, tagn: int) -> int:
    """The walk of mosaic_probe3.py:46 ``k_walk_1d`` for ``steps`` steps:
    ``tags[tc] = p``, ``p = (p + (v & 63) + adv) & mask``,
    ``tc = (tc + (v != 0)) % tagn``; returns ``p + tc + tags[0]``."""
    p = tc = 0
    tag0 = INT_MIN
    for _ in range(steps):
        v = t[p]
        if tc == 0:
            tag0 = p
        p = (p + (v & 63) + adv) & mask
        tc = (tc + (v != 0)) % tagn
    return p + tc + tag0


def walk_1d_plain(k: int, d: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """mosaic_probe3.py:46 ``k_walk_1d``: one load, one tag store a step."""
    return _full(_step_walk(t.tolist(), k, 1, N1D - 1, 2048))


def walk_1d_u4_plain(k: int, d: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """mosaic_probe3.py:60 ``k_walk_1d_u4``: the same walk, 4 steps an iteration."""
    return _full(_step_walk(t.tolist(), 4 * k, 1, N1D - 1, 2048))


def walk_il4_plain(k: int, d: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """mosaic_probe3.py:77 ``k_walk_il4``: four chains from 0, 11, 217 and
    3001, their four tags stored at tc .. tc + 3, tc += 4."""
    t = t.tolist()
    ps = [0, 11, 217, 3001]
    tc, tag0 = 0, INT_MIN
    for _ in range(k):
        if tc == 0:
            tag0 = ps[0]
        ps = [(p + (t[p] & 63) + 1) & (N1D - 1) for p in ps]
        tc = (tc + 4) & 2047
    return _full(sum(ps) + tc + tag0)


def walk_dec_real_plain(k: int, d: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """mosaic_probe3.py:101 ``k_walk_dec_real``: the walk with its error and
    end checks; ``done & 0`` at the end of a step keeps every step live."""
    t = t.tolist()
    p = tc = err = done = 0
    tag0 = INT_MIN
    for _ in range(k):
        v = t[p]
        live = int(done == 0)
        take = int(v != 0 and done == 0)
        if tc == 0:
            tag0 = p
        err |= live - take
        done |= 1 - take
        p = (p + (v & 63) + 1) & (N1D - 1)
        done &= int(p != N1D - 1) | 1
        tc, done = (tc + take) & 2047, done & 0
    return _full(p + tc + err + done + tag0)


def walk_enc_plain(k: int, d: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """mosaic_probe3.py:120 ``k_walk_enc``: ``v > 0`` takes the match arm
    (two tag pairs, ``p = lits = p + ml + 4``), else the skip arm."""
    t = t.tolist()
    p = lits = tc = 0
    tb1, tb2 = INT_MIN, INT_MIN             # tb1[0], tb2[0]
    for _ in range(k):
        v = t[p]
        if v > 0:
            ml = (v >> 15) & 63
            if tc == 0:
                tb1, tb2 = lits | ((p - lits) << 15), 0
            tc2 = (tc + int(lits < p)) & 2047
            if tc2 == 0:
                tb1, tb2 = p | (ml << 15), v & 0x7FFF
            p = lits = p + ml + 4
            tc = (tc2 + 1) & 2047
        else:
            p = p + (v & 31) + 1
        p, lits = p & (N1D - 1), lits & (N1D - 1)
    return _full(p + lits + tc + _i32(tb1) + tb2)


def walk_enc_nobr_plain(k: int, d: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """mosaic_probe3.py:150 ``k_walk_enc_nobr``: both tag slots stored every step."""
    t = t.tolist()
    p = lits = tc = 0
    tb1, tb2 = INT_MIN, INT_MIN
    for _ in range(k):
        v = t[p]
        m = int(v > 0)
        ml = ((v >> 15) & 63) + 4
        if tc == 0:
            tb1, tb2 = lits | ((p - lits) << 15), 0
        tc2 = (tc + (m & int(lits < p))) & 2047
        if tc2 == 0:
            tb1, tb2 = p | (ml << 15), v & 0x7FFF
        tc = (tc2 + m) & 2047
        p2 = (p + (ml if m else (v & 31) + 1)) & (N1D - 1)
        lits = (p2 if m else lits) & (N1D - 1)
        p = p2
    return _full(p + lits + tc + _i32(tb1) + tb2)


def _scal_steps(t: list, steps: int) -> int:
    """mosaic_probe3.py:196 ``_scal_chunk`` for ``steps`` steps (256 an
    iteration), tc advancing every step; ``p + tc + tags[0]``."""
    p = tc = 0
    tag0 = INT_MIN
    for _ in range(steps):
        if tc == 0:
            tag0 = p
        p = (p + (t[p] & 63) + 1) & (N1D - 1)
        tc = (tc + 1) & 2047
    return p + tc + tag0


def scal_only_plain(k: int, d: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """mosaic_probe3.py:206 ``k_scal_only``: 256 walk steps an iteration."""
    return _full(_scal_steps(t.tolist(), 256 * k))


def _sat_int32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float -> int32 convert: toward zero, saturating, NaN to 0
    (``.to(torch.int32)`` gives INT32_MIN for NaN and overflow on x86)."""
    x = x.double()
    return torch.where(torch.isnan(x), 0.0, x).clamp(INT_MIN, -INT_MIN - 1).trunc().long()


def _vec_acc(k: int, d: torch.Tensor) -> torch.Tensor:
    """The carry of mosaic_probe3.py:175 ``_vec_chunk`` after k chunks: 8
    dependent bf16 (8, 128) @ (128, 128) products a chunk, float32 sums
    rounded to bf16 (to nearest even; past the bf16 range to inf, then inf
    x 0 gives NaN, which stays)."""
    m = (d[:128] & 1).float()
    x = (d[:8] & 1).to(torch.bfloat16)
    for _ in range(8 * k):
        if torch.isnan(x).all():
            break
        xf = x.float()
        # the exact sums are order-free; a non-finite operand goes elementwise,
        # so inf x 0 is NaN whatever the matrix library skips
        y = xf @ m if torch.isfinite(xf).all() else (xf[:, :, None] * m).sum(1)
        x = y.to(torch.bfloat16)
    return x


def vec_only_plain(k: int, d: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """mosaic_probe3.py:187 ``k_vec_only``: the carry cast to int32."""
    return _sat_int32(_vec_acc(k, d)).int()


def vec_scal_plain(k: int, d: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """mosaic_probe3.py:214 ``k_vec_scal``: the vector chunk and the 256-step
    walk an iteration, independent; ``int32(acc) + p + tc + tags[0]``."""
    return _wrap(_sat_int32(_vec_acc(k, d)) + _scal_steps(t.tolist(), 256 * k)).int()


def dot_plain(k: int, d: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """mosaic_probe3.py:229 ``k_dot_s8`` and :245 ``k_dot_bf16_256``:
    ``acc += (b^T a)[0:8] + i`` with a = d[0:256] & 1, b = d[0:256] & 0x7F,
    in int8 (int32 sums) or bf16 (float32 sums of at most 256 x 127, exact):
    the product is the same every iteration, so it is computed once."""
    a = (d[:256] & 1).long()
    b = (d[:256] & 0x7F).long()
    y8 = b[:, :8].T @ a
    return _wrap(k * y8 + k * (k - 1) // 2).int()


def gather_plain(nrows: int, bits: int, k: int, d: torch.Tensor, t=None) -> torch.Tensor:
    """mosaic_probe3.py:260 ``_wide_gather`` (and mosaic_probe3b.py:146,
    mosaic_probe3c.py:65 ``_wide_gather_v2``): E indices
    ``(d.flat[:E] + i) & (nrows * 128 - 1)`` pick ``d.flat[idx]`` through
    one-hot products, limb by limb, keeping its low ``bits`` bits (8 or 7 a
    limb); the first 128 picks are added to every row of the carry.  Only
    those 128 reach the output, so only they are gathered here."""
    flat = d.reshape(-1).long()
    idx = (flat[:L][None, :] + torch.arange(k)[:, None]) & (nrows * L - 1)
    acc = (flat[idx] & ((1 << bits) - 1)).sum(0)
    return _wrap(acc).int().expand(OUT_SHAPE).clone()


def scatter_plain(k: int, d: torch.Tensor, t=None) -> torch.Tensor:
    """mosaic_probe3b.py:188 ``_mk_scatter(256, 2048, limbs)``: each
    iteration the histogram ``h[pos] += val`` over a (256, 128) table, with
    ``pos = (d.flat[:2048] + i) & 32767`` and ``val = d.flat[:2048] & 0x7FFF``
    (the limbs recombine to val), rows 0-7 added to the carry."""
    flat = d.reshape(-1)[:2048].long()
    pos = (flat[None, :] + torch.arange(k)[:, None]) & 32767
    hit = pos < 8 * L
    h = torch.zeros(8 * L, dtype=torch.int64).index_add_(
        0, pos[hit], (flat & 0x7FFF).expand(k, -1)[hit])
    return _wrap(h).int().reshape(OUT_SHAPE)


def scan_plain(sat: bool, k: int, d: torch.Tensor, t=None) -> torch.Tensor:
    """mosaic_probe3.py:301 ``k_scan_tril`` (``sat`` False) and :337
    ``k_scan_mm_cur`` (True): ``acc += y[0:8]``, y the row-major inclusive
    add-scan of ``(d[0:256] & 0x1FFFF) + (i & 1)``.  ``scan_tril`` carries the
    row totals in three 8-bit limbs (so mod 2^24) and wraps at 32 bits;
    ``scan2d_mm(op="addsat", bits=24)`` saturates every sum at 2^23.  Rows
    0-7 depend on rows 0-7 only, and y on i only through i & 1."""
    x = (d[:8] & 0x1FFFF).long()

    def y(inc: int) -> torch.Tensor:
        xa = x + inc
        if sat:
            return xa.reshape(-1).cumsum(0).clamp(max=SAT).reshape(OUT_SHAPE)
        s = xa.cumsum(1)
        tot = s[:, -1] & 0xFFFFFF
        return s + (tot.cumsum(0) - tot)[:, None]

    odd = k // 2
    return _wrap((k - odd) * y(0) + odd * y(1)).int()


def taa_plain(nrows: int, ncols: int, axis: int, k: int, d: torch.Tensor) -> torch.Tensor:
    """mosaic_probe3c.py:40 ``_mk_taa``: every element of an (nrows, ncols)
    carry is its own chain ``acc = (base[gathered] + 1) % lim`` with
    ``idx = (acc + i) % lim`` taken along ``axis`` (lim the axis' length),
    from ``(row + col) % lim``; base is d[0:nrows], or ``d[r, 0] + c`` at
    2048 columns.  Only the chains of rows 0-7, columns 0-127 reach the
    output, and no chain reads another, so only they run here."""
    lim = nrows if axis == 0 else ncols
    r = torch.arange(8)[:, None]
    c = torch.arange(L)[None, :]
    acc = (r + c) % lim
    base = d[:nrows].long()
    for i in range(k):
        idx = (acc + i) % lim
        if ncols != L:
            y = base[idx, 0] + c
        else:
            y = base[idx, c] if axis == 0 else base[r, idx]
        acc = (y + 1) % lim
    return acc.int()


def inrow_round_plain(k: int, d: torch.Tensor) -> torch.Tensor:
    """mosaic_probe3c.py:94 ``k_inrow_round``: a synchronous pointer-jumping
    round ``par[r, c] <- par[r, par[r, c] & 127]`` where ``par[r, c] >> 7 == r``,
    then ``^ (i & 1)``; par = d[0:256] & 32767.  A row reads only itself,
    so rows 0-7 run alone here."""
    par = (d[:8] & 32767).long()
    row = torch.arange(8)[:, None]
    for i in range(k):
        par = torch.where((par >> 7) == row, par.gather(1, par & 127), par) ^ (i & 1)
    return par.int()


# ---------------------------------------------- plain versions, mosaic_probe3b.py


def walk_u8_plain(k: int, d: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """mosaic_probe3b.py:52 ``k_walk_u8``: 8 steps an iteration, 2-D tag
    stores, ``p = (p + (v & 63) + 2) & 36863`` (a mask, not a modulus)."""
    return _full(_step_walk(t.tolist(), 8 * k, 2, NT - 1, 8192))


def _pair_steps(t: list, p: int, tc: int, tag0: int, steps: int) -> tuple[int, int, int]:
    """``steps`` pair-table steps of mosaic_probe3b.py:69 and :91: tags p and
    ``p + a`` (a = bits 17-21 of v) at tc and tc + 1, tc advancing by 1 or 2."""
    for _ in range(steps):
        v = t[p]
        if tc == 0:
            tag0 = p
        tc = (tc + 1 + (_srl(v, 17) & 31 != 0)) & 8191
        p = (p + (v & 63) + 2) & (NT - 1)
    return p, tc, tag0


def walk_pair_u4_plain(k: int, d: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """mosaic_probe3b.py:69 ``k_walk_pair_u4``: one load, two tags, 4 steps
    an iteration."""
    p, tc, tag0 = _pair_steps(t.tolist(), 0, 0, INT_MIN, 4 * k)
    return _full(p + tc + tag0)


def walk_dec_full_plain(k: int, d: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """mosaic_probe3b.py:91 ``k_walk_dec_full``: rounds of 128 pair steps
    while the last round moved p and fewer than k rounds ran."""
    t = t.tolist()
    p, tc, tag0 = 0, 0, INT_MIN
    for _ in range(k):
        p0 = p
        p, tc, tag0 = _pair_steps(t, p, tc, tag0, 128)
        if p == p0:
            break
    return _full(p + tc + tag0)


def walk_enc_real_plain(k: int, d: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """mosaic_probe3b.py:121 ``k_walk_enc_real``: the branch-free encoder
    walk, 4 steps an iteration, two 2-D tag stores a step."""
    t = t.tolist()
    p = lits = tc = 0
    tag0 = INT_MIN
    for _ in range(4 * k):
        v = t[p]
        m = int(v > 0)
        ml = (_srl(v, 15) & 63) + 4
        if tc == 0:
            tag0 = lits | ((p - lits) << 15)
        t2 = tc + (m & int(lits < p))
        if t2 == 0:
            tag0 = p | (ml << 15) | (v & 0x7FFF)
        tc = (t2 + m) & 8191
        p = (p + (ml if m else (v & 31) + 2)) & (NT - 1)
        lits = p if m else lits
    return _full(p + lits + tc + _i32(tag0))


def big_smem_plain(k: int, d: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """mosaic_probe3.py:352 ``k_big_smem``: the walk over 36,864 entries
    ``% 36864`` with a 17,408-entry tag buffer ``% 17408``; the output adds
    ``tags[0]`` and ``tags[17407]``."""
    t = t.tolist()
    p = tc = 0
    tag0 = tag_last = INT_MIN
    for _ in range(k):
        if tc == 0:
            tag0 = p
        elif tc == 17407:
            tag_last = p
        p = (p + (t[p] & 63) + 1) % NBIG
        tc = (tc + 1) % 17408
    return _full(p + tc + tag0 + tag_last)


# --------------------------------------- plain versions, mosaic_probe4.py and mosaic_probe6.py

R4 = 400                        # mosaic_probe4.py RMAX: input rows
R6, RG6 = 424, 32               # mosaic_probe6.py R, RG: table and index rows
MASK6 = R6 * L - 1              # 0xD3FF: an AND mask, not a modulus


def gather4_plain(rows: int, limbs: int, k: int, d: torch.Tensor) -> torch.Tensor:
    """mosaic_probe4.py:64 ``gather_kern``: T = d[0:rows] & (2^(8 limbs) - 1),
    idx = d[0:32] % (rows * 128); each iteration g = T.flat[idx], then
    ``idx = (g + acc + i) % (rows * 128)`` with the old acc (int32 sums,
    jnp's floor modulus), then acc += g[0, 0].  Element (0, 0)'s index
    depends only on itself and acc, so its chain alone reaches the output."""
    m = rows * L
    t = (d[:rows].reshape(-1) & ((1 << 8 * limbs) - 1)).tolist()
    ix, acc = int(d[0, 0]) % m, 0
    for i in range(k):
        g = t[min(max(ix, 0), m - 1)]
        ix = _i32(g + acc + i) % m
        acc = _i32(acc + g)
    return _full(acc)


def lane_gather4_plain(k: int, d: torch.Tensor) -> torch.Tensor:
    """mosaic_probe4.py:79 ``lane_gather_kern``: x = d[0:32] % 128;
    ``g[r, c] = x[r, x[r, c] & 127]``, ``x = (g + i) % 128``, acc += g[0, 0].
    Row 0 reads only itself, so it runs alone here."""
    x = d[0].long() % L
    acc = 0
    for i in range(k):
        g = x[x & (L - 1)]
        x = (g + i) % L
        acc = _i32(acc + int(g[0]))
    return _full(acc)


def conv4_plain(check: bool, k: int, d: torch.Tensor) -> torch.Tensor:
    """mosaic_probe4.py:92 ``while_conv_kern``: x = d[0:32] % 4096; each
    iteration 4 pointer-jumping rounds ``x = (x & 0xFFFF).flat[clip(x)] %
    4096``, every element reading the old x; with ``check`` the rounds stop
    after the first that changed nothing; acc += x[0, 0]."""
    x = d[:32].reshape(-1).long() % (32 * L)
    acc = 0
    for _ in range(k):
        rounds, changed = 0, 1
        while rounds < 4 and (changed or not check):
            g = (x & 0xFFFF)[x.clamp(0, 32 * L - 1)]
            changed = int((g != x).sum())
            x = g % (32 * L)
            rounds += 1
        acc = _i32(acc + int(x[0]))
    return _full(acc)


def dynslice4_plain(k: int, d: torch.Tensor) -> torch.Tensor:
    """mosaic_probe4.py:118 ``dynslice_kern``: base = ((acc + i) % 40) * 8,
    ``acc = (acc + d[base, 0]) % 251`` (the 32-row window's [0, 0])."""
    col = d[:, 0].tolist()
    acc = 0
    for i in range(k):
        acc = _i32(acc + col[(_i32(acc + i) % 40) * 8]) % 251
    return _full(acc)


def gather6_plain(k: int, d: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """mosaic_probe6.py:55 ``mk_base`` (and ``mk_el``, :96, the same
    function): acc += (d.flat[(idx + i) & 0xD3FF] & 0xFF) each iteration;
    the output is acc[0:8], so only idx[0:8] is gathered here."""
    t = (d.reshape(-1) & 0xFF).long()
    ix = idx[:8].reshape(-1).long()
    acc = torch.zeros(8 * L, dtype=torch.int64)
    for i0 in range(0, k, 512):
        i = torch.arange(i0, min(k, i0 + 512))
        acc += t[(ix[None, :] + i[:, None]) & MASK6].sum(0)
    return _wrap(acc).int().reshape(OUT_SHAPE)


# -------------------------------------------------------------------- the table


class Probe(NamedTuple):
    plain: Callable[..., torch.Tensor]    # (k, d), or (k, d, table) where table
    entry: str                  # the CUDA entry of csrc/<lib>.cu
    site: str                   # the TPU kernel's function, file:line
    call: str                   # its pl.pallas_call site, file:line
    k_lo: int
    k_hi: int
    steps: int                  # dependent steps counted per iteration (walk chains)
    space: str                  # where the probe's table or scratch lives on the card
    rows: int                   # input rows: (rows, 128) int32; 0 for smem_cap's k vector
    reads: int                  # int32 elements of input and walk table a run to k_hi reads (bound)
    ops: int                    # operations per iteration (bound)
    tensor: str = ""            # "bf16" or "int8": ops are tensor-core operations of that type
    table: int = 0              # entries of the 1-D int32 walk table beside the input; 0: none
    lib: str = "probe"          # the CUDA source csrc/<lib>.cu, entry <lib>_<entry>_launch
    index: int = 0              # rows of the (rows, 128) int32 index beside the input; 0: none
    fails: str = ""             # the JAX probe's trace-time error: no kernel, no plain version


P1, P2, P5 = "tools/mosaic_probe.py", "tools/mosaic_probe2.py", "tools/mosaic_probe5.py"
C1, C2, C5C, C5W = f"{P1}:45", f"{P2}:24", f"{P5}:39", f"{P5}:102"


def _walks() -> dict[str, Probe]:
    out = {}
    for chains, rows in ((1, 144), (2, 144), (2, 288), (4, 144), (4, 576)):
        space = "shared" if rows * L * 4 <= 232448 else "global"
        out[f"mosaic_probe5.walk_c{chains}_r{rows}"] = Probe(
            functools.partial(walk_plain, chains, rows), "walk", f"{P5}:54", C5W,
            8192, 131072, chains, space, rows, rows * L, 4 * chains)
    return out


P3, P3B, P3C = "tools/mosaic_probe3.py", "tools/mosaic_probe3b.py", "tools/mosaic_probe3c.py"
C3, C3B, C3C = f"{P3}:32", f"{P3B}:35", f"{P3C}:27"
VEC_OPS = 8 * 2 * 8 * L * L     # 8 bf16 (8, 128) @ (128, 128) products an iteration
DOT_OPS = 2 * L * L * 256       # one (128, 256) @ (256, 128) product an iteration
P = functools.partial


def _probe3() -> dict[str, Probe]:
    """The probes of mosaic_probe3.py, mosaic_probe3b.py and mosaic_probe3c.py
    (kernels of ``csrc/probe3.cu``): (probe, plain, site line, k_lo, k_hi,
    steps, ops, tensor type, int32 elements read, walk-table entries taken).
    A walk reads its table only; the others read the input rows they use
    and no table.  A factory-made probe's site is its factory's ``def``."""
    G = P(P, gather_plain)                       # G(rows, value bits)
    rows = {C3: [
        ("walk_1d", walk_1d_plain, 46, 8192, 65536, 1, 8, "", N1D, N1D),
        ("walk_1d_u4", walk_1d_u4_plain, 60, 2048, 16384, 4, 32, "", N1D, N1D),
        ("walk_il4", walk_il4_plain, 77, 2048, 16384, 4, 28, "", N1D, N1D),
        ("walk_dec_real", walk_dec_real_plain, 101, 8192, 65536, 1, 14, "", N1D, N1D),
        ("walk_enc", walk_enc_plain, 120, 8192, 65536, 1, 14, "", N1D, N1D),
        ("walk_enc_nobr", walk_enc_nobr_plain, 150, 8192, 65536, 1, 18, "", N1D, N1D),
        ("vec_only", vec_only_plain, 187, 256, 2048, 1, VEC_OPS, "bf16", L * L, N1D),
        ("scal_only", scal_only_plain, 206, 256, 2048, 256, 256 * 6, "", N1D, N1D),
        ("vec_scal", vec_scal_plain, 214, 256, 2048, 256, VEC_OPS, "bf16", L * L + N1D, N1D),
        ("dot_s8", dot_plain, 229, 4096, 32768, 1, DOT_OPS, "int8", 256 * L, N1D),
        ("dot_bf16_256", dot_plain, 245, 4096, 32768, 1, DOT_OPS, "bf16", 256 * L, N1D),
        ("gather_r136_e2048_l2", G(136, 16), 289, 512, 4096, 1, 2048, "", 136 * L, N1D),
        ("gather_r272_e2048_l2", G(272, 16), 289, 512, 4096, 1, 2048, "", 272 * L, N1D),
        ("gather_r64_e2048_l2", G(64, 16), 289, 512, 4096, 1, 2048, "", 64 * L, N1D),
        ("gather_r272_e2048_l4", G(272, 32), 289, 512, 4096, 1, 2048, "", 272 * L, N1D),
        ("gather_s8_r272_e2048_l2", G(272, 14), 289, 512, 4096, 1, 2048, "", 272 * L, N1D),
        ("gather_s8_r272_e2048_l3", G(272, 21), 289, 512, 4096, 1, 2048, "", 272 * L, N1D),
        ("scan_tril", P(scan_plain, False), 301, 512, 4096, 1, 2 * 256 * L, "", 256 * L, N1D),
        ("scan_mm_cur", P(scan_plain, True), 337, 512, 4096, 1, 2 * 256 * L, "", 256 * L, N1D),
        ("big_smem", big_smem_plain, 352, 8192, 65536, 1, 8, "", NBIG, NBIG),
    ], C3B: [
        ("walk_u8", walk_u8_plain, 52, 1024, 8192, 8, 8 * 7, "", NT, NT),
        ("walk_pair_u4", walk_pair_u4_plain, 69, 1024, 8192, 4, 4 * 11, "", NT, NT),
        ("walk_dec_full", walk_dec_full_plain, 91, 64, 512, 128, 128 * 11, "", NT, NT),
        ("walk_enc_real", walk_enc_real_plain, 121, 1024, 8192, 4, 4 * 18, "", NT, NT),
        ("gather_r256_e8192_l2", G(256, 16), 176, 256, 1024, 1, 8192, "", 256 * L, NT),
        ("gather_r256_e8192_l1", G(256, 8), 176, 256, 1024, 1, 8192, "", 256 * L, NT),
        ("gather_r256_e4096_l2", G(256, 16), 176, 256, 2048, 1, 4096, "", 256 * L, NT),
        ("gather_r136_e8192_l2", G(136, 16), 176, 256, 1024, 1, 8192, "", 136 * L, NT),
        ("gather_s8_r256_e8192_l3", G(256, 21), 176, 256, 1024, 1, 8192, "", 256 * L, NT),
        ("scatter_oc256_e2048_l2", scatter_plain, 188, 256, 1024, 1, 2048, "", 2048, NT),
        ("scatter_oc256_e2048_l4", scatter_plain, 188, 256, 1024, 1, 2048, "", 2048, NT),
    ], C3C: [
        ("taa_ax0_256x128", P(taa_plain, 256, L, 0), 40, 4096, 32768, 1, 4 * 256 * L, "",
         256 * L, 0),
        ("taa_ax1_256x128", P(taa_plain, 256, L, 1), 40, 4096, 32768, 1, 4 * 256 * L, "",
         256 * L, 0),
        ("taa_ax0_128x2048", P(taa_plain, L, 2048, 0), 40, 2048, 16384, 1, 4 * L * 2048, "", L, 0),
        ("gv2_r256_e2048_l2", G(256, 16), 82, 1024, 8192, 1, 2048, "", 256 * L, 0),
        ("gv2_r256_e4096_l2", G(256, 16), 82, 512, 4096, 1, 4096, "", 256 * L, 0),
        ("gv2_r136_e2048_l2", G(136, 16), 82, 1024, 8192, 1, 2048, "", 136 * L, 0),
        ("gv2_r256_e2048_l1", G(256, 8), 82, 1024, 8192, 1, 2048, "", 256 * L, 0),
        ("inrow_round", inrow_round_plain, 94, 2048, 16384, 1, 6 * 256 * L, "", 256 * L, 0),
    ]}
    out = {}
    for call, entries in rows.items():
        path = call.split(":")[0]
        module = path.split("/")[1][:-3]
        for short, plain, line, k_lo, k_hi, steps, ops, tensor, reads, table in entries:
            out[f"{module}.{short}"] = Probe(plain, short, f"{path}:{line}", call, k_lo, k_hi,
                                             steps, "shared", ROWS, reads, ops, tensor, table,
                                             "probe3")
    return out


P4, P6 = "tools/mosaic_probe4.py", "tools/mosaic_probe6.py"
C4, C6 = f"{P4}:37", f"{P6}:37"
TAA6_ERROR = "Incompatible shapes for broadcasting: (8, 128) and requested shape (4096, 128)"
# A K past the int32 wrap of acc in every 16-bit gather_r*_l2 probe on the constructed
# (400, 128) input in [0, 2^16) (case_p4rand of probes.npz): the first wrap comes at
# 56,213-77,894 iterations, and from there a truncating % would give negative indices.
WRAP_K = 100_000


def _probe4() -> dict[str, Probe]:
    """The probes of mosaic_probe4.py (named by the labels of its ``main()``,
    :128-139) and mosaic_probe6.py (its ``PROBES``, :155), kernels of
    ``csrc/probe4.cu``.  A gather reads its table and 32 x 128 indices;
    ``dynslice_32`` the rows its windows cover on the tool's data by k_hi
    (12 bases of the 40, 200 rows)."""
    e = RG6 * L                                  # 4,096 gathered values an iteration
    out = {"mosaic_probe4.lane_gather_32x128": Probe(
        lane_gather4_plain, "lane_gather_32x128", f"{P4}:79", C4, 1024, 8192, 1, "shared", R4,
        e, e, lib="probe4")}
    for rows in (32, 64, 128, 160, 288, 400):
        for limbs in (1, 2):
            short = f"gather_r{rows}_l{limbs}"
            out[f"mosaic_probe4.{short}"] = Probe(
                P(gather4_plain, rows, limbs), short, f"{P4}:64", C4, 1024, 8192, 1, "shared", R4,
                rows * L + e, e, lib="probe4")
    for short, check in (("conv_unrolled", False), ("conv_check", True)):
        out[f"mosaic_probe4.{short}"] = Probe(
            P(conv4_plain, check), short, f"{P4}:92", C4, 512, 4096, 4, "shared", R4, e, 4 * e,
            lib="probe4")
    out["mosaic_probe4.dynslice_32"] = Probe(dynslice4_plain, "dynslice_32", f"{P4}:118", C4, 1024,
                                             8192, 1, "shared", R4, 200 * L, e, lib="probe4")
    for short, line in (("base", 55), ("base_i16", 55), ("el_orient", 96), ("el_i16", 96)):
        out[f"mosaic_probe6.{short}"] = Probe(               # one function: one entry
            gather6_plain, "flat_gather", f"{P6}:{line}", C6, 128, 1024, 1, "shared", R6,
            R6 * L + e, e, lib="probe4", index=RG6)
    out["mosaic_probe6.taa_4096x128"] = Probe(None, "", f"{P6}:136", C6, 512, 4096, 1, "", R6, 0,
                                              0, lib="probe4", index=RG6, fails=TAA6_ERROR)
    return out


PROBES: dict[str, Probe] = {
    "mosaic_probe.walk_load": Probe(walk_load_plain, "walk_load", f"{P1}:58", C1,
                                    1024, 4096, 1, "global", ROWS, ROWS * L, 4),
    "mosaic_probe.walk_ldst": Probe(walk_ldst_plain, "walk_ldst", f"{P1}:68", C1,
                                    1024, 4096, 1, "global", ROWS, ROWS * L, 5),
    "mosaic_probe.walk_vst": Probe(walk_ldst_plain, "walk_vst", f"{P1}:79", C1,
                                   1024, 4096, 1, "global", ROWS, ROWS * L, 5),
    "mosaic_probe.walk_while": Probe(walk_load_plain, "walk_while", f"{P1}:90", C1,
                                     1024, 4096, 1, "global", ROWS, ROWS * L, 4),
    "mosaic_probe.walk_smem": Probe(walk_smem_plain, "walk_smem", f"{P1}:104", C1,
                                    1024, 4096, 1, "shared", ROWS, 16 * L, 4),
    "mosaic_probe.row_read": Probe(row_read_plain, "row_read", f"{P1}:118", C1,
                                   1024, 4096, 1, "global", ROWS, ROWS * L, L),
    "mosaic_probe.row_write": Probe(row_write_plain, "row_write", f"{P1}:128", C1,
                                    1024, 4096, 1, "shared", ROWS, ROWS * L, L),
    "mosaic_probe.mm_small": Probe(mm_small_plain, "mm_small", f"{P1}:138", C1,
                                   1024, 4096, 1, "shared", ROWS, L * L, 2 * L * L * L, "bf16"),
    "mosaic_probe.onehot_row": Probe(onehot_row_plain, "onehot_row", f"{P1}:150", C1,
                                     1024, 4096, 1, "global", ROWS, 256 * L, 2 * 8 * L),
    "mosaic_probe.vpu_dense": Probe(vpu_dense_plain, "vpu_dense", f"{P1}:164", C1,
                                    1024, 4096, 1, "registers", ROWS, 8 * L, 3 * 8 * L),
    "mosaic_probe.roll_static": Probe(roll_static_plain, "roll_static", f"{P1}:173", C1,
                                      1024, 4096, 1, "shared", ROWS, 8 * L, 2 * 8 * L),
    "mosaic_probe.roll_dyn": Probe(roll_dyn_plain, "roll_dyn", f"{P1}:182", C1,
                                   1024, 4096, 1, "shared", ROWS, 8 * L, 8 * L),
    "mosaic_probe2.roll_static_min": Probe(roll_static_min_plain, "roll_static_min",
                                           f"{P2}:37", C2, 1024, 8192, 1, "shared", ROWS,
                                           8 * L, 8 * L),
    "mosaic_probe2.walk_smem_st": Probe(walk_smem_st_plain, "walk_smem_st", f"{P2}:46", C2,
                                        2048, 16384, 1, "shared", ROWS, 16 * L, 6),
    "mosaic_probe2.walk_smem_big": Probe(walk_smem_big_plain, "walk_smem_big", f"{P2}:62", C2,
                                         2048, 16384, 1, "shared", ROWS, 128 * L, 4),
    "mosaic_probe2.smem_window_dma": Probe(smem_window_dma_plain, "smem_window_dma",
                                           f"{P2}:76", C2, 2048, 16384, 1, "shared", ROWS,
                                           288 * L, 4),   # windows of rows 0-287 by k_hi
    "mosaic_probe2.row_write_al": Probe(row_write_al_plain, "row_write_al", f"{P2}:97", C2,
                                        1024, 8192, 1, "shared", ROWS, 64 * L, 8 * L),
    "mosaic_probe2.gather_loop": Probe(gather_loop_plain, "gather_loop", f"{P2}:108", C2,
                                       256, 2048, 1, "shared", ROWS, ROWS * L, 3 * L),
    "mosaic_probe2.scatter_loop": Probe(scatter_loop_plain, "scatter_loop", f"{P2}:136", C2,
                                        256, 2048, 1, "shared", ROWS, ROWS * L, 6 * L),
    "mosaic_probe5.smem_cap": Probe(smem_cap_plain, "smem_cap", f"{P5}:32", C5C,
                                    256, 256, 0, "shared", 0, 4, 2),
    **_walks(),
    **_probe3(),
    **_probe4(),
}
SITES = {C1: "mosaic_probe", C2: "mosaic_probe2", C5C: "mosaic_probe5.smem_cap",
         C5W: "mosaic_probe5.time_walk", C3: "mosaic_probe3", C3B: "mosaic_probe3b",
         C3C: "mosaic_probe3c", C4: "mosaic_probe4", C6: "mosaic_probe6"}
# the probes timed by the slope in K: all but the capacity probe and those without a kernel
TIMED = tuple(n for n, p in PROBES.items() if p.entry not in ("smem_cap", ""))


def resolve(name: str) -> str:
    """A probe's full name from its full name or the part after the dot."""
    if name in PROBES:
        return name
    hits = [n for n in PROBES if n.split(".", 1)[1] == name]
    if len(hits) != 1:
        raise KeyError(f"unknown probe {name!r}; probes: {', '.join(PROBES)}")
    return hits[0]


def inputs(name: str, seed: int = 0) -> np.ndarray:
    """A probe's input as the JAX ``main()``s make it: (304, 128) int32 in
    [0, 2^20) (mosaic_probe.py:224, mosaic_probe3.py:422,
    mosaic_probe3b.py:247), in [0, 2^15) for mosaic_probe3c.py (:142);
    (rows, 128) in [2, 9) for a walk of mosaic_probe5.py (:117-118); the k
    vector ``ones(4)`` for smem_cap; ``arange(400 * 128) % 251`` as (400,
    128) for mosaic_probe4.py (:55; no seed); the (424, 128) table in
    [0, 256) for mosaic_probe6.py (:195-196)."""
    name = resolve(name)
    pr = PROBES[name]
    rng = np.random.default_rng(seed)
    if pr.entry == "smem_cap":
        return np.ones((4,), np.int32)
    if pr.entry == "walk":
        return rng.integers(2, 9, size=(pr.rows, L)).astype(np.int32)
    if name.startswith("mosaic_probe4."):
        return np.arange(R4 * L, dtype=np.int32).reshape(R4, L) % 251
    if name.startswith("mosaic_probe6."):
        return rng.integers(0, 256, (R6, L), dtype=np.int32)
    return rng.integers(0, 2**15 if name.startswith("mosaic_probe3c.") else 2**20, (ROWS, L),
                        dtype=np.int32)


def second_input(name: str, seed: int = 0) -> np.ndarray | None:
    """A probe's second input as its JAX ``main()`` draws it after the
    first, or None: the 1-D walk table of mosaic_probe3.py (:423-426 draws
    16,384 and then 36,864 entries in [1, 2^20); CPython iterates the set
    {16384, 36864} in that order) and mosaic_probe3b.py (:248, 36,864 in
    [1, 2^22)), or mosaic_probe6.py's (32, 128) index in [0, 424 * 128)
    (:197)."""
    name = resolve(name)
    pr = PROBES[name]
    rng = np.random.default_rng(seed)
    if pr.index:
        rng.integers(0, 256, (R6, L), dtype=np.int32)
        return rng.integers(0, R6 * L, (pr.index, L), dtype=np.int32)
    if not pr.table:
        return None
    rng.integers(0, 2**20, (ROWS, L), dtype=np.int32)
    if name.startswith("mosaic_probe3b."):
        return rng.integers(1, 2**22, (NT,), dtype=np.int32)
    t = rng.integers(1, 2**20, (N1D,), dtype=np.int32)
    return t if pr.table == N1D else rng.integers(1, 2**20, (NBIG,), dtype=np.int32)


# --------------------------------------------------------------------- the card


@functools.cache
def _kernel(entry: str, lib: str = "probe"):
    launch, check = _build.kernel(lib, entry)
    vp, i = ctypes.c_void_p, ctypes.c_int
    if lib in ("probe3", "probe4"):
        launch.argtypes = [vp, vp, i, vp, vp, vp]
    else:
        launch.argtypes = {"walk": [vp, i, i, i, vp, vp, vp], "smem_cap": [vp, ctypes.c_longlong, vp, vp]
                           }.get(entry, [vp, i, vp, vp, vp])
    return launch, check


def _as_input(name: str, data, dev: torch.device) -> torch.Tensor:
    pr = PROBES[name]
    t = data if isinstance(data, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(data))
    want = (4,) if pr.entry == "smem_cap" else (pr.rows, L)
    if t.dtype != torch.int32 or tuple(t.shape) != want:
        raise ValueError(f"{name}: input must be int32 {want}, got {t.dtype} {tuple(t.shape)}")
    return t.to(dev).contiguous()


def _as_second(name: str, second, dev: torch.device) -> torch.Tensor | None:
    pr = PROBES[name]
    what, want = ("walk table", (pr.table,)) if pr.table else ("index", (pr.index, L))
    if not pr.table and not pr.index:
        if second is not None:
            raise ValueError(f"{name} takes no walk table or index")
        return None
    if second is None:
        raise ValueError(f"{name} needs its {what}: int32 {want}, see second_input()")
    t = (second if isinstance(second, torch.Tensor)
         else torch.from_numpy(np.ascontiguousarray(second)))
    if t.dtype != torch.int32 or tuple(t.shape) != want:
        raise ValueError(f"{name}: the {what} must be int32 {want}, got {t.dtype} "
                         f"{tuple(t.shape)}")
    return t.to(dev).contiguous()


def _plain(name: str, k: int, d: torch.Tensor, t: torch.Tensor | None) -> torch.Tensor:
    pr = PROBES[name]
    return pr.plain(k, d) if t is None else pr.plain(k, d, t)


def _traces(name: str) -> None:
    """Raise what the JAX probe raises when it fails to trace."""
    if PROBES[name].fails:
        raise ValueError(f"{name}: {PROBES[name].fails} (the JAX kernel fails to trace; "
                         "there is no TPU kernel to port)")


def _launch(name: str, k: int, d: torch.Tensor,
            t: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``name``'s kernel at K = ``k`` on card tensor ``d`` (and second
    input ``t``); returns the (8, 128) output and the loop's ``clock64()``
    cycles, and counts the launch."""
    pr = PROBES[name]
    if d.data_ptr() % 16:
        raise ValueError(f"{name}: the input must be 16-byte aligned")
    dev = d.device
    out = torch.empty(OUT_SHAPE, dtype=torch.int32, device=dev)
    cycles = torch.zeros((1,), dtype=torch.int64, device=dev)
    launch, check = _kernel(pr.entry, pr.lib)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if pr.lib in ("probe3", "probe4"):
            check(launch(d.data_ptr(), None if t is None else t.data_ptr(), k, out.data_ptr(),
                         cycles.data_ptr(), stream))
        elif pr.entry == "walk":
            check(launch(d.data_ptr(), pr.rows, pr.steps, k, out.data_ptr(), cycles.data_ptr(),
                         stream))
        else:
            check(launch(d.data_ptr(), k, out.data_ptr(), cycles.data_ptr(), stream))
    probe.launches[name] += 1
    return out, cycles


def probe(name: str, k: int, data, second=None, device=None) -> torch.Tensor:
    """The (8, 128) int32 output of probe ``name`` after ``k`` iterations on
    ``data`` and its ``second`` input, if it has one (the walk table of
    mosaic_probe3.py and mosaic_probe3b.py, the index of mosaic_probe6.py;
    for ``smem_cap``, ``k`` is the scratch's rows and ``data`` the k vector).
    On the card (``device=None``) its kernel; with ``device="cpu"`` its plain
    version.  A probe that fails to trace in JAX raises its ValueError."""
    name = resolve(name)
    _traces(name)
    dev = resolve_device(device)
    refuse_card_tensors(dev, data, second)
    if not 0 <= k < 1 << 31:
        raise ValueError(f"k must be in [0, 2^31), got {k}")
    d = _as_input(name, data, dev)
    t = _as_second(name, second, dev)
    pr = PROBES[name]
    if pr.entry == "smem_cap" and k < 1:
        raise ValueError("smem_cap needs at least one row")
    if dev.type == "cpu":
        return _plain(name, k, d, t)
    if pr.entry == "smem_cap":
        out, ok = _smem_cap_launch(k * L * 4, d)
        if not ok:
            raise RuntimeError(f"smem_cap: {k} rows ({k * L * 4} B) of shared memory do not launch")
        return out
    return _launch(name, k, d, t)[0]


probe.launches = {name: 0 for name in PROBES}

_REFUSED = (1, 701)             # cudaErrorInvalidValue, cudaErrorLaunchOutOfResources


def _smem_cap_launch(nbytes: int, kvec: torch.Tensor) -> tuple[torch.Tensor, bool]:
    """Launch the capacity kernel with ``nbytes`` of dynamic shared memory;
    (output, True) when it launched, (output, False) when the card refused
    that much shared memory.  Any other CUDA error raises."""
    dev = kvec.device
    out = torch.zeros(OUT_SHAPE, dtype=torch.int32, device=dev)
    launch, check = _kernel("smem_cap")
    with torch.cuda.device(dev):
        rc = launch(kvec.data_ptr(), nbytes, out.data_ptr(),
                    torch.cuda.current_stream(dev).cuda_stream)
    if rc in _REFUSED:
        return out, False
    check(rc)
    probe.launches["mosaic_probe5.smem_cap"] += 1
    return out, True


def smem_cap(rows: int, device=None) -> bool:
    """mosaic_probe5.py:39: whether a (rows, 128) int32 scratch runs, i.e. the
    kernel launches with it and returns ``k[0] + 1`` from its last entry."""
    dev = resolve_device(device)
    kvec = torch.ones((4,), dtype=torch.int32)
    if dev.type == "cpu":
        return int(smem_cap_plain(rows, kvec)[0, 0]) == 2
    out, ok = _smem_cap_launch(rows * L * 4, kvec.to(dev))
    return ok and int(out[0, 0]) == 2


def smem_capacity(device=None) -> int:
    """The largest dynamic shared memory, in bytes (a multiple of 4), that a
    block of the capacity kernel launches with and uses: bisection between
    48 KiB and 1 MiB."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("the capacity is a property of the card: pass device=None or a cuda device")
    kvec = torch.ones((4,), dtype=torch.int32, device=dev)

    def runs(nbytes: int) -> bool:
        out, ok = _smem_cap_launch(nbytes, kvec)
        return ok and int(out[0, 0]) == 2

    lo, hi = 48 * 1024, 1 << 20                      # runs(lo); not runs(hi)
    if not runs(lo) or runs(hi):
        raise RuntimeError("shared memory capacity outside [48 KiB, 1 MiB)")
    while hi - lo > 4:
        mid = (lo + hi) // 2 // 4 * 4
        lo, hi = (mid, hi) if runs(mid) else (lo, mid)
    return lo


def _bound(name: str, k: int) -> tuple[float, str]:
    """Least time for ``k`` iterations of probe ``name``: the input rows
    and walk-table entries it reads (``Probe.reads``), K, and its output
    written once, over the memory rate, against its operations over the
    peak rate of their type."""
    pr = PROBES[name]
    nbytes = 4 * (pr.reads + (1 if pr.rows else 0) + OUT_SHAPE[0] * L)   # smem_cap: K is its input
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = k * pr.ops / {"": OPS_PER_S, "bf16": BF16_PER_S, "int8": INT8_PER_S}[pr.tensor] * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def slope(run: Callable[[int], tuple[torch.Tensor, torch.Tensor]], k_lo: int, k_hi: int,
          reps: int = 5) -> tuple[float, float, float, torch.Tensor]:
    """Time ``run(k)`` (a launch returning its output and its loop's cycles)
    at K = k_lo and k_hi after one warm-up run, the fastest of ``reps`` CUDA-
    event-timed runs each.  Returns (ns per iteration, SM cycles per
    iteration, ms of one run at k_hi, the output at k_hi)."""
    run(k_lo)
    ms, cyc = {}, {}
    for k in (k_lo, k_hi):
        times = []
        for _ in range(reps):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out, cycles = run(k)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        ms[k], cyc[k] = min(times), int(cycles[0])
    span = k_hi - k_lo
    return (ms[k_hi] - ms[k_lo]) * 1e6 / span, (cyc[k_hi] - cyc[k_lo]) / span, ms[k_hi], out


def measure(name: str, seed: int = 0, device=None, reps: int = 5) -> dict:
    """One probe on ``device`` (None = the card): ns and cycles per iteration
    from the slope between K = k_lo and K = k_hi, the ms of one launch at
    k_hi, and whether its output at k_hi equals the plain version's.  With
    ``device="cpu"`` only the plain version runs and no time is measured."""
    name = resolve(name)
    _traces(name)
    pr = PROBES[name]
    dev = resolve_device(device)
    data, table = inputs(name, seed), second_input(name, seed)
    host = torch.from_numpy(data)
    rec = {"probe": name, "site": pr.site, "entry": pr.entry, "k_lo": pr.k_lo, "k_hi": pr.k_hi,
           "steps_per_iter": pr.steps, "space": pr.space, "device": dev.type}
    t0 = time.perf_counter()
    want = _plain(name, pr.k_hi, host, None if table is None else torch.from_numpy(table))
    rec["plain_ms"] = (time.perf_counter() - t0) * 1e3
    rec["bound_ms"], rec["bound_by"] = _bound(name, pr.k_hi)
    if dev.type == "cpu":
        rec.update(ns_per_iter=None, cycles_per_iter=None, ms=None, result_equals_plain=True,
                   max_abs_err=0)
        return rec
    d = _as_input(name, data, dev)
    if pr.entry == "smem_cap":
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        got = probe(name, pr.k_hi, d)
        b.record()
        b.synchronize()
        rec.update(ns_per_iter=None, cycles_per_iter=None, ms=a.elapsed_time(b),
                   capacity_bytes=smem_capacity(dev),
                   rows_ok={r: smem_cap(r, dev) for r in SMEM_ROWS})
    else:
        t = _as_second(name, table, dev)
        ns, cycles, ms, got = slope(lambda k: _launch(name, k, d, t), pr.k_lo, pr.k_hi, reps)
        rec.update(ns_per_iter=ns, cycles_per_iter=cycles, ms=ms)
    diff = (got.cpu().long() - want.long()).abs()
    rec["max_abs_err"] = int(diff.max())
    rec["result_equals_plain"] = rec["max_abs_err"] == 0
    return rec


def clocks() -> dict:
    """The card's name, power limit and SM clocks now and at most, from nvidia-smi."""
    q = "name,power.limit,clocks.sm,clocks.max.sm"
    line = subprocess.run(["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    return dict(zip(q.split(","), (s.strip() for s in line.split(","))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("names", nargs="*",
                    help="probes (default: TIMED, all with a kernel but smem_cap)")
    ap.add_argument("--smem", action="store_true", help="add the shared-memory capacity probe")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: the card; cpu = plain versions")
    args = ap.parse_args(argv)
    names = [resolve(n) for n in args.names] or list(TIMED)
    if args.smem and "mosaic_probe5.smem_cap" not in names:
        names.append("mosaic_probe5.smem_cap")
    dev = resolve_device(args.device)
    out = {}
    for name in names:
        rec = measure(name, args.seed, dev)
        if not rec["result_equals_plain"]:
            raise AssertionError(f"{name}: the kernel's output differs from the plain version")
        out[name] = rec
        print(json.dumps(rec), flush=True)
    if dev.type == "cuda":
        out["card"] = clocks()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
