"""Latency and capacity probes on the card (port of ``tools/mosaic_probe.py``,
``tools/mosaic_probe2.py`` and ``tools/mosaic_probe5.py``).

The JAX tools measure, on the TPU, what one step of the constructs the
fused kernels are built from costs: a dependent load per step from vector
or scalar memory, with and without a store, at 1, 2 and 4 interleaved
chains; dynamic row reads and writes; a small matrix product; one-hot row
gathers; dense vector work; lane rolls; gather and scatter loops; and the
largest on-chip scratch that runs.  Each probe loops K times inside one
kernel, so the cost of a step is the slope between two values of K.

Here each probe is a kernel of ``csrc/probe.cu`` that computes what the TPU
kernel computes (the same int32 (8, 128) ``o_ref`` for the same K and
input), written for Hopper: the scalar walks are one thread walking a table
in shared or global memory, the vector probes 128 or 1024 threads, the
product a tensor-core ``wmma`` product, the rolls a 128-lane rotate through
shared memory, the window copy a ``cp.async.bulk`` into shared memory.
``PROBES`` names each probe by its JAX name (``"mosaic_probe.walk_load"``,
..., ``"mosaic_probe5.walk_c4_r576"``) with its plain version, its CUDA
entry, its TPU site and its (k_lo, k_hi).

* :func:`probe` — one probe's output at K on the card (``device=None``) or,
  with ``device="cpu"``, its plain version: torch ops (Python ints for the
  scalar walks) in a Python loop over K, wrapping at 32 bits as the JAX
  kernels do.  Scratch that a TPU kernel reads before writing holds
  INT32_MIN, as the Pallas interpreter fills it; the kernels fill it the same.
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
from .timing import BF16_PER_S, HBM_BYTES_PER_S, OPS_PER_S

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


# -------------------------------------------------------------------- the table


class Probe(NamedTuple):
    plain: Callable[[int, torch.Tensor], torch.Tensor]
    entry: str                  # the CUDA entry of csrc/probe.cu (probe_<entry>_launch)
    site: str                   # the TPU kernel's function, file:line
    call: str                   # its pl.pallas_call site, file:line
    k_lo: int
    k_hi: int
    steps: int                  # dependent steps counted per iteration (walk chains)
    space: str                  # where the probe's table or scratch lives on the card
    rows: int                   # input rows: (rows, 128) int32; 0 for smem_cap's k vector
    ops: int                    # operations per iteration (bound)
    tensor: bool = False        # ops are bf16 tensor-core flops


P1, P2, P5 = "tools/mosaic_probe.py", "tools/mosaic_probe2.py", "tools/mosaic_probe5.py"
C1, C2, C5C, C5W = f"{P1}:45", f"{P2}:24", f"{P5}:39", f"{P5}:102"


def _walks() -> dict[str, Probe]:
    out = {}
    for chains, rows in ((1, 144), (2, 144), (2, 288), (4, 144), (4, 576)):
        space = "shared" if rows * L * 4 <= 232448 else "global"
        out[f"mosaic_probe5.walk_c{chains}_r{rows}"] = Probe(
            functools.partial(walk_plain, chains, rows), "walk", f"{P5}:54", C5W,
            8192, 131072, chains, space, rows, 4 * chains)
    return out


PROBES: dict[str, Probe] = {
    "mosaic_probe.walk_load": Probe(walk_load_plain, "walk_load", f"{P1}:58", C1,
                                    1024, 4096, 1, "global", ROWS, 4),
    "mosaic_probe.walk_ldst": Probe(walk_ldst_plain, "walk_ldst", f"{P1}:68", C1,
                                    1024, 4096, 1, "global", ROWS, 5),
    "mosaic_probe.walk_vst": Probe(walk_ldst_plain, "walk_vst", f"{P1}:79", C1,
                                   1024, 4096, 1, "global", ROWS, 5),
    "mosaic_probe.walk_while": Probe(walk_load_plain, "walk_while", f"{P1}:90", C1,
                                     1024, 4096, 1, "global", ROWS, 4),
    "mosaic_probe.walk_smem": Probe(walk_smem_plain, "walk_smem", f"{P1}:104", C1,
                                    1024, 4096, 1, "shared", ROWS, 4),
    "mosaic_probe.row_read": Probe(row_read_plain, "row_read", f"{P1}:118", C1,
                                   1024, 4096, 1, "global", ROWS, L),
    "mosaic_probe.row_write": Probe(row_write_plain, "row_write", f"{P1}:128", C1,
                                    1024, 4096, 1, "shared", ROWS, L),
    "mosaic_probe.mm_small": Probe(mm_small_plain, "mm_small", f"{P1}:138", C1,
                                   1024, 4096, 1, "shared", ROWS, 2 * L * L * L, True),
    "mosaic_probe.onehot_row": Probe(onehot_row_plain, "onehot_row", f"{P1}:150", C1,
                                     1024, 4096, 1, "global", ROWS, 2 * 8 * L),
    "mosaic_probe.vpu_dense": Probe(vpu_dense_plain, "vpu_dense", f"{P1}:164", C1,
                                    1024, 4096, 1, "registers", ROWS, 3 * 8 * L),
    "mosaic_probe.roll_static": Probe(roll_static_plain, "roll_static", f"{P1}:173", C1,
                                      1024, 4096, 1, "shared", ROWS, 2 * 8 * L),
    "mosaic_probe.roll_dyn": Probe(roll_dyn_plain, "roll_dyn", f"{P1}:182", C1,
                                   1024, 4096, 1, "shared", ROWS, 8 * L),
    "mosaic_probe2.roll_static_min": Probe(roll_static_min_plain, "roll_static_min",
                                           f"{P2}:37", C2, 1024, 8192, 1, "shared", ROWS, 8 * L),
    "mosaic_probe2.walk_smem_st": Probe(walk_smem_st_plain, "walk_smem_st", f"{P2}:46", C2,
                                        2048, 16384, 1, "shared", ROWS, 6),
    "mosaic_probe2.walk_smem_big": Probe(walk_smem_big_plain, "walk_smem_big", f"{P2}:62", C2,
                                         2048, 16384, 1, "shared", ROWS, 4),
    "mosaic_probe2.smem_window_dma": Probe(smem_window_dma_plain, "smem_window_dma",
                                           f"{P2}:76", C2, 2048, 16384, 1, "shared", ROWS, 4),
    "mosaic_probe2.row_write_al": Probe(row_write_al_plain, "row_write_al", f"{P2}:97", C2,
                                        1024, 8192, 1, "shared", ROWS, 8 * L),
    "mosaic_probe2.gather_loop": Probe(gather_loop_plain, "gather_loop", f"{P2}:108", C2,
                                       256, 2048, 1, "shared", ROWS, 3 * L),
    "mosaic_probe2.scatter_loop": Probe(scatter_loop_plain, "scatter_loop", f"{P2}:136", C2,
                                        256, 2048, 1, "shared", ROWS, 6 * L),
    "mosaic_probe5.smem_cap": Probe(smem_cap_plain, "smem_cap", f"{P5}:32", C5C,
                                    256, 256, 0, "shared", 0, 2),
    **_walks(),
}
SITES = {C1: "mosaic_probe", C2: "mosaic_probe2", C5C: "mosaic_probe5.smem_cap",
         C5W: "mosaic_probe5.time_walk"}


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
    [0, 2^20) (mosaic_probe.py:224); (rows, 128) in [2, 9) for a walk
    (mosaic_probe5.py:117-118); the k vector ``ones(4)`` for smem_cap."""
    pr = PROBES[resolve(name)]
    rng = np.random.default_rng(seed)
    if pr.entry == "smem_cap":
        return np.ones((4,), np.int32)
    if pr.entry == "walk":
        return rng.integers(2, 9, size=(pr.rows, L)).astype(np.int32)
    return rng.integers(0, 2**20, (ROWS, L), dtype=np.int32)


# --------------------------------------------------------------------- the card


@functools.cache
def _kernel(entry: str):
    launch, check = _build.kernel("probe", entry)
    vp, i = ctypes.c_void_p, ctypes.c_int
    launch.argtypes = {"walk": [vp, i, i, i, vp, vp, vp],
                       "smem_cap": [vp, ctypes.c_longlong, vp, vp]}.get(entry, [vp, i, vp, vp, vp])
    return launch, check


def _as_input(name: str, data, dev: torch.device) -> torch.Tensor:
    pr = PROBES[name]
    t = data if isinstance(data, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(data))
    want = (4,) if pr.entry == "smem_cap" else (pr.rows, L)
    if t.dtype != torch.int32 or tuple(t.shape) != want:
        raise ValueError(f"{name}: input must be int32 {want}, got {t.dtype} {tuple(t.shape)}")
    return t.to(dev).contiguous()


def _launch(name: str, k: int, d: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``name``'s kernel at K = ``k`` on card tensor ``d``; returns the
    (8, 128) output and the loop's ``clock64()`` cycles, and counts the launch."""
    pr = PROBES[name]
    if d.data_ptr() % 16:
        raise ValueError(f"{name}: the input must be 16-byte aligned")
    dev = d.device
    out = torch.empty(OUT_SHAPE, dtype=torch.int32, device=dev)
    cycles = torch.zeros((1,), dtype=torch.int64, device=dev)
    launch, check = _kernel(pr.entry)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if pr.entry == "walk":
            check(launch(d.data_ptr(), pr.rows, pr.steps, k, out.data_ptr(), cycles.data_ptr(),
                         stream))
        else:
            check(launch(d.data_ptr(), k, out.data_ptr(), cycles.data_ptr(), stream))
    probe.launches[name] += 1
    return out, cycles


def probe(name: str, k: int, data, device=None) -> torch.Tensor:
    """The (8, 128) int32 output of probe ``name`` after ``k`` iterations on
    ``data`` (for ``smem_cap``, ``k`` is the scratch's rows and ``data`` the
    k vector).  On the card (``device=None``) its kernel; with
    ``device="cpu"`` its plain version."""
    name = resolve(name)
    dev = resolve_device(device)
    refuse_card_tensors(dev, data)
    if not 0 <= k < 1 << 31:
        raise ValueError(f"k must be in [0, 2^31), got {k}")
    d = _as_input(name, data, dev)
    pr = PROBES[name]
    if pr.entry == "smem_cap" and k < 1:
        raise ValueError("smem_cap needs at least one row")
    if dev.type == "cpu":
        return pr.plain(k, d)
    if pr.entry == "smem_cap":
        out, ok = _smem_cap_launch(k * L * 4, d)
        if not ok:
            raise RuntimeError(f"smem_cap: {k} rows ({k * L * 4} B) of shared memory do not launch")
        return out
    return _launch(name, k, d)[0]


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
    """Least time for ``k`` iterations of probe ``name``: its input read
    once and its output written once over the memory rate, against its
    operations over the peak rate of their type."""
    pr = PROBES[name]
    nbytes = 4 * ((pr.rows or 1) * L + 1 + OUT_SHAPE[0] * L)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = k * pr.ops / (BF16_PER_S if pr.tensor else OPS_PER_S) * 1e3
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
    pr = PROBES[name]
    dev = resolve_device(device)
    data = inputs(name, seed)
    host = torch.from_numpy(data)
    rec = {"probe": name, "site": pr.site, "entry": pr.entry, "k_lo": pr.k_lo, "k_hi": pr.k_hi,
           "steps_per_iter": pr.steps, "space": pr.space, "device": dev.type}
    t0 = time.perf_counter()
    want = pr.plain(pr.k_hi, host)
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
        ns, cycles, ms, got = slope(lambda k: _launch(name, k, d), pr.k_lo, pr.k_hi, reps)
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
    ap.add_argument("names", nargs="*", help="probes (default: all but smem_cap)")
    ap.add_argument("--smem", action="store_true", help="add the shared-memory capacity probe")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: the card; cpu = plain versions")
    args = ap.parse_args(argv)
    names = [resolve(n) for n in args.names] or [n for n, p in PROBES.items()
                                                if p.entry != "smem_cap"]
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
