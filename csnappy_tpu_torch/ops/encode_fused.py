"""Batched independent-block Snappy encode: one CUDA kernel from the raw
bytes to the stream on the card, tensor ops and a plain walk on the CPU.

Port of ``csnappy_tpu/ops/encode_fused.py``; the stream is byte-identical to
it (354,567 B on urls.10K).

* On a CUDA tensor, :func:`encode_blocks` launches ``csrc/encode_blocks.cu``
  once: one thread block per Snappy block finds every position's most recent
  prior equal 4-byte window (a stable radix sort of the positions in shared
  memory), its LCP, the staircase, lazy deferral and the next-candidate
  table, then walks the greedy commits and writes the records.  Its source
  comment says what bounds it on the card and what its design does about
  that.
* On a CPU tensor the plain version runs: :func:`prep`, the counterpart of
  the XLA preparation in front of the Pallas kernel
  (``encode_fused.py:492-600``) — every position's most recent prior
  occurrence of its 4-byte window from ONE sort of the unique key
  ``window << 15 | pos``, the LCP from ``EXTRAS`` further windows, a reverse
  segmented cummax (the staircase) through runs of consecutive candidates,
  lazy deferral when the next position's match is >= 2 longer, a reverse
  cummin for ``nc``, the next position that has a match; output, per
  position, ``in1 = cand | ml << 15 | has << 22`` and ``nc`` — then
  :func:`emit_plain`, the successor table, the greedy walk and the records.

The TPU kernel's pair fusion (two commits per walk step) changes how many
steps its walk takes, never the parse, so it has no counterpart here.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..config import refuse_card_tensors, resolve_device
from ..errors import E_DATA_MALFORMED, SnappyError
from ..models import wire
from . import _build
from .primitives import _stream

NOCAND = 0x7FFF   # candidate sentinel
EXTRAS = 2        # carried LCP windows, as the JAX package (direct LCP cap 4 + 4 * EXTRAS)
# the kernel's SM clock stamps a block (kStamps of encode_blocks.cu): at its
# start, then after each of these phases (``stamps`` of ``_launch``)
PHASES = ("staged", "sorted", "cand_lcp", "breaks", "staircase", "deferral_nc_T", "entries",
          "chain", "commits", "scan", "records", "zeroed")
STAMPS = 16


def ocap(bs: int) -> int:
    """Output row width for blocks of ``bs`` bytes (38,912 for 32 KiB)."""
    return (wire.max_compressed_length(bs) + 1023) // 1024 * 1024


def prep(data: torch.Tensor, blens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Match candidates and lengths: (in1, nc), both int32[B, bs].

    data: uint8[B, bs] (bytes past blen take part in windows, as in the JAX
    package); blens: int32[B] on the same device.
    """
    B, bs = data.shape
    dev = data.device
    x = torch.cat([data.to(torch.int64), torch.zeros((B, 32), dtype=torch.int64, device=dev)], 1)

    def win(at: int) -> torch.Tensor:
        return (x[:, at : bs + at] | (x[:, at + 1 : bs + at + 1] << 8)
                | (x[:, at + 2 : bs + at + 2] << 16) | (x[:, at + 3 : bs + at + 3] << 24))

    pos64 = torch.arange(bs, dtype=torch.int64, device=dev)
    # unique keys: equal windows group together in ascending position, so a
    # position's sorted predecessor with an equal window is its most recent
    # prior occurrence
    key = torch.sort((win(0) << 15) | pos64, dim=1).values
    ps = key & 0x7FFF
    ws = key >> 15
    same = torch.zeros((B, bs), dtype=torch.bool, device=dev)
    same[:, 1:] = ws[:, 1:] == ws[:, :-1]
    scand = torch.where(same, torch.roll(ps, 1, 1), NOCAND)

    # LCP beyond the 4 equal bytes, from the carried windows in sorted order
    st = torch.stack([torch.gather(win(4 * k), 1, ps) for k in range(1, 1 + EXTRAS)], 1)
    xk = st ^ torch.cat([st[:, :, :1], st[:, :, :-1]], 2)
    eqw = (xk == 0).to(torch.int64)
    teqk = torch.where(
        xk == 0, 4,
        ((xk & 0xFF) == 0).to(torch.int64) + ((xk & 0xFFFF) == 0).to(torch.int64)
        + ((xk & 0xFFFFFF) == 0).to(torch.int64),
    )
    pref = torch.cat([torch.ones_like(eqw[:, :1]), torch.cumprod(eqw[:, :-1], 1)], 1)
    slcp = torch.where(same, 4 + (pref * teqk).sum(1), 0)
    cand = torch.empty_like(ps).scatter_(1, ps, scand).to(torch.int32)
    lcpu = torch.empty_like(ps).scatter_(1, ps, slcp).to(torch.int32)

    pos = pos64.to(torch.int32)[None, :]
    blc = blens.to(device=dev, dtype=torch.int32)[:, None]
    has = (cand != NOCAND) & (pos + 4 <= blc) & (cand < pos)
    candn = torch.cat([cand[:, 1:], torch.full_like(cand[:, :1], NOCAND)], 1)
    hasn = torch.cat([has[:, 1:], torch.zeros_like(has[:, :1])], 1)
    consec = has & hasn & (candn == cand + 1)
    # staircase: ml(p) >= (j - p) + lcp(j) across p's run of consecutive
    # candidates — a reverse cummax of j + lcp(j), segmented by run id
    # (later runs sit K below any in-block value; rid * K stays in int32)
    K = 1 << 16
    brk = (~consec).to(torch.int32)
    rid = torch.cumsum(brk, 1, dtype=torch.int32) - brk
    hstair = torch.where(has, pos + lcpu, 0) - rid * K
    segmax = torch.flip(torch.cummax(torch.flip(hstair, [1]), 1).values, [1]) + rid * K
    cap = torch.clamp(blc - pos, 0, wire.MAX_COPY_LEN)
    ml0 = torch.minimum(torch.maximum(segmax - pos, lcpu), cap)
    # lazy deferral: skip a match when the next position's is >= 2 longer
    mln = torch.cat([ml0[:, 1:], torch.zeros_like(ml0[:, :1])], 1)
    has = has & ~(has & hasn & (mln >= ml0 + 2))
    in1 = (torch.where(has, cand, NOCAND) | (torch.where(has, ml0, 0) << 15)
           | (has.to(torch.int32) << 22))
    nc = torch.flip(torch.cummin(torch.flip(torch.where(has, pos, bs), [1]), 1).values, [1])
    return in1, nc.to(torch.int32)


def walk_cap(bs: int) -> int:
    """Commits a block's walk may take: each covers >= 4 bytes, so bs // 4 + 1
    bounds every valid parse; one more means a broken preparation."""
    return bs // 4 + 1


def encode_blocks(data, blens, hash_bits: int = 16, device=None):
    """Compress B independent fragments.

    data: uint8[B, bs] zero-padded, bs <= 32768; blens: int[B], each <= bs.
    ``hash_bits`` is accepted and ignored (the sort matcher is exact).
    Returns (comp uint8[B, ocap], comp_lens int32[B]) on ``device``
    (None = cuda); each row is zero past its length.
    """
    del hash_bits
    dev = resolve_device(device)
    refuse_card_tensors(dev, data, blens)
    t = data if isinstance(data, torch.Tensor) else torch.as_tensor(np.asarray(data))
    if t.dtype != torch.uint8 or t.dim() != 2:
        raise TypeError("data must be uint8[B, bs]")
    B, bs0 = t.shape
    if bs0 > wire.BLOCK_SIZE:
        raise ValueError("blocks are at most 32768 bytes")
    lens = np.asarray(blens.cpu() if isinstance(blens, torch.Tensor) else blens, np.int64)
    if lens.shape != (B,) or ((lens < 0) | (lens > bs0)).any():
        raise ValueError("blens must be B lengths in [0, bs]")
    bs = max(bs0 + 1023, 1024) // 1024 * 1024
    lens_t = torch.from_numpy(lens.astype(np.int32)).to(dev)
    if B == 0:
        return torch.zeros((0, ocap(bs)), dtype=torch.uint8, device=dev), lens_t
    if dev.type == "cpu":
        data_t = torch.nn.functional.pad(t, (0, bs - bs0)).contiguous()
        comp, clen, fail = emit_plain(data_t, lens_t, *prep(data_t, lens_t), ocap(bs))
    else:                       # the kernel pads the row to bs itself: one launch a call
        comp, clen, fail = _launch(t.to(dev).contiguous(), lens_t, bs, ocap(bs), walk_cap(bs))
    bad = np.nonzero(fail.cpu().numpy())[0]
    if bad.size:
        # the walk bound holds for every valid preparation: this is an
        # internal invariant break, surfaced through the codec's error codes
        raise SnappyError(E_DATA_MALFORMED,
                          f"encoder walk exhausted its bound (blocks {bad.tolist()})")
    return comp, clen


@functools.cache
def _kernel():
    launch, check = _build.kernel("encode_blocks")
    vp, i = ctypes.c_void_p, ctypes.c_int
    launch.argtypes = [vp, i, vp, i, i, vp, i, vp, vp, i, vp, vp]
    return launch, check


def smem_bytes(bs: int) -> int:
    """Shared memory a block of the kernel takes for blocks of ``bs`` bytes."""
    fn = _build.load("encode_blocks").encode_blocks_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    return fn(bs)


def _launch(data, blens, bs: int, width: int, cap: int, stamps=None):
    """Launch ``encode_blocks.cu`` on torch's current stream over ``data``
    (uint8[B, w], w <= bs, contiguous, on the card) as blocks of ``bs``
    bytes; counts on ``encode_blocks.launches``.  ``stamps``: None, or
    int64[B, STAMPS] on the card for each block's SM clock at its start and
    after each of ``PHASES``.  Returns (comp, clen, fail)."""
    dev = data.device
    B, w = data.shape
    if stamps is not None and (stamps.shape != (B, STAMPS) or stamps.dtype != torch.int64
                               or stamps.device != dev or not stamps.is_contiguous()):
        raise ValueError(f"stamps must be int64[{B}, {STAMPS}] on {dev}, contiguous")
    comp = torch.empty((B, width), dtype=torch.uint8, device=dev)
    clen = torch.empty((B,), dtype=torch.int32, device=dev)
    fail = torch.empty((B,), dtype=torch.int32, device=dev)
    launch, check = _kernel()
    args = (data.data_ptr(), w, blens.data_ptr(), bs, cap, comp.data_ptr(), width,
            clen.data_ptr(), fail.data_ptr(), B, None if stamps is None else stamps.data_ptr())
    if dev.index is None or dev.index == torch.cuda.current_device():
        rc = launch(*args, _stream(dev.index))
    else:                                           # operands on another card: launch there
        with torch.cuda.device(dev):
            rc = launch(*args, _stream(dev.index))
    check(rc)
    encode_blocks.launches += 1
    return comp, clen, fail


encode_blocks.launches = 0


def emit_plain(data, blens, in1, nc, width: int):
    """The plain version's walk and emission on CPU tensors, after
    :func:`prep`: the successor table, the greedy commit walk (at most
    ``walk_cap(bs)`` commits), then the records' bytes."""
    B, bs = data.shape
    comp = torch.zeros((B, width), dtype=torch.uint8)
    clen = torch.zeros((B,), dtype=torch.int32)
    fail = torch.zeros((B,), dtype=torch.int32)
    d, I, N = data.numpy(), in1.numpy(), nc.numpy()
    cap = walk_cap(bs)
    idx = np.arange(bs)
    for b in range(B):
        ml = (I[b] >> 15) & 0x7F
        q = idx + ml
        T = np.where((I[b] >> 22) & 1 == 1, np.where(q < bs, N[b][np.minimum(q, bs - 1)], bs),
                     N[b])
        commits, p = [], int(N[b][0])
        while p < bs and len(commits) < cap:
            commits.append(p)
            p = int(T[p])
        if p < bs:
            fail[b] = 1
            continue
        out = bytearray()
        prev_end = 0
        for p in commits:
            v = int(I[b][p])
            m = (v >> 15) & 0x7F
            wire.emit_literal(out, d[b, prev_end:p].tobytes())
            wire.emit_copy_leq64(out, p - (v & 0x7FFF), m)
            prev_end = p + m
        wire.emit_literal(out, d[b, prev_end : int(blens[b])].tobytes())
        if len(out) > width:
            fail[b] = 1
            continue
        clen[b] = len(out)
        if out:
            comp[b, : len(out)] = torch.frombuffer(out, dtype=torch.uint8)
    return comp, clen, fail


def compress_np(data, block_size: int = wire.BLOCK_SIZE, hash_bits: int = 16,
                device=None) -> bytes:
    """Whole-stream compress: varint preamble + independent ``block_size``
    fragments (csnappy_compress.c:621-656), one batch on ``device``."""
    buf = np.frombuffer(bytes(data), np.uint8) if isinstance(
        data, (bytes, bytearray, memoryview)) else np.asarray(data, np.uint8).reshape(-1)
    n = len(buf)
    out = bytearray(wire.varint_encode(n))
    if n == 0:
        return bytes(out)
    nb = (n + block_size - 1) // block_size
    padded = np.zeros((nb, block_size), np.uint8)
    padded.reshape(-1)[:n] = buf
    blens = np.full((nb,), block_size, np.int32)
    blens[-1] = n - (nb - 1) * block_size
    comp, lens = encode_blocks(torch.from_numpy(padded), blens, hash_bits, device)
    out += _compact(comp, lens)
    return bytes(out)


def _compact(comp: torch.Tensor, lens: torch.Tensor) -> bytes:
    """Host leg: concatenate ``comp[i, :lens[i]]`` (runtime/native.compact)."""
    from ..runtime import native

    lens_np = lens.cpu().numpy()
    width = int(lens_np.max()) if lens_np.size else 0
    return native.compact(comp[:, :width].cpu().numpy(), lens_np)
