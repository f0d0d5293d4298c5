"""Batched independent-block Snappy decode: the CUDA kernels and their plain version.

Port of ``csnappy_tpu/ops/decode_fused.py``.  Two sources serve both of the
TPU kernel's modes:

* :func:`decode_blocks` — block mode (``_compiled``): a ``[B, P]`` matrix of
  zero-padded fragments, one output row of ``block_out`` bytes each;
* :func:`decode_segments` — stream mode (``_compiled_streamed``): the
  segments of ONE contiguous stream, read in place at their compressed
  offsets.

The row's width chooses the kernels before the launch (:func:`kernel_for`).
Rows of at most ``FAST_MAX`` bytes, every route of the API, take
``csrc/decode_blocks.cu``'s ``decode_kernel``: one thread block a Snappy
block (the parse at every position, a pair-table walk of the tag starts, a
block scan and judgement of the tags, a cover max-scan of the output and
parents collapsed by pointer jumping, in shared memory), one launch.  Wider
rows take ``csrc/decode_wide.cu``: one memset of a workspace and three
launches, ``wide_chain_kernel`` (the tag chain over 8 KiB input chunks,
chained one word a chunk), ``wide_segment_kernel`` (one thread block a 32
KiB output segment, chained one flag a segment, a copy reading any earlier
segment of its row) and ``wide_finish_kernel`` (``produced``, ``status`` and
the zero fill).  Each source comment says what bounds its kernels on the
card and what the design does about it.

Contract, identical in every version.  For each block the stream is decoded
against its limit ``dlim`` exactly as the oracle does
(``models/pymodel.decompress_noheader``): tags in order, the first error
event in output order wins, and within a tag the offset check comes before
the space check (csnappy_decompress.c:295-317).  ``status`` is 0,
E_OUTPUT_OVERRUN or E_DATA_MALFORMED; ``produced`` is 0 unless the status is
0; each output row holds the decoded bytes and is zero past ``produced``.
COPY_4 offsets keep their full 32-bit value, so a copy may read any earlier
byte of its row.  Widths and limits lie in [0, 2^31): the int32
``produced`` and the card's memory are the only limits.

On a CUDA tensor the kernels run; on a CPU tensor the plain version runs
(:func:`decode_plain`); a CUDA tensor with ``device="cpu"`` raises.  Nothing
falls back from one to the other.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..config import refuse_card_tensors, resolve_device
from ..errors import SnappyError
from ..models import pymodel
from . import _build
from .primitives import _stream

MAX_WIDTH = (1 << 31) - 1  # widest row and largest limit: produced is int32
FAST_MAX = 1 << 15        # widest row decode_kernel takes; wider rows go to decode_wide.cu
WIDE_KERNELS = ("wide_chain_kernel", "wide_segment_kernel", "wide_finish_kernel")
KERNELS = ("decode_kernel",) + WIDE_KERNELS
# what decode_kernel's ``stamps`` hold a block (``_launch``): the SM cycles of
# each phase, summed over the input windows, then three counts
PHASES = ("staged", "parsed", "walked", "judged", "covered", "resolved", "gathered", "written")
COUNTS = ("windows", "tags", "rounds")     # at STAMPS - 3 .. STAMPS - 1
STAMPS = 16
# what the wide kernels' stamps hold (``_launch(..., stamps)``): a chunk's SM
# cycles of each phase, then counts (visited 1 or 0, pointer-jumping rounds,
# cover searches, the %globaltimer ns at which it published its exit); then a
# segment's SM cycles of each phase, then counts (windows, tags walked,
# resolve rounds, externals: 1 when it read bytes of earlier segments, the
# %globaltimer ns of its flag)
WIDE_CHAIN_STAMPS = ("staged", "jumped", "waited", "covers", "visited", "rounds", "searches",
                     "published_ns")
WIDE_SEG_STAMPS = ("entered", "parsed", "walked", "judged", "covered", "resolved", "waited",
                   "written", "windows", "tags", "rounds", "externals", "published_ns")
CHUNK_LOG = 13            # wide_chain_kernel's chunks: 8,192 input positions
SEG = 1 << 15             # wide_segment_kernel's output segments


def kernel_for(width: int) -> tuple[str, ...]:
    """The kernels a call with rows of ``width`` bytes launches, in order."""
    return KERNELS[:1] if width <= FAST_MAX else WIDE_KERNELS


def _u8_tensor(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        t = x
    else:
        a = np.frombuffer(x, np.uint8) if isinstance(x, (bytes, bytearray, memoryview)) else np.asarray(x)
        t = torch.from_numpy(a if a.flags.writeable else a.copy())
    if t.dtype != torch.uint8:
        raise TypeError(f"compressed input must be uint8, got {t.dtype}")
    return t.to(device).contiguous()


def _host_ints(x, n: int, what: str) -> np.ndarray:
    a = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    a = np.broadcast_to(a.astype(np.int64), (n,)) if a.ndim == 0 else a.astype(np.int64)
    if a.shape != (n,):
        raise ValueError(f"{what} must have {n} entries, got shape {a.shape}")
    return np.ascontiguousarray(a)


def decode_blocks(comp, src_lens, block_out: int, device=None):
    """Decode B independent fragments.

    comp: uint8[B, P] zero-padded fragments; src_lens: int[B], each <= P;
    block_out: each block's output limit and row width, in [0, 2^31).
    Returns (out uint8[B, block_out], produced int32[B], status int32[B]),
    on ``device`` (None = cuda).
    """
    dev = resolve_device(device)
    refuse_card_tensors(dev, comp, src_lens)
    comp = _u8_tensor(comp, dev)
    if comp.dim() != 2:
        raise ValueError("comp must be [B, P]")
    B, P = comp.shape
    lens = _host_ints(src_lens, B, "src_lens")
    if ((lens < 0) | (lens > P)).any():
        raise ValueError("src_lens must lie in [0, P]")
    if not 0 <= block_out <= MAX_WIDTH:
        raise ValueError(f"block_out must lie in [0, {MAX_WIDTH}]")
    offs = np.arange(B, dtype=np.int64) * P
    dlims = np.full((B,), block_out, np.int64)
    return _decode(decode_blocks, comp.reshape(-1), offs, lens, dlims, block_out)


def decode_segments(body, offs, lens, dlim, device=None):
    """Decode the independent segments of one contiguous stream in one call.

    body: uint8[n], the headerless stream; offs/lens: int[S], each segment's
    compressed offset and length inside ``body``; dlim: int or int[S], each
    segment's output limit, in [0, 2^31).  Returns (out uint8[S, max(dlim)],
    produced, status).  The segments are read in place; ``body`` is not
    copied into a padded matrix.
    """
    dev = resolve_device(device)
    refuse_card_tensors(dev, body, offs, lens, dlim)
    body = _u8_tensor(body, dev).reshape(-1)
    offs = np.asarray(offs, np.int64).reshape(-1)
    S = len(offs)
    lens = _host_ints(lens, S, "lens")
    dlims = _host_ints(dlim, S, "dlim")
    if ((offs < 0) | (lens < 0) | (offs + lens > body.numel())).any():
        raise ValueError("segments must lie inside body")
    if ((dlims < 0) | (dlims > MAX_WIDTH)).any():
        raise ValueError(f"dlim must lie in [0, {MAX_WIDTH}]")
    width = int(dlims.max()) if S else 0
    return _decode(decode_segments, body, offs, lens, dlims, width)


def wide_plan(lens, dlims, width: int) -> np.ndarray:
    """int64[2 (B + 1)]: each row's first chunk of ``wide_chain_kernel``
    (the chunk count after the last), then its first segment of
    ``wide_segment_kernel`` (the segment count after the last).  A row of
    n input bytes has ``(n >> CHUNK_LOG) + 1`` chunks, one of limit d
    ``min(d, width) // SEG + 1`` segments (the last judges a tag starting
    at d)."""
    lens = np.asarray(lens, np.int64)
    nseg = np.minimum(np.asarray(dlims, np.int64), width) // SEG + 1
    return np.concatenate([[0], np.cumsum((lens >> CHUNK_LOG) + 1), [0], np.cumsum(nseg)])


def plan_on(device, lens, dlims, width: int):
    """:func:`wide_plan` of host ``lens`` and ``dlims`` as ``_launch``'s
    ``plan``: (the plan on ``device``, chunks, segments)."""
    p = wide_plan(lens, dlims, width)
    B = len(p) // 2 - 1
    return torch.from_numpy(p).to(device), int(p[B]), int(p[-1])


def _decode(wrapper, src: torch.Tensor, offs, lens, dlims, width: int):
    if lens.size and int(lens.max()) >= 1 << 31:
        raise ValueError("a block's compressed length must be below 2 GiB")
    if len(offs) == 0:
        i32 = torch.zeros((0,), dtype=torch.int32, device=src.device)
        return torch.zeros((0, width), dtype=torch.uint8, device=src.device), i32, i32.clone()
    if src.device.type == "cpu":
        return decode_plain(src, offs, lens, dlims, width)
    # one host buffer, one copy to the card: int64 offsets (and the wide
    # kernels' plan), int32 lengths and limits, viewed in place (no
    # conversion kernel on the card)
    B = len(offs)
    plan = wide_plan(lens, dlims, width) if width > FAST_MAX else np.zeros((0,), np.int64)
    n64 = B + len(plan)
    host = np.empty((8 * n64 + 8 * B,), np.uint8)
    host[: 8 * n64].view(np.int64)[:] = np.concatenate([offs, plan])
    host[8 * n64 :].view(np.int32)[:] = np.concatenate([lens, dlims])
    ints = torch.from_numpy(host).to(src.device)
    i64 = ints[: 8 * n64].view(torch.int64)
    i32 = ints[8 * n64 :].view(torch.int32)
    return _launch(wrapper, src, i64[:B], i32[:B], i32[B:], width,
                   plan=(i64[B:], int(plan[B]), int(plan[-1])) if len(plan) else None)


@functools.cache
def _kernel():
    launch, check = _build.kernel("decode_blocks")
    vp = ctypes.c_void_p
    launch.argtypes = [vp, vp, vp, vp, vp, ctypes.c_longlong, vp, vp, ctypes.c_int, vp, vp]
    return launch, check


@functools.cache
def _wide_kernel():
    launch, check = _build.kernel("decode_wide")
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    launch.argtypes = [vp, vp, vp, vp, vp, vp, ll, vp, vp, ctypes.c_int, ll, ll, vp, vp, vp]
    return launch, check


def layout(width: int) -> dict:
    """``decode_kernel``'s shared arrays for rows of ``width`` bytes: each
    array's byte offset and the total."""
    fn = _build.load("decode_blocks").decode_blocks_layout
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_void_p], None
    fields = (ctypes.c_int * 8)()
    fn(width, fields)
    return dict(zip(("out", "par", "win", "nx", "cp", "tl", "tos", "total"), fields))


def smem_bytes(kernel: str, width: int = FAST_MAX) -> int:
    """Dynamic shared memory a block of ``kernel`` takes (``decode_kernel``'s
    for rows of ``width`` bytes; ``wide_finish_kernel`` takes none)."""
    if kernel == KERNELS[0]:
        return layout(width)["total"]
    if kernel == WIDE_KERNELS[2]:
        return 0
    fn = _build.load("decode_wide").decode_wide_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    return fn(WIDE_KERNELS.index(kernel))


@functools.cache
def _wide_work_fn():
    fn = _build.load("decode_wide").decode_wide_work_bytes
    fn.argtypes, fn.restype = [ctypes.c_longlong] * 3, ctypes.c_longlong
    return fn


def wide_work_bytes(nrows: int, nchunks: int, nseg: int) -> int:
    """The wide kernels' workspace of one call, as ``csrc/decode_wide.cu``
    lays it out and clears it (its ``decode_wide_work_bytes``)."""
    return _wide_work_fn()(nrows, nchunks, nseg)


def wide_stamp_count(nchunks: int, nseg: int) -> int:
    """int64 stamps of one wide call: ``len(WIDE_CHAIN_STAMPS)`` a chunk,
    then ``len(WIDE_SEG_STAMPS)`` a segment, in ticket order."""
    return nchunks * len(WIDE_CHAIN_STAMPS) + nseg * len(WIDE_SEG_STAMPS)


def split_wide_stamps(stamps, nchunks: int):
    """The stamps of one wide call as (chunks int64[nchunks, 8], segments
    int64[nseg, 13]) on the host."""
    st = stamps.cpu().numpy()
    nc = nchunks * len(WIDE_CHAIN_STAMPS)
    return (st[:nc].reshape(-1, len(WIDE_CHAIN_STAMPS)),
            st[nc:].reshape(-1, len(WIDE_SEG_STAMPS)))


def _launch(wrapper, src, offs_t, lens_t, dlims_t, width: int, stamps=None, outs=None,
            plan=None):
    """Launch the kernels of :func:`kernel_for` on torch's current stream and
    count them on ``wrapper.launches`` (one a call) and ``launches_by_kernel``.
    All tensors are on the card: the flat source, int64 offsets, int32
    lengths and limits (validated by the caller).  ``stamps``: None, or on
    the card, contiguous: int64[B, STAMPS] for ``decode_kernel`` (each
    block's ``PHASES`` cycles, then ``COUNTS``), int64[:func:`wide_stamp_count`]
    for the wide kernels; ``outs``: None, or the int32[B] tensors on the card
    that take ``produced`` and ``status`` (views of a caller's buffer);
    ``plan``: the wide kernels' (:func:`wide_plan` on the card, chunks,
    segments), or None to compute it from ``lens_t`` and ``dlims_t`` (a copy
    to the host)."""
    dev = src.device
    B = offs_t.numel()
    wide = width > FAST_MAX
    if wide and plan is None:
        plan = plan_on(dev, lens_t.cpu().numpy(), dlims_t.cpu().numpy(), width)
    want = ((wide_stamp_count(plan[1], plan[2]),) if wide else (B, STAMPS))
    if stamps is not None and (tuple(stamps.shape) != want or stamps.dtype != torch.int64
                               or stamps.device != dev or not stamps.is_contiguous()):
        raise ValueError(f"stamps must be int64{list(want)} on {dev}, contiguous")
    out = torch.empty((B, width), dtype=torch.uint8, device=dev)
    if outs is None:
        outs = (torch.empty((B,), dtype=torch.int32, device=dev),
                torch.empty((B,), dtype=torch.int32, device=dev))
    produced, status = outs
    sp = None if stamps is None else stamps.data_ptr()
    if wide:
        firsts, nchunks, nseg = plan
        work = torch.empty((wide_work_bytes(B, nchunks, nseg),), dtype=torch.uint8, device=dev)
        launch, check = _wide_kernel()
        args = (src.data_ptr(), offs_t.data_ptr(), lens_t.data_ptr(), dlims_t.data_ptr(),
                firsts.data_ptr(), out.data_ptr(), width, produced.data_ptr(),
                status.data_ptr(), B, nchunks, nseg, work.data_ptr(), sp)
    else:
        launch, check = _kernel()
        args = (src.data_ptr(), offs_t.data_ptr(), lens_t.data_ptr(), dlims_t.data_ptr(),
                out.data_ptr(), width, produced.data_ptr(), status.data_ptr(), B, sp)
    if dev.index is None or dev.index == torch.cuda.current_device():
        rc = launch(*args, _stream(dev.index))
    else:                                           # operands on another card: launch there
        with torch.cuda.device(dev):
            rc = launch(*args, _stream(dev.index))
    check(rc)
    wrapper.launches += 1
    for k in kernel_for(width):
        launches_by_kernel[k] += 1
    return out, produced, status


decode_blocks.launches = 0
decode_segments.launches = 0
launches_by_kernel = dict.fromkeys(KERNELS, 0)


# ------------------------------------------------------------ plain version


def decode_plain(src: torch.Tensor, offs, lens, dlims, width: int):
    """Plain version of ``decode_blocks.cu`` on CPU tensors (same arguments
    as the launch: the flat source, per-block offsets, lengths, limits).
    Each block goes through the oracle; its error code is the status."""
    flat = src.numpy().tobytes()
    B = len(offs)
    out = torch.zeros((B, width), dtype=torch.uint8)
    produced = torch.zeros((B,), dtype=torch.int32)
    status = torch.zeros((B,), dtype=torch.int32)
    for b in range(B):
        o, ln = int(offs[b]), int(lens[b])
        try:
            got = pymodel.decompress_noheader(flat[o : o + ln], int(dlims[b]))
        except SnappyError as e:
            status[b] = e.code
            continue
        produced[b] = len(got)
        if got:
            out[b, : len(got)] = torch.frombuffer(bytearray(got), dtype=torch.uint8)
    return out, produced, status
