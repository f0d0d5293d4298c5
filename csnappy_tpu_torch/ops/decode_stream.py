"""Whole-stream decoder for crossing streams: the CUDA kernel and its plain version.

Port of ``csnappy_tpu/ops/decode_stream.py``.  It decodes one headerless
stream whose tags or copies cross 32 KiB output boundaries (the host scan's
rc 1), which the segment decoder cannot split.  ``csrc/decode_stream.cu``
runs it as two grids after one memset of a workspace: the tag chain over
chunks of ``2**CHUNK_LOG`` stream positions, chained one word a chunk, then
one thread block per 32 KiB output segment, chained one flag a segment; its
source comment says what bounds it and how.

Contract, identical in both versions, and the JAX kernel's rather than the
oracle's where the two differ:

* envelope: copy offsets 1..32768 and literals whose 4-byte length trailer
  has a zero top byte (at most 2^24 bytes); anything outside it, like an
  offset of 0, an offset past the bytes written or a truncated tag, is
  E_DATA_MALFORMED at that tag's output position (decode_stream.py:127-149);
* the first event in output order wins, a malformed tag before the overrun
  of that same tag (ties go to E_DATA_MALFORMED, :484-522);
* the output limit is walked in 32 KiB segments, ``ceil(dst_len / 32768)``
  of them: when ``dst_len`` is a multiple of 32768 and tags remain after
  the output is exactly full, the answer is E_DATA_MALFORMED (the stream is
  not consumed at the last segment's end), where the oracle says
  E_OUTPUT_OVERRUN.

``produced`` is 0 unless the status is 0; ``out[:produced]`` holds the
bytes.  ``out`` is ``min(dst_len, (n // 3 + 1) * 64)`` bytes: no stream of n
bytes produces more (a 3-byte COPY_2 produces at most 64).

On a CUDA tensor the kernel runs; on a CPU tensor the plain version runs
(:func:`decode_plain`); a CUDA tensor with ``device="cpu"`` raises.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..config import refuse_card_tensors, resolve_device
from ..errors import E_DATA_MALFORMED, E_OK, E_OUTPUT_OVERRUN
from ..models import wire
from . import _build
from .decode_fused import _u8_tensor
from .decode_ws import _carve
from .primitives import _stream

SEG = 32768                # output segment the limit is walked in
MAX_OFFSET = 32768         # the history the JAX kernel keeps
CHUNK_LOG = 13             # the chain kernel's chunks: 8,192 stream positions
# what the kernels' ``stamps`` hold (:func:`_launch`): a chunk's SM cycles of
# each phase, then counts (visited 1 or 0, pointer-jumping rounds, cover
# searches, the %globaltimer ns at which it published its exit); then a
# segment's SM cycles of each phase, then counts (windows, tags walked,
# resolve rounds, externals: 1 when it read bytes of the segment before, the
# %globaltimer ns of its flag)
CHAIN_STAMPS = ("staged", "jumped", "waited", "covers", "visited", "rounds", "searches",
                "published_ns")
SEG_STAMPS = ("entered", "parsed", "walked", "judged", "covered", "resolved", "waited", "written",
              "windows", "tags", "rounds", "externals", "published_ns")


def out_capacity(n: int, dst_len: int) -> int:
    """Bytes a stream of ``n`` bytes can produce under ``dst_len``."""
    return min(dst_len, (n // 3 + 1) * 64)


def _limits(n: int, dst_len: int) -> tuple[int, int]:
    if n >= 1 << 31 or not 0 <= dst_len < 1 << 40:
        raise ValueError("decode_stream takes streams below 2 GiB and limits below 2^40")
    return out_capacity(n, dst_len), max(1, -(-dst_len // SEG)) * SEG


def decode_stream(body, dst_len: int, device=None):
    """Decode one headerless stream into at most ``dst_len`` bytes.

    body: uint8[n] (bytes, array or tensor).  Returns (out uint8[cap],
    produced int64, status int64) on ``device`` (None = cuda).
    """
    dev = resolve_device(device)
    refuse_card_tensors(dev, body)
    body = _u8_tensor(body, dev).reshape(-1)
    cap, limit = _limits(body.numel(), dst_len)
    if dev.type == "cpu":
        return decode_plain(body, dst_len)
    return _launch(body, cap, limit)


def decompress_noheader_np(src, dst_len: int, device=None) -> tuple[np.ndarray, int, int]:
    """The JAX module's entry point: (out uint8[produced], produced, status)."""
    out, produced, status = decode_stream(src, dst_len, device)
    produced = int(produced)
    return out[:produced].cpu().numpy(), produced, int(status)


@functools.cache
def _kernel():
    launch, check = _build.kernel("decode_stream")
    vp = ctypes.c_void_p
    launch.argtypes = [vp, ctypes.c_longlong, vp, ctypes.c_longlong, ctypes.c_longlong, vp, vp,
                       vp, vp]
    return launch, check


def chunks(n: int) -> int:
    """Thread blocks of the chain kernel for a stream of ``n`` bytes."""
    return (n >> CHUNK_LOG) + 1


def segments(cap: int) -> int:
    """Thread blocks of the segment kernel for an output of ``cap`` bytes: one
    a 32 KiB segment, and one more that judges a tag starting at ``cap``."""
    return cap // SEG + 1


@functools.cache
def _work_fn():
    fn = _build.load("decode_stream").decode_stream_work_bytes
    fn.argtypes, fn.restype = [ctypes.c_longlong] * 2, ctypes.c_longlong
    return fn


def work_bytes(n: int, cap: int) -> int:
    """The workspace of one call, as ``csrc/decode_stream.cu`` lays it out
    and clears it (its ``decode_stream_work_bytes``): the heads, a word a
    chunk, 16 bytes a segment."""
    return _work_fn()(n, cap)


def stamp_count(n: int, cap: int) -> int:
    """int64 stamps of one call: ``len(CHAIN_STAMPS)`` a chunk, then
    ``len(SEG_STAMPS)`` a segment."""
    return chunks(n) * len(CHAIN_STAMPS) + segments(cap) * len(SEG_STAMPS)


def split_stamps(stamps, n: int, cap: int):
    """The stamps of one call as (chain int64[chunks, 8], segments int64[segments, 13]) on the host."""
    st = stamps.cpu().numpy()
    nc = chunks(n) * len(CHAIN_STAMPS)
    return (st[:nc].reshape(-1, len(CHAIN_STAMPS)), st[nc:].reshape(-1, len(SEG_STAMPS)))


def _launch(body: torch.Tensor, cap: int, limit: int, stamps=None):
    """Launch ``decode_stream.cu`` on torch's current stream and count it.

    One buffer holds meta, the output and the workspace; ``stamps``: None,
    or int64[:func:`stamp_count`] on the card for each block's phase cycles
    and counts.  The overrun limit is ``min(dst_len, cap) = cap``: no stream
    produces more than cap, and it bounds every write."""
    dev = body.device
    n = body.numel()
    if stamps is not None and (stamps.shape != (stamp_count(n, cap),) or stamps.dtype != torch.int64
                               or stamps.device != dev or not stamps.is_contiguous()):
        raise ValueError(f"stamps must be int64[{stamp_count(n, cap)}] on {dev}")
    meta, out, work = _carve(dev, (torch.int64, 2), (torch.uint8, max(cap, 1)),
                             (torch.uint8, work_bytes(n, cap)))
    launch, check = _kernel()
    args = (body.data_ptr(), n, out.data_ptr(), cap, limit, meta.data_ptr(), work.data_ptr(),
            None if stamps is None else stamps.data_ptr())
    if dev.index is None or dev.index == torch.cuda.current_device():
        rc = launch(*args, _stream(dev.index))
    else:                                           # operands on another card: launch there
        with torch.cuda.device(dev):
            rc = launch(*args, _stream(dev.index))
    check(rc)
    decode_stream.launches += 1
    return out[:cap], meta[0], meta[1]


def smem_bytes(kernel: int) -> int:
    """Dynamic shared memory a block of kernel 0 (the chain) or 1 (a segment) takes."""
    fn = _build.load("decode_stream").decode_stream_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    return fn(kernel)


decode_stream.launches = 0


# ------------------------------------------------------------ plain version


def decode_plain(body: torch.Tensor, dst_len: int):
    """Plain version of ``decode_stream.cu`` on a CPU tensor: a sequential
    decoder with the JAX kernel's envelope and event rules."""
    src = body.numpy().tobytes()
    n = len(src)
    cap, limit = _limits(n, dst_len)
    out = bytearray()
    ip, status = 0, E_OK
    while True:
        op = len(out)
        if ip == n:
            break                                   # consumed: the clean end
        if op >= limit:                             # exactly full at a segment end, tags left
            status = E_DATA_MALFORMED
            break
        tag = src[ip]
        kind = tag & 3
        if kind == wire.TAG_LITERAL:
            nb = max(0, (tag >> 2) - 59)
            if ip + 1 + nb > n or (nb == 4 and src[ip + 4] != 0):
                status = E_DATA_MALFORMED           # truncated, or a literal beyond 2^24
                break
            length = (int.from_bytes(src[ip + 1 : ip + 1 + nb], "little") if nb else tag >> 2) + 1
            hdr = 1 + nb
            if ip + hdr + length > n:
                status = E_DATA_MALFORMED
                break
        else:
            hdr = (0, 2, 3, 5)[kind]
            if ip + hdr > n:
                status = E_DATA_MALFORMED
                break
            length = ((tag >> 2) & 7) + wire.MIN_MATCH if kind == wire.TAG_COPY_1 else (tag >> 2) + 1
            if kind == wire.TAG_COPY_1:
                offset = ((tag >> 5) << 8) | src[ip + 1]
            else:
                offset = int.from_bytes(src[ip + 1 : ip + hdr], "little")
            if offset == 0 or offset > MAX_OFFSET or offset > op:
                status = E_DATA_MALFORMED
                break
        if op + length > dst_len:
            status = E_OUTPUT_OVERRUN
            break
        if kind == wire.TAG_LITERAL:
            out += src[ip + hdr : ip + hdr + length]
            ip += hdr + length
        else:
            start = op - offset
            out += (out[start:] * (length // offset + 1))[:length] if offset < length \
                else out[start : start + length]
            ip += hdr
    res = torch.zeros((cap,), dtype=torch.uint8)
    produced = len(out) if status == E_OK else 0
    if out:
        res[: len(out)] = torch.frombuffer(out, dtype=torch.uint8)
    return res, torch.tensor(produced), torch.tensor(status)
