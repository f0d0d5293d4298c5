"""Device-resident whole-stream decode: boundary scan, then the segment decoder.

Port of ``csnappy_tpu/ops/decode_ws.py``.  The stream goes to the card once
and stays there:

1. ``csrc/scan_segments.cu`` parses every position of the stream into a walk
   entry ``adv | prod << 16`` (the JAX module's ``_entries``) and walks the
   tag chain once, recording the compressed offset of the tag that covers
   each 32 KiB output boundary (the JAX ``_scan_kernel``);
2. offsets, lengths and limits of the segments are computed from that with
   tensor ops on the card, clamped so that no segment reads outside the
   stream;
3. ``csrc/decode_blocks.cu`` decodes every segment in one launch
   (``decode_fused._launch``, stream mode), in place in the stream;
4. the small verification tensors come back to the host in one copy.

The contract is the JAX module's: bytes only when verified, else None.
:func:`decompress_noheader_ws` returns the decoded bytes only when the scan
consumed the stream exactly (``p_final == len``, ``pp_final == dst_len``),
no segment is wider than ``MAX_SEGMENT_WIDTH`` compressed bytes, and every
segment decoded with status 0 and exactly ``min(32768, dst_len - k * 32768)``
bytes; otherwise None, and the caller decodes on the exact-error path.  It
serves the streams a 32 KiB fragment encoder emits; a tag across a boundary
leaves its segment short, a copy into a prior segment fails the decoder's
offset check, so those give None, never wrong bytes.

On a CUDA tensor the kernels run; on a CPU tensor the plain versions
(:func:`entries`, :func:`scan_plain`, ``decode_fused.decode_plain``) do.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..config import refuse_card_tensors, resolve_device
from ..models import wire
from . import _build, decode_fused
from .decode_fused import _u8_tensor

SEG = wire.BLOCK_SIZE              # 32768 output bytes per segment
MAX_FAST_MB = 64                   # larger streams take the routed path
MAX_OUT = 128 << 20                # so do larger outputs
MAX_SEGMENT_WIDTH = 312 * 128      # the JAX pipeline's widest segment bucket (CI = 312 rows)


def plan(src_len: int, dst_len: int) -> int | None:
    """Segments of a stream in this path's envelope, or None (the JAX
    ``plan``'s envelope: at least 2 segments, <= 64 MiB in, <= 128 MiB out)."""
    nseg = -(-dst_len // SEG)
    if nseg < 2 or src_len < 2 or src_len > MAX_FAST_MB << 20 or dst_len > MAX_OUT:
        return None
    return nseg


def entries(body: torch.Tensor) -> torch.Tensor:
    """Walk entries of every position of ``body`` (uint8[n]): ``adv | prod << 16``
    as int32, 0 where no tag of a segmentable stream can start (past the end,
    truncated, a literal above 32 KiB, ``prod > SEG`` or ``adv > SEG + 5``).
    ``prod == SEG`` packs as bit 31, a negative int32, as in the JAX module."""
    n = body.numel()
    b = torch.cat([body.to(torch.int32), body.new_zeros(4, dtype=torch.int32)])
    b0, b1, b2, b3, b4 = (b[k : k + n] for k in range(5))
    kind = b0 & 3
    u = b0 >> 2
    islit = kind == wire.TAG_LITERAL
    extra = (u - 59).clamp(0, 4)
    t2 = b1 | (b2 << 8)
    t3 = t2 | (b3 << 16)
    tr = torch.where(extra == 0, 0, torch.where(extra == 1, b1, torch.where(extra == 2, t2, t3)))
    lit_len = torch.where(u >= 60, tr + 1, u + 1)
    lit_bad = islit & (u >= 60) & (((extra == 4) & (b4 > 0)) | (tr + 1 > SEG))
    hdr = torch.where(islit, 1 + extra, torch.where(
        kind == wire.TAG_COPY_1, 2, torch.where(kind == wire.TAG_COPY_2, 3, 5)).to(torch.int32))
    prod = torch.where(islit, lit_len,
                       torch.where(kind == wire.TAG_COPY_1, (u & 7) + wire.MIN_MATCH, u + 1))
    adv = hdr + torch.where(islit, lit_len, 0)
    pos = torch.arange(n, dtype=torch.int32, device=body.device)
    valid = (pos + adv <= n) & ~lit_bad & (prod <= SEG) & (adv <= SEG + 5)
    return torch.where(valid, adv | (prod << 16), 0)


def scan_segments(body, nslot: int, device=None):
    """One walk of the tag chain of ``body`` (uint8[n], headerless).

    Returns (seg int32[nslot], meta int64[4]) on ``device``.  Each tag at
    stream position p with output start pp writes ``seg[ceil(pp / 32768)] =
    p``, and so does the position where the walk stops, last (the JAX walk
    stores on every step, its stalled ones too): ``seg[k]`` is the offset of
    the tag that covers output byte ``k * 32768``.  Slots from ``nslot - 1``
    on share the last one; unwritten slots hold ``n``.  ``meta = (p, pp, 0,
    steps)``: where the walk stopped, and its number of steps (specific to
    each version)."""
    dev = resolve_device(device)
    refuse_card_tensors(dev, body)
    body = _u8_tensor(body, dev).reshape(-1)
    if body.numel() >= 1 << 31 or nslot < 1:
        raise ValueError("scan_segments takes streams below 2 GiB and at least one slot")
    if dev.type == "cpu":
        return scan_plain(body, nslot)
    seg = torch.empty((nslot,), dtype=torch.int32, device=dev)
    meta = torch.empty((4,), dtype=torch.int64, device=dev)
    launch, check = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        check(launch(body.data_ptr(), body.numel(), seg.data_ptr(), nslot, meta.data_ptr(), stream))
    scan_segments.launches += 1
    return seg, meta


scan_segments.launches = 0


@functools.cache
def _kernel():
    launch, check = _build.kernel("scan_segments")
    vp = ctypes.c_void_p
    launch.argtypes = [vp, ctypes.c_longlong, vp, ctypes.c_int, vp, vp]
    return launch, check


def scan_plain(body: torch.Tensor, nslot: int):
    """Plain version of ``scan_segments.cu``: a sequential walk over :func:`entries`."""
    ent = entries(body).numpy().view(np.uint32)
    n = len(ent)
    seg = np.full(nslot, n, np.int32)
    p = pp = steps = 0
    while True:
        seg[min((pp + SEG - 1) >> 15, nslot - 1)] = p
        if p >= n or not ent[p]:
            break
        e = int(ent[p])
        p += e & 0xFFFF
        pp += e >> 16
        steps += 1
    return torch.from_numpy(seg), torch.tensor([p, pp, 0, steps], dtype=torch.int64)


def decompress_noheader_ws(src, dst_len: int, device=None) -> bytes | None:
    """Whole-stream decode on the card: the decoded bytes when verified, else None."""
    dev = resolve_device(device)
    refuse_card_tensors(dev, src)
    n = src.numel() if isinstance(src, torch.Tensor) else len(src)
    nseg = plan(n, dst_len)
    if nseg is None:
        return None
    body = _u8_tensor(src, dev).reshape(-1)
    seg, meta = scan_segments(body, nseg + 1, dev)
    offs = seg[:nseg].long().clamp(0, n)
    ends = torch.cat([seg[1:nseg].long(), offs.new_full((1,), n)]).clamp(max=n)
    widths = (ends - offs).clamp(min=0)
    k = torch.arange(nseg, dtype=torch.int64, device=dev)
    dlims = (dst_len - k * SEG).clamp(1, SEG)
    lens = widths.clamp(max=MAX_SEGMENT_WIDTH)
    if dev.type == "cpu":
        out, prod, status = decode_fused.decode_segments(body, offs.numpy(), lens.numpy(),
                                                         dlims.numpy(), dev)
    else:
        out, prod, status = decode_fused._launch(decode_fused.decode_segments, body, offs,
                                                 lens.int(), dlims.int(), SEG)
    check = torch.cat([meta[:3], widths, prod.long(), status.long()]).cpu()
    p_f, pp_f, bad = check[:3].tolist()
    widths, prod, status = check[3:].split(nseg)
    if bad or p_f != n or pp_f != dst_len or bool((widths > MAX_SEGMENT_WIDTH).any()):
        return None
    if bool((status != 0).any()) or not torch.equal(prod, dlims.cpu()):
        return None
    return out.reshape(-1)[:dst_len].cpu().numpy().tobytes()
