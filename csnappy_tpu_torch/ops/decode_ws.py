"""Device-resident whole-stream decode: boundary scan, then the segment decoder.

Port of ``csnappy_tpu/ops/decode_ws.py``.  The stream goes to the card once
and stays there:

1. ``csrc/scan_segments.cu`` parses every position of the stream into a walk
   entry ``adv | prod << 16`` (the JAX module's ``_entries``) and finds the
   compressed offset of the tag that covers each 32 KiB output boundary (the
   JAX ``_scan_kernel``): a grid of chunks of ``2**CHUNK_LOG`` stream
   positions, each pointer-jumped in shared memory, whose exits are chained
   one lookup a chunk (the source's header says how);
2. the same launch writes the segment table: offsets, lengths and limits of
   the segments, clamped so that no segment reads outside the stream, and a
   small check vector;
3. ``csrc/decode_blocks.cu`` decodes every segment in one launch
   (``decode_fused._launch``, stream mode), in place in the stream, its
   ``produced`` and ``status`` written beside the check;
4. the check comes back to the host in one copy, then the bytes.

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
(:func:`entries`, :func:`scan_plain`, :func:`table_plain`,
``decode_fused.decode_plain``) do.  Nothing falls back from one to the
other: a failed launch raises.
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
from .primitives import _stream

SEG = wire.BLOCK_SIZE              # 32768 output bytes per segment
MAX_FAST_MB = 64                   # larger streams take the routed path
MAX_OUT = 128 << 20                # so do larger outputs
MAX_SEGMENT_WIDTH = 312 * 128      # the JAX pipeline's widest segment bucket (CI = 312 rows)
CHUNK_LOG = 13                     # 8,192 stream positions a thread block (PERF.md, the sweep)
CHUNK_LOGS = (12, 13, 14)          # the chunk sizes the kernel is built for
WORK_HEAD = 16                     # the workspace's head; then 8 bytes a chunk
# what the kernel's ``stamps`` hold a chunk (:func:`_launch`): the SM cycles
# of each phase, then counts (visited 1 or 0, pointer-jumping rounds, slot
# searches, and the %globaltimer ns at which the chunk published its exit)
PHASES = ("staged", "jumped", "waited", "slots", "table")
COUNTS = ("visited", "rounds", "searches", "published_ns")
STAMPS = len(PHASES) + len(COUNTS)


def chunks(n: int, chunk_log: int = CHUNK_LOG) -> int:
    """Thread blocks of a scan of ``n`` bytes: the chunks that hold positions 0 to n."""
    return (n >> chunk_log) + 1


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
    """The boundary scan of ``body`` (uint8[n], headerless).

    Returns (seg int32[nslot], meta int64[4]) on ``device``.  Each tag at
    stream position p with output start pp writes ``seg[ceil(pp / 32768)] =
    p``, and so does the position where the chain stops, last (the JAX walk
    stores on every step, its stalled ones too): ``seg[k]`` is the offset of
    the tag that covers output byte ``k * 32768``.  Slots from ``nslot - 1``
    on share the last one; unwritten slots hold ``n``.  ``meta = (p, pp, 0,
    count)``: where the chain stopped, then a count specific to each version:
    the chunks the chain visited on the card, the tags walked in
    :func:`scan_plain`."""
    dev = resolve_device(device)
    refuse_card_tensors(dev, body)
    body = _u8_tensor(body, dev).reshape(-1)
    if body.numel() >= 1 << 31 or nslot < 1:
        raise ValueError("scan_segments takes streams below 2 GiB and at least one slot")
    if dev.type == "cpu":
        return scan_plain(body, nslot)
    seg, meta, work = _carve(dev, (torch.int32, nslot), (torch.int64, 4), _work(body.numel()))
    _launch(body, seg, meta, work)
    return seg, meta


scan_segments.launches = 0


def _carve(dev, *parts):
    """Views of one new uint8 buffer on ``dev``, each (dtype, count) 16-byte aligned."""
    offs, at = [], 0
    for dt, count in parts:
        offs.append((at, count * dt.itemsize))
        at += (count * dt.itemsize + 15) & ~15
    buf = torch.empty((at,), dtype=torch.uint8, device=dev)
    return [buf[o : o + n].view(dt) for (dt, _), (o, n) in zip(parts, offs)]


def _work(n: int, chunk_log: int = CHUNK_LOG):
    """The workspace's (dtype, count) for a scan of ``n`` bytes: a head, then 8 bytes a chunk."""
    return torch.uint8, WORK_HEAD + 8 * chunks(n, chunk_log)


def _launch(body, seg, meta, work=None, table=None, dst_len: int = 0,
            chunk_log: int = CHUNK_LOG, stamps=None):
    """Launch ``scan_segments.cu`` on torch's current stream and count it on
    ``scan_segments.launches``.  All tensors are on the card: the flat
    stream, seg int32[nslot], meta int64[4]; ``work``: None (allocated
    here), or at least :func:`_work`'s bytes; ``table``: None, or the
    segment table's (offs int64[nseg], lens int32[nseg], dlims int32[nseg],
    check int64[3 + nseg]) for a stream of ``dst_len`` output bytes;
    ``chunk_log``: one of ``CHUNK_LOGS``; ``stamps``: None, or int64[chunks,
    STAMPS] on the card for each chunk's phase cycles and counts."""
    dev = body.device
    n = body.numel()
    if chunk_log not in CHUNK_LOGS:
        raise ValueError(f"chunk_log must be one of {CHUNK_LOGS}")
    if stamps is not None and (stamps.shape != (chunks(n, chunk_log), STAMPS)
                               or stamps.dtype != torch.int64 or stamps.device != dev
                               or not stamps.is_contiguous()):
        raise ValueError(f"stamps must be int64[{chunks(n, chunk_log)}, {STAMPS}] on {dev}")
    if work is None:
        (work,) = _carve(dev, _work(n, chunk_log))
    elif work.numel() < _work(n, chunk_log)[1]:
        raise ValueError("the workspace is too small for this chunk size")
    offs, lens, dlims, check = table if table is not None else (None,) * 4
    ptr = (lambda t: None if t is None else t.data_ptr())
    args = (body.data_ptr(), n, seg.data_ptr(), seg.numel(), meta.data_ptr(), work.data_ptr(),
            ptr(offs), ptr(lens), ptr(dlims), ptr(check), dst_len,
            0 if offs is None else offs.numel(), MAX_SEGMENT_WIDTH, chunk_log, ptr(stamps))
    launch, check_rc = _kernel()
    if dev.index is None or dev.index == torch.cuda.current_device():
        rc = launch(*args, _stream(dev.index))
    else:                                           # operands on another card: launch there
        with torch.cuda.device(dev):
            rc = launch(*args, _stream(dev.index))
    check_rc(rc)
    scan_segments.launches += 1


@functools.cache
def _kernel():
    launch, check = _build.kernel("scan_segments")
    vp = ctypes.c_void_p
    launch.argtypes = [vp, ctypes.c_longlong, vp, ctypes.c_int, vp, vp, vp, vp, vp, vp,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, vp, vp]
    return launch, check


def smem_bytes(chunk_log: int = CHUNK_LOG) -> int:
    """Dynamic shared memory a block of the scan takes at chunks of ``2**chunk_log``."""
    fn = _build.load("scan_segments").scan_segments_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    return fn(chunk_log)


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


def limits(nseg: int, dst_len: int) -> np.ndarray:
    """Each segment's output limit, ``clamp(dst_len - k * 32768, 1, 32768)``."""
    return np.clip(dst_len - np.arange(nseg, dtype=np.int64) * SEG, 1, SEG)


def table_plain(seg: torch.Tensor, n: int, nseg: int, dst_len: int):
    """Plain version of the scan kernel's segment table, from ``seg``: int64
    offsets clamped to [0, n], int32 lengths clamped to ``MAX_SEGMENT_WIDTH``,
    int32 limits, and the int64 widths (the check's tail)."""
    s = seg[:nseg].numpy().astype(np.int64)
    offs = s.clip(0, n)
    ends = np.append(s[1:], n).clip(max=n)
    widths = (ends - offs).clip(min=0)
    return (offs, widths.clip(max=MAX_SEGMENT_WIDTH).astype(np.int32),
            limits(nseg, dst_len).astype(np.int32), widths)


def decompress_noheader_ws(src, dst_len: int, device=None) -> bytes | None:
    """Whole-stream decode on the card: the decoded bytes when verified, else None."""
    dev = resolve_device(device)
    refuse_card_tensors(dev, src)
    n = src.numel() if isinstance(src, torch.Tensor) else len(src)
    nseg = plan(n, dst_len)
    if nseg is None:
        return None
    body = _u8_tensor(src, dev).reshape(-1)
    if dev.type == "cpu":
        seg, meta = scan_plain(body, nseg + 1)
        offs, lens, dlims, widths = table_plain(seg, n, nseg, dst_len)
        out, prod, status = decode_fused.decode_segments(body, offs, lens, dlims, dev)
        head, prod, status = meta[:3].tolist(), prod.numpy(), status.numpy()
    else:
        # one buffer: meta, the check (meta[:3], widths) with produced and
        # status behind it (one copy back), the table, seg, the workspace
        meta, check, offs, seg, lens, dlims, work = _carve(
            dev, (torch.int64, 4), (torch.int64, 3 + nseg + nseg), (torch.int64, nseg),
            (torch.int32, nseg + 1), (torch.int32, nseg), (torch.int32, nseg), _work(n))
        ps = check[3 + nseg :].view(torch.int32)
        _launch(body, seg, meta, work, (offs, lens, dlims, check[: 3 + nseg]), dst_len)
        out, _, _ = decode_fused._launch(decode_fused.decode_segments, body, offs, lens, dlims,
                                         SEG, outs=(ps[:nseg], ps[nseg:]))
        host = check.cpu().numpy()
        head, widths = host[:3].tolist(), host[3 : 3 + nseg]
        prod, status = host[3 + nseg :].view(np.int32).reshape(2, nseg)
    p_f, pp_f, bad = head
    if bad or p_f != n or pp_f != dst_len or bool((widths > MAX_SEGMENT_WIDTH).any()):
        return None
    if bool((status != 0).any()) or not np.array_equal(prod, limits(nseg, dst_len)):
        return None
    return out.reshape(-1)[:dst_len].cpu().numpy().tobytes()
