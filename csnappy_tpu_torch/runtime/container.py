"""Paged block container — the reference's block_compressor capability (C8).

Port of ``csnappy_tpu/runtime/container.py``, with the same bytes, stats and
errors.  Container layout (block_compressor.c:298-333): ``u32 nr_pages``,
then a ``u32[nr_pages]`` length table, then the concatenated per-page
payloads.  The length table doubles as the random-access index: any page can
be located and decoded on its own.

Rules mirrored from the reference:
  * raw fallback — a page whose compressed form is not smaller is stored
    uncompressed (block_compressor.c:315-324, 378-383).  A full raw page is
    marked by ``len == page_size``, as in the reference; a raw *tail* page
    (shorter than page_size) carries the ``RAW_BIT`` high bit on its length
    entry, since an incompressible 4093-4095-byte tail can compress to
    exactly page_size bytes and would otherwise be ambiguous.  Every stored
    *compressed* length is < ilen <= page_size, so the markers cannot collide
    with a compressed page.
  * per-page codec behind a vtable (struct compressor_funcs,
    block_compressor.c:233-249): "snappy" (the block codec's kernels, batched,
    on ``device``) and "zlib" (stdlib, host); "lzo" is gated out.
  * codec-only timing and a compressibility histogram
    (block_compressor.c:251-268, 341-344).

The snappy arm is the serving path: every page of a chunk in one
``encode_blocks`` launch over ``[pages, page_size]`` and one
``decode_blocks`` launch with ``block_out = page_size``.  A chunk holds at
most :data:`MAX_PAGES_PER_LAUNCH` pages, which bounds each of the encoder
prep's int64 intermediates to 8,192 x 4,096 x 8 B = 256 MiB at 4 KiB pages;
this is a shape policy, like the JAX package's bucketing, not semantics.  The
per-page bookkeeping (raw fallback, length table, payload assembly,
histogram) is array code, byte-identical to the JAX container's per-page
loop.  ``codec_seconds`` counts the kernel calls only, with the card
synchronised before each clock read; uploads, downloads and assembly are host
time.
"""
from __future__ import annotations

import time
import zlib
from dataclasses import dataclass, field

import numpy as np
import torch

from ..config import resolve_device
from ..errors import E_DATA_MALFORMED, SnappyError
from ..models import wire

RAW_BIT = 1 << 31  # length-table flag: raw tail page, true length in low bits
MAX_PAGES_PER_LAUNCH = 8192


@dataclass
class BlockStats:
    """Reference's histogram + codec timing (block_compressor.c:341-344)."""

    nr_pages: int = 0
    bytes_in: int = 0
    bytes_out: int = 0
    codec_seconds: float = 0.0
    # buckets: expanded (>100%), >50%, <=50% — same three as the reference
    histogram: list[int] = field(default_factory=lambda: [0, 0, 0])

    def account(self, ilen: int, olen: int) -> None:
        self.account_pages(np.array([ilen]), np.array([olen]))

    def account_pages(self, ilen: np.ndarray, olen: np.ndarray) -> None:
        """:meth:`account` for every (ilen[i], olen[i]) pair at once."""
        ilen, olen = np.asarray(ilen, np.int64), np.asarray(olen, np.int64)
        self.nr_pages += len(ilen)
        self.bytes_in += int(ilen.sum())
        self.bytes_out += int(olen.sum())
        expanded = olen >= ilen
        half = ~expanded & (2 * olen > ilen)
        self.histogram[0] += int(expanded.sum())
        self.histogram[1] += int(half.sum())
        self.histogram[2] += int((~expanded & ~half).sum())


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _compact(rows: torch.Tensor, lens: np.ndarray) -> bytes:
    """``rows[i, :lens[i]]`` concatenated (runtime/native.compact)."""
    from . import native

    width = int(lens.max()) if len(lens) else 0
    return native.compact(rows[:, :width].cpu().numpy(), lens)


def _gather_rows(src: torch.Tensor, offs: np.ndarray, lens: np.ndarray, width: int) -> torch.Tensor:
    """uint8[len(offs), width]: row i = src[offs[i] : offs[i] + lens[i]], zero-padded."""
    dev = src.device
    col = torch.arange(width, device=dev)
    o = torch.from_numpy(np.asarray(offs, np.int64)).to(dev)
    n = torch.from_numpy(np.asarray(lens, np.int64)).to(dev)
    idx = (o[:, None] + col).clamp_(max=src.numel() - 1)   # a container holds >= 4 bytes
    return torch.where(col < n[:, None], src[idx], 0)


def _snappy_compress(buf: np.ndarray, page_size: int, dev: torch.device, stats: BlockStats):
    """(length table, payload) of the snappy arm."""
    from ..ops import encode_fused

    if page_size > wire.BLOCK_SIZE:
        # the block encoder takes at most 32 KiB; the JAX container at a
        # larger page returns a container that does not decode to its input
        raise ValueError(f"snappy pages are at most {wire.BLOCK_SIZE} bytes, not {page_size}")

    n = len(buf)
    nr = (n + page_size - 1) // page_size
    ilen = np.full((nr,), page_size, np.int64)
    if nr:
        ilen[-1] = n - (nr - 1) * page_size
    padded = np.zeros((nr * page_size,), np.uint8)
    padded[:n] = buf
    olen = np.zeros((nr,), np.int64)
    payload = []
    for s in range(0, nr, MAX_PAGES_PER_LAUNCH):
        e = min(nr, s + MAX_PAGES_PER_LAUNCH)
        pages = torch.from_numpy(padded[s * page_size : e * page_size]).reshape(e - s, page_size)
        pages = pages.to(dev)
        lens = ilen[s:e].astype(np.int32)
        _sync(dev)
        t0 = time.perf_counter()
        comp, clens = encode_fused.encode_blocks(pages, lens, device=dev)
        _sync(dev)
        stats.codec_seconds += time.perf_counter() - t0
        olen[s:e] = clens.cpu().numpy()
        raw = olen[s:e] >= ilen[s:e]      # raw fallback (block_compressor.c:315-324)
        rows = torch.where(torch.from_numpy(raw).to(dev)[:, None], pages, comp[:, :page_size])
        payload.append(_compact(rows, np.where(raw, ilen[s:e], olen[s:e])))
    stats.account_pages(ilen, olen)
    raw = olen >= ilen
    table = np.where(raw, np.where(ilen == page_size, page_size, RAW_BIT | ilen), olen)
    return table, b"".join(payload)


def compress_blocks(data: bytes, page_size: int = 4096, codec: str = "snappy",
                    device=None) -> tuple[bytes, BlockStats]:
    """Compress ``data`` page-by-page into the container format.

    ``device`` (None = cuda) is where the snappy arm's kernels run; ``"cpu"``
    runs their plain versions.  zlib is host code whatever ``device`` says.
    """
    stats = BlockStats()
    n = len(data)
    nr = (n + page_size - 1) // page_size
    head = np.array([nr], "<u4").tobytes()

    if codec == "snappy":
        table, payload = _snappy_compress(np.frombuffer(data, np.uint8), page_size,
                                          resolve_device(device), stats)
    elif codec == "zlib":
        table = np.zeros((nr,), np.int64)
        parts = []
        for i in range(nr):
            page = data[i * page_size : (i + 1) * page_size]
            t0 = time.perf_counter()
            c = zlib.compress(page, 6)
            stats.codec_seconds += time.perf_counter() - t0
            stats.account(len(page), len(c))
            if len(c) >= len(page):
                table[i] = page_size if len(page) == page_size else (RAW_BIT | len(page))
                parts.append(page)
            else:
                table[i] = len(c)
                parts.append(c)
        payload = b"".join(parts)
    else:
        if codec == "lzo":
            raise ValueError(
                "codec 'lzo' is gated out: no liblzo2/python-lzo binding in "
                "this environment (the reference's block_compressor.c:233-249 "
                "vtable has snappy|lzo|zlib; snappy and zlib are available)"
            )
        raise ValueError(f"unknown codec {codec!r} (available: snappy, zlib)")
    return head + table.astype("<u4").tobytes() + payload, stats


def decompress_blocks(container: bytes, page_size: int = 4096, codec: str = "snappy",
                      device=None) -> tuple[bytes, BlockStats]:
    """Inverse of :func:`compress_blocks` (block_compressor.c:348-394)."""
    stats = BlockStats()
    if len(container) < 4:
        raise SnappyError(E_DATA_MALFORMED, "container too short")
    nr = int(np.frombuffer(container, "<u4", count=1)[0])
    table_end = 4 + 4 * nr
    if len(container) < table_end:
        raise SnappyError(E_DATA_MALFORMED, "length table truncated")
    raw_lens = np.frombuffer(container, "<u4", count=nr, offset=4)
    raw_mask = (raw_lens == page_size) | (raw_lens & RAW_BIT > 0)
    lens = (raw_lens & ~np.uint32(RAW_BIT)).astype(np.int64)
    if (lens > page_size).any():
        raise SnappyError(E_DATA_MALFORMED, "length entry exceeds page size")
    offs = np.concatenate([[0], np.cumsum(lens)]) + table_end
    if offs[-1] > len(container):
        raise SnappyError(E_DATA_MALFORMED, "payload truncated")

    if codec == "snappy":
        out = _snappy_decompress(container, page_size, raw_mask, lens, offs[:-1],
                                 resolve_device(device), stats)
    elif codec == "zlib":
        parts = []
        for i in range(nr):
            seg = container[offs[i] : offs[i] + lens[i]]
            if raw_mask[i]:
                parts.append(seg)
            else:
                t0 = time.perf_counter()
                parts.append(zlib.decompress(bytes(seg)))
                stats.codec_seconds += time.perf_counter() - t0
        out = b"".join(parts)
    else:
        if codec == "lzo":
            raise ValueError(
                "codec 'lzo' is gated out: no liblzo2/python-lzo binding in "
                "this environment"
            )
        raise ValueError(f"unknown codec {codec!r}")
    return out, stats


def _snappy_decompress(container: bytes, page_size: int, raw_mask: np.ndarray,
                       lens: np.ndarray, offs: np.ndarray, dev: torch.device,
                       stats: BlockStats) -> bytes:
    """The snappy arm: compressed pages decode on ``dev`` in chunks, in page
    order; the first failing page's status raises before any output."""
    from ..ops import decode_fused

    src = torch.frombuffer(bytearray(container), dtype=torch.uint8).to(dev)
    comp_idx = np.nonzero(~raw_mask)[0]
    dec, produced = [], np.zeros((len(comp_idx),), np.int64)
    for s in range(0, len(comp_idx), MAX_PAGES_PER_LAUNCH):
        idx = comp_idx[s : s + MAX_PAGES_PER_LAUNCH]
        width = (int(lens[idx].max()) + 127) // 128 * 128
        batch = _gather_rows(src, offs[idx], lens[idx], max(width, 128))
        _sync(dev)
        t0 = time.perf_counter()
        out, prod, status = decode_fused.decode_blocks(batch, lens[idx], page_size, device=dev)
        _sync(dev)
        stats.codec_seconds += time.perf_counter() - t0
        status = status.cpu().numpy()
        bad = status[status != 0]
        if bad.size:
            raise SnappyError(int(bad[0]), "page decode failed")
        dec.append(out)
        produced[s : s + len(idx)] = prod.cpu().numpy()
    # every page's row in page order: raw pages straight from the container
    rows = torch.zeros((len(lens), page_size), dtype=torch.uint8, device=dev)
    if dec:
        rows[torch.from_numpy(comp_idx).to(dev)] = torch.cat(dec)
    raw_idx = np.nonzero(raw_mask)[0]
    if raw_idx.size:
        rows[torch.from_numpy(raw_idx).to(dev)] = _gather_rows(
            src, offs[raw_idx], lens[raw_idx], page_size)
    out_lens = lens.copy()
    out_lens[comp_idx] = produced
    stats.account_pages(out_lens, lens)
    return _compact(rows, out_lens)
