"""Executable format model — the codec oracle (own copy of ``csnappy_tpu/models/pymodel.py``).

Plays the role the reference's ``python/`` plays for its C code
(SURVEY.md C9/C10): an independent, readable implementation of the full
format used to validate every performance backend.  Not a performance path.

The compressor here is *exhaustive-greedy*: it tracks every previous
occurrence of each 4-byte window (a dict keyed by the window itself), so it
finds strictly more matches than the reference's lossy 16-bit hash table
(csnappy_compress.c:469-606) while emitting the identical tag grammar —
proof, like the reference's two Python matchers (pysnappy_compress.py:42-96),
that match-finder strategy is a free design axis.
"""
from __future__ import annotations

from ..errors import (
    E_DATA_MALFORMED,
    E_HEADER_BAD,
    E_INPUT_NOT_CONSUMED,
    E_OUTPUT_INSUF,
    E_OUTPUT_OVERRUN,
    SnappyError,
)
from . import wire

# ---------------------------------------------------------------- decode --


def get_uncompressed_length(src: bytes) -> tuple[int, int]:
    """Parse the varint preamble → (uncompressed_length, header_bytes)."""
    try:
        return wire.varint_decode(src)
    except ValueError as e:
        raise SnappyError(E_HEADER_BAD, str(e)) from None


def decompress_noheader(src: bytes, dst_len: int, strict_consume: bool = False) -> bytes:
    """Safely decode a headerless tag stream into at most ``dst_len`` bytes.

    Error contract mirrors csnappy_decompress_noheader
    (csnappy_decompress.c:319-387): never writes past ``dst_len``; offset 0 or
    beyond produced output ⇒ E_DATA_MALFORMED; truncated tags/payloads ⇒
    E_DATA_MALFORMED; output overflow ⇒ E_OUTPUT_OVERRUN.

    ``strict_consume`` enables the reference *Python model's* stricter
    header-mode contract (pysnappy_decompress.py:57-60, the only place the
    reference makes CSNAPPY_E_INPUT_NOT_CONSUMED reachable): when the output
    is already exactly full and further input tags remain, that is
    E_INPUT_NOT_CONSUMED rather than E_OUTPUT_OVERRUN.
    """
    out = bytearray()
    i, n = 0, len(src)
    while i < n:
        if strict_consume and len(out) == dst_len:
            raise SnappyError(
                E_INPUT_NOT_CONSUMED, f"{n - i} input bytes remain after output filled"
            )
        op = src[i]
        kind = op & 3
        if kind == wire.TAG_LITERAL:
            u = op >> 2
            if u < wire.LITERAL_INLINE_MAX:
                length = u + 1
                i += 1
            else:
                extra = u - 59
                if i + 1 + extra > n:
                    raise SnappyError(E_DATA_MALFORMED, "literal length trailer truncated")
                length = int.from_bytes(src[i + 1 : i + 1 + extra], "little") + 1
                i += 1 + extra
            if i + length > n:
                raise SnappyError(E_DATA_MALFORMED, "literal payload truncated")
            if len(out) + length > dst_len:
                raise SnappyError(E_OUTPUT_OVERRUN)
            out += src[i : i + length]
            i += length
        else:
            if kind == wire.TAG_COPY_1:
                if i + 2 > n:
                    raise SnappyError(E_DATA_MALFORMED, "copy1 trailer truncated")
                length = ((op >> 2) & 7) + wire.MIN_MATCH
                offset = ((op >> 5) << 8) | src[i + 1]
                i += 2
            elif kind == wire.TAG_COPY_2:
                if i + 3 > n:
                    raise SnappyError(E_DATA_MALFORMED, "copy2 trailer truncated")
                length = (op >> 2) + 1
                offset = int.from_bytes(src[i + 1 : i + 3], "little")
                i += 3
            else:
                if i + 5 > n:
                    raise SnappyError(E_DATA_MALFORMED, "copy4 trailer truncated")
                length = (op >> 2) + 1
                offset = int.from_bytes(src[i + 1 : i + 5], "little")
                i += 5
            if offset == 0 or offset > len(out):
                raise SnappyError(E_DATA_MALFORMED, f"bad offset {offset} at out={len(out)}")
            if len(out) + length > dst_len:
                raise SnappyError(E_OUTPUT_OVERRUN)
            # byte j reads out[start + j % offset]: with overlap (offset <
            # length) the last ``offset`` bytes repeat
            start = len(out) - offset
            if offset >= length:
                out += out[start : start + length]
            else:
                out += (out[start:] * (length // offset + 1))[:length]
    return bytes(out)


def decompress_stream(src, write, dst_len: int, window: int = wire.BLOCK_SIZE):
    """Streaming decode with a bounded history ring — O(window) memory.

    The resumable-decode model (SURVEY.md \u00a75 checkpoint/resume): decodes
    the headerless tag stream, emitting output through ``write(bytes)``
    while keeping only the last ``window`` bytes of history, like the
    reference Python model's 9-page ring (python/OutputBuffer.py:4-12,
    57-86).  Valid for streams whose offsets never exceed ``window`` (all
    reference-encoder streams: kBlockLog=15, csnappy_compress.c:75-86).
    Returns the number of bytes produced; error contract as
    :func:`decompress_noheader`.
    """
    ring = bytearray()
    produced = 0
    i, n = 0, len(src)

    def emit(chunk: bytes):
        nonlocal ring, produced
        write(bytes(chunk))
        produced += len(chunk)
        ring += chunk
        if len(ring) > window:
            del ring[: len(ring) - window]

    while i < n:
        op = src[i]
        kind = op & 3
        if kind == wire.TAG_LITERAL:
            u = op >> 2
            if u < wire.LITERAL_INLINE_MAX:
                length = u + 1
                i += 1
            else:
                extra = u - 59
                if i + 1 + extra > n:
                    raise SnappyError(E_DATA_MALFORMED, "literal length trailer truncated")
                length = int.from_bytes(src[i + 1 : i + 1 + extra], "little") + 1
                i += 1 + extra
            if i + length > n:
                raise SnappyError(E_DATA_MALFORMED, "literal payload truncated")
            if produced + length > dst_len:
                raise SnappyError(E_OUTPUT_OVERRUN)
            emit(src[i : i + length])
            i += length
        else:
            if kind == wire.TAG_COPY_1:
                if i + 2 > n:
                    raise SnappyError(E_DATA_MALFORMED, "copy1 trailer truncated")
                length = ((op >> 2) & 7) + wire.MIN_MATCH
                offset = ((op >> 5) << 8) | src[i + 1]
                i += 2
            elif kind == wire.TAG_COPY_2:
                if i + 3 > n:
                    raise SnappyError(E_DATA_MALFORMED, "copy2 trailer truncated")
                length = (op >> 2) + 1
                offset = int.from_bytes(src[i + 1 : i + 3], "little")
                i += 3
            else:
                if i + 5 > n:
                    raise SnappyError(E_DATA_MALFORMED, "copy4 trailer truncated")
                length = (op >> 2) + 1
                offset = int.from_bytes(src[i + 1 : i + 5], "little")
                i += 5
            if offset == 0 or offset > produced:
                raise SnappyError(E_DATA_MALFORMED, f"bad offset {offset} at out={produced}")
            if offset > len(ring):
                raise SnappyError(
                    E_DATA_MALFORMED, f"offset {offset} beyond {len(ring)}-byte window"
                )
            if produced + length > dst_len:
                raise SnappyError(E_OUTPUT_OVERRUN)
            chunk = bytearray()
            base = len(ring) - offset
            for c in range(length):  # byte-wise: handles overlap (offset < length)
                chunk.append(ring[base + c] if c < offset else chunk[c - offset])
            emit(chunk)
    return produced


def decompress(src: bytes, dst_len: int | None = None) -> bytes:
    """Whole-stream decode: header parse + DoS guard + noheader decode
    (csnappy_decompress.c:394-411 semantics)."""
    ulen, hdr = get_uncompressed_length(src)
    if dst_len is None:
        dst_len = ulen
    if ulen > dst_len:
        raise SnappyError(E_OUTPUT_INSUF, f"header says {ulen}, buffer {dst_len}")
    out = decompress_noheader(src[hdr:], ulen, strict_consume=True)
    if len(out) != ulen:
        raise SnappyError(E_DATA_MALFORMED, f"stream produced {len(out)}, header said {ulen}")
    return out


# -------------------------------------------------------------- encode --


def compress_fragment(data: bytes) -> bytes:
    """Greedy-compress one fragment (≤ 32 KiB) with an exhaustive match index.

    All offsets stay inside the fragment, preserving the block-independence
    property (csnappy_compress.c:75-87).
    """
    n = len(data)
    if n > wire.BLOCK_SIZE:
        raise ValueError("fragment larger than 32 KiB")
    out = bytearray()
    if n == 0:
        return bytes(out)
    index: dict[bytes, int] = {}
    i, next_emit = 0, 0
    while i + wire.MIN_MATCH <= n:
        window = data[i : i + 4]
        cand = index.get(window)
        index[window] = i
        if cand is None:
            i += 1
            continue
        # extend the match (source may overlap destination — plain indexing is
        # correct because cand < i)
        ml = 4
        while i + ml < n and data[cand + ml] == data[i + ml]:
            ml += 1
        wire.emit_literal(out, data[next_emit:i])
        wire.emit_copy(out, i - cand, ml)
        # index every covered position so later matches can land inside
        for j in range(i + 1, min(i + ml, n - 3)):
            index[data[j : j + 4]] = j
        i += ml
        next_emit = i
    wire.emit_literal(out, data[next_emit:n])
    return bytes(out)


def compress_fragment_table(data: bytes, table_bits: int = 12) -> bytes:
    """Second, independent in-model match-finder: a lossy 2^table_bits
    single-probe hash table (the reference model ships the same pair —
    exhaustive dict vs lossy table, pysnappy_compress.py:42-96 — proving
    that ANY match strategy emits a conformant stream,
    csnappy_compress.c:221-227).  Collisions silently drop older
    candidates, exactly like the C encoder's table (csnappy_compress.c:
    535-551); the hash is the reference's multiplier (:228-232).
    """
    n = len(data)
    if n > wire.BLOCK_SIZE:
        raise ValueError("fragment larger than 32 KiB")
    out = bytearray()
    if n == 0:
        return bytes(out)
    shift = 32 - table_bits
    table = [-1] * (1 << table_bits)
    i, next_emit = 0, 0
    while i + wire.MIN_MATCH <= n:
        w = int.from_bytes(data[i : i + 4], "little")
        h = ((w * 0x1E35A7BD) & 0xFFFFFFFF) >> shift
        cand = table[h]
        table[h] = i
        if cand < 0 or data[cand : cand + 4] != data[i : i + 4]:
            i += 1
            continue
        ml = 4
        while i + ml < n and data[cand + ml] == data[i + ml]:
            ml += 1
        wire.emit_literal(out, data[next_emit:i])
        wire.emit_copy(out, i - cand, ml)
        i += ml
        next_emit = i
    wire.emit_literal(out, data[next_emit:n])
    return bytes(out)


def compress(data: bytes, block_size: int = wire.BLOCK_SIZE) -> bytes:
    """Whole-stream encode: varint preamble + independent ≤32 KiB fragments
    (csnappy_compress.c:621-656 semantics)."""
    out = bytearray(wire.varint_encode(len(data)))
    for start in range(0, len(data), block_size):
        out += compress_fragment(data[start : start + block_size])
    return bytes(out)
