"""Snappy wire format — the L1 contract, as code (own copy of ``csnappy_tpu/models/wire.py``).

This module is the single source of truth for the byte-level format shared by
every backend (Python oracle, XLA/Pallas kernels, C++ host runtime).  It
matches the format implemented by the reference (tag enum
csnappy_internal.h:151-156; varint csnappy_compress.c:46-73 /
csnappy_decompress.c:45-71; opcode table csnappy_decompress.c:152-185) but is
written from the public format spec — constants and arithmetic, no code reuse.

Format summary
--------------
A *stream* is ``varint32(uncompressed_length) || tag-stream``.  A headerless
*fragment* is just the tag-stream.  Each tag starts with one opcode byte whose
low 2 bits select the element kind:

* ``00`` LITERAL — upper 6 bits ``u``:  if ``u < 60`` the literal length is
  ``u + 1``; else ``u - 59`` (1..4) little-endian trailer bytes hold
  ``length - 1``.  Payload bytes follow inline.
* ``01`` COPY_1 — length ``((op >> 2) & 7) + 4`` (4..11), offset is 11 bits:
  ``(op >> 5) << 8 | trailer[0]`` (0..2047), 1 trailer byte.
* ``10`` COPY_2 — length ``(op >> 2) + 1`` (1..64), offset = 2-byte LE
  trailer (0..65535).
* ``11`` COPY_4 — length ``(op >> 2) + 1`` (1..64), offset = 4-byte LE
  trailer.  Decoders must accept it; our encoder (like the reference's,
  csnappy_compress.c:395-415) never emits it.

A conformant *encoder* additionally guarantees no copy offset reaches back
across a 32 KiB block boundary (kBlockLog, csnappy_compress.c:75-87) — the
property all block parallelism hangs off.
"""
from __future__ import annotations

import numpy as np

# --- tag kinds (low 2 bits of the opcode byte) ---
TAG_LITERAL = 0
TAG_COPY_1 = 1
TAG_COPY_2 = 2
TAG_COPY_4 = 3

BLOCK_LOG = 15
BLOCK_SIZE = 1 << BLOCK_LOG          # 32 KiB — max fragment length / max offset
MAX_VARINT32_BYTES = 5

# Emitter limits (shared by all encoder backends, for reference parity).
MAX_COPY_LEN = 64                     # COPY_2 length field ceiling
MIN_MATCH = 4                         # shortest emittable back-reference
COPY1_MAX_LEN = 11                    # len < 12 fits COPY_1
COPY1_MAX_OFFSET = 1 << 11            # offset < 2048 fits COPY_1
LITERAL_INLINE_MAX = 60               # u < 60 ⇒ inline length

HASH_MULTIPLIER = 0x1E35A7BD          # free choice; kept for comparability
                                      # (csnappy_compress.c:228-232)


def max_compressed_length(n: int) -> int:
    """Worst-case compressed size of ``n`` input bytes (csnappy.h:30-31 contract)."""
    return 32 + n + n // 6


# --- varint32 ------------------------------------------------------------

def varint_encode(value: int) -> bytes:
    if value < 0 or value >= 1 << 32:
        raise ValueError("varint32 out of range")
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        out.append(b | (0x80 if value else 0))
        if not value:
            return bytes(out)


def varint_decode(buf: bytes, pos: int = 0) -> tuple[int, int]:
    """Return (value, bytes_consumed).  Raises ValueError on a bad header.

    Accepts at most 5 bytes and rejects shift overflow, like
    csnappy_get_uncompressed_length (csnappy_decompress.c:45-71).
    """
    result = 0
    for i in range(MAX_VARINT32_BYTES):
        if pos + i >= len(buf):
            raise ValueError("varint truncated")
        b = buf[pos + i]
        result |= (b & 0x7F) << (7 * i)
        if not b & 0x80:
            if result >= 1 << 32:
                raise ValueError("varint overflows 32 bits")
            return result, i + 1
    raise ValueError("varint longer than 5 bytes")


# --- opcode table ---------------------------------------------------------
# Per-opcode (base_length, trailer_bytes, inline_literal, offset_high_bits):
# regenerated arithmetically; semantically equivalent to the reference's
# char_table (csnappy_decompress.c:152-185) but derived, not transcribed.

def make_opcode_table() -> np.ndarray:
    """(256, 4) int32 table: [length, n_trailer, is_literal, offset_hi].

    * LITERAL u<60:  length=u+1, n_trailer=0
    * LITERAL u>=60: length=0 (from trailer), n_trailer=u-59
    * COPY_1: length=((u)&7)+4, n_trailer=1, offset_hi=(u>>3)<<8
    * COPY_2/4: length=u+1, n_trailer=2/4
    """
    table = np.zeros((256, 4), dtype=np.int32)
    for op in range(256):
        kind = op & 3
        u = op >> 2
        if kind == TAG_LITERAL:
            if u < LITERAL_INLINE_MAX:
                table[op] = (u + 1, 0, 1, 0)
            else:
                table[op] = (0, u - 59, 1, 0)
        elif kind == TAG_COPY_1:
            table[op] = ((u & 7) + MIN_MATCH, 1, 0, (u >> 3) << 8)
        elif kind == TAG_COPY_2:
            table[op] = (u + 1, 2, 0, 0)
        else:
            table[op] = (u + 1, 4, 0, 0)
    return table


OPCODE_TABLE = make_opcode_table()


# --- tag emission helpers (host-side; kernels re-derive the same math) ----

def emit_literal(out: bytearray, payload: bytes) -> None:
    n = len(payload) - 1
    if n < 0:
        return
    if n < LITERAL_INLINE_MAX:
        out.append(n << 2)
    else:
        nbytes = (n.bit_length() + 7) // 8
        out.append((LITERAL_INLINE_MAX - 1 + nbytes) << 2)
        out += n.to_bytes(nbytes, "little")
    out += payload


def emit_copy_leq64(out: bytearray, offset: int, length: int) -> None:
    if length <= COPY1_MAX_LEN and offset < COPY1_MAX_OFFSET:
        out.append(TAG_COPY_1 | ((length - MIN_MATCH) << 2) | ((offset >> 8) << 5))
        out.append(offset & 0xFF)
    else:
        out.append(TAG_COPY_2 | ((length - 1) << 2))
        out += offset.to_bytes(2, "little")


def emit_copy(out: bytearray, offset: int, length: int) -> None:
    """Chunk a long match exactly like the reference (csnappy_compress.c:395-415)."""
    while length >= 68:
        emit_copy_leq64(out, offset, 64)
        length -= 64
    if length > 64:
        emit_copy_leq64(out, offset, 60)
        length -= 60
    emit_copy_leq64(out, offset, length)
