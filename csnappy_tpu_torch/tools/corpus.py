"""Deterministic benchmark corpus (own copy of ``csnappy_tpu/tools/corpus.py``;
the same seeds give the same bytes, file by file) — the multi-file spread the
reference published numbers for (userspace_benchmark.txt: 18 files spanning
text, html, binaries, jpeg/incompressible, block_compressor_benchmark.txt: 9).

No Silesia copy is in-tree and nothing is downloaded, so the corpus is
generated: seeded synthetic files covering the same compressibility spread
(high-redundancy text, structured binary, RLE-heavy, incompressible) plus
the committed urls.10K vector.  Generation is pure-seeded (reproducible
byte-for-byte anywhere); sizes mirror the reference's small-corpus scale.
"""
from __future__ import annotations

import pathlib

import numpy as np

_WORDS = (
    b"the of and a to in is was he for it with as his on be at by had not "
    b"are but from or have an they which one you were her all she there "
    b"would their we him been has when who will more no if out so said what"
).split()


def _text(rng: np.random.Generator, n: int) -> bytes:
    """English-like word soup — compresses like alice29.txt-class text."""
    out = bytearray()
    while len(out) < n:
        w = _WORDS[int(rng.integers(0, len(_WORDS)))]
        out += w + (b" " if rng.random() > 0.08 else b".\n")
    return bytes(out[:n])


def _html(rng: np.random.Generator, n: int) -> bytes:
    """Tag-heavy markup — long repeated structural strings."""
    out = bytearray()
    i = 0
    while len(out) < n:
        out += b'<tr class="row"><td href="/item/%d">' % i
        out += _WORDS[int(rng.integers(0, len(_WORDS)))]
        out += b"</td></tr>\n"
        i += 1
    return bytes(out[:n])


def _binary(rng: np.random.Generator, n: int) -> bytes:
    """Struct-like records: small-int fields + repeated 16-byte headers."""
    rec = np.zeros((n // 32 + 1, 32), np.uint8)
    rec[:, :8] = np.frombuffer(b"\x7fRECv1\x00\x00", np.uint8)
    rec[:, 8:12] = rng.integers(0, 4, (len(rec), 4))
    rec[:, 12:16] = np.arange(len(rec))[:, None].astype(np.uint32).view(np.uint8).reshape(len(rec), 4)
    rec[:, 16:] = rng.integers(0, 255, (len(rec), 16)) & rng.integers(0, 2, (len(rec), 16)) * 255
    return rec.reshape(-1)[:n].tobytes()


def _rle(rng: np.random.Generator, n: int) -> bytes:
    """Run-heavy data (zram zero-page-like with runs of varying bytes)."""
    out = bytearray()
    while len(out) < n:
        out += bytes([int(rng.integers(0, 256))]) * int(rng.integers(16, 2000))
    return bytes(out[:n])


def _random(rng: np.random.Generator, n: int) -> bytes:
    """Incompressible — the house.jpg analog (best-case decode speed)."""
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


def _mixed(rng: np.random.Generator, n: int) -> bytes:
    parts = []
    kinds = (_text, _binary, _rle, _random)
    total = 0
    while total < n:
        m = int(rng.integers(2000, 20000))
        parts.append(kinds[int(rng.integers(0, 4))](rng, m))
        total += m
    return b"".join(parts)[:n]


def corpus(data_dir: str | pathlib.Path | None = None) -> dict[str, bytes]:
    """Name -> bytes for the benchmark table (deterministic)."""
    files: dict[str, bytes] = {}
    gens = {
        "text.1M": (_text, 1 << 20),
        "html.512K": (_html, 512 << 10),
        "binrec.1M": (_binary, 1 << 20),
        "rle.512K": (_rle, 512 << 10),
        "random.512K": (_random, 512 << 10),
        "mixed.1M": (_mixed, 1 << 20),
        "text.64K": (_text, 64 << 10),
        "random.64K": (_random, 64 << 10),
    }
    import zlib

    for name, (fn, n) in gens.items():
        files[name] = fn(np.random.default_rng(zlib.crc32(name.encode())), n)
    d = pathlib.Path(data_dir) if data_dir else pathlib.Path(__file__).parents[2] / "tests" / "data"
    u = d / "urls.10K"
    if u.exists():
        files["urls.10K"] = u.read_bytes()
    return files
