"""Write the JAX package's reference outputs for the PyTorch port's tests.

    JAX_PLATFORMS=cpu python tools/make_torch_fixtures.py [--far]

Writes ``tests/data/torch_ref/``:

* ``urls.10K.jax.snappy`` — ``encode_fused.compress_np(urls.10K)``;
* ``blocks.npz`` — seeded inputs (built by :func:`build_inputs`) and what
  ``decode_fused.decode_blocks`` / ``encode_fused.encode_blocks`` return for
  them.  The tests rebuild the inputs from the seed, check them against the
  stored copies (drift check), then hold the port against the stored outputs.

On a CPU backend the Pallas kernels run in interpret mode, so this takes
minutes; it is run by hand when the reference or the input set changes, never
by the tests.  ``--far`` adds the 70000-byte-window COPY_4 vector
(``far`` group, offset 66000 > 65535), which costs several minutes more.
"""
from __future__ import annotations

import argparse
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
DATA = ROOT / "tests" / "data"
OUT = DATA / "torch_ref"
SEED = 20261016

# decode groups: name -> block_out (one decode_blocks call each)
DECODE_GROUPS = {"d4": 4, "d4k": 4096, "d32k": 32768, "d1k": 1024}
FAR_GROUP = {"far": 70000}
# encode groups: name -> padded block width
ENCODE_GROUPS = {"e1k": 1024, "e4k": 4096}


def _pack(frags):
    width = max(1, max(len(f) for f in frags))
    arr = np.zeros((len(frags), width), np.uint8)
    lens = np.zeros((len(frags),), np.int32)
    for i, f in enumerate(frags):
        arr[i, : len(f)] = np.frombuffer(f, np.uint8)
        lens[i] = len(f)
    return arr, lens


def _mutate(rng, frag: bytes, k_max: int = 5) -> bytes:
    bad = bytearray(frag)
    for _ in range(int(rng.integers(1, k_max + 1))):
        bad[int(rng.integers(0, len(bad)))] = int(rng.integers(0, 256))
    return bytes(bad)


def build_inputs(urls: bytes, baddata3: bytes, far: bool = False) -> dict:
    """Seeded inputs of every group, as numpy arrays (deterministic)."""
    from csnappy_tpu.models import pymodel, wire

    rng = np.random.default_rng(SEED)
    out = {}

    # d4: the offset-before-space priority vector at dst limit 4
    s = bytearray()
    wire.emit_literal(s, b"ab")
    s += bytes([wire.TAG_COPY_1 | ((4 - wire.MIN_MATCH) << 2), 50])
    wire.emit_literal(s, b"c" * 60)
    out["d4_comp"], out["d4_lens"] = _pack([bytes(s)])

    # d4k: the mirrored decode vectors at dst limit 4096
    frags = [pymodel.compress_fragment(d) for d in (
        b"", b"a", b"hello world hello world hello", b"a" * 4096, b"ab" * 2048,
        bytes(range(256)) * 16, b"the quick brown fox jumps over the lazy dog " * 90,
    )]
    frags.append(pymodel.compress_fragment(rng.integers(0, 256, 4000, dtype=np.uint8).tobytes()))
    frags.append(pymodel.compress_fragment(
        rng.integers(0, 256, 2000, dtype=np.uint8).tobytes() + b"abcdefgh" * 200))
    c4 = bytearray()
    wire.emit_literal(c4, b"0123456789abcdef")
    c4 += bytes([wire.TAG_COPY_4 | ((8 - 1) << 2)]) + (16).to_bytes(4, "little")
    frags.append(bytes(c4))
    frags += [b"\xc4foooooo", b"\x00a\x01\x00", b"\x00a\x0a\x08\x00"]   # malformed
    frags.append(pymodel.compress_fragment(b"x" * 5000))                  # overrun
    frags.append(pymodel.compress_fragment(b"y" * 5000)[:-1])             # overrun, then truncated
    frags += [pymodel.compress_fragment(urls[i * 4096 : (i + 1) * 4096]) for i in range(8)]
    for trial in range(10):
        n = int(rng.integers(1, 4096))
        if trial % 3 == 0:
            data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        elif trial % 3 == 1:
            data = (b"abcdef" * (n // 6 + 1))[:n]
        else:
            data = bytes(rng.integers(97, 100, n, dtype=np.uint8))
        frags.append(pymodel.compress_fragment(data))
    base = pymodel.compress_fragment(b"hello world " * 200)
    frags += [_mutate(rng, base) for _ in range(10)]
    out["d4k_comp"], out["d4k_lens"] = _pack(frags)

    # d32k: bench-shaped urls blocks, baddata3's body, seeded mutations
    blocks = [urls[i * 32768 : (i + 1) * 32768] for i in range(4)]
    frags = [pymodel.compress_fragment(b) for b in blocks]
    _, hdr = wire.varint_decode(baddata3)
    frags.append(baddata3[hdr:])
    frags += [_mutate(rng, frags[0], 3) for _ in range(3)]
    out["d32k_comp"], out["d32k_lens"] = _pack(frags)

    # d1k: the 8 x 1 KiB batch
    starts = rng.integers(0, len(urls) - 1024, 8)
    frags = [pymodel.compress_fragment(urls[s : s + 1024]) for s in starts]
    out["d1k_comp"], out["d1k_lens"] = _pack(frags)

    if far:
        # a COPY_4 offset above 65535: legal once 66000 bytes are written
        lit = rng.integers(0, 256, 66000, dtype=np.uint8).tobytes()
        f = bytearray()
        wire.emit_literal(f, lit)
        f += bytes([wire.TAG_COPY_4 | ((8 - 1) << 2)]) + (66000).to_bytes(4, "little")
        out["far_comp"], out["far_lens"] = _pack([bytes(f)])

    # e1k: 8 x 1 KiB encode batch with ragged lengths
    blens = np.array([1024, 1024, 1000, 777, 1024, 64, 5, 1024], np.int32)
    e = np.zeros((8, 1024), np.uint8)
    for i in range(8):
        kind = i % 4
        if kind == 0:
            s0 = int(rng.integers(0, len(urls) - 1024))
            row = np.frombuffer(urls[s0 : s0 + 1024], np.uint8)
        elif kind == 1:
            row = rng.integers(0, 256, 1024, dtype=np.uint8)
        elif kind == 2:
            row = np.frombuffer((b"abcdefgh" * 128), np.uint8)
        else:
            row = rng.integers(0, 4, 1024, dtype=np.uint8) * 65
        e[i, : blens[i]] = row[: blens[i]]
    out["e1k_data"], out["e1k_lens"] = e, blens

    # e4k: the mirrored encode vectors at width 4096
    datas = [
        b"", b"a", b"hello world hello world hello", b"a" * 4096, b"ab" * 2048,
        bytes(range(256)) * 16, b"the quick brown fox jumps over the lazy dog " * 90,
        rng.integers(0, 256, 4000, dtype=np.uint8).tobytes(), urls[:4096],
    ]
    for trial in range(7):
        n = int(rng.integers(1, 4096))
        datas.append(rng.integers(0, 256, n, dtype=np.uint8).tobytes() if trial % 2
                     else (b"abcdefgh" * (n // 8 + 1))[:n])
    e = np.zeros((len(datas), 4096), np.uint8)
    for i, d in enumerate(datas):
        e[i, : len(d)] = np.frombuffer(d, np.uint8)
    out["e4k_data"] = e
    out["e4k_lens"] = np.array([len(d) for d in datas], np.int32)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--far", action="store_true", help="add the far COPY_4 group")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import jax

    jax.config.update("jax_platforms", "cpu")
    from csnappy_tpu.ops import decode_fused, encode_fused

    urls = (DATA / "urls.10K").read_bytes()
    baddata3 = (DATA / "baddata3.snappy").read_bytes()
    OUT.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    stream = encode_fused.compress_np(urls)
    (OUT / "urls.10K.jax.snappy").write_bytes(stream)
    print(f"compress_np(urls.10K): {len(stream)} B ({time.time() - t0:.0f} s)", flush=True)

    arrays = build_inputs(urls, baddata3, far=args.far)
    groups = dict(DECODE_GROUPS, **(FAR_GROUP if args.far else {}))
    for name, block_out in groups.items():
        t0 = time.time()
        o, p, s = decode_fused.decode_blocks(arrays[f"{name}_comp"], arrays[f"{name}_lens"],
                                             block_out)
        arrays[f"{name}_out"], arrays[f"{name}_prod"], arrays[f"{name}_status"] = (
            o, np.asarray(p, np.int32), np.asarray(s, np.int32))
        print(f"decode {name}: B={len(p)} ({time.time() - t0:.0f} s)", flush=True)
    for name in ENCODE_GROUPS:
        t0 = time.time()
        c, n = encode_fused.encode_blocks(arrays[f"{name}_data"], arrays[f"{name}_lens"])
        arrays[f"{name}_comp"], arrays[f"{name}_clen"] = c, np.asarray(n, np.int32)
        print(f"encode {name}: B={len(n)} ({time.time() - t0:.0f} s)", flush=True)
    np.savez_compressed(OUT / "blocks.npz", **arrays)
    print(f"wrote {OUT}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
