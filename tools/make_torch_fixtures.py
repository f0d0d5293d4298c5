"""Write the JAX package's reference outputs for the PyTorch port's tests.

    JAX_PLATFORMS=cpu python tools/make_torch_fixtures.py [--far] [--group G]

Writes ``tests/data/torch_ref/``:

* ``urls.10K.jax.snappy`` — ``encode_fused.compress_np(urls.10K)``;
* ``blocks.npz`` — seeded inputs (built by :func:`build_inputs`) and what
  ``decode_fused.decode_blocks`` / ``encode_fused.encode_blocks`` return for
  them;
* ``streams.npz`` — whole headerless streams and their output limits (built
  by :func:`build_streams`), and for each what the JAX package answers:
  ``decode_ws.decompress_noheader_ws`` (run with ``FORCE_CPU``: bytes or
  None, plus the boundary scan's ``seg[:nseg]`` and ``meta[:3]``),
  ``decode_stream`` and ``decode_jnp`` (``produced``, ``status``) and
  ``api.decompress_noheader`` (status), with a sha256 of every output instead
  of the output itself;
* ``container.npz`` — the paged container (``runtime/container.py``) on the
  inputs of :func:`build_container_inputs`: each container's bytes and the
  compress and decompress stats, and for each malformed container of
  :func:`build_bad_containers` the error code;
* ``movebench.npz`` — ``tools/movebench.py``'s two Pallas kernels (the flat
  one-hot gather at ``bits = 16`` and the max-scan) on seeded ``(R, 128)``
  int32 inputs at R = 16 and R = 64 (:func:`build_movebench_inputs`).

The tests rebuild the inputs from the seed, check them against the stored
copies (drift check), then hold the port against the stored outputs.

On a CPU backend the Pallas kernels run in interpret mode, so this takes
minutes; it is run by hand when the reference or the input set changes, never
by the tests.  ``--far`` adds the 70000-byte-window COPY_4 vector
(``far`` group, offset 66000 > 65535), which costs several minutes more.
``--group blocks``, ``streams``, ``container`` or ``movebench`` writes one
file only; the stream and container groups run one process per case,
``--procs`` at a time.
"""
from __future__ import annotations

import argparse
import hashlib
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


def _fuzz_stream(rng, trial: int) -> bytes:
    """The mixed random / RLE / text data of ``tests/test_decode_stream.py``'s fuzz case."""
    pieces, n = [], 0
    while n < 90000:
        kind = int(rng.integers(0, 3))
        m = int(rng.integers(500, 8000))
        if kind == 0:
            pieces.append(rng.integers(0, 256, m, dtype=np.uint8).tobytes())
        elif kind == 1:
            pieces.append(bytes([int(rng.integers(97, 100))]) * m)
        else:
            pieces.append((b"lorem ipsum dolor sit amet " * (m // 27 + 1))[:m])
        n += m
    return b"".join(pieces)[: 90000 + trial * 7]


def build_streams(urls: bytes, golden: bytes, baddata3: bytes,
                  unaligned: bytes) -> list[tuple[str, bytes, int]]:
    """Seeded whole-stream inputs: (name, headerless body, dst_len) each.

    ``golden`` is urls.10K.snappy and ``unaligned`` the reference's
    unaligned_uint64_test.snappy, both with their headers."""
    from csnappy_tpu.models import pymodel, wire

    def split(stream: bytes) -> tuple[bytes, int]:
        ulen, hdr = wire.varint_decode(stream)
        return stream[hdr:], ulen

    def literal(payload: bytes) -> bytearray:
        s = bytearray()
        wire.emit_literal(s, payload)
        return s

    def copy(kind: int, length: int, offset: int) -> bytes:
        width = 2 if kind == wire.TAG_COPY_2 else 4
        return bytes([kind | ((length - 1) << 2)]) + offset.to_bytes(width, "little")

    rng = np.random.default_rng(SEED + 1)
    out = [("own120k", *split(pymodel.compress(urls[:120000]))),
           ("golden", *split(golden))]
    raw = rng.integers(0, 256, 100000, dtype=np.uint8).tobytes()
    out.append(("straddling_literal", bytes(literal(raw)), len(raw)))
    raw = rng.integers(0, 256, 50000, dtype=np.uint8).tobytes()
    s = literal(raw) + copy(wire.TAG_COPY_2, 64, 1000)
    out.append(("straddling_literal_then_copy", bytes(s), len(raw) + 64))
    out.append(("fragments_of_a_period_8_run", *split(pymodel.compress((b"abcdefgh" * 5000)[:40000]))))
    # copies that read the previous 32 KiB segment, offset 32768 included
    raw = rng.integers(0, 256, 30000, dtype=np.uint8).tobytes()
    s = literal(raw) + copy(wire.TAG_COPY_2, 64, 30000) * 200
    out.append(("copies_into_the_previous_segment", bytes(s), 30000 + 64 * 200))
    raw = rng.integers(0, 256, 32768, dtype=np.uint8).tobytes()
    s = literal(raw) + copy(wire.TAG_COPY_2, 64, 32768) * 100
    out.append(("offset_32768", bytes(s), 32768 + 6400))
    fuzz = np.random.default_rng(77)                    # test_decode_stream.py's seed
    for trial in range(4):
        out.append((f"fuzz{trial}", *split(pymodel.compress(_fuzz_stream(fuzz, trial)))))
    b100, u100 = split(pymodel.compress(urls[:100000]))
    out.append(("truncated", b100[:-1], u100))
    out.append(("overrun_by_5000", b100, u100 - 5000))
    out.append(("baddata3", split(baddata3)[0], 1 << 20))
    uba, ulen = split(unaligned)
    for k in range(8):
        src, cap = (b100, u100) if k < 5 else (uba, ulen)
        bad = bytearray(src)
        for _ in range(int(rng.integers(1, 12))):
            bad[int(rng.integers(0, len(bad)))] ^= 1 << int(rng.integers(0, 8))
        out.append((f"bit_flips{k}", bytes(bad), cap))
    raw = rng.integers(0, 256, 40960, dtype=np.uint8).tobytes()
    for kind, name in ((wire.TAG_COPY_2, "copy2_offset_40000"), (wire.TAG_COPY_4, "copy4_offset_40000")):
        out.append((name, bytes(literal(raw) + copy(kind, 8, 40000)), len(raw) + 8))
    out.append(("unaligned", *split(unaligned)))
    # the output is exactly full at a multiple of 32768 and tags remain
    b70, _ = split(pymodel.compress(urls[:70000]))
    out.append(("full_at_65536_with_tags_left", b70, 65536))
    out.append(("ends_at_65536", *split(pymodel.compress(urls[:65536]))))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--far", action="store_true", help="add the far COPY_4 group")
    ap.add_argument("--group", choices=("all", "blocks", "streams", "container", "movebench"),
                    default="all")
    ap.add_argument("--procs", type=int, default=4, help="processes for the stream group")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import jax

    jax.config.update("jax_platforms", "cpu")
    OUT.mkdir(parents=True, exist_ok=True)
    if args.group in ("all", "blocks"):
        write_blocks(args.far)
    if args.group in ("all", "streams"):
        write_streams(args.procs)
    if args.group in ("all", "container"):
        write_container(args.procs)
    if args.group in ("all", "movebench"):
        write_movebench()
    print(f"wrote {OUT}", flush=True)
    return 0


def write_blocks(far: bool) -> None:
    from csnappy_tpu.ops import decode_fused, encode_fused

    urls = (DATA / "urls.10K").read_bytes()
    baddata3 = (DATA / "baddata3.snappy").read_bytes()
    t0 = time.time()
    stream = encode_fused.compress_np(urls)
    (OUT / "urls.10K.jax.snappy").write_bytes(stream)
    print(f"compress_np(urls.10K): {len(stream)} B ({time.time() - t0:.0f} s)", flush=True)

    arrays = build_inputs(urls, baddata3, far=far)
    groups = dict(DECODE_GROUPS, **(FAR_GROUP if far else {}))
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


def sha(b: bytes) -> np.ndarray:
    return np.frombuffer(hashlib.sha256(bytes(b)).digest(), np.uint8)


def load_streams() -> list[tuple[str, bytes, int]]:
    """:func:`build_streams` over the repository's data files."""
    return build_streams(*((DATA / f).read_bytes() for f in (
        "urls.10K", "urls.10K.snappy", "baddata3.snappy", "unaligned_uint64_test.snappy")))


def read_streams() -> tuple[list[tuple[str, bytes, int]], dict]:
    """The stored stream group: its inputs as (name, body, dst_len) and every array."""
    with np.load(OUT / "streams.npz") as z:
        a = {k: z[k] for k in z.files}
    inputs = [(str(a["names"][i]), a["body"][a["offs"][i] : a["offs"][i + 1]].tobytes(),
               int(a["dst_len"][i])) for i in range(len(a["names"]))]
    return inputs, a


def _answer_stream(i: int) -> dict:
    """What the JAX package answers for stream ``i`` of :func:`load_streams`.

    Runs in a fresh process per stream: the Pallas interpreter's programs,
    compiled per stream shape, exhaust the XLA CPU compiler's code memory
    within one long process."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from csnappy_tpu import api
    from csnappy_tpu.errors import SnappyError
    from csnappy_tpu.ops import decode_jnp, decode_stream, decode_ws

    name, body, dst_len = load_streams()[i]
    t0 = time.time()
    buf = np.frombuffer(body, np.uint8)
    r = {"ws_seg": np.zeros(0, np.int32), "ws_meta": np.zeros(3, np.int32), "api_status": 0,
         "ws_sha": np.zeros(32, np.uint8), "api_sha": np.zeros(32, np.uint8)}
    shapes = decode_ws.plan(len(buf), dst_len)
    if shapes is not None:
        MR, Bb, _ = shapes
        arr = np.zeros(MR * decode_ws.L, np.uint8)
        arr[: len(buf)] = buf
        ent = decode_ws._entries(jnp.asarray(arr).astype(jnp.int32).reshape(MR, decode_ws.L),
                                 jnp.int32(len(buf)))
        seg, meta = decode_ws._scan_compiled(MR, Bb)(jnp.full((1,), len(buf), jnp.int32), ent)
        r["ws_seg"] = np.asarray(seg)[: -(-dst_len // decode_ws.SEG)]
        r["ws_meta"] = np.asarray(meta)[:3]
    decode_ws.FORCE_CPU = True                # the api skips it on a CPU backend
    res = decode_ws.decompress_noheader_ws(buf, dst_len)
    decode_ws.FORCE_CPU = False
    r["ws_bytes"] = res is not None
    if res is not None:
        r["ws_sha"] = sha(res)
    for key, mod in (("st", decode_stream), ("jnp", decode_jnp)):
        out, prod, status = mod.decompress_noheader_np(buf, dst_len)
        r[f"{key}_prod"], r[f"{key}_status"] = prod, status
        r[f"{key}_sha"] = sha(np.asarray(out)[:prod].tobytes())
    try:
        r["api_sha"] = sha(api.decompress_noheader(body, dst_len))
    except SnappyError as e:
        r["api_status"] = e.code
    print(f"stream {name}: {len(body)} B -> {dst_len}; ws {'bytes' if res is not None else 'None'}, "
          f"stream {r['st_status']}, jnp {r['jnp_status']}, api {r['api_status']} "
          f"({time.time() - t0:.0f} s)", flush=True)
    return r


def write_streams(procs: int) -> None:
    import multiprocessing

    streams = load_streams()
    with multiprocessing.get_context("spawn").Pool(procs, maxtasksperchild=1) as pool:
        rs = pool.map(_answer_stream, range(len(streams)), chunksize=1)
    a = {"names": np.array([s[0] for s in streams]),
         "body": np.frombuffer(b"".join(s[1] for s in streams), np.uint8),
         "offs": np.cumsum([0] + [len(s[1]) for s in streams]).astype(np.int64),
         "dst_len": np.array([s[2] for s in streams], np.int64),
         "ws_seg": np.concatenate([r["ws_seg"] for r in rs]).astype(np.int32),
         "ws_seg_offs": np.cumsum([0] + [len(r["ws_seg"]) for r in rs]).astype(np.int64)}
    for key in rs[0]:
        if key != "ws_seg":
            a[key] = np.array([r[key] for r in rs])
    for key in ("ws_meta", "st_prod", "st_status", "jnp_prod", "jnp_status", "api_status"):
        a[key] = a[key].astype(np.int32)
    np.savez_compressed(OUT / "streams.npz", **a)



# ---------------------------------------------------------------- container


def build_container_inputs(urls: bytes) -> list[tuple[str, bytes, int]]:
    """Seeded container inputs: (name, data, page_size) each."""
    rng = np.random.default_rng(SEED + 2)
    rand = rng.integers(0, 256, 4096 * 2, dtype=np.uint8).tobytes()
    out = [(f"urls100k_p{p}", urls[:100000], p) for p in (4096, 8192, 32768)]
    out.append(("random_page", rand[:4096], 4096))             # raw fallback, full page
    out.append(("urls_random_urls", urls[:4096] + rand[:4096] + urls[4096:6000], 4096))
    for tail in (4093, 4095):                                   # incompressible raw tails
        out.append((f"tail{tail}", urls[:4096] + rand[:tail], 4096))
    out.append(("empty", b"", 4096))
    return out


def build_bad_containers(urls: bytes) -> list[tuple[str, bytes, int]]:
    """Malformed containers made from the port-independent layout:
    (name, container bytes, page_size).  Each page is the oracle's fragment
    or raw bytes, so building them needs no kernel."""
    from csnappy_tpu.models import pymodel, wire

    def cont(pages, page_size=4096):
        table = b"".join(int(n).to_bytes(4, "little") for n, _ in pages)
        return len(pages).to_bytes(4, "little") + table + b"".join(p for _, p in pages)

    frags = [pymodel.compress_fragment(urls[i * 4096 : (i + 1) * 4096]) for i in range(3)]
    good = cont([(len(f), f) for f in frags])
    bad_page = bytearray()                                      # a copy before its
    wire.emit_literal(bad_page, b"ab")                          # source: E_DATA_MALFORMED
    bad_page += bytes([wire.TAG_COPY_1, 50])
    over = pymodel.compress_fragment(b"z" * 5000)               # decodes past the page: overrun
    return [
        ("truncated_payload", good[:-10], 4096),
        ("three_bytes", good[:3], 4096),
        ("table_truncated", good[:4 + 4 * 2], 4096),
        ("entry_exceeds_page", cont([(5000, b"x" * 5000)]), 4096),
        ("raw_bit_exceeds_page", cont([((1 << 31) | 4097, b"x" * 4097)]), 4096),
        ("bad_page_then_overrun", cont([(len(frags[0]), frags[0]), (len(bad_page), bytes(bad_page)),
                                        (len(over), over)]), 4096),
        ("overrun_page", cont([(len(frags[0]), frags[0]), (len(over), over)]), 4096),
    ]


def _container_case(i: int) -> dict:
    """What the JAX container answers for case ``i`` (good cases first, then
    the malformed ones); one process per case, as for the streams."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from csnappy_tpu.errors import SnappyError
    from csnappy_tpu.runtime import container

    urls = (DATA / "urls.10K").read_bytes()
    good = build_container_inputs(urls)
    t0 = time.time()
    if i < len(good):
        name, data, page = good[i]
        cont, sc = container.compress_blocks(data, page_size=page)
        back, sd = container.decompress_blocks(cont, page_size=page)
        assert back == data, name
        r = {"cont": cont, "stats_c": [sc.nr_pages, sc.bytes_in, sc.bytes_out, *sc.histogram],
             "stats_d": [sd.nr_pages, sd.bytes_in, sd.bytes_out, *sd.histogram]}
        print(f"container {name}: {len(data)} B -> {len(cont)} B ({time.time() - t0:.0f} s)",
              flush=True)
        return r
    name, cont, page = build_bad_containers(urls)[i - len(good)]
    try:
        container.decompress_blocks(cont, page_size=page)
        code = 0
    except SnappyError as e:
        code = e.code
    print(f"bad container {name}: code {code} ({time.time() - t0:.0f} s)", flush=True)
    return {"code": code}


def read_container() -> dict:
    with np.load(OUT / "container.npz") as z:
        return {k: z[k] for k in z.files}


def write_container(procs: int) -> None:
    import multiprocessing

    urls = (DATA / "urls.10K").read_bytes()
    good, bad = build_container_inputs(urls), build_bad_containers(urls)
    with multiprocessing.get_context("spawn").Pool(procs, maxtasksperchild=1) as pool:
        rs = pool.map(_container_case, range(len(good) + len(bad)), chunksize=1)
    conts = [r["cont"] for r in rs[: len(good)]]
    a = {"names": np.array([g[0] for g in good]),
         "page_size": np.array([g[2] for g in good], np.int64),
         "data": np.frombuffer(b"".join(g[1] for g in good), np.uint8),
         "data_offs": np.cumsum([0] + [len(g[1]) for g in good]).astype(np.int64),
         "cont": np.frombuffer(b"".join(conts), np.uint8),
         "cont_offs": np.cumsum([0] + [len(c) for c in conts]).astype(np.int64),
         "stats_c": np.array([r["stats_c"] for r in rs[: len(good)]], np.int64),
         "stats_d": np.array([r["stats_d"] for r in rs[: len(good)]], np.int64),
         "bad_names": np.array([b[0] for b in bad]),
         "bad_page_size": np.array([b[2] for b in bad], np.int64),
         "bad_cont": np.frombuffer(b"".join(b[1] for b in bad), np.uint8),
         "bad_offs": np.cumsum([0] + [len(b[1]) for b in bad]).astype(np.int64),
         "bad_code": np.array([r["code"] for r in rs[len(good):]], np.int32)}
    np.savez_compressed(OUT / "container.npz", **a)


# ---------------------------------------------------------------- movebench

MOVEBENCH_R = (16, 64)


def build_movebench_inputs() -> dict:
    """Seeded (R, 128) int32 inputs of movebench's two kernels, at each R of
    MOVEBENCH_R: ``tbl`` in [0, 2^15) and ``idx`` in [0, n) as movebench
    makes them; ``wide`` in [0, 2^31) (the gather's limbs keep its low 16
    bits) with ``idx_oob`` partly outside [0, n) (clipped); ``scan`` in
    [0, 2^31)."""
    rng = np.random.default_rng(SEED + 3)
    out = {}
    for R in MOVEBENCH_R:
        n = R * 128
        out[f"tbl{R}"] = rng.integers(0, 1 << 15, (R, 128), dtype=np.int32)
        out[f"idx{R}"] = rng.integers(0, n, (R, 128), dtype=np.int32)
        out[f"wide{R}"] = rng.integers(0, 1 << 31, (R, 128), dtype=np.int32)
        out[f"idx_oob{R}"] = rng.integers(-n, 2 * n, (R, 128), dtype=np.int32)
        out[f"scan{R}"] = rng.integers(0, 1 << 31, (R, 128), dtype=np.int32)
    return out


def movebench_calls(R: int):
    """The two ``pl.pallas_call``s of ``csnappy_tpu/tools/movebench.py``
    (:50-62 and :86-92), built the same way for an (R, 128) input."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    from csnappy_tpu.ops import kernel_lib as kl
    from csnappy_tpu.ops import primitives as prim

    def _k(i_ref, t_ref, o_ref):
        def grp(g, _):
            r0 = pl.multiple_of(g * 8, 8)
            (got,) = kl.gather_rows_multi([(t_ref[...], 16)], i_ref, r0)
            o_ref[pl.ds(r0, 8), :] = got
            return 0

        jax.lax.fori_loop(0, R // 8, grp, 0)

    gather = pl.pallas_call(
        _k, out_shape=jax.ShapeDtypeStruct((R, 128), jnp.int32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 2,
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM), interpret=prim.interpret_mode())

    def _ks(x_ref, o_ref):
        o_ref[...] = kl.scan2d_mm(x_ref[...], op="max", bits=31)

    scan = pl.pallas_call(
        _ks, out_shape=jax.ShapeDtypeStruct((R, 128), jnp.int32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM), interpret=prim.interpret_mode())
    return gather, scan


def write_movebench() -> None:
    import jax.numpy as jnp

    a = build_movebench_inputs()
    for R in MOVEBENCH_R:
        t0 = time.time()
        gather, scan = movebench_calls(R)
        a[f"gather{R}"] = np.asarray(gather(jnp.asarray(a[f"idx{R}"]), jnp.asarray(a[f"tbl{R}"])))
        a[f"gather_wide{R}"] = np.asarray(gather(jnp.asarray(a[f"idx_oob{R}"]),
                                                 jnp.asarray(a[f"wide{R}"])))
        a[f"scanned{R}"] = np.asarray(scan(jnp.asarray(a[f"scan{R}"])))
        print(f"movebench R={R} ({time.time() - t0:.0f} s)", flush=True)
    np.savez_compressed(OUT / "movebench.npz", **a)


if __name__ == "__main__":
    sys.exit(main())
