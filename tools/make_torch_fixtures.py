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
  int32 inputs at R = 16 and R = 64 (:func:`build_movebench_inputs`);
* ``primitives.npz`` — the six Pallas kernels of ``ops/primitives.py``, run
  under ``primitives.force_pallas()``, on the seeded cases of
  :func:`build_primitives_inputs` (values outside the limbs' contract
  included);
* ``probes.npz`` — the latency and capacity probes of ``tools/mosaic_probe.py``,
  ``mosaic_probe2.py`` and ``mosaic_probe5.py`` (:func:`write_probes`): the
  inputs their ``main()``s make from seed 0, each named probe's ``o_ref`` at
  K in ``PROBE_KS``, ``walk_kern`` at N in ``WALK_NS`` for the five
  configurations of ``mosaic_probe5.main()``, and ``smem_cap`` at
  ``SMEM_ROWS`` as the interpreter answers it; then the walk-form and
  wide-gather probes of ``tools/mosaic_probe3.py``, ``mosaic_probe3b.py`` and
  ``mosaic_probe3c.py`` at K in ``PROBE3_KS`` on their ``main()``s' inputs
  (the walk tables beside ``data``), and on the constructed inputs of
  ``PROBE3_CASES`` where the seed-0 data hides a mechanism; then the
  resolve-phase probes of ``tools/mosaic_probe4.py`` and the flat gathers of
  ``mosaic_probe6.py`` at K in ``PROBE4_KS`` on their ``main()``s' inputs
  and on the constructed inputs of ``PROBE4_CASES``;
* ``kernel_lib.npz`` — the helpers of ``csnappy_tpu/ops/kernel_lib.py``, each
  run inside a ``pl.pallas_call`` in interpret mode (the harness ``_run`` of
  ``tests/test_kernel_lib.py``, or a call of several outputs like its
  :137), on every parametrised case of ``tests/test_kernel_lib.py`` and on
  the constructed cases of :func:`build_kernel_lib_cases` (answers outside
  the helpers' contracts, the helpers no JAX test runs, and
  ``scatter_rows_multi`` at the shapes the JAX fused kernels give it).

The tests rebuild the inputs from the seed, check them against the stored
copies (drift check), then hold the port against the stored outputs.

On a CPU backend the Pallas kernels run in interpret mode, so this takes
minutes; it is run by hand when the reference or the input set changes, never
by the tests.  ``--far`` adds the 70000-byte-window COPY_4 vector
(``far`` group, offset 66000 > 65535), which costs several minutes more.
``--group blocks``, ``streams``, ``container``, ``movebench``,
``primitives``, ``probes`` or ``kernel_lib`` (seconds) writes one file
only; the stream and container groups run one process per case, ``--procs``
at a time.
"""
from __future__ import annotations

import argparse
import functools
import hashlib
import importlib.util
import os
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
DATA = ROOT / "tests" / "data"
OUT = DATA / "torch_ref"
JAX_CACHE = ROOT / "build" / "jax_cache"      # git-ignored: the JAX probe files default to a
                                              # cache inside the tree
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
    ap.add_argument("--group", default="all",
                    choices=("all", "blocks", "streams", "container", "movebench", "primitives",
                             "probes", "kernel_lib"))
    ap.add_argument("--procs", type=int, default=4, help="processes for the stream group")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", str(JAX_CACHE))
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
    if args.group in ("all", "primitives"):
        write_primitives()
    if args.group in ("all", "probes"):
        write_probes()
    if args.group in ("all", "kernel_lib"):
        write_kernel_lib()
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



# --------------------------------------------------------------- primitives

def _chunk_end(shape) -> np.ndarray:
    """compose_round's chunk_end as tests/test_primitives.py makes it: the end
    of each position's 128-lane row."""
    n = int(np.prod(shape))
    return (((np.arange(n, dtype=np.int32) >> 7) + 1) << 7).reshape(shape)


def build_primitives_inputs() -> list[tuple[str, str, int, dict]]:
    """Seeded cases of the six primitives as (case, function, limbs, arrays);
    limbs is 0 for the three local ops.  The shapes of
    tests/test_primitives.py, leading batch dims with C not a multiple of 8
    (the TPU grid's RC = 1), row_gather at M = 64 and 2048, table_gather at
    N not a multiple of 4096, rowwise_gather at G = 12; indices below 0 and
    at or above the width; table values outside [0, 2^(8 * limbs)) for
    limbs 1-4; compose_round sums that pass 1 << 23 and that wrap int32."""
    rng = np.random.default_rng(SEED + 4)

    def ints(lo, hi, shape):
        return rng.integers(lo, hi, shape, dtype=np.int64).astype(np.int32)

    full = (-(1 << 31), 1 << 31)
    cases = [
        ("lg16", "local_gather", 0, dict(values=ints(*full, (16, 128)),
                                         idx=ints(-5, 140, (16, 128)))),
        ("lg236", "local_gather", 0, dict(values=ints(*full, (2, 3, 128)),
                                          idx=ints(-200, 300, (2, 3, 128)))),
        ("ls16", "local_scatter_or", 0, dict(mask=ints(0, 2, (16, 128)),
                                             tgt=ints(-5, 200, (16, 128)))),
        ("ls236", "local_scatter_or", 0, dict(mask=ints(-2, 3, (2, 3, 128)),
                                              tgt=ints(-130, 260, (2, 3, 128)))),
        ("cr16", "compose_round", 0, dict(F=ints(0, 16 * 128, (16, 128)),
                                          S=ints(0, 1 << 15, (16, 128)),
                                          E=ints(0, 2, (16, 128)),
                                          chunk_end=_chunk_end((16, 128)))),
        ("cr236", "compose_round", 0, dict(F=ints(-50, 6 * 128 + 50, (2, 3, 128)),
                                           S=ints(1 << 22, 1 << 23, (2, 3, 128)),
                                           E=ints(*full, (2, 3, 128)),
                                           chunk_end=_chunk_end((2, 3, 128)))),
        ("crwrap", "compose_round", 0, dict(F=ints(0, 8 * 128, (8, 128)),
                                            S=ints(1 << 30, (1 << 31) - 1, (8, 128)),
                                            E=ints(0, 4, (8, 128)),
                                            chunk_end=_chunk_end((8, 128)))),
        ("rg2048", "row_gather", 3, dict(table2d=ints(0, 1 << 22, (40, 128)),
                                         rows=ints(-3, 45, (2048,)))),
        ("rg64", "row_gather", 3, dict(table2d=ints(0, 1 << 24, (40, 128)),
                                       rows=ints(-3, 45, (64,)))),
        ("tg1", "table_gather", 1, dict(table=ints(0, 1 << 8, (4096,)),
                                        idx=ints(-9, 5000, (3000,)))),
        ("tg2", "table_gather", 2, dict(table=ints(0, 1 << 16, (4096,)),
                                        idx=ints(-9, 5000, (3000,)))),
        ("rw12", "rowwise_gather", 3, dict(tables=ints(0, 1 << 22, (12, 256)),
                                           idx=ints(-4, 300, (12, 128)))),
    ]
    for limbs in (1, 2, 3, 4):          # values outside the contract: negative and >= 2^(8 limbs)
        cases += [
            (f"rg_oob{limbs}", "row_gather", limbs, dict(table2d=ints(*full, (40, 128)),
                                                         rows=ints(-3, 45, (64,)))),
            (f"tg_oob{limbs}", "table_gather", limbs, dict(table=ints(*full, (512,)),
                                                           idx=ints(-600, 1200, (5000,)))),
            (f"rw_oob{limbs}", "rowwise_gather", limbs, dict(tables=ints(*full, (12, 256)),
                                                             idx=ints(-300, 600, (12, 128)))),
        ]
    return cases


def primitives_outputs(cases) -> dict[str, list[np.ndarray]]:
    """Each case's outputs from the JAX package's Pallas kernels
    (``primitives.force_pallas()``: interpret mode on a CPU backend)."""
    import jax.numpy as jnp

    from csnappy_tpu.ops import primitives as prim
    from csnappy_tpu_torch.ops.primitives import PRIMITIVES

    out = {}
    with prim.force_pallas():
        for case, fn, limbs, arrays in cases:
            args = [jnp.asarray(arrays[a]) for a in PRIMITIVES[fn].args]
            got = getattr(prim, fn)(*args, **({"limbs": limbs} if limbs else {}))
            out[case] = [np.asarray(g) for g in (got if isinstance(got, tuple) else (got,))]
    return out


def read_primitives() -> list[tuple[str, str, int, dict, list[np.ndarray]]]:
    """The stored primitives group: (case, function, limbs, inputs, outputs)."""
    from csnappy_tpu_torch.ops.primitives import PRIMITIVES

    with np.load(OUT / "primitives.npz") as z:
        out = []
        for case, fn, limbs in zip(z["cases"], z["fns"], z["limbs"]):
            case, fn = str(case), str(fn)
            inputs = {a: z[f"{case}__{a}"] for a in PRIMITIVES[fn].args}
            outs = [z[f"{case}__out{k}"] for k in range(3 if fn == "compose_round" else 1)]
            out.append((case, fn, int(limbs), inputs, outs))
    return out


def write_primitives() -> None:
    t0 = time.time()
    cases = build_primitives_inputs()
    outs = primitives_outputs(cases)
    a = {"cases": np.array([c[0] for c in cases]), "fns": np.array([c[1] for c in cases]),
         "limbs": np.array([c[2] for c in cases], np.int32)}
    for case, _, _, arrays in cases:
        a.update({f"{case}__{k}": v for k, v in arrays.items()})
        a.update({f"{case}__out{k}": v for k, v in enumerate(outs[case])})
    np.savez_compressed(OUT / "primitives.npz", **a)
    print(f"primitives: {len(cases)} cases ({time.time() - t0:.0f} s)", flush=True)


# ------------------------------------------------------------------- probes

PROBE_KS = (0, 1, 37, 300, 2100)      # 300 passes the window refill at step 255,
                                      # 2100 the 2048-entry scratch wrap and int32 wrap
WALK_NS = (0, 1, 3000)
WALK_CONFIGS = ((1, 144), (2, 144), (2, 288), (4, 144), (4, 576))   # mosaic_probe5.main()
SMEM_ROWS = (256, 512)
PROBE3_KS = (0, 1, 3, 37, 300, 2100)  # floor(3 / 2) is odd: inrow_round's flip shows
PROBE3_FILES = ("mosaic_probe3", "mosaic_probe3b", "mosaic_probe3c")
# constructed inputs (``case_<case>``) for probes whose seed-0 data hides the mechanism
PROBE4_KS = (0, 1, 3, 37, 300)
PROBE4_FILES = ("mosaic_probe4", "mosaic_probe6")
PROBE3_CASES = {"mosaic_probe3c.inrow_round": "inrow",
                "mosaic_probe3b.scatter_oc256_e2048_l2": "collide",
                "mosaic_probe3b.scatter_oc256_e2048_l4": "collide",
                "mosaic_probe3.scan_tril": "rowfull",
                "mosaic_probe3.scan_mm_cur": "rowfull"}


def probe_module(name: str):
    """``tools/<name>.py`` of the JAX package, imported from its file (its
    compilation cache kept out of the tree)."""
    os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", str(JAX_CACHE))
    spec = importlib.util.spec_from_file_location(name, ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build_probe_inputs() -> dict[str, np.ndarray]:
    """The probes' inputs as the JAX ``main()``s make them: ``data`` for
    mosaic_probe.py and mosaic_probe2.py (mosaic_probe.py:224), ``walk_r<rows>``
    for each walk of mosaic_probe5.py (a fresh seed-0 generator each,
    mosaic_probe5.py:117-118)."""
    out = {"data": np.random.default_rng(0).integers(0, 2**20, (304, 128), dtype=np.int32)}
    for rows in sorted({r for _, r in WALK_CONFIGS}):
        out[f"walk_r{rows}"] = np.random.default_rng(0).integers(
            2, 9, size=(rows, 128)).astype(np.int32)
    out.update(build_probe3_inputs())
    out.update(build_probe4_inputs())
    return out


def build_probe3_inputs() -> dict[str, np.ndarray]:
    """The inputs of mosaic_probe3.py, mosaic_probe3b.py and mosaic_probe3c.py:
    their ``main()``s draw ``data`` (the same array as ``data`` above) and
    then the walk tables from one seed-0 generator: ``p3_t16384`` and
    ``p3_t36864`` in [1, 2^20) (mosaic_probe3.py:421-426; CPython iterates
    the set {16384, 36864} in that order), ``p3b_t36864`` in [1, 2^22)
    (mosaic_probe3b.py:246-248); ``p3c_data`` in [0, 2^15)
    (mosaic_probe3c.py:141-142).  Then the constructed inputs:
    ``case_inrow``, whose pointers (``& 32767``) stay in their row for seven
    elements in eight, ``case_collide``, whose rows 0-15 lie in [0, 512), so
    the scatters' positions collide in rows 0-7, and ``case_rowfull``,
    ``data`` with rows 0 and 3 all 0x1FFFF, so at odd i those rows of the
    scans total 2^24, which ``scan_tril``'s three 8-bit limbs drop."""
    out = {}
    rng = np.random.default_rng(0)
    data = rng.integers(0, 2**20, (304, 128), dtype=np.int32)
    for n in (16384, 36864):
        out[f"p3_t{n}"] = rng.integers(1, 2**20, (n,), dtype=np.int32)
    rng = np.random.default_rng(0)
    rng.integers(0, 2**20, (304, 128), dtype=np.int32)
    out["p3b_t36864"] = rng.integers(1, 2**22, (36864,), dtype=np.int32)
    out["p3c_data"] = np.random.default_rng(0).integers(0, 2**15, (304, 128), dtype=np.int32)
    rng = np.random.default_rng(SEED + 5)
    rows = (np.arange(304) % 256)[:, None]
    inrow = rows * 128 + rng.integers(0, 128, (304, 128))
    off = rng.random((304, 128)) < 0.125
    inrow[off] = rng.integers(0, 1 << 15, int(off.sum()))
    out["case_inrow"] = inrow.astype(np.int32)
    collide = rng.integers(0, 2**20, (304, 128))
    collide[:16] = rng.integers(0, 512, (16, 128))
    out["case_collide"] = collide.astype(np.int32)
    rowfull = data.copy()
    rowfull[[0, 3]] = 0x1FFFF
    out["case_rowfull"] = rowfull
    return out


def probe3_call(mod_name: str, name: str):
    """The jitted ``pl.pallas_call`` of one probe of mosaic_probe3.py,
    mosaic_probe3b.py or mosaic_probe3c.py, and whether it takes a table."""
    import jax

    mod = probe_module(mod_name)
    entry = mod.PROBES[name]
    if mod_name == "mosaic_probe3":
        return jax.jit(mod._call(entry[0], entry[1], tbl_n=entry[4])), f"p3_t{entry[4]}"
    return jax.jit(mod._call(entry[0], entry[1])), ("p3b_t36864" if mod_name == "mosaic_probe3b"
                                                    else None)


def walk_call(nchains: int, rows: int):
    """The ``pl.pallas_call`` of ``mosaic_probe5.time_walk`` (:102-117) for one
    configuration, without its timing."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    mp5 = probe_module("mosaic_probe5")
    return jax.jit(pl.pallas_call(
        functools.partial(mp5.walk_kern, nchains, rows),
        out_shape=jax.ShapeDtypeStruct((8, 128), jnp.int32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM), pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        scratch_shapes=[pltpu.SMEM((rows, 128), jnp.int32), pltpu.SemaphoreType.DMA],
        interpret=mp5.INTERP))


def probe_outputs(inputs: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Each probe's ``o_ref`` from the JAX kernels (interpret mode on a CPU
    backend), keyed ``<module>.<probe>__k<K>``; the walks as
    ``mosaic_probe5.walk_c<chains>_r<rows>__k<N>``."""
    import jax
    import jax.numpy as jnp

    out = {}
    data = jnp.asarray(inputs["data"])
    for mod_name in ("mosaic_probe", "mosaic_probe2"):
        mod = probe_module(mod_name)
        for name, entry in mod.PROBES.items():
            fn = jax.jit(mod._call(entry[0], entry[1]))
            for k in PROBE_KS:
                got = fn(jnp.full((1,), k, jnp.int32), data)
                out[f"{mod_name}.{name}__k{k}"] = np.asarray(got)
    for nchains, rows in WALK_CONFIGS:
        fn = walk_call(nchains, rows)
        d = jnp.asarray(inputs[f"walk_r{rows}"])
        for n in WALK_NS:
            got = fn(jnp.full((4,), n, jnp.int32), d)
            out[f"mosaic_probe5.walk_c{nchains}_r{rows}__k{n}"] = np.asarray(got)
    out.update(probe3_outputs(inputs))
    out.update(probe4_outputs(inputs))
    return out


def probe3_outputs(inputs: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Each probe of mosaic_probe3.py, mosaic_probe3b.py and mosaic_probe3c.py
    at K in ``PROBE3_KS``, keyed ``<module>.<probe>__k<K>``, and on its
    constructed input, keyed ``<module>.<probe>__<case>_k<K>``."""
    import jax.numpy as jnp

    out = {}
    for mod_name in PROBE3_FILES:
        for name in probe_module(mod_name).PROBES:
            fn, tkey = probe3_call(mod_name, name)
            tbl = () if tkey is None else (jnp.asarray(inputs[tkey]),)
            full = f"{mod_name}.{name}"
            runs = [("", inputs["p3c_data" if mod_name == "mosaic_probe3c" else "data"])]
            if full in PROBE3_CASES:
                runs.append((PROBE3_CASES[full] + "_", inputs["case_" + PROBE3_CASES[full]]))
            for case, data in runs:
                d = jnp.asarray(data)
                for k in PROBE3_KS:
                    got = fn(jnp.full((1,), k, jnp.int32), d, *tbl)
                    out[f"{full}__{case}k{k}"] = np.asarray(got)
    return out


def build_probe4_inputs() -> dict[str, np.ndarray]:
    """The inputs of mosaic_probe4.py and mosaic_probe6.py: ``p4_data``, the
    (400, 128) ``arange % 251`` of mosaic_probe4.py:55 (unperturbed), and
    ``p6_tab`` (424, 128) in [0, 256) then ``p6_idx`` (32, 128) in
    [0, 54272) from one seed-0 generator (mosaic_probe6.py:195-197).  Then
    the constructed inputs: ``case_p4rand``, (400, 128) in [0, 2^16) from
    seed 0, on which table height and limbs change the gathers' answers
    (the tool's own data is ``j % 251`` at every flat j, so every gather
    answers alike, and a fixed point of pointer jumping); ``case_p4path``,
    whose rows 0-31 hold ``x[j] = min(j + 1, 4095)``, so pointer jumping
    doubles x[0] each round and converges after 12 rounds; ``case_p6wide``, a
    table in [-2^31, 2^31), which shows mosaic_probe6's ``& 0xFF``."""
    out = {"p4_data": np.arange(400 * 128, dtype=np.int32).reshape(400, 128) % 251}
    rng = np.random.default_rng(0)
    out["p6_tab"] = rng.integers(0, 256, (424, 128), dtype=np.int32)
    out["p6_idx"] = rng.integers(0, 424 * 128, (32, 128), dtype=np.int32)
    out["case_p4rand"] = np.random.default_rng(0).integers(0, 2**16, (400, 128), dtype=np.int32)
    path = out["p4_data"].copy()
    path[:32] = np.minimum(np.arange(1, 32 * 128 + 1), 4095).reshape(32, 128)
    out["case_p4path"] = path
    out["case_p6wide"] = np.random.default_rng(SEED + 6).integers(
        -(2**31), 2**31, (424, 128), dtype=np.int64).astype(np.int32)
    return out


PROBE4_NAMES = (("lane_gather_32x128",)
                + tuple(f"gather_r{r}_l{l}" for r in (32, 64, 128, 160, 288, 400) for l in (1, 2))
                + ("conv_unrolled", "conv_check", "dynslice_32"))   # mosaic_probe4.main() :128-139
# the constructed inputs each probe of mosaic_probe4.py and mosaic_probe6.py runs on
PROBE4_CASES = {**{f"mosaic_probe4.{n}": ("p4rand",) for n in PROBE4_NAMES},
                "mosaic_probe4.conv_unrolled": ("p4rand", "p4path"),
                "mosaic_probe4.conv_check": ("p4rand", "p4path"),
                **{f"mosaic_probe6.{n}": ("p6wide",) for n in ("base", "base_i16", "el_orient",
                                                              "el_i16")}}


def probe4_call(mod_name: str, name: str):
    """The jitted ``pl.pallas_call`` of one probe of mosaic_probe4.py (its
    kernel for the label of ``main()``) or mosaic_probe6.py (its ``PROBES``)."""
    import jax

    mod = probe_module(mod_name)
    if mod_name == "mosaic_probe6":
        return jax.jit(mod._call(mod.PROBES[name][0]))
    if name == "lane_gather_32x128":
        kern = mod.lane_gather_kern
    elif name.startswith("gather_r"):
        rows, limbs = name[len("gather_r"):].split("_l")
        kern = functools.partial(mod.gather_kern, int(rows), int(limbs))
    elif name.startswith("conv_"):
        kern = functools.partial(mod.while_conv_kern, name == "conv_check")
    else:
        kern = mod.dynslice_kern
    return jax.jit(mod._call(kern))


def probe4_outputs(inputs: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Each probe of mosaic_probe4.py and mosaic_probe6.py at K in
    ``PROBE4_KS``, keyed ``<module>.<probe>__k<K>`` on the tool's input and
    ``<module>.<probe>__<case>_k<K>`` on a constructed one; ``taa_4096x128``
    fails to trace, and ``p6_taa_error`` keeps the first line of its error."""
    import jax.numpy as jnp

    out = {}
    for mod_name, names in (("mosaic_probe4", PROBE4_NAMES),
                            ("mosaic_probe6", ("base", "base_i16", "el_orient", "el_i16"))):
        for name in names:
            fn = probe4_call(mod_name, name)
            full = f"{mod_name}.{name}"
            first = "p4_data" if mod_name == "mosaic_probe4" else "p6_tab"
            runs = [("", inputs[first])] + [(c + "_", inputs["case_" + c])
                                             for c in PROBE4_CASES.get(full, ())]
            for case, data in runs:
                args = (jnp.asarray(data),) + ((jnp.asarray(inputs["p6_idx"]),)
                                               if mod_name == "mosaic_probe6" else ())
                for k in PROBE4_KS:
                    kvec = jnp.full((4,) if mod_name == "mosaic_probe4" else (1,), k, jnp.int32)
                    out[f"{full}__{case}k{k}"] = np.asarray(fn(kvec, *args))
    try:
        probe4_call("mosaic_probe6", "taa_4096x128")(
            jnp.full((1,), 1, jnp.int32), jnp.asarray(inputs["p6_tab"]),
            jnp.asarray(inputs["p6_idx"]))
    except ValueError as e:
        out["p6_taa_error"] = np.array(str(e).split("\n")[0])
    else:
        raise AssertionError("mosaic_probe6.taa_4096x128 traced: the port's entry is out of date")
    return out


def read_probes() -> dict[str, np.ndarray]:
    """The stored probes group, every array by its key."""
    with np.load(OUT / "probes.npz") as z:
        return {k: z[k] for k in z.files}


def write_probes() -> None:
    t0 = time.time()
    a = build_probe_inputs()
    a.update(probe_outputs(a))
    mp5 = probe_module("mosaic_probe5")
    a["smem_cap_rows"] = np.array(SMEM_ROWS, np.int32)
    a["smem_cap_ok"] = np.array([mp5.smem_cap(r) for r in SMEM_ROWS])
    np.savez_compressed(OUT / "probes.npz", **a)
    print(f"probes: {len(a)} arrays ({time.time() - t0:.0f} s)", flush=True)


# --------------------------------------------------------------- kernel_lib


def _test_kernel_lib():
    """``tests/test_kernel_lib.py``, imported from its file: its ``_run`` is
    the Pallas harness (row 15a) the fixtures go through."""
    spec = importlib.util.spec_from_file_location("test_kernel_lib",
                                                  ROOT / "tests" / "test_kernel_lib.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build_kernel_lib_cases() -> list[tuple[str, str, dict, dict]]:
    """The cases of the kernel_lib group as (case, helper, arrays, params):
    the arrays in call order (for ``gather_rows_multi`` the tables, then the
    index; for ``scatter_rows_multi`` the positions, then the value tiles),
    the params the helper's static arguments.  First the 35 parametrised
    cases of tests/test_kernel_lib.py with its own seeds and shapes, then a
    constructed case for each answer outside a helper's contract and cases
    of the helpers that no JAX test runs."""
    cases = []
    for d in (0, 1, 7, 127, 128, 129, 300, 1023):                     # :25
        x = np.arange(8 * 128, dtype=np.int32).reshape(8, 128) * 3 + 1
        cases.append((f"ssd_d{d}", "stream_shift_down", {"x": x}, {"d": d, "fill": -7}))
    for d in (1, 127, 128, 200, 1023):                                # :39
        x = np.arange(8 * 128, dtype=np.int32).reshape(8, 128) * 5 + 2
        cases.append((f"ssu_d{d}", "stream_shift_up", {"x": x}, {"d": d, "fill": -3}))
    for rows in (8, 16):                                              # :52-53
        for op in ("max", "add"):
            x = np.random.default_rng(0).integers(-1000, 1000, (rows, 128)).astype(np.int32)
            cases.append((f"scan2d_{op}_r{rows}", "scan2d", {"x": x}, {"op": op}))
    for bits in (8, 16, 24):                                          # :66
        r = np.random.default_rng(1)
        tbl = r.integers(0, 1 << bits, (16, 128)).astype(np.int32)
        idx = r.integers(0, 16 * 128, (1, 256)).astype(np.int32)
        cases.append((f"gflat_b{bits}", "gather_flat", {"table": tbl, "idx": idx}, {"bits": bits}))
    r = np.random.default_rng(2)                                      # :79
    v = r.integers(-(2**31), 2**31 - 1, (16, 128)).astype(np.int32)
    li = r.integers(0, 128, (16, 128)).astype(np.int32)
    cases.append(("lgr", "local_gather_rows", {"vals": v, "li": li}, {}))
    for d in (1, 2, 4, 5):                                            # :91
        x = np.arange(16 * 128, dtype=np.int32).reshape(16, 128) * 7 + 3
        cases.append((f"ssumm_d{d}", "stream_shift_up_mm", {"x": x}, {"d": d}))
    for rows in (8, 24):                                              # :104-105
        for op, bits in (("max", 31), ("add", 24)):
            hi = (1 << 30) if op == "max" else 1000
            x = np.random.default_rng(4).integers(0, hi, (rows, 128)).astype(np.int32)
            cases.append((f"scanmm_{op}_b{bits}_r{rows}", "scan2d_mm", {"x": x},
                          {"op": op, "bits": bits}))
    for bits in (8, 19):                                              # :119
        r = np.random.default_rng(5)
        tbl = r.integers(0, 1 << bits, (24, 128)).astype(np.int32)
        tbl2 = r.integers(0, 1 << 16, (24, 128)).astype(np.int32)
        idx = r.integers(0, 24 * 128, (8, 128)).astype(np.int32)
        cases.append((f"grm_b{bits}", "gather_rows_multi", {"t0": tbl, "t1": tbl2, "idx": idx},
                      {"bits": [bits, 16], "r0": 0, "nrows": 8}))
    for bits in (16, 31):                                             # :148
        r = np.random.default_rng(6)
        pos = r.permutation(16 * 128)[: 8 * 128].astype(np.int32).reshape(8, 128)
        val = r.integers(0, 1 << bits, (8, 128)).astype(np.int32)
        mask = r.random((8, 128)) < 0.7
        pos_m = np.where(mask, pos, -1).astype(np.int32)
        cases.append((f"srm_b{bits}", "scatter_rows_multi", {"pos": pos_m, "v0": val},
                      {"bits": [bits], "r0": 0, "out_rows": 16, "nrows": 8}))
    for bits in (16, 31):                                             # :168
        r = np.random.default_rng(3)
        pos = r.permutation(16 * 128)[:128].astype(np.int32).reshape(1, 128)
        val = r.integers(0, 1 << bits, (1, 128)).astype(np.int32)
        mask = (r.random((1, 128)) < 0.8).astype(np.int32)
        cases.append((f"sst_b{bits}", "scatter_sum_tile",
                      {"pos_row": pos, "val_row": val, "mask_row": mask},
                      {"out_rows": 16, "bits": bits}))
    return cases + _kernel_lib_constructed() + _kernel_lib_main_path()


def _kernel_lib_constructed() -> list[tuple[str, str, dict, dict]]:
    """Answers outside the contracts (the table of the port's decision in
    csnappy_tpu_torch/ops/kernel_lib.py), and the helpers no JAX test runs."""
    rng = np.random.default_rng(SEED + 7)

    def ints(lo, hi, shape):
        return rng.integers(lo, hi, shape, dtype=np.int64).astype(np.int32)

    full = (-(1 << 31), 1 << 31)
    seq = np.arange(8 * 128, dtype=np.int32).reshape(8, 128) * 3 + 1
    # gather_flat: idx 2048 and -1 on a 2,048-entry table give 0; wide values
    gidx = ints(-3000, 5000, (1, 512))
    gidx[0, :4] = (2048, -1, 2047, -2049)
    # gather_rows_multi clips: 2048 -> T[2047], -1 and -129 -> T[0]
    ridx = ints(-200, 16 * 128 + 200, (16, 128))
    ridx[3, :3] = (2048, -1, -129)
    # scatter_rows_multi: 1,024 x 3 at one position sum; 0x1F0001 at bits 16
    # keeps 21 bits; out-of-range positions scatter nowhere
    dpos = np.full((8, 128), 77, np.int32)
    dpos[5, :10] = (-5, 2048, 4000, 1, 2, 3, 4, 5, 6, 7)
    wide = np.full((8, 128), 0x1F0001, np.int32)
    wide[6] = ints(*full, (128,))
    # scatter_sum_tile: 0x80 and 0x180 at one position give 0x100
    spos = ints(6, 40, (1, 128))              # collisions, but none at 5 beside the two
    spos[0, :2] = 5
    sval = ints(0, 1 << 16, (1, 128))
    sval[0, :2] = (0x80, 0x180)
    smask = (ints(0, 5, (1, 128)) > 0).astype(np.int32)
    smask[0, :2] = 1
    # scan2d_tril: rows 0 and 3 total 2^24 + 2^20 at bits 24 (their totals' bit 24 drops)
    tril = ints(0, 1 << 17, (8, 128))
    tril[[0, 3]] = (1 << 24 | 1 << 20) // 128
    # fill_max_rows: sparse fills a few rows apart
    sparse = np.where(ints(0, 40, (16, 128)) == 0, ints(0, 1 << 18, (16, 128)), 0).astype(np.int32)
    return [
        ("ssd_d1500", "stream_shift_down", {"x": seq}, {"d": 1500, "fill": -7}),
        ("scan2d_wrap", "scan2d", {"x": np.full((8, 128), 300_000_000, np.int32)}, {"op": "add"}),
        ("scan2d_negmax", "scan2d", {"x": ints(-(1 << 31), -(1 << 31) + 5, (8, 128))},
         {"op": "max"}),
        ("gflat_oob_b16", "gather_flat", {"table": ints(*full, (16, 128)), "idx": gidx},
         {"bits": 16}),
        ("gflat_oob_b32", "gather_flat", {"table": ints(*full, (16, 128)), "idx": gidx},
         {"bits": 32}),
        ("lgr_oob", "local_gather_rows", {"vals": ints(*full, (8, 128)),
                                          "li": ints(-200, 300, (8, 128))}, {}),
        ("ssumm_wide_b16", "stream_shift_up_mm",
         {"x": np.full((8, 128), 0x12345678, np.int32)}, {"d": 3, "bits": 16}),
        ("ssumm_neg_b31", "stream_shift_up_mm", {"x": ints(*full, (8, 128))}, {"d": 127}),
        ("scanmm_bite", "scan2d_mm", {"x": np.full((8, 128), 200_000, np.int32)},
         {"op": "add", "bits": 24}),
        ("scanmm_addsat", "scan2d_mm", {"x": ints(-(1 << 22), 1 << 22, (8, 128))},
         {"op": "addsat", "bits": 24}),
        ("scanmm_min_b20", "scan2d_mm", {"x": ints(0, 1 << 21, (16, 128))},
         {"op": "min", "bits": 20}),
        ("scanmm_max_b16", "scan2d_mm", {"x": ints(*full, (8, 128))}, {"op": "max", "bits": 16}),
        ("grm_clip", "gather_rows_multi",
         {"t0": ints(*full, (16, 128)), "t1": ints(*full, (16, 128)),
          "t2": ints(*full, (16, 128)), "idx": ridx},
         {"bits": [8, 16, 32], "r0": 3, "nrows": 8}),
        ("srm_dup", "scatter_rows_multi", {"pos": dpos, "v0": np.full((8, 128), 3, np.int32),
                                           "v1": wide},
         {"bits": [31, 16], "r0": 0, "out_rows": 16, "nrows": 8}),
        ("sst_or", "scatter_sum_tile", {"pos_row": spos, "val_row": sval, "mask_row": smask},
         {"out_rows": 16, "bits": 16}),
        ("sst_neg_b31", "scatter_sum_tile",
         {"pos_row": spos, "val_row": ints(*full, (1, 128)), "mask_row": smask},
         {"out_rows": 16, "bits": 31}),
        ("lg_take", "lane_gather",
         {"x": ints(*full, (8, 128)), "lane_idx": ints(-200, 300, (8, 128))}, {}),
        ("ssdmm_b16", "stream_shift_down_mm", {"x": ints(*full, (8, 128))}, {"d": 5, "bits": 16}),
        ("lsd_k3_b16", "lane_shift_down", {"x": ints(*full, (8, 128))}, {"k": 3, "bits": 16}),
        ("lsd_k0", "lane_shift_down", {"x": ints(*full, (8, 128))}, {"k": 0, "bits": 8}),
        ("lsu_k130_b8", "lane_shift_up", {"x": ints(*full, (8, 128))}, {"k": 130, "bits": 8}),
        ("lsu_k1", "lane_shift_up", {"x": ints(*full, (8, 128))}, {"k": 1}),
        ("rsd_k3", "row_shift_down", {"x": seq}, {"k": 3, "fill": -9}),
        ("rsd_k20", "row_shift_down", {"x": seq}, {"k": 20, "fill": -9}),
        ("rsu_k2", "row_shift_up", {"x": seq}, {"k": 2, "fill": 11}),
        ("tril_b24", "scan2d_tril", {"x": tril}, {"bits": 24}),
        ("tril_b31", "scan2d_tril", {"x": ints(0, 1 << 20, (24, 128))}, {"bits": 31}),
        ("fmr_b18_r2", "fill_max_rows", {"x": sparse}, {"bits": 18, "rounds": 2}),
        ("fmr_b31_r5", "fill_max_rows", {"x": sparse}, {"bits": 31, "rounds": 5}),
        ("flip_b16", "flip2d", {"x": ints(*full, (8, 128))}, {"bits": 16}),
        ("flip_b31", "flip2d", {"x": ints(*full, (24, 128))}, {"bits": 31}),
    ]


def _kernel_lib_main_path() -> list[tuple[str, str, dict, dict]]:
    """``scatter_rows_multi`` at the shapes the JAX fused kernels call it
    with: 16 rows of a 64-row position tile into 256 or 304 output rows
    (csnappy_tpu/ops/decode_fused.py:470, decode_stream.py:315,
    encode_fused.py:375), unique positions masked by the -1 sentinel as the
    callers mask; then duplicates, out-of-range positions and wide values."""
    rng = np.random.default_rng(SEED + 9)

    def ints(lo, hi, shape):
        return rng.integers(lo, hi, shape, dtype=np.int64).astype(np.int32)

    def unique(out_rows):
        pos = rng.permutation(out_rows * 128)[: 64 * 128].astype(np.int32).reshape(64, 128)
        return np.where(rng.random((64, 128)) < 0.3, -1, pos).astype(np.int32)

    def rows(out_rows, bits):
        return {"r0": 16, "out_rows": out_rows, "nrows": 16, "bits": bits}

    dup = ints(-300, 256 * 128 + 300, (64, 128))
    dup[16:32:3] = dup[17]                                # whole rows repeated
    dup[20, :40] = -1
    return [
        ("srm_dec_co256", "scatter_rows_multi",
         {"pos": unique(256), "v0": ints(0, 1 << 31, (64, 128)), "v1": ints(0, 1 << 18, (64, 128))},
         rows(256, [31, 18])),
        ("srm_stream_co256_t3", "scatter_rows_multi",
         {"pos": unique(256), **{f"v{k}": ints(0, 1 << 31, (64, 128)) for k in range(3)}},
         rows(256, [31, 31, 31])),
        ("srm_enc_ocr304_t3", "scatter_rows_multi",
         {"pos": unique(304), **{f"v{k}": ints(0, 1 << 31, (64, 128)) for k in range(3)}},
         rows(304, [31, 31, 31])),
        ("srm_co256_dup", "scatter_rows_multi",
         {"pos": dup, "v0": ints(-(1 << 31), 1 << 31, (64, 128)),
          "v1": ints(-(1 << 31), 1 << 31, (64, 128))},
         rows(256, [31, 18])),
    ]


def kernel_lib_outputs(cases) -> dict[str, list[np.ndarray]]:
    """Each case's outputs from the JAX helper inside a ``pl.pallas_call``
    in interpret mode: ``test_kernel_lib._run`` for one output, a call of
    several VMEM outputs (as tests/test_kernel_lib.py:137) for more."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    from csnappy_tpu.ops import kernel_lib as kl

    run = _test_kernel_lib()._run
    out = {}
    for case, helper, arrays, params in cases:
        ins = [jnp.asarray(a) for a in arrays.values()]
        shape = next(iter(arrays.values())).shape
        if helper in ("gather_rows_multi", "scatter_rows_multi", "fill_max_rows"):
            bits = params.get("bits")
            if helper == "gather_rows_multi":
                nout, shape = len(bits), (params["nrows"], 128)

                def body(*refs, bits=bits, p=params):
                    tabs, idx_ref, outs = refs[: len(bits)], refs[len(bits)], refs[len(bits) + 1:]
                    got = kl.gather_rows_multi([(t[...], b) for t, b in zip(tabs, bits)], idx_ref,
                                               p["r0"], nrows=p["nrows"])
                    for o, g in zip(outs, got):
                        o[...] = g
            elif helper == "scatter_rows_multi":
                nout, shape = len(bits), (params["out_rows"], 128)

                def body(*refs, bits=bits, p=params):
                    pos_ref, vrefs, outs = refs[0], refs[1 : 1 + len(bits)], refs[1 + len(bits):]
                    got = kl.scatter_rows_multi(pos_ref, list(zip(vrefs, bits)), p["r0"],
                                                p["out_rows"], nrows=p["nrows"])
                    for o, g in zip(outs, got):
                        o[...] = g
            else:
                nout = 3

                def body(x_ref, *outs, p=params):
                    for o, g in zip(outs, kl.fill_max_rows(x_ref[...], p["bits"], p["rounds"])):
                        o[...] = g
            got = pl.pallas_call(
                body, out_shape=(jax.ShapeDtypeStruct(shape, jnp.int32),) * nout,
                in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * len(ins),
                out_specs=(pl.BlockSpec(memory_space=pltpu.VMEM),) * nout, interpret=True)(*ins)
            out[case] = [np.asarray(g) for g in got]
            continue
        if helper == "scatter_sum_tile":
            shape = (params["out_rows"], 128)

            def body(p_ref, v_ref, m_ref, o_ref, p=params):
                o_ref[...] = kl.scatter_sum_tile(p_ref[...], v_ref[...], m_ref[...] > 0,
                                                 p["out_rows"], p["bits"])
        else:
            if helper in ("gather_flat", "local_gather_rows", "lane_gather"):
                shape = list(arrays.values())[1].shape

            def body(*refs, fn=getattr(kl, helper), p=params):
                *in_refs, o_ref = refs
                o_ref[...] = fn(*[r[...] for r in in_refs], **p)
        out[case] = [np.asarray(run(body, shape, *ins))]
    return out


def write_kernel_lib() -> None:
    import json

    t0 = time.time()
    cases = build_kernel_lib_cases()
    outs = kernel_lib_outputs(cases)
    a = {"cases": np.array([c[0] for c in cases]), "helpers": np.array([c[1] for c in cases]),
         "args": np.array([",".join(c[2]) for c in cases]),
         "params": np.array([json.dumps(c[3]) for c in cases])}
    for case, _, arrays, _ in cases:
        a.update({f"{case}__{k}": v for k, v in arrays.items()})
        a.update({f"{case}__out{k}": v for k, v in enumerate(outs[case])})
    np.savez_compressed(OUT / "kernel_lib.npz", **a)
    print(f"kernel_lib: {len(cases)} cases ({time.time() - t0:.0f} s)", flush=True)


if __name__ == "__main__":
    sys.exit(main())
