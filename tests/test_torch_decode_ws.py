"""Port's whole-stream pipeline (``csnappy_tpu_torch.ops.decode_ws``) on the CPU.

The seven cases of ``test_decode_ws.py`` through the port's plain versions
(``device="cpu"``: the dense parse and the walk of ``scan_plain``, then the
segment decoder's plain version), the dense parse against the JAX
``_entries``, and every stream of ``tests/data/torch_ref/streams.npz``
against what the JAX pipeline answered for it: the scan's ``seg[:nseg]``
and ``meta[:3]``, and bytes or None; the adversarial streams of
``scan_adv.npz`` against the JAX scan.  Then a numpy model of the card
kernel's decomposition (``csrc/scan_segments.cu``: chunk tables by pointer
jumping, one lookup a chunk, slots by the kernel's rule), held to
``scan_plain`` at chunk sizes that make skipped chunks, stops at chunk edges
and chains that never merge occur at small sizes.  All exact.
"""
import functools
import hashlib
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csnappy_tpu.ops import decode_ws as jax_ws
from csnappy_tpu_torch import api
from csnappy_tpu_torch.models import pymodel, wire
from csnappy_tpu_torch.ops import decode_ws

# the suite runs in parallel worker processes: one intra-op thread each keeps
# the torch ops here from contending with every other worker
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = "cpu"


def _maker():
    spec = importlib.util.spec_from_file_location(
        "make_torch_fixtures", ROOT / "tools" / "make_torch_fixtures.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


MAKER = _maker()
STREAMS, REF = MAKER.read_streams()
ADV, ADV_REF = MAKER.read_scan_adv()
JAX_ENTRIES = jax.jit(jax_ws._entries)


def _ws(body: bytes, ulen: int):
    return decode_ws.decompress_noheader_ws(body, ulen, device=CPU)


def _split(stream: bytes):
    ulen, hdr = wire.varint_decode(stream)
    return stream[hdr:], ulen


def test_multisegment_own_stream(urls10k):
    data = urls10k[:120000]
    assert _ws(*_split(pymodel.compress(data))) == data


def test_golden_reference_stream(urls10k, urls10k_snappy):
    assert _ws(*_split(urls10k_snappy)) == urls10k


def test_straddling_literal_returns_none():
    # one literal across every 32 KiB boundary: the walk stops at its zero
    # entry and the pipeline declines, never emits wrong bytes
    raw = np.random.default_rng(5).integers(0, 256, 100000, dtype=np.uint8).tobytes()
    s = bytearray()
    wire.emit_literal(s, raw)
    assert _ws(bytes(s), len(raw)) is None


def test_malformed_matches_oracle(urls10k):
    body, ulen = _split(pymodel.compress(urls10k[:100000]))
    body = bytearray(body)
    body[len(body) // 2] ^= 0x5A
    res = _ws(bytes(body), ulen)
    if res is not None:
        assert res == pymodel.decompress_noheader(bytes(body), ulen)


def test_plan_envelope_equals_jax():
    # the port has no shape buckets (nothing compiles per shape), but it
    # declines exactly where the JAX plan does
    sizes = [(100, 1000), (2, 32769), (1, 40000), (350000, 702087), (351234, 700000),
             (decode_ws.MAX_FAST_MB << 20, 128 << 20), ((decode_ws.MAX_FAST_MB << 20) + 1, 256 << 20),
             (1 << 20, (128 << 20) + 1), (5000, 65536), (5000, 32768)]
    for src_len, dst_len in sizes:
        want = jax_ws.plan(src_len, dst_len)
        got = decode_ws.plan(src_len, dst_len)
        assert (got is None) == (want is None), (src_len, dst_len)
        assert got is None or got == -(-dst_len // decode_ws.SEG)
    assert decode_ws.plan(100, 1000) is None        # single segment: the block path


def test_oversized_stream_declines():
    big_src = (decode_ws.MAX_FAST_MB << 20) + 1
    assert decode_ws.plan(big_src, 256 << 20) is None
    assert decode_ws.plan(1 << 20, (128 << 20) + 1) is None
    assert _ws(np.zeros(big_src, np.uint8), 256 << 20) is None


def test_api_straddling_literal_routes_correctly():
    raw = np.random.default_rng(7).integers(0, 256, 80000, dtype=np.uint8).tobytes()
    s = bytearray()
    wire.emit_literal(s, raw)
    assert _ws(bytes(s), len(raw)) is None
    assert api.decompress_noheader(bytes(s), len(raw), device=CPU) == raw


# ---------------------------------------------------- against the JAX module


@pytest.mark.parametrize("body", [b for _, b, _ in STREAMS[:3]] + [
    np.random.default_rng(9).integers(0, 256, 3000, dtype=np.uint8).tobytes()],
    ids=[n for n, _, _ in STREAMS[:3]] + ["random"])
def test_entries_equal_jax(body):
    # the JAX parse works on (rows, 128) tiles padded with zeros; one shape
    # for every case, so it compiles once
    n = len(body)
    rows = -(-(max(len(b) for _, b, _ in STREAMS[:3]) + 4) // 128)
    arr = np.zeros(rows * 128, np.uint8)
    arr[:n] = np.frombuffer(body, np.uint8)
    want = np.asarray(JAX_ENTRIES(jnp.asarray(arr.astype(np.int32)).reshape(rows, 128),
                                  jnp.int32(n))).reshape(-1)[:n]
    got = decode_ws.entries(torch.frombuffer(bytearray(body), dtype=torch.uint8))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("i", range(len(STREAMS)), ids=[s[0] for s in STREAMS])
def test_scan_and_answer_equal_jax(i):
    _, body, dst = STREAMS[i]
    nseg = decode_ws.plan(len(body), dst)
    want_seg = REF["ws_seg"][REF["ws_seg_offs"][i] : REF["ws_seg_offs"][i + 1]]
    if nseg is None:
        assert len(want_seg) == 0 and not REF["ws_bytes"][i]
        assert _ws(body, dst) is None
        return
    seg, meta = decode_ws.scan_segments(body, nseg + 1, device=CPU)
    assert seg[:nseg].tolist() == want_seg.tolist()
    assert meta[:3].tolist() == REF["ws_meta"][i].tolist()
    res = _ws(body, dst)
    assert (res is not None) == bool(REF["ws_bytes"][i])
    if res is not None:
        assert hashlib.sha256(res).digest() == REF["ws_sha"][i].tobytes()


def test_fixture_covers_both_answers():
    assert REF["ws_bytes"].any() and not REF["ws_bytes"].all()


def test_wrapper_checks():
    with pytest.raises(ValueError):
        decode_ws.scan_segments(b"\x00a", 0, device=CPU)
    seg, meta = decode_ws.scan_segments(b"", 3, device=CPU)
    assert seg.tolist() == [0, 0, 0] and meta.tolist() == [0, 0, 0, 0]


# ------------------------------------------- the adversarial scan group


def test_scan_adv_inputs_rebuild():
    assert [(n, b, d) for n, b, d in MAKER.load_scan_adv()] == ADV


@pytest.mark.parametrize("i", range(len(ADV)), ids=[s[0] for s in ADV])
def test_scan_adv_equals_jax(i):
    _, body, dst = ADV[i]
    nseg = decode_ws.plan(len(body), dst)
    seg, meta = decode_ws.scan_segments(body, nseg + 1, device=CPU)
    want = ADV_REF["jax_seg"][ADV_REF["jax_seg_offs"][i] : ADV_REF["jax_seg_offs"][i + 1]]
    assert seg[:nseg].tolist() == want.tolist()
    assert meta[:3].tolist() == ADV_REF["jax_meta"][i].tolist()
    pinned = ADV_REF["plain_seg"][ADV_REF["plain_seg_offs"][i] : ADV_REF["plain_seg_offs"][i + 1]]
    assert seg.tolist() == pinned.tolist() and meta.tolist() == ADV_REF["plain_meta"][i].tolist()


# ------------------------------- a model of the card kernel's decomposition

SEG = decode_ws.SEG
SUB = 256          # the kernel's sub-chunks (kSubLog = 8)


def chunk_scan_model(body: bytes, nslots, C: int):
    """The decomposition of ``csrc/scan_segments.cu`` in numpy, chunk size C
    (any, not only the kernel's powers of two).  Returns {nslot: (seg, meta[:3])}.

    Chunk tables: every position's exit from its sub-chunk (J1, P1), then from
    its chunk (J, P), by pointer jumping.  Chaining: one lookup a chunk.
    Slots: each visited chunk writes the boundaries in its output range, each
    exactly once, by sub-chunk hops and then tags from its entry."""
    n = len(body)
    nchunks = n // C + 1
    N = nchunks * C
    ent = np.zeros(N, np.int64)
    ent[:n] = decode_ws.entries(torch.frombuffer(bytearray(body), dtype=torch.uint8)
                                if n else torch.zeros(0, dtype=torch.uint8)).numpy().view(np.uint32)
    adv, prod = ent & 0xFFFF, ent >> 16
    pos = np.arange(N, dtype=np.int64)
    cstart = pos - pos % C
    sub_end = np.minimum(cstart + (pos % C // SUB + 1) * SUB, cstart + C)

    def jump(J, P, stop, end, max_rounds):
        for r in range(max_rounds + 1):
            live = ~stop & (J < end)
            if not live.any():
                return
            assert r < max_rounds, "pointer jumping did not end within its bound"
            j = J[live]
            J[live], P[live], stop[live] = J[j], P[live] + P[j], stop[j]

    stop1 = ent == 0
    J1, P1 = np.where(stop1, pos, pos + adv), np.where(stop1, 0, prod)
    jump(J1, P1, stop1, sub_end, (SUB // 2).bit_length())
    J, P, stopc = J1.copy(), P1.copy(), stop1.copy()
    jump(J, P, stopc, cstart + C, (-(-C // SUB)).bit_length())

    visited, e, pp = [], 0, 0          # (entry, pp at entry, pp at exit or stop, stops)
    while True:
        out = pp + int(P[e])
        visited.append((e, pp, out, bool(stopc[e])))
        if stopc[e]:
            stop_at, pp_stop = int(J[e]), out
            break
        assert J[e] >= cstart[e] + C and J[e] <= n        # lands in a later chunk
        e, pp = int(J[e]), out

    def last_at_or_below(x, px, bound):
        end = cstart[x] + C
        while True:
            py = px + int(P1[x])
            if py > bound:
                break
            if stop1[x]:
                x, px = int(J1[x]), py
                break
            if J1[x] >= end:
                break
            x, px = int(J1[x]), py
        while ent[x] and px + int(prod[x]) <= bound and x + adv[x] < end:
            x, px = int(x + adv[x]), px + int(prod[x])
        return x, px

    got = {}
    for nslot in nslots:
        seg = np.full(nslot, -1, np.int64)
        for e, pp, out, stops in visited:
            kstop = -(-out // SEG)
            k1 = nslot - 2 if stops else min(kstop - 1, nslot - 2)
            for k in range(-(-pp // SEG), k1 + 1):
                v = n
                if not stops or k <= kstop:
                    q, pq = last_at_or_below(e, pp, k * SEG)
                    v = q if pq > (k - 1) * SEG else n
                assert seg[k] == -1, "a slot written twice"
                seg[k] = v
            if stops:
                assert seg[nslot - 1] == -1
                seg[nslot - 1] = stop_at if kstop >= nslot - 1 else n
        assert (seg >= 0).all(), "a slot no chunk wrote"
        got[nslot] = (seg, [stop_at, pp_stop, 0])
    return got


def _tiny_tags() -> bytes:
    return b"\x04ab" + bytes([wire.TAG_COPY_1, 2]) * 40000      # 40,001 tags of 2-3 bytes


MODEL_CASES = ([("streams", n, b, d) for n, b, d in STREAMS] + [("scan_adv", n, b, d) for n, b, d in ADV]
               + [("edges", "tiny_tags_40001", _tiny_tags(), 3 + 4 * 40000),
                  ("edges", "empty", b"", 0), ("edges", "one_byte", b"\x00", 1)])


@functools.cache
def _plain(i: int, nslot: int):
    body = MODEL_CASES[i][2]
    seg, meta = decode_ws.scan_plain(torch.frombuffer(bytearray(body), dtype=torch.uint8)
                                     if body else torch.zeros(0, dtype=torch.uint8), nslot)
    return seg.tolist(), meta[:3].tolist()


@pytest.mark.parametrize("C", [64, 1000, 8192])
@pytest.mark.parametrize("i", range(len(MODEL_CASES)),
                         ids=[f"{g}-{n}" for g, n, _, _ in MODEL_CASES])
def test_chunk_model_equals_scan_plain(i, C):
    _, _, body, dst = MODEL_CASES[i]
    nseg = -(-dst // SEG)
    nslots = sorted({nseg + 1, 2, 1})
    got = chunk_scan_model(body, nslots, C)
    for nslot in nslots:
        seg, meta = _plain(i, nslot)
        assert got[nslot][0].tolist() == seg, nslot
        assert got[nslot][1] == meta, nslot
