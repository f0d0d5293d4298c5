"""Port's whole-stream pipeline (``csnappy_tpu_torch.ops.decode_ws``) on the CPU.

The seven cases of ``test_decode_ws.py`` through the port's plain versions
(``device="cpu"``: the dense parse and the walk of ``scan_plain``, then the
segment decoder's plain version), the dense parse against the JAX
``_entries``, and every stream of ``tests/data/torch_ref/streams.npz``
against what the JAX pipeline answered for it: the scan's ``seg[:nseg]``
and ``meta[:3]``, and bytes or None.  All exact.
"""
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

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs in parallel worker processes; one intra-op thread each
    # keeps the torch ops here from contending with every other worker
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _maker():
    spec = importlib.util.spec_from_file_location(
        "make_torch_fixtures", ROOT / "tools" / "make_torch_fixtures.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


STREAMS, REF = _maker().read_streams()
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
