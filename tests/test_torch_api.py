"""Port's public API (``csnappy_tpu_torch.api``) on the CPU.

The ``test_api.py`` cases of the block codec's slice (lengths, roundtrips,
fragment roundtrip, decode errors, the hostile header, the selftests), run
on ``device="cpu"``, plus the routes of the port: the kernel decides
``dst_len == 0`` and every single-block input itself, and whole streams
that are not segmentable (crossing, far offsets) decode as the JAX package
decodes them.
"""
import hashlib
import pathlib

import numpy as np
import pytest
import torch

from csnappy_tpu_torch import api, errors
from csnappy_tpu_torch.config import CodecConfig
from csnappy_tpu_torch.models import pymodel, wire
from csnappy_tpu_torch.runtime import native

# the suite runs in parallel worker processes: one intra-op thread each keeps
# the torch ops here from contending with every other worker
torch.set_num_threads(1)

FAKE = b"\x32\xc4foooooo"
CPU = "cpu"
STREAMS = pathlib.Path(__file__).parent / "data" / "torch_ref" / "streams.npz"


def _fixture_stream(name: str) -> tuple[bytes, int]:
    with np.load(STREAMS) as z:
        i = [str(n) for n in z["names"]].index(name)
        return z["body"][z["offs"][i] : z["offs"][i + 1]].tobytes(), int(z["dst_len"][i])


def _jax_api_answer(name: str) -> bytes:
    """The port's bytes for a fixture stream, once checked against the sha256
    of what the JAX package's ``api.decompress_noheader`` returned for it."""
    body, cap = _fixture_stream(name)
    with np.load(STREAMS) as z:
        i = [str(n) for n in z["names"]].index(name)
        assert z["api_status"][i] == 0
        want = z["api_sha"][i].tobytes()
    got = pymodel.decompress_noheader(body, cap)
    assert hashlib.sha256(got).digest() == want
    return got


def _code(fn):
    with pytest.raises(errors.SnappyError) as ei:
        fn()
    return ei.value.code


class TestApi:
    def test_max_compressed_length(self):
        assert api.max_compressed_length(32768) == 32 + 32768 + 32768 // 6

    def test_get_uncompressed_length(self, urls10k_snappy, urls10k):
        ulen, n = api.get_uncompressed_length(urls10k_snappy)
        assert ulen == len(urls10k)
        assert _code(lambda: api.get_uncompressed_length(b"\xff" * 6)) == errors.E_HEADER_BAD

    @pytest.mark.parametrize("backend", ["py", "torch"])
    def test_roundtrip_both_backends(self, backend, urls10k):
        data = urls10k[:70000]
        comp = api.compress(data, backend=backend, device=CPU)
        assert api.decompress(comp, backend=backend, device=CPU) == data
        other = "torch" if backend == "py" else "py"
        assert api.decompress(comp, backend=other, device=CPU) == data

    def test_fragment_roundtrip(self, urls10k):
        data = urls10k[:32768]
        frag = api.compress_fragment(data, device=CPU)
        assert api.decompress_noheader(frag, len(data), device=CPU) == data
        assert len(frag) <= api.max_compressed_length(len(data))
        with pytest.raises(ValueError):
            api.compress_fragment(b"x" * 40000, device=CPU)

    def test_decompress_errors(self, urls10k_snappy):
        assert _code(lambda: api.decompress(urls10k_snappy, dst_len=10, device=CPU)) \
            == errors.E_OUTPUT_INSUF
        with pytest.raises(errors.SnappyError):
            api.decompress(FAKE, device=CPU)

    def test_hostile_header_length_rejected(self):
        hostile = wire.varint_encode((1 << 32) - 1) + b"\x00a"
        assert _code(lambda: api.decompress(hostile, device=CPU)) == errors.E_HEADER_BAD
        data = b"z" * 30000
        comp = api.compress(data, backend="py")
        assert api.decompress(comp, device=CPU) == data

    def test_selftest_compression_contract(self):
        rng = np.random.default_rng(0)
        data = rng.integers(0, 256, size=4096 + 100, dtype=np.uint8).tobytes()
        comp = api.compress(data, device=CPU)
        assert len(comp) <= api.max_compressed_length(len(data)) + wire.MAX_VARINT32_BYTES

    def test_selftest_decompression(self):
        rng = np.random.default_rng(1)
        data = rng.integers(0, 256, size=4096 + 100, dtype=np.uint8).tobytes()
        comp = api.compress(data, device=CPU)
        assert api.decompress(comp, device=CPU) == data
        assert _code(lambda: api.decompress(comp, dst_len=len(data) - 1, device=CPU)) \
            == errors.E_OUTPUT_INSUF
        hdr = wire.varint_decode(comp)[1]
        assert _code(lambda: api.decompress_noheader(comp[hdr:], len(data) - 1, device=CPU)) \
            == errors.E_OUTPUT_OVERRUN
        for fn in (lambda: api.decompress(FAKE, device=CPU),
                   lambda: api.decompress_noheader(FAKE, 4096, device=CPU)):
            with pytest.raises(errors.SnappyError):
                fn()


# ------------------------------------------------------------- the port's routes


def test_golden_stream_and_fixture(urls10k, urls10k_snappy, unaligned_bin, unaligned_snappy):
    assert api.decompress(urls10k_snappy, device=CPU) == urls10k
    assert api.decompress(api.compress(unaligned_bin, device=CPU), device=CPU) == unaligned_bin
    # the reference's unaligned stream has tags across 32 KiB output
    # boundaries: the crossing-stream decoder serves it, as in the JAX package
    body, ulen = unaligned_snappy[3:], wire.varint_decode(unaligned_snappy)[0]
    assert native.scan_segments(body, ulen)[0] == native.SCAN_CROSSING
    got = api.decompress(unaligned_snappy, device=CPU)
    assert got == unaligned_bin == pymodel.decompress(unaligned_snappy)
    assert got == _jax_api_answer("unaligned")


def test_zero_limit_decided_by_the_decoder():
    frag = pymodel.compress_fragment(b"abc")
    assert _code(lambda: api.decompress_noheader(frag, 0, device=CPU)) == errors.E_OUTPUT_OVERRUN
    assert api.decompress_noheader(b"", 0, device=CPU) == b""
    assert api.decompress(b"\x00", device=CPU) == b""


@pytest.mark.parametrize("frag, cap", [
    (b"\xc4foooooo", 4096),                   # literal past the end
    (b"\x00a\x01\x00", 4096),                 # offset 0
    (b"\x00a\x0a\x08\x00", 4096),             # offset past the written bytes
    (b"\x00a\x02", 4096),                     # truncated COPY_1 header
    (b"\x00a\x07\x10\x00\x00", 4096),         # truncated COPY_4 header
    (b"\xfc\xff\xff\xff\xff", 32768),         # literal of 2^32 bytes
])
def test_single_block_errors_equal_the_oracle(frag, cap):
    want = _code(lambda: pymodel.decompress_noheader(frag, cap))
    assert _code(lambda: api.decompress_noheader(frag, cap, device=CPU)) == want


def test_input_not_consumed_folds_into_overrun():
    # output exactly full with tags left: the oracle's header mode says
    # E_INPUT_NOT_CONSUMED, the reference C (and this API) E_OUTPUT_OVERRUN
    s = bytearray(wire.varint_encode(3))
    wire.emit_literal(s, b"abc")
    wire.emit_literal(s, b"d")
    assert _code(lambda: pymodel.decompress(bytes(s))) == errors.E_INPUT_NOT_CONSUMED
    assert _code(lambda: api.decompress(bytes(s), device=CPU)) == errors.E_OUTPUT_OVERRUN


def test_short_stream_fails_the_produced_length_check(urls10k):
    comp = api.compress(urls10k[:50000], device=CPU)
    n, hdr = wire.varint_decode(comp)
    lying = wire.varint_encode(n + 5) + comp[hdr:]
    assert _code(lambda: api.decompress(lying, device=CPU)) == errors.E_DATA_MALFORMED


def test_long_stream_error_is_the_scans_exact_code(urls10k):
    comp = pymodel.compress(urls10k[:70000])
    hdr = wire.varint_decode(comp)[1]
    body = comp[hdr:]
    cases = [(body[:-1], 70000), (body, 69999), (body[:40000] + b"\x0a\xff\xff", 70000)]
    for src, cap in cases:
        want = _code(lambda: pymodel.decompress_noheader(src, cap))
        assert _code(lambda: api.decompress_noheader(src, cap, device=CPU)) == want


def test_crossing_and_far_streams_not_ported_yet():
    # named for when these streams raised; both classes now decode, equal to
    # the oracle and to what the JAX package's API answered
    lit = np.random.default_rng(3).integers(0, 256, 40000, dtype=np.uint8).tobytes()
    crossing = bytearray()
    wire.emit_literal(crossing, lit)          # one literal across the 32 KiB boundary
    far = bytearray(crossing)
    far += bytes([wire.TAG_COPY_4 | ((8 - 1) << 2)]) + (33000).to_bytes(4, "little")
    for stream, cap, rc in ((crossing, 40000, native.SCAN_CROSSING),
                            (far, 40008, native.SCAN_FAR_OFFSET)):
        stream = bytes(stream)
        assert native.scan_segments(stream, cap)[0] == rc
        want = pymodel.decompress_noheader(stream, cap)
        assert api.decompress_noheader(stream, cap, device=CPU) == want
        assert api.decompress_noheader(stream, cap, backend="py") == want
    for name in ("straddling_literal", "copy4_offset_40000"):
        body, cap = _fixture_stream(name)
        assert api.decompress_noheader(body, cap, device=CPU) == _jax_api_answer(name)


def test_config_device_and_debug_checks(urls10k):
    cfg = CodecConfig(device=CPU, debug_checks=True)
    data = urls10k[:40000]
    assert api.decompress(api.compress(data, config=cfg), config=cfg) == data
    assert api.decompress_noheader(api.compress_fragment(data[:100], config=cfg), 100,
                                   config=cfg) == data[:100]


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.compress(b"abc")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.decompress(pymodel.compress(b"abc"))
    assert api.compress(b"abc", backend="py") == pymodel.compress(b"abc")


# ------------------------------------- the routed decode's fallbacks, as in JAX


def _oracle_answer(body: bytes, cap: int) -> tuple[bytes, int]:
    try:
        return pymodel.decompress_noheader(body, cap), errors.E_OK
    except errors.SnappyError as e:
        return b"", e.code


def _port_answer(body: bytes, cap: int) -> tuple[bytes, int]:
    try:
        return api.decompress_noheader(body, cap, device=CPU), errors.E_OK
    except errors.SnappyError as e:
        return b"", e.code


def _spy(monkeypatch, mod, name: str) -> list:
    calls, real = [], getattr(mod, name)
    monkeypatch.setattr(mod, name, lambda *a, **k: calls.append(1) or real(*a, **k))
    return calls


def test_segment_decoder_disagreeing_with_the_scan_is_redecided(monkeypatch, urls10k_snappy):
    # csnappy_tpu/api.py:177-189: with device="cpu" a segment decoder that
    # disagrees with the host scan (here one segment comes back a byte short)
    # re-decides the stream with decode_jnp; on the card it raises
    # (test_torch_cuda.py::test_segment_decoder_fault_raises_on_the_card)
    from csnappy_tpu_torch.ops import decode_fused, decode_jnp

    real = decode_fused.decode_segments

    def short(*a, **k):
        out, prod, status = real(*a, **k)
        prod = prod.clone()
        prod[0] -= 1
        return out, prod, status

    monkeypatch.setattr(decode_fused, "decode_segments", short)
    jnp_calls = _spy(monkeypatch, decode_jnp, "decompress_noheader_np")
    golden = urls10k_snappy[wire.varint_decode(urls10k_snappy)[1]:]
    ulen = wire.varint_decode(urls10k_snappy)[0]
    assert native.scan_segments(golden, ulen)[0] == native.SCAN_SEGMENTABLE
    for body, cap in ((golden, ulen), _fixture_stream("straddling_literal")):
        assert _port_answer(body, cap) == _oracle_answer(body, cap)
    assert len(jnp_calls) == 1                       # the golden stream, re-decided


def test_routed_decode_without_the_host_library(monkeypatch, request, urls10k_snappy):
    # csnappy_tpu/api.py:141-147, :197-205: with no host library the scan is
    # skipped and decode_stream (then decode_jnp on E_DATA_MALFORMED) decides
    from csnappy_tpu_torch.ops import decode_stream, decode_ws

    def no_library():
        raise OSError("libcsnappy_host: cannot open shared object file")

    monkeypatch.setattr(native, "_lib", no_library)
    native.available.cache_clear()                   # available() keeps its answer
    request.addfinalizer(native.available.cache_clear)
    assert native.available() is False
    stream_calls = _spy(monkeypatch, decode_stream, "decompress_noheader_np")
    crossing = _fixture_stream("straddling_literal")
    assert _port_answer(*crossing) == _oracle_answer(*crossing)
    # a stream decode_ws does not verify, with no scan to route it
    monkeypatch.setattr(decode_ws, "decompress_noheader_ws", lambda *a, **k: None)
    golden = urls10k_snappy[wire.varint_decode(urls10k_snappy)[1]:]
    ulen = wire.varint_decode(urls10k_snappy)[0]
    assert _port_answer(golden, ulen) == _oracle_answer(golden, ulen)
    assert len(stream_calls) == 2
