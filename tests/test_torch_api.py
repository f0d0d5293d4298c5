"""Port's public API (``csnappy_tpu_torch.api``) on the CPU.

The ``test_api.py`` cases of the block codec's slice (lengths, roundtrips,
fragment roundtrip, decode errors, the hostile header, the selftests), run
on ``device="cpu"``, plus the routes that differ from the JAX package: the
kernel decides ``dst_len == 0`` and every single-block input itself, and
whole streams that are not segmentable raise ``NotImplementedError``.
"""
import numpy as np
import pytest
import torch

from csnappy_tpu_torch import api, errors
from csnappy_tpu_torch.config import CodecConfig
from csnappy_tpu_torch.models import pymodel, wire

FAKE = b"\x32\xc4foooooo"
CPU = "cpu"


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
    # boundaries: the crossing-stream decoder is a later slice
    with pytest.raises(NotImplementedError, match="decode_stream"):
        api.decompress(unaligned_snappy, device=CPU)


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
    lit = np.random.default_rng(3).integers(0, 256, 40000, dtype=np.uint8).tobytes()
    crossing = bytearray()
    wire.emit_literal(crossing, lit)          # one literal across the 32 KiB boundary
    with pytest.raises(NotImplementedError, match="decode_stream"):
        api.decompress_noheader(bytes(crossing), 40000, device=CPU)
    far = bytearray(crossing)
    far += bytes([wire.TAG_COPY_4 | ((8 - 1) << 2)]) + (33000).to_bytes(4, "little")
    with pytest.raises(NotImplementedError, match="decode_jnp"):
        api.decompress_noheader(bytes(far), 40008, device=CPU)
    # the oracle backend still serves both
    assert api.decompress_noheader(bytes(far), 40008, backend="py") == \
        pymodel.decompress_noheader(bytes(far), 40008)


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
