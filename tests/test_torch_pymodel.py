"""The port's oracle additions, mirroring ``tests/test_pymodel.py:115-178``:
``wire.make_opcode_table``, ``pymodel.decompress_stream`` (bounded-window
streaming decode) and ``pymodel.compress_fragment_table`` (the second,
lossy-table match-finder), each also held against the JAX package's copy."""
import numpy as np
import pytest

from csnappy_tpu.models import pymodel as jax_pymodel
from csnappy_tpu.models import wire as jax_wire
from csnappy_tpu_torch import errors
from csnappy_tpu_torch.models import pymodel, wire


def test_opcode_table_shape():
    t = wire.make_opcode_table()
    assert t.shape == (256, 4)
    # literal 0x00 -> length 1; copy1 base; copy2 len 64 ceiling
    assert t[0x00].tolist() == [1, 0, 1, 0]
    assert t[0xFC].tolist() == [0, 4, 1, 0]  # literal u=63 -> 4 trailer bytes
    assert (t[1::4, 1] == 1).all()  # every copy1 has 1 trailer byte
    assert (t[2::4, 1] == 2).all()
    assert (t[3::4, 1] == 4).all()


def test_opcode_table_equals_jax():
    assert np.array_equal(wire.OPCODE_TABLE, jax_wire.OPCODE_TABLE)
    assert wire.OPCODE_TABLE.dtype == jax_wire.OPCODE_TABLE.dtype


class TestStreamingDecode:
    """Bounded-window streaming decode (OutputBuffer.py analog)."""

    def test_urls_with_window_memory(self, urls10k, urls10k_snappy):
        ulen, hdr = wire.varint_decode(urls10k_snappy)
        chunks = []
        n = pymodel.decompress_stream(urls10k_snappy[hdr:], chunks.append, ulen, window=32768)
        assert n == ulen
        assert b"".join(chunks) == urls10k

    def test_overlap_and_small_window(self):
        data = b"ab" * 1000 + b"xyz" * 500
        comp = pymodel.compress_fragment(data)
        chunks = []
        pymodel.decompress_stream(comp, chunks.append, len(data), window=4096)
        assert b"".join(chunks) == data

    def test_offset_beyond_window_rejected(self):
        comp = pymodel.compress_fragment(b"Q" * 9000 + bytes(range(200)) + b"Q" * 9000)
        # a window smaller than the largest offset must be detected, not
        # silently corrupt
        try:
            pymodel.decompress_stream(comp, lambda c: None, 1 << 20, window=256)
        except errors.SnappyError as e:
            assert e.code == errors.E_DATA_MALFORMED

    @pytest.mark.parametrize("window", [256, 4096, 32768])
    def test_chunks_and_errors_equal_jax(self, urls10k, window):
        rng = np.random.default_rng(window)
        body = pymodel.compress_fragment(urls10k[:20000])
        bad = bytearray(body)
        bad[int(rng.integers(0, len(bad)))] ^= 0x41
        for src, cap in ((body, 20000), (body, 19000), (bytes(bad), 20000)):
            got, want = [], []
            try:
                res = pymodel.decompress_stream(src, got.append, cap, window=window)
            except errors.SnappyError as e:
                res = e.code
            try:
                ref = jax_pymodel.decompress_stream(src, want.append, cap, window=window)
            except Exception as e:       # the JAX package's SnappyError
                ref = e.code
            assert (res, got) == (ref, want)


def test_second_matcher_table(urls10k):
    # any match strategy must emit a conformant stream that the oracle decodes
    data = urls10k[:32768]
    frag_dict = pymodel.compress_fragment(data)
    frag_tab = pymodel.compress_fragment_table(data)
    assert pymodel.decompress_noheader(frag_tab, len(data)) == data
    assert frag_dict != frag_tab              # genuinely different strategies
    # the lossy table compresses worse than the exhaustive dict, but must
    # still compress real text
    assert len(frag_dict) <= len(frag_tab) < len(data)


def test_second_matcher_roundtrip_patterns():
    for data in (b"", b"a", b"ab" * 5000, bytes(range(256)) * 10,
                 b"\x00" * 4000, b"abcabcabcabcx" * 100):
        frag = pymodel.compress_fragment_table(data)
        assert pymodel.decompress_noheader(frag, len(data)) == data


@pytest.mark.parametrize("bits", [10, 12, 14])
def test_second_matcher_equals_jax(urls10k, bits):
    for data in (urls10k[:32768], b"abcabcabcabcx" * 100, bytes(range(256)) * 10):
        assert pymodel.compress_fragment_table(data, bits) == \
            jax_pymodel.compress_fragment_table(data, bits)
