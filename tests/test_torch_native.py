"""The port's ``native`` backend (``runtime/native.py`` over its own
``csrc/host/csnappy_host.cpp``), mirroring ``tests/test_native.py:12-60``,
and held byte for byte against ``csnappy_tpu.runtime.native``: the same C++
algorithm, so the same streams and the same error codes.
"""
import numpy as np
import pytest
import torch

from csnappy_tpu import errors as jax_errors
from csnappy_tpu.runtime import native as jax_native
from csnappy_tpu_torch import api, errors
from csnappy_tpu_torch.models import pymodel, wire
from csnappy_tpu_torch.runtime import native

# the suite runs in parallel worker processes: one intra-op thread each keeps
# the torch ops here from contending with every other worker
torch.set_num_threads(1)

PATTERNS = [b"", b"x", b"a" * 70000, bytes(range(256)) * 200]


def test_golden_decode(urls10k, urls10k_snappy):
    assert native.decompress(urls10k_snappy, len(urls10k)) == urls10k


def test_unaligned_decode(unaligned_bin, unaligned_snappy):
    assert native.decompress(unaligned_snappy, len(unaligned_bin)) == unaligned_bin


def test_baddata3_rejected(baddata3):
    with pytest.raises(errors.SnappyError):
        native.decompress(baddata3, 1 << 22)


def test_roundtrip_and_ratio(urls10k):
    comp = native.compress(urls10k)
    assert pymodel.decompress(comp) == urls10k       # py oracle decodes it
    assert native.decompress(comp, len(urls10k)) == urls10k
    assert len(comp) <= 357267, f"native ratio regression: {len(comp)}"


def test_cross_backend_interop(urls10k):
    data = urls10k[:100000]
    for enc in ("py", "native", "torch"):
        comp = api.compress(data, backend=enc, device="cpu")
        for dec in ("py", "native", "torch"):
            assert api.decompress(comp, backend=dec, device="cpu") == data, (enc, dec)


def test_error_codes(urls10k, urls10k_snappy):
    with pytest.raises(errors.SnappyError) as ei:
        native.decompress(urls10k_snappy, 100)
    assert ei.value.code == errors.E_OUTPUT_INSUF
    with pytest.raises(errors.SnappyError) as ei:
        native.decompress(b"\xff\xff\xff\xff\xff\xff", 10)
    assert ei.value.code == errors.E_HEADER_BAD
    hdr = wire.varint_decode(urls10k_snappy)[1]
    with pytest.raises(errors.SnappyError) as ei:
        native.decompress_noheader(urls10k_snappy[hdr:], len(urls10k) - 1)
    assert ei.value.code == errors.E_OUTPUT_OVERRUN
    with pytest.raises(errors.SnappyError):
        native.decompress(b"\x32\xc4foooooo", 4096)


@pytest.mark.parametrize("data", PATTERNS, ids=["empty", "one", "run70000", "range256x200"])
def test_roundtrip_patterns(data):
    comp = native.compress(data)
    assert native.decompress(comp, len(data)) == data
    assert pymodel.decompress(comp) == data


def test_compact():
    padded = np.zeros((3, 16), np.uint8)
    padded[0, :4] = [1, 2, 3, 4]
    padded[1, :2] = [5, 6]
    padded[2, :3] = [7, 8, 9]
    assert native.compact(padded, np.array([4, 2, 3])) == bytes([1, 2, 3, 4, 5, 6, 7, 8, 9])


# ------------------------------------------- byte identity with the JAX native


def test_compress_equals_jax_native_on_urls(urls10k):
    assert native.compress(urls10k) == jax_native.compress(urls10k)


@pytest.mark.parametrize("data", PATTERNS, ids=["empty", "one", "run70000", "range256x200"])
def test_compress_equals_jax_native_on_patterns(data):
    assert native.compress(data) == jax_native.compress(data)
    frag = data[:32768]
    assert native.compress_fragment(frag) == jax_native.compress_fragment(frag)


def test_error_codes_equal_jax_native(urls10k_snappy, baddata3):
    hdr = wire.varint_decode(urls10k_snappy)[1]
    rng = np.random.default_rng(9)
    cases = [(baddata3, 1 << 22, True), (b"\xff\xff\xff\xff\xff\xff", 10, True),
             (urls10k_snappy, 100, True), (b"\x32\xc4foooooo", 4096, True),
             (urls10k_snappy[hdr:], 702086, False), (urls10k_snappy[hdr : hdr + 5000], 40000, False)]
    for _ in range(6):
        bad = bytearray(urls10k_snappy[hdr : hdr + 3000])
        bad[int(rng.integers(0, len(bad)))] ^= 1 << int(rng.integers(0, 8))
        cases.append((bytes(bad), 10000, False))
    for src, cap, header in cases:
        fn = "decompress" if header else "decompress_noheader"
        try:
            want = getattr(jax_native, fn)(src, cap)
        except jax_errors.SnappyError as e:
            want = e.code
        try:
            got = getattr(native, fn)(src, cap)
        except errors.SnappyError as e:
            got = e.code
        assert got == want, (fn, len(src), cap)


def test_api_native_routes():
    data = bytes(range(256)) * 50
    assert api.compress(data, backend="native") == jax_native.compress(data)
    assert api.compress_fragment(data[:1000], backend="native") == \
        jax_native.compress_fragment(data[:1000])
    comp = api.compress(data, backend="native")
    hdr = wire.varint_decode(comp)[1]
    assert api.decompress_noheader(comp[hdr:], len(data), backend="native") == data
    with pytest.raises(errors.SnappyError) as e:
        api.decompress_noheader(comp[hdr:], len(data) - 1, backend="native")
    assert e.value.code == errors.E_OUTPUT_OVERRUN
