"""Port's general decoder (``csnappy_tpu_torch.ops.decode_jnp``, torch ops) on the CPU.

The eleven cases of ``test_decode_jnp.py``, the JAX module's own rules
where they differ from the oracle's, and every stream of
``tests/data/torch_ref/streams.npz`` against what the JAX decoder returned
for it (``produced``, ``status``, sha256 of the bytes).  All exact.
"""
import hashlib
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from csnappy_tpu_torch import errors
from csnappy_tpu_torch.models import pymodel, wire
from csnappy_tpu_torch.ops import decode_jnp

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


STREAMS, REF = _maker().read_streams()


def _decode(body: bytes, dst_len: int):
    return decode_jnp.decompress_noheader_np(np.frombuffer(body, np.uint8), dst_len, device=CPU)


def _strip_header(stream: bytes) -> tuple[bytes, int]:
    ulen, hdr = wire.varint_decode(stream)
    return stream[hdr:], ulen


def test_golden_decode(urls10k, urls10k_snappy):
    out, produced, status = _decode(*_strip_header(urls10k_snappy))
    assert status == errors.E_OK and produced == len(urls10k) and out.tobytes() == urls10k


def test_unaligned_decode(unaligned_bin, unaligned_snappy):
    out, produced, status = _decode(*_strip_header(unaligned_snappy))
    assert status == errors.E_OK and out.tobytes() == unaligned_bin


def test_baddata3_rejected(baddata3):
    out, produced, status = _decode(_strip_header(baddata3)[0], 1 << 22)
    assert status < 0 and produced == 0 and out.size == 0


def test_fake_truncated_literal():
    assert _decode(b"\xc4foooooo", 1 << 12)[2] == errors.E_DATA_MALFORMED


def test_output_overrun(urls10k_snappy):
    body, ulen = _strip_header(urls10k_snappy)
    assert _decode(body, ulen - 1)[2] == errors.E_OUTPUT_OVERRUN


def test_offset_zero_rejected():
    bad = bytes([(2 - 1) << 2]) + b"ab" + bytes([wire.TAG_COPY_1 | (0 << 2) | 0, 0])
    assert _decode(bad, 64)[2] == errors.E_DATA_MALFORMED


def test_offset_too_far_rejected():
    bad = bytes([(2 - 1) << 2]) + b"ab" + bytes([wire.TAG_COPY_2 | (3 << 2), 100, 0])
    assert _decode(bad, 64)[2] == errors.E_DATA_MALFORMED


@pytest.mark.parametrize("data", [
    b"", b"a", b"abcd" * 3,
    b"a" * 100000,                                  # RLE: deep overlapped-copy chains
    b"ab" * 50000,
    bytes(range(256)) * 40,
    b"the quick brown fox jumps over the lazy dog " * 500,
])
def test_roundtrip_vs_oracle(data):
    out, _, status = _decode(*_strip_header(pymodel.compress(data)))
    assert status == errors.E_OK and out.tobytes() == data


def test_roundtrip_random():
    data = np.random.default_rng(7).integers(0, 256, size=50000, dtype=np.uint8).tobytes()
    out, _, status = _decode(*_strip_header(pymodel.compress(data)))
    assert status == errors.E_OK and out.tobytes() == data


def test_decode_blocks_batched(urls10k):
    blocks = [urls10k[i : i + 32768] for i in range(0, 32768 * 8, 32768)]
    comps = [pymodel.compress_fragment(b) for b in blocks]
    arr = np.zeros((len(comps), -(-max(len(c) for c in comps) // 512) * 512), np.uint8)
    for i, c in enumerate(comps):
        arr[i, : len(c)] = np.frombuffer(c, np.uint8)
    lens = np.array([len(c) for c in comps], np.int32)
    out, produced, status = decode_jnp.decode_blocks(arr, lens, 32768, device=CPU)
    assert (status == errors.E_OK).all()
    for i, b in enumerate(blocks):
        assert produced[i] == len(b) and out[i, : len(b)].numpy().tobytes() == b


def test_copy4_accepted():
    lit = b"0123456789abcdef"
    stream = bytearray()
    wire.emit_literal(stream, lit)
    stream += bytes([wire.TAG_COPY_4 | ((8 - 1) << 2)]) + (16).to_bytes(4, "little")
    out, produced, status = _decode(bytes(stream), 64)
    assert status == errors.E_OK and out.tobytes() == lit + lit[:8]


# ---------------------------------------- the JAX module's rules, not the oracle's


def test_malformed_beats_an_earlier_overrun():
    # a tag past the limit, then a bad copy: the oracle stops at the overrun,
    # this decoder reports the malformed copy (decode_jnp.py:193-198)
    s = bytearray()
    wire.emit_literal(s, b"abcdefgh")
    s += bytes([wire.TAG_COPY_2 | (3 << 2)]) + (500).to_bytes(2, "little")
    with pytest.raises(errors.SnappyError) as e:
        pymodel.decompress_noheader(bytes(s), 4)
    assert e.value.code == errors.E_OUTPUT_OVERRUN
    assert _decode(bytes(s), 4)[2] == errors.E_DATA_MALFORMED


def test_copy4_offset_above_2_31_wraps_and_is_malformed():
    s = bytearray()
    wire.emit_literal(s, b"0123456789abcdef")
    s += bytes([wire.TAG_COPY_4 | ((8 - 1) << 2)]) + (0xF0000000).to_bytes(4, "little")
    assert _decode(bytes(s), 64)[2] == errors.E_DATA_MALFORMED


# ---------------------------------------------------- against the JAX decoder


@pytest.mark.parametrize("i", range(len(STREAMS)), ids=[s[0] for s in STREAMS])
def test_decode_equals_jax(i):
    _, body, dst = STREAMS[i]
    out, produced, status = _decode(body, dst)
    assert (produced, status) == (REF["jnp_prod"][i], REF["jnp_status"][i])
    assert hashlib.sha256(out.tobytes()).digest() == REF["jnp_sha"][i].tobytes()
