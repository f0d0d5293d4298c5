"""Port's crossing-stream decoder (``csnappy_tpu_torch.ops.decode_stream``) on the CPU.

The thirteen cases of ``test_decode_stream.py`` through the plain version
(``device="cpu"``), which carries the CUDA kernel's contract: the JAX
kernel's envelope and event rules.  Then every stream of
``tests/data/torch_ref/streams.npz`` against what the JAX kernel returned
for it (``produced``, ``status``, sha256 of the bytes), the
exact-multiple-of-32768 case among them, where the JAX kernel and the
oracle differ.  All exact.
"""
import hashlib
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from csnappy_tpu_torch import api, errors
from csnappy_tpu_torch.models import pymodel, wire
from csnappy_tpu_torch.ops import decode_stream, encode_fused

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


def _dec(body: bytes, ulen: int):
    return decode_stream.decompress_noheader_np(np.frombuffer(body, np.uint8), ulen, device=CPU)


def _split(stream: bytes):
    ulen, hdr = wire.varint_decode(stream)
    return stream[hdr:], ulen


def test_single_segment():
    data = b"hello world hello world hello"
    out, produced, status = _dec(pymodel.compress_fragment(data), len(data))
    assert status == errors.E_OK and out.tobytes() == data


def test_multisegment_own_stream(urls10k):
    big = urls10k[:150000]
    out, produced, status = _dec(*_split(pymodel.compress(big)))
    assert status == errors.E_OK and produced == len(big) and out.tobytes() == big


def test_golden_reference_stream(urls10k, urls10k_snappy):
    out, produced, status = _dec(*_split(urls10k_snappy))
    assert status == errors.E_OK and produced == len(urls10k) and out.tobytes() == urls10k


def test_straddling_literal_and_copy():
    raw = np.random.default_rng(3).integers(0, 256, 50000, dtype=np.uint8).tobytes()
    s = bytearray()
    wire.emit_literal(s, raw)
    s += bytes([wire.TAG_COPY_2 | ((64 - 1) << 2)]) + (1000).to_bytes(2, "little")
    want = raw + raw[-1000 : -1000 + 64]
    out, produced, status = _dec(bytes(s), len(want))
    assert status == errors.E_OK and out.tobytes() == want


def test_copy_across_segment_boundary():
    # copies whose sources lie in the previous segment, offset 32768 included
    raw = np.random.default_rng(6).integers(0, 256, 32768, dtype=np.uint8).tobytes()
    s = bytearray()
    wire.emit_literal(s, raw)
    s += (bytes([wire.TAG_COPY_2 | ((64 - 1) << 2)]) + (32768).to_bytes(2, "little")) * 3
    s += bytes([wire.TAG_COPY_1 | ((11 - wire.MIN_MATCH) << 2) | (7 << 5), 255])   # offset 2047
    want = bytearray(raw)
    for _ in range(3):
        want += want[-32768 : -32768 + 64]
    want += want[-2047 : -2047 + 11]
    out, produced, status = _dec(bytes(s), len(want))
    assert status == errors.E_OK and out.tobytes() == bytes(want)
    data = (b"abcdefgh" * 5000)[:40000]
    out, produced, status = _dec(*_split(pymodel.compress(data)))
    assert status == errors.E_OK and out.tobytes() == data


def test_giant_literal_decodes_bit_exact():
    # a single 100000-byte literal (an advance above 64 KiB) decodes in the
    # stream decoder, and through the API
    raw = np.random.default_rng(4).integers(0, 256, 100000, dtype=np.uint8).tobytes()
    s = bytearray()
    wire.emit_literal(s, raw)
    out, produced, status = _dec(bytes(s), len(raw))
    assert status == errors.E_OK and out.tobytes() == raw
    assert api.decompress_noheader(bytes(s), len(raw), device=CPU) == raw


def test_past_envelope_literal_rejected():
    # a literal of 2^24 + 4096 bytes is outside the envelope: E_DATA_MALFORMED,
    # never corruption (the API's re-decide on decode_jnp runs in the card
    # tests: its CPU version takes too long at this size)
    n = (1 << 24) + 4096
    raw = (b"\xa5\x5a\x01\xfe" * ((n + 3) // 4))[:n]
    s = bytearray()
    wire.emit_literal(s, raw)
    _, produced, status = _dec(bytes(s), n)
    assert (produced, status) == (0, errors.E_DATA_MALFORMED)


def test_adversarial(baddata3):
    _, _, status = _dec(_split(baddata3)[0], 1 << 20)
    assert status != errors.E_OK


def test_truncated_multisegment(urls10k):
    body, ulen = _split(pymodel.compress(urls10k[:100000]))
    _, _, status = _dec(body[:-1], ulen)
    assert status == errors.E_DATA_MALFORMED


def test_overrun_multisegment(urls10k):
    body, ulen = _split(pymodel.compress(urls10k[:100000]))
    _, _, status = _dec(body, ulen - 5000)
    assert status == errors.E_OUTPUT_OVERRUN


def test_api_wholestream(urls10k, urls10k_snappy, unaligned_bin, unaligned_snappy):
    assert api.decompress(urls10k_snappy, device=CPU) == urls10k
    assert api.decompress(unaligned_snappy, device=CPU) == unaligned_bin   # the crossing route


def test_fuzz_multisegment_vs_oracle():
    rng = np.random.default_rng(77)
    fuzz = _maker()._fuzz_stream
    for trial in range(4):
        data = fuzz(rng, trial)
        out, produced, status = _dec(*_split(pymodel.compress(data)))
        assert status == errors.E_OK and out.tobytes() == data, trial


def test_fuzz_encoder_stream_through_stream_decoder(urls10k):
    data = urls10k[:100000]
    out, produced, status = _dec(*_split(encode_fused.compress_np(data, device=CPU)))
    assert status == errors.E_OK and out.tobytes() == data


# ---------------------------------------------------- against the JAX kernel


@pytest.mark.parametrize("i", range(len(STREAMS)), ids=[s[0] for s in STREAMS])
def test_stream_equals_jax(i):
    _, body, dst = STREAMS[i]
    out, produced, status = _dec(body, dst)
    assert (produced, status) == (REF["st_prod"][i], REF["st_status"][i])
    assert hashlib.sha256(out.tobytes()).digest() == REF["st_sha"][i].tobytes()


def test_full_at_a_multiple_of_32768_is_malformed():
    # output exactly full at 65536 with tags left: the JAX kernel's
    # E_DATA_MALFORMED (not consumed), where the oracle says E_OUTPUT_OVERRUN
    i = [s[0] for s in STREAMS].index("full_at_65536_with_tags_left")
    _, body, dst = STREAMS[i]
    assert REF["st_status"][i] == errors.E_DATA_MALFORMED
    assert _dec(body, dst)[2] == errors.E_DATA_MALFORMED
    with pytest.raises(errors.SnappyError) as e:
        pymodel.decompress_noheader(body, dst)
    assert e.value.code == errors.E_OUTPUT_OVERRUN
    assert _dec(body, dst + 1)[2] == errors.E_OUTPUT_OVERRUN


def test_fixture_covers_every_status():
    assert set(REF["st_status"].tolist()) == {0, errors.E_OUTPUT_OVERRUN, errors.E_DATA_MALFORMED}


def test_zero_limit_and_empty_stream():
    assert _dec(b"", 0)[1:] == (0, errors.E_OK)
    assert _dec(b"\x00a", 0)[1:] == (0, errors.E_OUTPUT_OVERRUN)
    assert _dec(b"\x04a", 0)[1:] == (0, errors.E_DATA_MALFORMED)    # truncated before the overrun
    out, produced, status = decode_stream.decode_stream(b"\x00a", 40000, device=CPU)
    assert out.numel() == 64 and (int(produced), int(status)) == (1, errors.E_OK)
