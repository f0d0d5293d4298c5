"""Port's block decoder (``csnappy_tpu_torch.ops.decode_fused``) on the CPU.

The thirteen cases of ``test_decode_fused.py``, run through the port's plain
version (``device="cpu"``), which carries the same contract as the CUDA
kernel; plus the stream-mode entry point ``decode_segments`` and the
wrapper's argument checks.  Bytes, ``produced`` and ``status`` are compared
exactly: a decoder has no tolerance.
"""
import numpy as np
import pytest
import torch

from csnappy_tpu_torch import errors
from csnappy_tpu_torch.models import pymodel, wire
from csnappy_tpu_torch.ops import decode_fused


def _decode_one(frag: bytes, out_cap: int):
    arr = np.frombuffer(frag, np.uint8)[None, :] if frag else np.zeros((1, 1), np.uint8)
    out, produced, status = decode_fused.decode_blocks(
        arr, np.array([len(frag)], np.int32), out_cap, device="cpu"
    )
    return out[0].numpy(), int(produced[0]), int(status[0])


@pytest.mark.parametrize(
    "data",
    [
        b"",
        b"a",
        b"hello world hello world hello",
        b"a" * 4096,                       # RLE offset-1 chains
        b"ab" * 2048,
        bytes(range(256)) * 16,            # period-256 far matches
        b"the quick brown fox jumps over the lazy dog " * 90,
    ],
)
def test_roundtrip_4k(data):
    frag = pymodel.compress_fragment(data)
    out, produced, status = _decode_one(frag, 4096)
    assert status == errors.E_OK
    assert produced == len(data)
    assert out[: len(data)].tobytes() == data
    assert not out[len(data):].any()       # the row is zero past produced


def test_roundtrip_32k_urls(urls10k):
    data = urls10k[:32768]
    frag = pymodel.compress_fragment(data)
    out, produced, status = _decode_one(frag, 32768)
    assert status == errors.E_OK
    assert out[: len(data)].tobytes() == data


def test_incompressible_and_long_literal():
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, 4000, dtype=np.uint8).tobytes()
    frag = pymodel.compress_fragment(data)
    out, _, status = _decode_one(frag, 4096)
    assert status == errors.E_OK and out[:4000].tobytes() == data
    data = rng.integers(0, 256, 2000, dtype=np.uint8).tobytes() + b"abcdefgh" * 200
    frag = pymodel.compress_fragment(data)
    out, produced, status = _decode_one(frag, 4096)
    assert status == errors.E_OK and out[: len(data)].tobytes() == data


def test_copy4_accepted():
    lit = b"0123456789abcdef"
    stream = bytearray()
    wire.emit_literal(stream, lit)
    stream += bytes([wire.TAG_COPY_4 | ((8 - 1) << 2)]) + (16).to_bytes(4, "little")
    out, produced, status = _decode_one(bytes(stream), 4096)
    assert status == errors.E_OK
    assert out[:24].tobytes() == lit + lit[:8]


def test_malformed_rejected():
    for frag in (b"\xc4foooooo", b"\x00a\x01\x00", b"\x00a\x0a\x08\x00"):
        _, produced, status = _decode_one(frag, 4096)
        assert status == errors.E_DATA_MALFORMED, frag
        assert produced == 0


def test_baddata3_rejected(baddata3):
    _, hdr = wire.varint_decode(baddata3)
    _, _, status = _decode_one(baddata3[hdr:], 65536)
    assert status != errors.E_OK
    with pytest.raises(errors.SnappyError) as ei:
        pymodel.decompress_noheader(baddata3[hdr:], 65536)
    assert status == ei.value.code


def test_overrun_rejected():
    frag = pymodel.compress_fragment(b"x" * 5000)
    _, _, status = _decode_one(frag, 4096)
    assert status == errors.E_OUTPUT_OVERRUN


def test_error_priority_offset_before_space():
    # a bad-offset copy *before* the overrun point wins (DATA): the offset
    # check comes before the space check within a tag
    s = bytearray()
    wire.emit_literal(s, b"ab")
    s += bytes([wire.TAG_COPY_1 | ((4 - wire.MIN_MATCH) << 2) | (0 << 5), 50])  # off 50 > written
    wire.emit_literal(s, b"c" * 60)
    _, _, status = _decode_one(bytes(s), 4)  # also overruns dst_limit=4
    assert status == errors.E_DATA_MALFORMED


def test_overrun_before_malformed_end():
    # the overrun at byte dlim comes before the truncated tail
    frag = bytearray(pymodel.compress_fragment(b"y" * 5000))
    frag = frag[:-1]
    _, _, status = _decode_one(bytes(frag), 4096)
    assert status == errors.E_OUTPUT_OVERRUN


def test_batched_mixed_blocks(urls10k):
    blocks = [urls10k[i * 4096 : (i + 1) * 4096] for i in range(8)]
    frags = [pymodel.compress_fragment(b) for b in blocks]
    P = max(len(f) for f in frags)
    arr = np.zeros((8, P), np.uint8)
    lens = np.zeros((8,), np.int32)
    for i, f in enumerate(frags):
        arr[i, : len(f)] = np.frombuffer(f, np.uint8)
        lens[i] = len(f)
    out, produced, status = decode_fused.decode_blocks(arr, lens, 4096, device="cpu")
    assert out.dtype == torch.uint8 and out.shape == (8, 4096)
    assert produced.dtype == torch.int32 and status.dtype == torch.int32
    assert (status == errors.E_OK).all()
    for i, b in enumerate(blocks):
        assert produced[i] == len(b)
        assert out[i, : len(b)].numpy().tobytes() == b


def test_fuzz_roundtrip_vs_oracle():
    rng = np.random.default_rng(42)
    for trial in range(10):
        kind = trial % 3
        n = int(rng.integers(1, 4096))
        if kind == 0:
            data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        elif kind == 1:
            data = (b"abcdef" * (n // 6 + 1))[:n]
        else:
            pieces, left = [], n
            while left > 0:
                m = int(rng.integers(1, min(left, 200) + 1))
                pieces.append(
                    rng.integers(0, 256, m, dtype=np.uint8).tobytes()
                    if rng.random() < 0.5 else bytes([int(rng.integers(97, 99))]) * m
                )
                left -= m
            data = b"".join(pieces)[:n]
        frag = pymodel.compress_fragment(data)
        out, produced, status = _decode_one(frag, 4096)
        assert status == errors.E_OK, (trial, status)
        assert out[: len(data)].tobytes() == data, trial


def test_fuzz_malformed_never_crashes():
    # the port decides every input exactly: status and bytes equal the oracle's
    rng = np.random.default_rng(43)
    base = pymodel.compress_fragment(b"hello world " * 200)
    for _ in range(10):
        bad = bytearray(base)
        for _ in range(int(rng.integers(1, 6))):
            bad[int(rng.integers(0, len(bad)))] = int(rng.integers(0, 256))
        out, produced, status = _decode_one(bytes(bad), 4096)
        try:
            want, code = pymodel.decompress_noheader(bytes(bad), 4096), errors.E_OK
        except errors.SnappyError as e:
            want, code = b"", e.code
        assert status == code
        assert produced == len(want) and out[:produced].tobytes() == want


def test_nonpow2_out_cap_rows():
    rng = np.random.default_rng(12)
    data = rng.integers(0, 256, 4196, dtype=np.uint8).tobytes()
    frag = pymodel.compress_fragment(data)
    out, produced, status = _decode_one(frag, 4196)
    assert status == errors.E_OK
    assert out.shape == (4196,)
    assert out[: len(data)].tobytes() == data


# ----------------------------------------------------------- beyond the mirror


def test_zero_limit_overruns_on_any_byte():
    out, produced, status = _decode_one(pymodel.compress_fragment(b"a"), 0)
    assert (status, produced, out.shape) == (errors.E_OUTPUT_OVERRUN, 0, (0,))
    _, produced, status = _decode_one(b"", 0)
    assert (status, produced) == (errors.E_OK, 0)


def test_copy4_offset_above_64k_keeps_32_bits():
    # the oracle resolves a COPY_4 offset of 66000 once 66000 bytes exist
    lit = np.random.default_rng(5).integers(0, 256, 66000, dtype=np.uint8).tobytes()
    f = bytearray()
    wire.emit_literal(f, lit)
    f += bytes([wire.TAG_COPY_4 | ((8 - 1) << 2)]) + (66000).to_bytes(4, "little")
    out, produced, status = _decode_one(bytes(f), 70000)
    assert status == errors.E_OK
    assert out[:produced].tobytes() == pymodel.decompress_noheader(bytes(f), 70000)


def test_decode_segments_reads_stream_in_place(urls10k_snappy, urls10k):
    from csnappy_tpu_torch.runtime import native

    body = urls10k_snappy[wire.varint_decode(urls10k_snappy)[1]:]
    rc, offs, produced = native.scan_segments(body, len(urls10k))
    assert rc == 0 and produced == len(urls10k)
    lens = np.diff(np.append(offs, len(body)))
    dlims = np.minimum(32768, len(urls10k) - np.arange(len(offs)) * 32768)
    out, prod, status = decode_fused.decode_segments(body, offs, lens, dlims, device="cpu")
    assert (status == 0).all() and int(prod.sum()) == len(urls10k)
    assert out.reshape(-1)[: len(urls10k)].numpy().tobytes() == urls10k
    # the same segments, copied into a padded matrix, decode identically
    arr = np.zeros((len(offs), int(lens.max())), np.uint8)
    for i, (o, n) in enumerate(zip(offs, lens)):
        arr[i, :n] = np.frombuffer(body[o : o + n], np.uint8)
    out2, prod2, _ = decode_fused.decode_blocks(arr[:-1], lens[:-1], 32768, device="cpu")
    assert torch.equal(out2, out[:-1]) and torch.equal(prod2, prod[:-1])


@pytest.mark.parametrize("bad", [
    dict(src_lens=[5], block_out=16),          # length past the row
    dict(src_lens=[1], block_out=1 << 18),     # output row too wide
    dict(src_lens=[1, 1], block_out=16),       # one length per block
])
def test_decode_blocks_rejects_bad_arguments(bad):
    with pytest.raises(ValueError):
        decode_fused.decode_blocks(np.zeros((1, 4), np.uint8), device="cpu", **bad)


def test_decode_blocks_takes_only_bytes():
    with pytest.raises(TypeError):
        decode_fused.decode_blocks(np.zeros((1, 4), np.int32), [1], 16, device="cpu")


def test_device_none_means_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        decode_fused.decode_blocks(np.zeros((1, 4), np.uint8), [1], 16)
