"""Port's block encoder (``csnappy_tpu_torch.ops.encode_fused``) on the CPU.

The six cases of ``test_encode_fused.py`` through the port's plain version
(the tensor-op preparation, then the plain walk and emission), plus the
preparation's own invariants and the walk-exhausted error.
"""
import numpy as np
import pytest
import torch

from csnappy_tpu_torch import errors
from csnappy_tpu_torch.models import pymodel, wire
from csnappy_tpu_torch.ops import decode_fused, encode_fused


def _enc1(data: bytes, bs: int = 4096) -> bytes:
    arr = np.zeros((1, bs), np.uint8)
    arr[0, : len(data)] = np.frombuffer(data, np.uint8)
    comp, lens = encode_fused.encode_blocks(arr, np.array([len(data)], np.int32), device="cpu")
    return comp[0, : int(lens[0])].numpy().tobytes()


@pytest.mark.parametrize(
    "data",
    [
        b"",
        b"a",
        b"hello world hello world hello",
        b"a" * 4096,                       # RLE
        b"ab" * 2048,
        bytes(range(256)) * 16,            # far matches
        b"the quick brown fox jumps over the lazy dog " * 90,
    ],
)
def test_roundtrip_via_oracle(data):
    frag = _enc1(data)
    assert pymodel.decompress_noheader(frag, 4096) == data
    assert len(frag) <= wire.max_compressed_length(len(data)) or not data


def test_incompressible_within_bound():
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, 4000, dtype=np.uint8).tobytes()
    frag = _enc1(data)
    assert pymodel.decompress_noheader(frag, 4096) == data
    assert len(frag) <= wire.max_compressed_length(4000)


def test_batched_blocks(urls10k):
    nb = 8
    pages = np.zeros((nb, 4096), np.uint8)
    pages.reshape(-1)[: nb * 4096] = np.frombuffer(urls10k[: nb * 4096], np.uint8)
    lens = np.full((nb,), 4096, np.int32)
    comp, clens = encode_fused.encode_blocks(pages, lens, device="cpu")
    assert comp.dtype == torch.uint8 and comp.shape == (nb, encode_fused.ocap(4096))
    for i in range(nb):
        frag = comp[i, : int(clens[i])].numpy().tobytes()
        assert pymodel.decompress_noheader(frag, 4096) == urls10k[i * 4096 : (i + 1) * 4096]
        assert not comp[i, int(clens[i]):].any()   # the row is zero past its length


def test_ratio_beats_reference_on_urls_head(urls10k):
    data = urls10k[:32768]
    frag = _enc1(data, bs=32768)
    assert pymodel.decompress_noheader(frag, 32768) == data
    assert len(frag) <= len(pymodel.compress_fragment(data)) * 1.04


def test_grammar_decoded_by_fused_decoder(urls10k):
    data = urls10k[:4096]
    frag = _enc1(data)
    arr = np.frombuffer(frag, np.uint8)[None, :]
    out, produced, status = decode_fused.decode_blocks(
        arr, np.array([len(frag)], np.int32), 4096, device="cpu"
    )
    assert int(status[0]) == 0
    assert out[0, : len(data)].numpy().tobytes() == data


def test_fuzz_roundtrip():
    rng = np.random.default_rng(9)
    for trial in range(8):
        n = int(rng.integers(1, 4096))
        if trial % 2:
            data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        else:
            data = (b"abcdefgh" * (n // 8 + 1))[:n]
        frag = _enc1(data)
        assert pymodel.decompress_noheader(frag, 4096) == data, trial


# ----------------------------------------------------------- beyond the mirror


def test_prep_matches_are_real(urls10k):
    # every position the preparation marks holds a true match of its length
    # against an earlier position, inside the block
    data = np.frombuffer(urls10k[:4096], np.uint8).copy()[None, :]
    blen = 4000
    in1, nc = encode_fused.prep(torch.from_numpy(data), torch.tensor([blen], dtype=torch.int32))
    in1, nc = in1[0].numpy(), nc[0].numpy()
    has = (in1 >> 22) & 1
    cand, ml = in1 & 0x7FFF, (in1 >> 15) & 0x7F
    assert has.any()
    for p in np.nonzero(has)[0]:
        c, m = int(cand[p]), int(ml[p])
        assert c < p and 4 <= m <= wire.MAX_COPY_LEN and p + m <= blen
        assert (data[0, c : c + m] == data[0, p : p + m]).all()
    # nc is the next position with a match, or the width
    nxt = np.where(has[::-1] == 1, np.arange(4096)[::-1], 4096)
    assert (nc == np.minimum.accumulate(nxt)[::-1]).all()


def test_compress_np_splits_into_fragments(urls10k):
    data = urls10k[:70000]
    stream = encode_fused.compress_np(data, device="cpu")
    n, hdr = wire.varint_decode(stream)
    assert n == len(data)
    assert pymodel.decompress(stream) == data
    # three independent fragments, each the block encoder's own output
    first = _enc1(data[:32768], bs=32768)
    assert stream[hdr : hdr + len(first)] == first


def test_compress_np_block_size():
    data = b"0123456789" * 500
    stream = encode_fused.compress_np(data, block_size=1024, device="cpu")
    assert pymodel.decompress(stream) == data


def test_walk_exhausted_raises(monkeypatch):
    def broken(data, blens, in1, nc, width):
        B = data.shape[0]
        return (torch.zeros((B, width), dtype=torch.uint8), torch.zeros((B,), dtype=torch.int32),
                torch.ones((B,), dtype=torch.int32))

    monkeypatch.setattr(encode_fused, "emit_plain", broken)
    with pytest.raises(errors.SnappyError) as ei:
        _enc1(b"abc" * 100)
    assert ei.value.code == errors.E_DATA_MALFORMED


def test_encode_blocks_rejects_bad_arguments():
    with pytest.raises(ValueError):
        encode_fused.encode_blocks(np.zeros((1, 40000), np.uint8), [10], device="cpu")
    with pytest.raises(ValueError):
        encode_fused.encode_blocks(np.zeros((1, 1024), np.uint8), [2000], device="cpu")
    with pytest.raises(TypeError):
        encode_fused.encode_blocks(np.zeros((1, 1024), np.int32), [10], device="cpu")
