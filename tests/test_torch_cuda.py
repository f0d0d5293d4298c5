"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is
false (decided inside the ``card`` fixture, never at import).  The machine
with the card need not have JAX, so the file brings its own data fixtures
and runs without ``tests/conftest.py``:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

The kernels build from ``csnappy_tpu_torch/csrc`` at first use.  Outputs are
bytes, compared exactly.
"""
import pathlib

import numpy as np
import pytest
import torch

from csnappy_tpu_torch import api
from csnappy_tpu_torch.models import pymodel, wire
from csnappy_tpu_torch.ops import decode_fused, encode_fused

pytestmark = pytest.mark.cuda
DATA = pathlib.Path(__file__).parent / "data"


@pytest.fixture(scope="module")
def urls10k() -> bytes:
    return (DATA / "urls.10K").read_bytes()


@pytest.fixture(scope="module")
def urls10k_snappy() -> bytes:
    return (DATA / "urls.10K.snappy").read_bytes()


@pytest.fixture(scope="module")
def baddata3() -> bytes:
    return (DATA / "baddata3.snappy").read_bytes()


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _pack(frags):
    arr = np.zeros((len(frags), max(1, max(len(f) for f in frags))), np.uint8)
    for i, f in enumerate(frags):
        arr[i, : len(f)] = np.frombuffer(f, np.uint8)
    return arr, np.array([len(f) for f in frags], np.int32)


def _mutants(base: bytes, n: int, seed: int):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        b = bytearray(base)
        for _k in range(int(rng.integers(1, 6))):
            b[int(rng.integers(0, len(b)))] = int(rng.integers(0, 256))
        out.append(bytes(b))
    return out


@pytest.mark.parametrize("cap", [0, 4, 4096, 32768])
def test_decode_kernel_equals_plain(card, urls10k, baddata3, cap):
    frags = [pymodel.compress_fragment(urls10k[i * 32768 : (i + 1) * 32768]) for i in range(3)]
    frags += [b"", b"\xc4foooooo", baddata3[wire.varint_decode(baddata3)[1]:],
              pymodel.compress_fragment(b"a" * 32768)]
    frags += _mutants(frags[0], 8, seed=cap)
    arr, lens = _pack(frags)
    got = decode_fused.decode_blocks(torch.from_numpy(arr).to(card), lens, cap, device=card)
    torch.cuda.synchronize()
    want = decode_fused.decode_blocks(arr, lens, cap, device="cpu")
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("cap", [100, 32768])
def test_decode_kernel_fuzz_equals_plain(card, urls10k, cap):
    # random bytes, truncations and byte mutations of valid fragments: the
    # kernel must decide each exactly as the plain version does
    rng = np.random.default_rng(cap + 1)
    base = [pymodel.compress_fragment(urls10k[i * 4096 : (i + 1) * 4096]) for i in range(16)]
    frags = [rng.integers(0, 256, int(rng.integers(1, 64)), dtype=np.uint8).tobytes()
             for _ in range(64)]
    frags += [f[: int(rng.integers(1, len(f)))] for f in base]
    for f in base:
        frags += _mutants(f, 8, seed=int(rng.integers(1 << 30)))
    arr, lens = _pack(frags)
    got = decode_fused.decode_blocks(arr, lens, cap, device=card)
    torch.cuda.synchronize()
    want = decode_fused.decode_blocks(arr, lens, cap, device="cpu")
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert set(want[2].tolist()) >= {-5}


@pytest.mark.parametrize("cap", [70000, decode_fused.MAX_BLOCK_OUT])
def test_decode_kernel_wide_rows_and_far_copy4(card, cap):
    # rows wider than 64 KiB, and a COPY_4 offset above 65535 kept at 32 bits
    lit = np.random.default_rng(cap).integers(0, 256, 66000, dtype=np.uint8).tobytes()
    far = bytearray()
    wire.emit_literal(far, lit)
    far += bytes([wire.TAG_COPY_4 | ((64 - 1) << 2)]) + (66000).to_bytes(4, "little")
    run = bytearray(b"\x04ab") + bytes([wire.TAG_COPY_2 | (63 << 2), 2, 0]) * 937   # 59970 B
    frags = [bytes(far), bytes(run), bytes(far[:-1])]
    arr, lens = _pack(frags)
    got = decode_fused.decode_blocks(arr, lens, cap, device=card)
    torch.cuda.synchronize()
    want = decode_fused.decode_blocks(arr, lens, cap, device="cpu")
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert got[2].tolist() == [0, 0, -5]
    assert got[0][0, : int(got[1][0])].cpu().numpy().tobytes() == \
        pymodel.decompress_noheader(bytes(far), cap)


def test_decode_segments_kernel_equals_plain(card, urls10k_snappy, urls10k):
    from csnappy_tpu_torch.runtime import native

    body = urls10k_snappy[wire.varint_decode(urls10k_snappy)[1]:]
    rc, offs, _ = native.scan_segments(body, len(urls10k))
    lens = np.diff(np.append(offs, len(body)))
    dl = np.minimum(32768, len(urls10k) - np.arange(len(offs)) * 32768)
    got = decode_fused.decode_segments(body, offs, lens, dl, device=card)
    torch.cuda.synchronize()
    want = decode_fused.decode_segments(body, offs, lens, dl, device="cpu")
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("bs", [1024, 32768])
def test_encode_kernel_equals_plain(card, urls10k, bs):
    rng = np.random.default_rng(bs)
    B = 8
    data = np.zeros((B, bs), np.uint8)
    blens = rng.integers(0, bs + 1, B).astype(np.int32)
    blens[0] = bs
    for i in range(B):
        row = (np.frombuffer(urls10k[i * bs : (i + 1) * bs], np.uint8) if i % 2 == 0
               else rng.integers(0, 4, bs, dtype=np.uint8) * 65)
        data[i, : blens[i]] = row[: blens[i]]
    got = encode_fused.encode_blocks(torch.from_numpy(data).to(card), blens, device=card)
    torch.cuda.synchronize()
    want = encode_fused.encode_blocks(data, blens, device="cpu")
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def test_api_runs_the_kernels(card, urls10k, urls10k_snappy):
    wrappers = (decode_fused.decode_blocks, decode_fused.decode_segments,
                encode_fused.encode_blocks)
    before = [w.launches for w in wrappers]
    comp = api.compress(urls10k)                  # device=None: the card
    assert api.decompress(comp) == urls10k
    assert api.decompress(urls10k_snappy) == urls10k
    assert api.decompress_noheader(api.compress_fragment(urls10k[:1000]), 1000) == urls10k[:1000]
    assert all(w.launches > b for w, b in zip(wrappers, before))


def test_card_tensor_with_cpu_device_raises(card, urls10k):
    # a tensor on the card is never copied back to run the plain version
    frag = pymodel.compress_fragment(urls10k[:1000])
    arr, lens = _pack([frag])
    comp = torch.from_numpy(arr).to(card)
    with pytest.raises(ValueError, match="CUDA tensor"):
        decode_fused.decode_blocks(comp, lens, 1000, device="cpu")
    with pytest.raises(ValueError, match="CUDA tensor"):
        decode_fused.decode_segments(comp.reshape(-1), [0], lens, 1000, device="cpu")
    data = torch.from_numpy(np.frombuffer(urls10k[:1024], np.uint8).copy()[None, :]).to(card)
    with pytest.raises(ValueError, match="CUDA tensor"):
        encode_fused.encode_blocks(data, [1024], device="cpu")


def test_card_never_takes_the_plain_version(card, monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("plain version called for a CUDA tensor")

    monkeypatch.setattr(decode_fused, "decode_plain", refuse)
    monkeypatch.setattr(encode_fused, "emit_plain", refuse)
    frag = api.compress_fragment(b"hello hello hello hello")
    assert api.decompress_noheader(frag, 100) == b"hello hello hello hello"
