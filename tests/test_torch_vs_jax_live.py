"""The port against the JAX package, live, on fresh seeded inputs (``slow``).

The JAX kernels run in Pallas interpret mode on the CPU, about a minute for
the two calls, so this file is marked ``slow`` and left out of runs with
``-m 'not slow'``; ``test_torch_fixtures.py`` holds the port against stored outputs
instead.  Run it with

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_vs_jax_live.py -q -m slow

Inputs are made with numpy from a seed and handed to both packages; outputs
are compared exactly: bytes, ``produced``, ``status``.
"""
import numpy as np
import pytest

from csnappy_tpu.models import pymodel as jax_pymodel
from csnappy_tpu.ops import decode_fused as jax_decode
from csnappy_tpu.ops import encode_fused as jax_encode
from csnappy_tpu_torch.ops import decode_fused, encode_fused

pytestmark = pytest.mark.slow

B, BS = 8, 1024


@pytest.fixture(scope="module")
def batch(urls10k):
    rng = np.random.default_rng(int.from_bytes(b"live", "little"))
    data = np.zeros((B, BS), np.uint8)
    blens = rng.integers(1, BS + 1, B).astype(np.int32)
    for i in range(B):
        if i % 2:
            row = rng.integers(0, 8, BS, dtype=np.uint8) * 31
        else:
            s = int(rng.integers(0, len(urls10k) - BS))
            row = np.frombuffer(urls10k[s : s + BS], np.uint8)
        data[i, : blens[i]] = row[: blens[i]]
    return rng, data, blens


def test_encode_blocks_live(batch):
    _, data, blens = batch
    jc, jl = jax_encode.encode_blocks(data, blens)
    pc, pl = encode_fused.encode_blocks(data, blens, device="cpu")
    assert pl.numpy().tolist() == np.asarray(jl).tolist()
    assert np.array_equal(pc.numpy(), jc)


def test_decode_blocks_live(batch):
    rng, data, blens = batch
    frags = [jax_pymodel.compress_fragment(data[i, : blens[i]].tobytes()) for i in range(B)]
    for i in (1, 5):                                  # two mutated blocks
        b = bytearray(frags[i])
        b[int(rng.integers(0, len(b)))] ^= 0x5A
        frags[i] = bytes(b)
    arr = np.zeros((B, max(len(f) for f in frags)), np.uint8)
    for i, f in enumerate(frags):
        arr[i, : len(f)] = np.frombuffer(f, np.uint8)
    lens = np.array([len(f) for f in frags], np.int32)
    jo, jp, js = jax_decode.decode_blocks(arr, lens, BS)
    po, pp, ps = decode_fused.decode_blocks(arr, lens, BS, device="cpu")
    assert ps.numpy().tolist() == np.asarray(js).tolist()
    assert pp.numpy().tolist() == np.asarray(jp).tolist()
    for i, n in enumerate(pp.tolist()):
        assert np.array_equal(po[i, :n].numpy(), jo[i, :n])
