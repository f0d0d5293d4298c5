"""The port against the JAX package, live, on fresh seeded inputs (``slow``).

The JAX kernels run in Pallas interpret mode on the CPU, minutes for the
calls, so this file is marked ``slow`` and left out of runs with
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


def test_whole_stream_decoders_live():
    # a fresh crossing stream (a literal across the 32 KiB boundary, then
    # copies into the previous segment) and a bit-flipped copy of it
    from csnappy_tpu.ops import decode_jnp as jax_jnp
    from csnappy_tpu.ops import decode_stream as jax_stream
    from csnappy_tpu_torch.models import wire
    from csnappy_tpu_torch.ops import decode_jnp, decode_stream

    rng = np.random.default_rng(int.from_bytes(b"stream", "little"))
    s = bytearray()
    wire.emit_literal(s, rng.integers(0, 256, 33000, dtype=np.uint8).tobytes())
    for _ in range(100):
        s += bytes([wire.TAG_COPY_2 | ((int(rng.integers(1, 65)) - 1) << 2)]) \
            + int(rng.integers(1, 32769)).to_bytes(2, "little")
    bad = bytearray(s)
    bad[33005 + int(rng.integers(0, 300))] ^= 1 << int(rng.integers(0, 8))
    for body in (bytes(s), bytes(bad)):
        buf = np.frombuffer(body, np.uint8)
        for jax_mod, mod in ((jax_stream, decode_stream), (jax_jnp, decode_jnp)):
            jo, jp, js = jax_mod.decompress_noheader_np(buf, 40000)
            po, pp, ps = mod.decompress_noheader_np(buf, 40000, device="cpu")
            assert (pp, ps) == (jp, js), mod.__name__
            assert np.array_equal(po, np.asarray(jo)[:jp]), mod.__name__


def test_container_and_movebench_live(urls10k):
    # the JAX container (its encode and decode kernels) and movebench's two
    # Pallas kernels on fresh seeded inputs, against the port's plain path
    import importlib.util
    import pathlib

    import jax.numpy as jnp

    from csnappy_tpu.runtime import container as jax_container
    from csnappy_tpu_torch.runtime import container
    from csnappy_tpu_torch.tools import movebench

    rng = np.random.default_rng(int.from_bytes(b"zram", "little"))
    s = int(rng.integers(0, len(urls10k) - 20000))
    data = urls10k[s : s + 12000] + rng.integers(0, 256, 4094, dtype=np.uint8).tobytes()
    want, sw = jax_container.compress_blocks(data, 4096)
    got, sg = container.compress_blocks(data, 4096, device="cpu")
    assert got == want and sg.histogram == sw.histogram
    assert container.decompress_blocks(got, 4096, device="cpu")[0] == \
        jax_container.decompress_blocks(want, 4096)[0] == data

    root = pathlib.Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location(
        "make_torch_fixtures", root / "tools" / "make_torch_fixtures.py")
    maker = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(maker)
    R = 24
    gather, scan = maker.movebench_calls(R)
    tbl = rng.integers(0, 1 << 20, (R, 128), dtype=np.int32)
    idx = rng.integers(-100, R * 128 + 100, (R, 128), dtype=np.int32)
    x = rng.integers(0, 1 << 31, (R, 128), dtype=np.int32)
    assert np.array_equal(movebench.gather_flat(tbl, idx, 16, device="cpu").numpy(),
                          np.asarray(gather(jnp.asarray(idx), jnp.asarray(tbl))))
    assert np.array_equal(movebench.scan_max(x, device="cpu").numpy(),
                          np.asarray(scan(jnp.asarray(x))))
