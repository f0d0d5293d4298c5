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


def test_primitives_pallas_live():
    # the six Pallas kernels of ops/primitives.py in interpret mode, run anew
    # on the fixture's seeded cases, against the port's plain path and the
    # stored outputs
    import importlib.util
    import pathlib

    import torch

    from csnappy_tpu_torch.ops import primitives

    root = pathlib.Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location(
        "make_torch_fixtures", root / "tools" / "make_torch_fixtures.py")
    maker = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(maker)
    cases = maker.build_primitives_inputs()
    live = maker.primitives_outputs(cases)
    stored = {c[0]: c[4] for c in maker.read_primitives()}
    for case, fn, limbs, arrays in cases:
        args = [torch.from_numpy(arrays[a]) for a in primitives.PRIMITIVES[fn].args]
        got = primitives.PRIMITIVES[fn].wrapper(*args, **({"limbs": limbs} if limbs else {}),
                                                device="cpu")
        got = got if isinstance(got, tuple) else (got,)
        for g, w, s in zip(got, live[case], stored[case]):
            assert np.array_equal(g.numpy(), w) and np.array_equal(w, s), case



def test_probes_live():
    # every probe of tools/mosaic_probe.py, mosaic_probe2.py, mosaic_probe5.py,
    # mosaic_probe3.py, mosaic_probe3b.py and mosaic_probe3c.py in interpret
    # mode at a seeded random K, on a fresh seeded input (and walk table),
    # against the port's plain versions
    import importlib.util
    import pathlib

    import jax
    import jax.numpy as jnp
    import torch

    from csnappy_tpu_torch.tools import probe

    root = pathlib.Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location(
        "make_torch_fixtures", root / "tools" / "make_torch_fixtures.py")
    maker = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(maker)
    rng = np.random.default_rng(int.from_bytes(b"probe", "little"))
    data = rng.integers(0, 2**20, (probe.ROWS, 128), dtype=np.int32)
    for mod_name in ("mosaic_probe", "mosaic_probe2"):
        mod = maker.probe_module(mod_name)
        for name, entry in mod.PROBES.items():
            k = int(rng.integers(0, 3000))
            want = jax.jit(mod._call(entry[0], entry[1]))(jnp.full((1,), k, jnp.int32),
                                                          jnp.asarray(data))
            got = probe.probe(f"{mod_name}.{name}", k, data, device="cpu")
            assert np.array_equal(got.numpy(), np.asarray(want)), (name, k)
    for chains, rows in maker.WALK_CONFIGS:
        n = int(rng.integers(0, 5000))
        d = rng.integers(2, 9, size=(rows, 128)).astype(np.int32)
        want = maker.walk_call(chains, rows)(jnp.full((4,), n, jnp.int32), jnp.asarray(d))
        got = probe.probe(f"mosaic_probe5.walk_c{chains}_r{rows}", n, d, device="cpu")
        assert np.array_equal(got.numpy(), np.asarray(want)), (chains, rows, n)
    rows = int(rng.integers(1, 600))
    assert maker.probe_module("mosaic_probe5").smem_cap(rows) == probe.smem_cap(rows, device="cpu")
    assert (probe.probe("smem_cap", rows, torch.ones(4, dtype=torch.int32), device="cpu") == 2).all()
    # mosaic_probe3.py, mosaic_probe3b.py, mosaic_probe3c.py: fresh tables
    # in their ranges; K below 600 (the one-hot gathers are slow to interpret)
    tables = {"p3_t16384": rng.integers(1, 2**20, (16384,), dtype=np.int32),
              "p3_t36864": rng.integers(1, 2**20, (36864,), dtype=np.int32),
              "p3b_t36864": rng.integers(1, 2**22, (36864,), dtype=np.int32)}
    data3c = rng.integers(0, 2**15, (probe.ROWS, 128), dtype=np.int32)
    for mod_name in maker.PROBE3_FILES:
        for name in maker.probe_module(mod_name).PROBES:
            fn, tkey = maker.probe3_call(mod_name, name)
            d = data3c if mod_name == "mosaic_probe3c" else data
            tbl = () if tkey is None else (tables[tkey],)
            k = int(rng.integers(0, 600))
            want = fn(jnp.full((1,), k, jnp.int32), jnp.asarray(d), *map(jnp.asarray, tbl))
            got = probe.probe(f"{mod_name}.{name}", k, d, *tbl, device="cpu")
            assert np.array_equal(got.numpy(), np.asarray(want)), (name, k)
