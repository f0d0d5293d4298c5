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
import torch

from csnappy_tpu.models import pymodel as jax_pymodel
from csnappy_tpu.ops import decode_fused as jax_decode
from csnappy_tpu.ops import encode_fused as jax_encode
from csnappy_tpu_torch.ops import decode_fused, encode_fused

# the suite runs in parallel worker processes: one intra-op thread each keeps
# the torch ops here from contending with every other worker
torch.set_num_threads(1)

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


def _maker():
    import importlib.util
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location(
        "make_torch_fixtures", root / "tools" / "make_torch_fixtures.py")
    maker = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(maker)
    return maker


def test_resolve_probes_live():
    # every probe of tools/mosaic_probe4.py and mosaic_probe6.py in interpret
    # mode at a seeded random K below 120 (the R = 400 gather takes ~10 ms an
    # iteration to interpret), on a fresh seeded input in [0, 2^16) (and a
    # fresh index), against the port's plain versions; taa_4096x128 raising
    # in JAX as in the port
    import jax.numpy as jnp

    from csnappy_tpu_torch.tools import probe

    maker = _maker()
    rng = np.random.default_rng(int.from_bytes(b"probe4", "little"))
    d4 = rng.integers(0, 2**16, (probe.R4, 128), dtype=np.int32)
    d6 = rng.integers(-(2**31), 2**31, (probe.R6, 128), dtype=np.int64).astype(np.int32)
    idx = rng.integers(0, probe.R6 * 128, (probe.RG6, 128), dtype=np.int32)
    for name in maker.PROBE4_NAMES:
        k = int(rng.integers(0, 120))
        want = maker.probe4_call("mosaic_probe4", name)(jnp.full((4,), k, jnp.int32),
                                                         jnp.asarray(d4))
        got = probe.probe(f"mosaic_probe4.{name}", k, d4, device="cpu")
        assert np.array_equal(got.numpy(), np.asarray(want)), (name, k)
    for name in ("base", "base_i16", "el_orient", "el_i16"):
        k = int(rng.integers(0, 120))
        want = maker.probe4_call("mosaic_probe6", name)(jnp.full((1,), k, jnp.int32),
                                                         jnp.asarray(d6), jnp.asarray(idx))
        got = probe.probe(f"mosaic_probe6.{name}", k, d6, idx, device="cpu")
        assert np.array_equal(got.numpy(), np.asarray(want)), (name, k)
    with pytest.raises(ValueError, match="Incompatible shapes for broadcasting"):
        maker.probe4_call("mosaic_probe6", "taa_4096x128")(
            jnp.full((1,), 1, jnp.int32), jnp.asarray(d6), jnp.asarray(idx))
    with pytest.raises(ValueError, match="Incompatible shapes for broadcasting"):
        probe.probe("mosaic_probe6.taa_4096x128", 1, d6, idx, device="cpu")


def test_kernel_lib_live():
    # every helper of csnappy_tpu/ops/kernel_lib.py inside a pl.pallas_call in
    # interpret mode, on fresh seeded tiles over all of int32 (indices and
    # positions partly out of range), against the port's plain versions
    import torch

    from csnappy_tpu_torch.ops import kernel_lib

    maker = _maker()
    rng = np.random.default_rng(int.from_bytes(b"kernel_lib", "little"))

    def ints(lo, hi, shape):
        return rng.integers(lo, hi, shape, dtype=np.int64).astype(np.int32)

    full = (-(2**31), 2**31)
    rows = int(rng.integers(1, 5)) * 8
    x, n = ints(*full, (rows, 128)), rows * 128
    cases = [
        ("stream_shift_down", {"x": x}, {"d": int(rng.integers(0, n)), "fill": -5}),
        ("stream_shift_up", {"x": x}, {"d": int(rng.integers(1, n)), "fill": 9}),
        ("stream_shift_up_mm", {"x": x}, {"d": int(rng.integers(1, 128)), "bits": 16}),
        ("stream_shift_down_mm", {"x": x}, {"d": int(rng.integers(1, 128)), "bits": 24}),
        ("lane_shift_down", {"x": x}, {"k": int(rng.integers(0, 300)), "bits": 8}),
        ("lane_shift_up", {"x": x}, {"k": int(rng.integers(0, 300)), "bits": 31}),
        ("row_shift_down", {"x": x}, {"k": int(rng.integers(0, rows + 3)), "fill": 1}),
        ("row_shift_up", {"x": x}, {"k": int(rng.integers(0, rows + 3)), "fill": 2}),
        ("scan2d", {"x": x}, {"op": "add"}),
        ("scan2d", {"x": x}, {"op": "max"}),
        ("scan2d_mm", {"x": ints(0, 1 << 20, (rows, 128))}, {"op": "add", "bits": 24}),
        ("scan2d_mm", {"x": x}, {"op": "addsat", "bits": 31}),
        ("scan2d_mm", {"x": ints(0, 1 << 22, (rows, 128))}, {"op": "min", "bits": 21}),
        ("scan2d_tril", {"x": ints(0, 1 << 20, (rows, 128))}, {"bits": 24}),
        ("fill_max_rows", {"x": x}, {"bits": 18, "rounds": int(rng.integers(0, 6))}),
        ("flip2d", {"x": x}, {"bits": 16}),
        ("gather_flat", {"table": x, "idx": ints(-100, n + 100, (1, 384))}, {"bits": 24}),
        ("local_gather_rows", {"vals": x, "li": ints(-130, 260, (rows, 128))}, {}),
        ("lane_gather", {"x": x, "lane_idx": ints(-260, 260, (rows, 128))}, {}),
        ("gather_rows_multi", {"t0": x, "t1": ints(*full, (rows, 128)),
                               "idx": ints(-100, n + 100, (rows, 128))},
         {"bits": [8, 32], "r0": 0, "nrows": rows}),
        ("scatter_rows_multi", {"pos": ints(-5, 16 * 128 + 5, (rows, 128)), "v0": x},
         {"bits": [19], "r0": 0, "out_rows": 16, "nrows": rows}),
        ("scatter_sum_tile", {"pos_row": ints(-5, 2100, (1, 128)), "val_row": x[:1],
                              "mask_row": ints(0, 2, (1, 128))}, {"out_rows": 16, "bits": 24}),
    ]
    cases = [(f"live{i}", h, a, p) for i, (h, a, p) in enumerate(cases)]
    want = maker.kernel_lib_outputs(cases)
    for case, helper, arrays, params in cases:
        got = kernel_lib.call(helper, {k: torch.from_numpy(v) for k, v in arrays.items()}, params,
                              device="cpu")
        assert len(got) == len(want[case])
        for g, w in zip(got, want[case]):
            assert np.array_equal(g.numpy(), w), (helper, params)
