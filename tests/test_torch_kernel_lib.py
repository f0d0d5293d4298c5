"""The port's kernel_lib helpers (``csnappy_tpu_torch/ops/kernel_lib.py``) on the CPU.

* each parametrised case of ``tests/test_kernel_lib.py``, mirrored: the same
  seeds and shapes through the port's plain versions, against numpy;
* every plain version against the JAX helpers' own answers inside a
  ``pl.pallas_call`` in interpret mode, stored by
  ``tools/make_torch_fixtures.py --group kernel_lib``
  (``tests/data/torch_ref/kernel_lib.npz``): the 35 cases of
  ``tests/test_kernel_lib.py`` and the constructed ones, answers outside the
  helpers' contracts and the helpers no JAX test runs; 0 differing elements;
* those answers outside the contracts, one by one;
* the ``HELPERS`` table against the JAX functions and tests it names;
* the scatter's block plan (``scatter_plan``) at the JAX fused kernels'
  shapes and at the tests' own, and the scatters' refusals;
* a numpy model of the scan kernels' decomposition (a warp a row, the row
  rounds over each block's window of totals or as grid passes) against the
  JAX answers and the plain version, and of the shift kernel's clamped
  offset.

The kernels of ``csrc/kernel_lib.cu`` are held against these plain versions
on the card (``test_torch_cuda.py``, ``chip_smoke.py``).
"""
import ast
import hashlib
import importlib.util
import inspect
import pathlib
import re

import numpy as np
import pytest
import torch

from csnappy_tpu_torch.ops import kernel_lib as kl

# the suite runs in parallel worker processes: one intra-op thread each keeps
# the torch ops here from contending with every other worker
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _maker():
    spec = importlib.util.spec_from_file_location(
        "make_torch_fixtures", ROOT / "tools" / "make_torch_fixtures.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


MAKER = _maker()
FIXTURE = kl.read_cases(ROOT / "tests" / "data" / "torch_ref" / "kernel_lib.npz")
BY_CASE = {c[0]: c for c in FIXTURE}


def _np(x: torch.Tensor) -> np.ndarray:
    assert x.dtype == torch.int32
    return x.numpy()


# ------------------------------------------- tests/test_kernel_lib.py, mirrored


@pytest.mark.parametrize("d", [0, 1, 7, 127, 128, 129, 300, 1023])
def test_stream_shift_down(d):
    x = np.arange(8 * 128, dtype=np.int32).reshape(8, 128) * 3 + 1
    got = _np(kl.stream_shift_down(x, d, fill=-7, device="cpu")).reshape(-1)
    want = np.full(8 * 128, -7, np.int32)
    if d < 8 * 128:
        want[d:] = x.reshape(-1)[: 8 * 128 - d]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("d", [1, 127, 128, 200, 1023])
def test_stream_shift_up(d):
    x = np.arange(8 * 128, dtype=np.int32).reshape(8, 128) * 5 + 2
    got = _np(kl.stream_shift_up(x, d, fill=-3, device="cpu")).reshape(-1)
    want = np.full(8 * 128, -3, np.int32)
    want[: 8 * 128 - d] = x.reshape(-1)[d:]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("op", ["max", "add"])
@pytest.mark.parametrize("rows", [8, 16])
def test_scan2d(op, rows):
    x = np.random.default_rng(0).integers(-1000, 1000, (rows, 128)).astype(np.int32)
    got = _np(kl.scan2d(x, op=op, device="cpu")).reshape(-1)
    f = np.maximum.accumulate if op == "max" else np.cumsum
    np.testing.assert_array_equal(got, f(x.reshape(-1)).astype(np.int32))


@pytest.mark.parametrize("bits", [8, 16, 24])
def test_gather_flat(bits):
    r = np.random.default_rng(1)
    tbl = r.integers(0, 1 << bits, (16, 128)).astype(np.int32)
    idx = r.integers(0, 16 * 128, (1, 256)).astype(np.int32)
    got = _np(kl.gather_flat(tbl, idx, bits, device="cpu"))
    np.testing.assert_array_equal(got[0], tbl.reshape(-1)[idx[0]])


def test_local_gather_rows():
    r = np.random.default_rng(2)
    v = r.integers(-(2**31), 2**31 - 1, (16, 128)).astype(np.int32)
    li = r.integers(0, 128, (16, 128)).astype(np.int32)
    got = _np(kl.local_gather_rows(v, li, device="cpu"))
    np.testing.assert_array_equal(got, np.take_along_axis(v, li, axis=1))


@pytest.mark.parametrize("d", [1, 2, 4, 5])
def test_stream_shift_up_mm(d):
    x = np.arange(16 * 128, dtype=np.int32).reshape(16, 128) * 7 + 3
    got = _np(kl.stream_shift_up_mm(x, d, device="cpu")).reshape(-1)
    want = np.zeros(16 * 128, np.int32)
    want[: 16 * 128 - d] = x.reshape(-1)[d:]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("op,bits", [("max", 31), ("add", 24)])
@pytest.mark.parametrize("rows", [8, 24])
def test_scan2d_mm(op, bits, rows):
    hi = (1 << 30) if op == "max" else 1000
    x = np.random.default_rng(4).integers(0, hi, (rows, 128)).astype(np.int32)
    got = _np(kl.scan2d_mm(x, op=op, bits=bits, device="cpu")).reshape(-1)
    f = np.maximum.accumulate if op == "max" else np.cumsum
    np.testing.assert_array_equal(got, f(x.reshape(-1)).astype(np.int32))


@pytest.mark.parametrize("bits", [8, 19])
def test_gather_rows_multi(bits):
    r = np.random.default_rng(5)
    tbl = r.integers(0, 1 << bits, (24, 128)).astype(np.int32)
    tbl2 = r.integers(0, 1 << 16, (24, 128)).astype(np.int32)
    idx = r.integers(0, 24 * 128, (8, 128)).astype(np.int32)
    got, got2 = kl.gather_rows_multi([(tbl, bits), (tbl2, 16)], idx, 0, device="cpu")
    np.testing.assert_array_equal(_np(got), tbl.reshape(-1)[idx])
    np.testing.assert_array_equal(_np(got2), tbl2.reshape(-1)[idx])


@pytest.mark.parametrize("bits", [16, 31])
def test_scatter_rows_multi(bits):
    r = np.random.default_rng(6)
    pos = r.permutation(16 * 128)[: 8 * 128].astype(np.int32).reshape(8, 128)
    val = r.integers(0, 1 << bits, (8, 128)).astype(np.int32)
    mask = r.random((8, 128)) < 0.7
    pos_m = np.where(mask, pos, -1).astype(np.int32)
    (h,) = kl.scatter_rows_multi(pos_m, [(val, bits)], 0, 16, device="cpu")
    want = np.zeros(16 * 128, np.int32)
    want[pos[mask]] = val[mask]
    np.testing.assert_array_equal(_np(h).reshape(-1), want)


@pytest.mark.parametrize("bits", [16, 31])
def test_scatter_sum_tile(bits):
    r = np.random.default_rng(3)
    pos = r.permutation(16 * 128)[:128].astype(np.int32).reshape(1, 128)
    val = r.integers(0, 1 << bits, (1, 128)).astype(np.int32)
    mask = r.random((1, 128)) < 0.8
    got = _np(kl.scatter_sum_tile(pos, val, mask, 16, bits, device="cpu")).reshape(-1)
    want = np.zeros(16 * 128, np.int32)
    want[pos[0][mask[0]]] = val[0][mask[0]]
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------- the JAX helpers' answers


@pytest.mark.parametrize("case", list(BY_CASE))
def test_plain_equals_the_jax_helper(case):
    _, helper, arrays, params, outs = BY_CASE[case]
    got = kl.call(helper, {k: torch.from_numpy(v) for k, v in arrays.items()}, params,
                  device="cpu")
    assert len(got) == len(outs)
    for g, o in zip(got, outs):
        assert g.dtype == torch.int32 and tuple(g.shape) == o.shape
        assert int((g.numpy() != o).sum()) == 0


def test_fixture_covers_every_helper_and_test_case():
    assert {c[1] for c in FIXTURE} == set(kl.HELPERS)
    # the first 35 are tests/test_kernel_lib.py's parametrised cases
    assert len(FIXTURE) > 35 and all(kl.HELPERS[c[1]].test for c in FIXTURE[:35])
    # the stored inputs are what the maker builds from its seeds (drift check)
    for case, helper, arrays, params in MAKER.build_kernel_lib_cases():
        _, h, stored, p, _ = BY_CASE[case]
        assert (h, p) == (helper, params), case
        assert list(stored) == list(arrays), case
        for k in arrays:
            assert np.array_equal(stored[k], arrays[k]), (case, k)


@pytest.mark.parametrize("case", list(BY_CASE))
def test_traffic_counts_no_more_than_the_case_holds(case):
    # the bound's bytes: at least the outputs, at most every input and output
    # once; operations at least one a landing value or output element
    _, helper, arrays, params, outs = BY_CASE[case]
    nbytes, nops = kl.traffic(helper, arrays, params)
    out_bytes = 4 * sum(o.size for o in outs)
    assert out_bytes <= nbytes <= 4 * sum(v.size for v in arrays.values()) + out_bytes, case
    assert nops >= 0 and (nops > 0 or kl.HELPERS[helper].kind == "scatter"), case


def test_traffic_counts_what_each_helper_reads():
    rng = np.random.default_rng(3)
    tbl = rng.integers(0, 2**31, (16, 128), dtype=np.int64).astype(np.int32)
    # gather_flat: the distinct in-range entries, the indices and outputs
    idx = rng.integers(-40, 2100, (1, 256), dtype=np.int64).astype(np.int32)
    reached = np.unique(idx[(idx >= 0) & (idx < 2048)]).size
    assert kl.traffic("gather_flat", {"table": tbl, "idx": idx}, {"bits": 8}) == (
        4 * (reached + 2 * 256), 256)
    assert 4 * (reached + 2 * 256) <= 3072
    # gather_rows_multi: only rows r0 .. r0 + nrows - 1 of the index, clipped
    idx = np.zeros((24, 128), np.int32)
    idx[2:4] = np.arange(256).reshape(2, 128) - 3          # -3..-1 clip to entry 0
    other = idx.copy()
    other[[0, 1, 4]] = 999
    for ix in (idx, other):
        assert kl.traffic("gather_rows_multi", {"t0": tbl, "t1": tbl, "idx": ix},
                          {"bits": [8, 16], "r0": 2, "nrows": 2}) == (
            4 * (2 * 253 + 256 + 2 * 256), 512)
    # scatter_rows_multi: the slice's positions, its landing values, the histograms
    pos = np.full((8, 128), -1, np.int32)
    pos[5, :10] = np.arange(10)
    pos[6, :3] = 5000                                      # out of range: lands nowhere
    assert kl.traffic("scatter_rows_multi", {"pos": pos, "v0": pos, "v1": pos},
                      {"bits": [16, 8], "r0": 5, "out_rows": 4, "nrows": 2}) == (
        4 * (256 + 2 * 10 + 2 * 512), 20)
    # shifts read what reaches the output
    x = np.zeros((8, 128), np.int32)
    assert kl.traffic("stream_shift_down", {"x": x}, {"d": 100, "fill": 0})[0] == 4 * (924 + 1024)
    assert kl.traffic("lane_shift_up", {"x": x}, {"k": 130, "bits": 8})[0] == 4 * (8 * 126 + 1024)
    assert kl.traffic("row_shift_down", {"x": x}, {"k": 3, "fill": 0})[0] == 4 * (640 + 1024)


def test_read_cases_gives_the_stored_arrays():
    with np.load(ROOT / "tests" / "data" / "torch_ref" / "kernel_lib.npz") as z:
        assert [c[0] for c in FIXTURE] == [str(c) for c in z["cases"]]
        for case, _, arrays, _, outs in FIXTURE[:5]:
            for k, v in arrays.items():
                assert np.array_equal(v, z[f"{case}__{k}"])
            assert np.array_equal(outs[0], z[f"{case}__out0"])


def _out(case: str, k: int = 0) -> np.ndarray:
    return BY_CASE[case][4][k]


def test_answers_outside_the_contracts():
    # gather_flat: an index outside the table gives 0; values keep 16 bits
    tbl, idx = BY_CASE["gflat_oob_b16"][2].values()
    assert (idx[0, :4] == (2048, -1, 2047, -2049)).all()
    assert list(_out("gflat_oob_b16")[0, :4]) == [0, 0, tbl.reshape(-1)[2047] & 0xFFFF, 0]
    tbl32 = BY_CASE["gflat_oob_b32"][2]["table"].reshape(-1)
    assert _out("gflat_oob_b32")[0, 2] == tbl32[2047] and (tbl32 < 0).any()
    # gather_rows_multi clips: 2048 -> T[2047], -1 and -129 -> T[0]
    t0 = BY_CASE["grm_clip"][2]["t0"].reshape(-1)
    assert list(_out("grm_clip", 0)[0, :3]) == [t0[2047] & 0xFF, t0[0] & 0xFF, t0[0] & 0xFF]
    assert _out("grm_clip", 2)[0, 0] == BY_CASE["grm_clip"][2]["t2"].reshape(-1)[2047]
    # and at decode_stream.py:255's shape: index row 18 (output row 2) holds
    # -1, -300, 1664 * 128 and 1664 * 128 - 1; 29 bits keep 32, 17 keep 24
    t0, t1 = (BY_CASE["grm_r1664_clip"][2][k].reshape(-1) for k in ("t0", "t1"))
    assert list(_out("grm_r1664_clip", 0)[2, :4]) == [t0[0], t0[0], t0[-1], t0[-1]]
    assert list(_out("grm_r1664_clip", 1)[2, :4]) == [t1[0] & 0xFFFFFF] * 2 + [
        t1[-1] & 0xFFFFFF] * 2
    # local_gather_rows: lanes outside [0, 128) give 0; lane_gather: -128..-1
    # count from the end, the rest INT32_MIN
    vals, li = BY_CASE["lgr_oob"][2].values()
    assert (_out("lgr_oob")[(li < 0) | (li >= 128)] == 0).all()
    x, lidx = BY_CASE["lg_take"][2].values()
    far = (lidx < -128) | (lidx >= 128)
    assert far.any() and (_out("lg_take")[far] == kl.NEG).all()
    r, c = np.nonzero(lidx == -1)
    assert (_out("lg_take")[r, c] == x[r, 127]).all()
    # stream_shift_up_mm at bits 16 keeps 0x5678 of 0x12345678
    assert (_out("ssumm_wide_b16").reshape(-1)[:-3] == 0x5678).all()
    # scan2d_mm: the 24-bit mask bites at every lane round and at the row
    # total: 9,022,784 at flat 128 where the true sum is 25,800,000
    got = _out("scanmm_bite").reshape(-1)
    assert got[128] == 9_022_784 and (got != np.cumsum(np.full(1024, 200_000))).sum() == 896
    # scatter_rows_multi: duplicates sum (1,024 x 3 less the 10 moved
    # positions), 0x1F0001 at bits 16 keeps its 21 bits
    dup, wide = _out("srm_dup", 0).reshape(-1), _out("srm_dup", 1).reshape(-1)
    assert dup[77] == 3 * (1024 - 10) and wide[77] != 0
    assert list(dup[1:8]) == [3] * 7 and wide[1] == 0x1F0001
    # scatter_sum_tile ORs the 8-bit limb sums: 0x80 and 0x180 give 0x100
    pos, val, mask = BY_CASE["sst_or"][2].values()
    assert (pos[0, :2] == 5).all() and list(val[0, :2]) == [0x80, 0x180]
    assert not ((pos[0, 2:] == 5) & (mask[0, 2:] > 0)).any()
    assert _out("sst_or").reshape(-1)[5] == 0x100


@pytest.mark.parametrize("helper", ["lane_gather", "local_gather_rows"])
def test_row_gathers_broadcast_a_one_row_index_as_jax(helper):
    # a (1, E) index over a (4, 128) tile: JAX broadcasts it over the rows
    # (take_along_axis, and the one-hot select of kernel_lib.py:164)
    import jax.numpy as jnp

    from csnappy_tpu.ops import kernel_lib as jkl

    r = np.random.default_rng(5)
    x = r.integers(-(2**31), 2**31 - 1, (4, 128)).astype(np.int32)
    idx = r.integers(0, 128, (1, 128)).astype(np.int32)
    want = np.asarray(getattr(jkl, helper)(jnp.asarray(x), jnp.asarray(idx)))
    got = _np(getattr(kl, helper)(x, idx, device="cpu"))
    assert want.shape == got.shape == (4, 128)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.take_along_axis(x, np.repeat(idx, 4, 0), 1))
    with pytest.raises(ValueError, match=r"\(4, E >= 1\) or \(1, E\)"):
        getattr(kl, helper)(x, idx[:, :0], device="cpu")
    with pytest.raises(ValueError, match=r"\(4, E >= 1\) or \(1, E\)"):
        getattr(kl, helper)(x, np.zeros((2, 128), np.int32), device="cpu")


@pytest.mark.parametrize("shape", [(3, 256), (256,), (1, 1, 256)])
def test_gather_flat_takes_one_index_row_as_jax(shape):
    # JAX's contract is a (1, E) row (kernel_lib.py:139): a (3, 256) index
    # fails its one-hot products' broadcast with TypeError; the port refuses
    # every other shape before any launch
    import jax.numpy as jnp

    from csnappy_tpu.ops import kernel_lib as jkl

    r = np.random.default_rng(6)
    tbl = r.integers(0, 1 << 16, (16, 128)).astype(np.int32)
    idx = r.integers(0, 16 * 128, (1, 256)).astype(np.int32)
    want = np.asarray(jkl.gather_flat(jnp.asarray(tbl), jnp.asarray(idx), 16))
    np.testing.assert_array_equal(_np(kl.gather_flat(tbl, idx, 16, device="cpu")), want)
    bad = r.integers(0, 16 * 128, shape).astype(np.int32)
    if shape == (3, 256):
        with pytest.raises(TypeError):
            jkl.gather_flat(jnp.asarray(tbl), jnp.asarray(bad), 16)
    with pytest.raises(ValueError, match=r"one row \(1, E >= 1\)"):
        kl.gather_flat(tbl, bad, 16, device="cpu")


def test_static_arguments_outside_their_range_raise():
    x = np.zeros((8, 128), np.int32)
    with pytest.raises(ValueError, match="roll"):
        kl.stream_shift_up(x, 1024, device="cpu")
    with pytest.raises(ValueError, match=r"\[0, 128\)"):
        kl.stream_shift_up_mm(x, 128, device="cpu")
    with pytest.raises(ValueError, match="op"):
        kl.scan2d(x, op="min", device="cpu")
    with pytest.raises(ValueError, match="bits"):
        kl.gather_flat(x, x[:1], 0, device="cpu")
    with pytest.raises(ValueError, match="tile"):
        kl.scan2d(x[:, :64], device="cpu")
    with pytest.raises(TypeError, match="int32"):
        kl.flip2d(x.astype(np.int64), device="cpu")
    with pytest.raises(ValueError, match="outside"):
        kl.gather_rows_multi([(x, 8)], x, 4, nrows=8, device="cpu")
    # d >= R * 128 fills everything (the JAX answer, not an error)
    assert (kl.stream_shift_down(x + 1, 5000, fill=-1, device="cpu") == -1).all()


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kl.scan2d(np.zeros((8, 128), np.int32))


def test_table_names_the_jax_helpers_and_tests():
    src = (ROOT / "csnappy_tpu" / "ops" / "kernel_lib.py").read_text().splitlines()
    tests = (ROOT / "tests" / "test_kernel_lib.py").read_text().splitlines()
    cu = (ROOT / "csnappy_tpu_torch" / "csrc" / "kernel_lib.cu").read_text()
    for name, h in kl.HELPERS.items():
        path, line = h.jax.split(":")
        assert path == "csnappy_tpu/ops/kernel_lib.py" and src[int(line) - 1].startswith(
            f"def {name}("), name
        assert f"int kernel_lib_{h.kind}_launch(" in cu, name
        assert h.row == ("15b" if name == "gather_rows_multi" else "15a"), name
        if h.test is not None:
            path, line = h.test.split(":")
            assert tests[int(line) - 1].startswith(f"def test_{name}("), name
    # every public helper of the JAX module has a counterpart, but the TPU encodings
    jax_helpers = {m.group(1) for m in (re.match(r"def ([a-z]\w*)\(", s) for s in src) if m}
    assert jax_helpers - set(kl.HELPERS) == {"row_iota", "limb_f", "onehot_rows_t",
                                             "onehot_lanes_t", "perm_apply"}
    # one entry a device function, whatever the helper
    assert re.findall(r"^int kernel_lib_(\w+)_launch\(", cu, re.M) == [
        "shift", "scan", "gather", "scatter"]
    tested = {re.match(r"def test_(\w+)\(", s).group(1) for s in tests if s.startswith("def test_")}
    assert tested == {n for n, h in kl.HELPERS.items() if h.test}
    # the port's helpers take the JAX helpers' parameters in their order (a
    # Ref or row becomes a tensor of any rows), then the device
    tree = ast.parse("\n".join(src))
    jax_args = {f.name: [a.arg for a in f.args.args] for f in tree.body
                if isinstance(f, ast.FunctionDef)}
    renamed = {"idx_row": "idx", "idx_ref": "idx", "pos_ref": "pos", "val_refs_bits": "vals_bits"}
    for name, h in kl.HELPERS.items():
        ours = list(inspect.signature(h.wrapper).parameters)
        assert ours == [renamed.get(a, a) for a in jax_args[name]] + ["device"], name


# ------------------------------------------------------- the scatter's blocks

# (tables, output positions, limbs): the JAX fused kernels' scatters
# (decode_fused.py:470, decode_stream.py:315, encode_fused.py:375), the JAX
# tests' tiles, scatter_sum_tile at 1-4 limbs, and edges of a slice
PLAN_SHAPES = [(2, 256 * 128, 0), (3, 256 * 128, 0), (3, 304 * 128, 0), (1, 16 * 128, 0),
               (2, 16 * 128, 0), (1, 16 * 128, 2), (1, 16 * 128, 4), (1, 20 * 128, 4),
               (1, 256 * 128, 4), (1, 128, 3), (8, 40 * 128, 1), (8, 1000 * 128, 4)]
# the shared memory kernel_lib_scatter_launch gives a block at most: what a
# launch takes unasked (csrc/kernel_lib.cu's kSmemDefault)
SCATTER_SMEM = eval(re.search(r"kSmemDefault = ([0-9 *]+);",
                              (ROOT / "csnappy_tpu_torch/csrc/kernel_lib.cu").read_text())[1])


@pytest.mark.parametrize("ntab,n_out,limbs", PLAN_SHAPES)
def test_scatter_plan_covers_every_output_once(ntab, n_out, limbs):
    plan = kl.scatter_plan(ntab, n_out, limbs)
    slices, tables = plan.grid
    assert tables == ntab and plan.slice > 0
    # block (x, j) owns [x * slice, min((x + 1) * slice, n_out)) of table j,
    # as the kernel computes it
    for j in range(tables):
        owned = np.zeros(n_out, np.int64)
        for x in range(slices):
            lo = x * plan.slice
            n = min(plan.slice, n_out - lo)
            assert n > 0, (j, x)
            owned[lo : lo + n] += 1
        assert (owned == 1).all(), j
    assert plan.smem == 4 * plan.slice * max(limbs, 1) <= SCATTER_SMEM == 48 * 1024


def test_scatter_plan_refuses_what_the_kernel_does_not_take():
    for ntab, n_out, limbs in ((0, 128, 0), (9, 128, 0), (1, 128, 5), (1, 128, -1),
                               (1, 0, 0), (1, 1 << 31, 0)):
        with pytest.raises(ValueError):
            kl.scatter_plan(ntab, n_out, limbs)


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself as on the card."""

    @property
    def is_cuda(self):
        return True


def test_scatters_refuse_their_bad_arguments():
    x = np.zeros((8, 128), np.int32)
    with pytest.raises(ValueError, match="1 to 8"):
        kl.scatter_rows_multi(x, [(x, 8)] * 9, 0, 16, device="cpu")
    with pytest.raises(ValueError, match="bits"):               # five 8-bit limbs
        kl.scatter_sum_tile(x[:1], x[:1], x[:1], 8, 33, device="cpu")
    with pytest.raises(ValueError, match="outside"):
        kl.scatter_rows_multi(x, [(x, 8)], 4, 16, nrows=8, device="cpu")
    card = torch.from_numpy(x).as_subclass(_OnCard)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kl.scatter_sum_tile(card[:1], card[:1], card[:1], 8, 16, device="cpu")
    with pytest.raises(ValueError, match="CUDA tensor"):
        kl.scatter_rows_multi(card, [(card, 31), (card, 18)], 0, 256, device="cpu")


def test_scatter_sum_tile_takes_its_mask_in_any_dtype():
    _, _, arrays, params, outs = BY_CASE["sst_or"]
    pos, val, mask = arrays.values()
    for m in (mask != 0, (mask != 0).astype(np.uint8), (mask != 0).astype(np.int8),
              mask.astype(np.int64), torch.from_numpy(mask != 0)):
        got = kl.scatter_sum_tile(pos, val, m, **params, device="cpu")
        assert np.array_equal(got.numpy(), outs[0])
    # another dtype becomes int32 first, as before: 0.5 truncates to 0, unset
    half = np.where(mask != 0, 1.0, 0.5)
    got = kl.scatter_sum_tile(pos, val, half, **params, device="cpu")
    assert np.array_equal(got.numpy(), outs[0])


def _case_digest(z, cases) -> str:
    h = hashlib.sha256()
    for case, helper, args, params in cases:
        case = str(case)
        h.update(f"{case}|{helper}|{args}|{params}".encode())
        for k in sorted(k for k in z.files if k.startswith(case + "__")):
            a = z[k]
            h.update(k.encode() + str(a.dtype).encode() + str(a.shape).encode() + a.tobytes())
    return h.hexdigest()


def test_earlier_fixture_cases_are_byte_identical():
    # the 66 cases written before the main-path scatter cases, the 70
    # written before the main-path gather cases and the 74 written before
    # the shifts and scans at the JAX call sites: names, parameters, inputs
    # and JAX answers, exactly as they were first stored
    with np.load(ROOT / "tests" / "data" / "torch_ref" / "kernel_lib.npz") as z:
        cases = list(zip(z["cases"], z["helpers"], z["args"], z["params"]))
        assert _case_digest(z, cases[:66]) == (
            "df4596b48102d3a766da0212d4f3be5c999120aa94c520b7b0aa39347787bde7")
        assert [str(c[0]) for c in cases[66:70]] == [
            "srm_dec_co256", "srm_stream_co256_t3", "srm_enc_ocr304_t3", "srm_co256_dup"]
        assert _case_digest(z, cases[:70]) == (
            "c775ad82d2bb3dc7913812469aee370969653e6a183ab581366fa6a20bcb41fb")
        assert [str(c[0]) for c in cases[70:74]] == [
            "grm_dec_ci256_t8", "grm_stream_r1664_t2", "grm_stream_r1664_t1", "grm_r1664_clip"]
        assert _case_digest(z, cases[:74]) == (
            "1ba8128138080902e3a5755ee471654af8b540ef7ef709a0059406e887abe651")
        assert [str(c[0]) for c in cases[74:]] == [
            "ssumm_dec_ci512_d1", "ssumm_dadv_ci2048_d4", "ssumm_stream_r1664_d2", "rsu_dec_ci512",
            "rsu_dadv_ci2048", "tril_dadv_tr528", "scanmm_stream_addsat_tr256",
            "fmr_dec_co256_b31", "fmr_dec_co256_b18", "fmr_stream_co256_b31",
            "fmr_enc_ocr304_b31", "scanmm_addsat_order_tr256"]


# ------------------------------------------------ the scan kernels' decomposition

SCAN_HELPERS = ("scan2d", "scan2d_mm", "scan2d_tril", "fill_max_rows")
ROUNDS_HELPERS = ("scan2d_mm", "fill_max_rows")      # the JAX lane rounds, not a warp scan


def _combine(op: str, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if op == "max":
        return np.maximum(a, b)
    if op == "min":
        return np.minimum(a, b)
    s = (a + b + (1 << 31)) % (1 << 32) - (1 << 31)       # int32 wrap
    return s if op == "add" else np.minimum(s, kl.SAT)


def _row_scan(s: np.ndarray, op: str, rounds: bool, lane_mask: int, fill: int) -> np.ndarray:
    """kernel_lib.cuh scan_row on every row at once: lane t of a warp holds
    lanes 4t..4t+3.  Without rounds a scan of four, a shuffle scan of the 32
    partial totals and the exclusive prefix; with rounds the seven doubling
    lane rounds, the shifted operand masked, lanes l < k taking the fill
    (max, min) or 0."""
    rows = s.shape[0]
    if not rounds:
        v = s.reshape(rows, 32, 4).copy()
        for j in range(1, 4):
            v[:, :, j] = _combine(op, v[:, :, j - 1], v[:, :, j])
        inc = v[:, :, 3].copy()
        for o in (1, 2, 4, 8, 16):
            up = np.roll(inc, o, axis=1)
            inc = np.where(np.arange(32) >= o, _combine(op, up, inc), inc)
        before = np.roll(inc, 1, axis=1)[:, :, None]
        v = np.where((np.arange(32) > 0)[None, :, None], _combine(op, before, v), v)
        return v.reshape(rows, 128)
    low = fill if op in ("max", "min") else 0
    for r in range(7):
        k = 1 << r
        sh = np.full_like(s, low)
        sh[:, k:] = s[:, :-k] & lane_mask
        s = _combine(op, s, sh)
    return s


BLOCK_ROWS = 8                  # rows a scan_finish block owns (kScanRows: a warp a row)


def scan_model(x, op: str, rounds: bool, in_mask: int, lane_mask: int, tot_mask: int, fill: int,
               row_rounds: int, passes: bool):
    """The scan kernels of csrc/kernel_lib.cu on a (rows, 128) tile, in
    int64: scan_totals (each row's scan, its last lane & tot_mask); the row
    rounds as grid passes over all totals (``passes``), or in each
    scan_finish block of ``BLOCK_ROWS`` rows over the window of totals
    rows r0 - 2^rounds .. r1 - 1, a row reading below the window taking the
    fill; then each row combined with the total of the row before.  The
    rounds that run are those of ``row_rounds`` with 2^r < rows.
    Returns (result, s, t) as ``_scan_plain`` does."""
    x = np.asarray(x).astype(np.int64)
    rows = x.shape[0]
    s = _row_scan(x & in_mask if in_mask != kl.FULL else x, op, rounds, lane_mask, fill)
    tot = s[:, -1] & tot_mask if tot_mask != kl.FULL else s[:, -1].copy()
    rr = min(row_rounds, (rows - 1).bit_length())
    if passes:
        for rd in range(rr):
            k = 1 << rd
            tot = _combine(op, tot, np.concatenate([np.full(min(k, rows), fill), tot[:-k]]))
        rr = 0
    out, t_all = np.empty_like(s), np.empty(rows, np.int64)
    for r0 in range(0, rows, BLOCK_ROWS):
        r1 = min(rows, r0 + BLOCK_ROWS)
        lo = max(0, r0 - (1 << rr))
        cur = tot[lo:r1].copy()
        for rd in range(rr):
            k = 1 << rd
            i = np.arange(cur.size)
            cur = _combine(op, cur, np.where(i >= k, cur[np.maximum(i - k, 0)], fill))
        t_all[r0:r1] = cur[r0 - lo : r1 - lo]
        for r in range(r0, r1):
            out[r] = _combine(op, s[r], cur[r - 1 - lo] if r >= 1 else fill)
    return out, s, np.repeat(t_all[:, None], 128, 1)


def _scan_args(helper: str, arrays: dict, params: dict) -> tuple:
    """The arguments ``helper`` gives the scan (as ``_scan_plain`` takes
    them), recorded from a call of its CPU path."""
    seen = []
    orig = kl._scan_plain
    kl._scan_plain = lambda x, *a: (seen.append(a), orig(x, *a))[1]
    try:
        kl.call(helper, {k: torch.from_numpy(v) for k, v in arrays.items()}, params,
                device="cpu")
    finally:
        kl._scan_plain = orig
    (args,) = seen
    return args


SCAN_CASES = [c for c in BY_CASE if BY_CASE[c][1] in SCAN_HELPERS]


@pytest.mark.parametrize("passes", [False, True], ids=["window", "passes"])
@pytest.mark.parametrize("case", SCAN_CASES)
def test_scan_model_equals_the_jax_helper(case, passes):
    # the kernels' decomposition, both ways of running the row rounds, on
    # every stored scan case (the JAX call sites' tiles among them): 0
    # differing elements from the JAX helper's outputs
    _, helper, arrays, params, outs = BY_CASE[case]
    op, in_mask, lane_mask, tot_mask, fill, row_rounds = _scan_args(helper, arrays, params)
    got = scan_model(next(iter(arrays.values())), op, helper in ROUNDS_HELPERS, in_mask,
                     lane_mask, tot_mask, fill, row_rounds, passes)
    for g, o in zip(got, outs):
        assert g.shape == o.shape and int((g != o).sum()) == 0, case


MODEL_TILES = [
    # (helper, rows, params, input range): past a window, with rounds
    # cut short, the order-dependent addsat, a one-row tile
    ("scan2d_mm", 300, {"op": "addsat", "bits": 24}, (-(1 << 22), 1 << 22)),
    ("scan2d_mm", 70, {"op": "min", "bits": 20, "fill": 1 << 20}, (0, 1 << 21)),
    ("fill_max_rows", 300, {"bits": 31, "rounds": 5}, None),
    ("fill_max_rows", 41, {"bits": 18, "rounds": 0}, None),
    ("scan2d", 130, {"op": "add"}, (-(1 << 31), 1 << 31)),
    ("scan2d", 1, {"op": "max"}, (-(1 << 31), 1 << 31)),
    ("scan2d", 264, {"op": "max"}, (-(1 << 31), 1 << 31)),
    ("scan2d_tril", 97, {"bits": 24}, (0, 1 << 20)),
]


@pytest.mark.parametrize("helper,rows,params,span", MODEL_TILES)
def test_scan_model_equals_plain_at_wider_tiles(helper, rows, params, span):
    rng = np.random.default_rng(rows)
    if span is None:                                 # sparse fills, one long empty span
        x = np.where(rng.integers(0, 40, (rows, 128)) == 0,
                     rng.integers(0, 1 << 18, (rows, 128)), 0).astype(np.int32)
        x[rows // 3 : rows // 3 + 40] = 0
    else:
        x = rng.integers(*span, (rows, 128), dtype=np.int64).astype(np.int32)
    want = kl.call(helper, {"x": torch.from_numpy(x)}, params, device="cpu")
    op, in_mask, lane_mask, tot_mask, fill, row_rounds = _scan_args(helper, {"x": x}, params)
    for passes in (False, True):
        got = scan_model(x, op, helper in ROUNDS_HELPERS, in_mask, lane_mask, tot_mask, fill,
                         row_rounds, passes)
        for g, w in zip(got, want):
            assert np.array_equal(g, w.numpy()), (helper, passes)


@pytest.mark.parametrize("helper,k", [("row_shift_down", 20), ("row_shift_up", 9),
                                      ("stream_shift_down", 5000), ("lane_shift_up", 300),
                                      ("row_shift_down", 1 << 20)])
def test_shift_kernel_offset_clamp_keeps_the_answer(helper, k):
    # the wrapper clamps the offset to [-span, span] for the kernel (an
    # int): past the segment every element is the fill either way
    x = np.arange(8 * 128, dtype=np.int32).reshape(8, 128) - 500
    params = {"d": k} if helper.startswith("stream") else {"k": k}
    seen = []
    orig = kl._shift_plain
    kl._shift_plain = lambda t, *a: (seen.append(a), orig(t, *a))[1]
    try:
        want = kl.call(helper, {"x": torch.from_numpy(x)}, params, device="cpu")[0]
    finally:
        kl._shift_plain = orig
    (span, off, fill, vmask), = seen
    clamped = max(-span, min(off, span))
    assert torch.equal(kl._shift_plain(torch.from_numpy(x), span, clamped, fill, vmask), want)
