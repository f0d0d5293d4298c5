"""The port's latency and capacity probes (``csnappy_tpu_torch/tools/probe.py``) on the CPU.

* each probe's plain version against the JAX probes' own answers, stored by
  ``tools/make_torch_fixtures.py --group probes``
  (``tests/data/torch_ref/probes.npz``): every named probe of
  ``tools/mosaic_probe.py`` and ``tools/mosaic_probe2.py`` at K in
  ``PROBE_KS``, the five walks of ``tools/mosaic_probe5.py`` at N in
  ``WALK_NS``, ``smem_cap``, and every probe of ``tools/mosaic_probe3.py``,
  ``mosaic_probe3b.py`` and ``mosaic_probe3c.py`` at K in ``PROBE3_KS``
  (with their walk tables), also on the constructed inputs of
  ``PROBE3_CASES``; 0 differing elements;
* the inputs and walk tables rebuilt from the seed equal the stored ones
  (drift check);
* the answers that hinge on XLA's float convert (saturation, NaN to 0), on
  unwritten scratch, on ``inrow_round``'s flip and on ``scan_tril``'s row
  totals mod 2^24;
* the bound's bytes: what each probe reads, not its whole input;
* the ``PROBES`` table: every entry names an existing JAX site (a factory's
  ``def`` for a factory-made probe) and an entry of ``csrc/probe.cu`` or
  ``csrc/probe3.cu``;
* the CLI with ``--device cpu``, and ``device=None`` raising without a card.

The kernels themselves are held against these plain versions on the card
(``test_torch_cuda.py``, ``chip_smoke.py``).
"""
import importlib.util
import json
import pathlib
import re

import numpy as np
import pytest
import torch

from csnappy_tpu_torch.tools import probe as pb

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _maker():
    spec = importlib.util.spec_from_file_location(
        "make_torch_fixtures", ROOT / "tools" / "make_torch_fixtures.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


MAKER = _maker()
FIXTURE = MAKER.read_probes()
CASES = [(name, k) for name, p in pb.PROBES.items()
         if p.entry not in ("walk", "smem_cap") and p.lib == "probe" for k in MAKER.PROBE_KS]
CASES += [(name, n) for name, p in pb.PROBES.items() if p.entry == "walk" for n in MAKER.WALK_NS]
CASES3 = [(name, "", k) for name, p in pb.PROBES.items() if p.lib == "probe3"
          for k in MAKER.PROBE3_KS]
CASES3 += [(name, case, k) for name, case in MAKER.PROBE3_CASES.items() for k in MAKER.PROBE3_KS]


def _plain3(name, k, data=None):
    table = pb.walk_table(name)
    return pb.probe(name, k, pb.inputs(name) if data is None else data, table, device="cpu")


@pytest.mark.parametrize("name, k", CASES, ids=[f"{n.split('.')[1]}-k{k}" for n, k in CASES])
def test_plain_equals_the_jax_probe(name, k):
    got = pb.probe(name, k, pb.inputs(name), device="cpu")
    want = FIXTURE[f"{name}__k{k}"]
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape == pb.OUT_SHAPE
    assert int((got.numpy() != want).sum()) == 0


@pytest.mark.parametrize("name, case, k", CASES3,
                         ids=[f"{n.split('.')[0][12:]}.{n.split('.')[1]}-{c or 'seed0'}-k{k}"
                              for n, c, k in CASES3])
def test_plain_equals_the_jax_probe3(name, case, k):
    # mosaic_probe3.py, mosaic_probe3b.py, mosaic_probe3c.py: the JAX
    # main()s' inputs and walk tables, or a constructed input
    got = _plain3(name, k, FIXTURE["case_" + case] if case else None)
    want = FIXTURE[f"{name}__{case + '_' if case else ''}k{k}"]
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape == pb.OUT_SHAPE
    assert int((got.numpy() != want).sum()) == 0


def test_every_probe_has_fixture_cases():
    names = {key.split("__")[0] for key in FIXTURE if "__k" in key}
    assert names == {n for n, p in pb.PROBES.items() if p.entry != "smem_cap"}
    assert len(CASES) == 19 * len(MAKER.PROBE_KS) + 5 * len(MAKER.WALK_NS)
    assert len(CASES3) == (39 + 5) * len(MAKER.PROBE3_KS)
    assert any((k // 2) % 2 for k in MAKER.PROBE3_KS)       # inrow_round's flip shows
    assert {key for key in FIXTURE if key.startswith("mosaic_probe3")} == {
        f"{n}__{c + '_' if c else ''}k{k}" for n, c, k in CASES3}


def test_inputs_match_the_stored_inputs():
    assert np.array_equal(pb.inputs("walk_load"), FIXTURE["data"])
    rebuilt = MAKER.build_probe_inputs()
    for key, arr in rebuilt.items():
        assert arr.dtype == FIXTURE[key].dtype and np.array_equal(arr, FIXTURE[key]), key
    walks = [n for n, p in pb.PROBES.items() if p.entry == "walk"]
    assert {pb.PROBES[n].rows for n in walks} == {144, 288, 576}
    for name in walks:
        assert np.array_equal(pb.inputs(name), FIXTURE[f"walk_r{pb.PROBES[name].rows}"])
    # the probe module's own inputs and tables, one probe of each kind
    for name, data, table in (("walk_1d", "data", "p3_t16384"), ("big_smem", "data", "p3_t36864"),
                              ("walk_u8", "data", "p3b_t36864"), ("inrow_round", "p3c_data", None)):
        assert np.array_equal(pb.inputs(name), FIXTURE[data]), name
        t = pb.walk_table(name)
        assert (t is None) if table is None else np.array_equal(t, FIXTURE[table]), name
    # the constructed inputs show the mechanism the seed-0 data hides
    par = FIXTURE["case_inrow"][:256] & 32767
    assert ((par >> 7) == np.arange(256)[:, None]).mean() > 0.8
    pos = FIXTURE["case_collide"][:16].reshape(-1)
    assert (pos < 1024).all() and len(np.unique(pos)) < len(pos) // 3


def test_float_convert_saturates_and_maps_nan_to_zero():
    # vec_only's bf16 carry passes int32's range at K = 1 (XLA saturates)
    # and is NaN from K = 3 (inf x 0; XLA converts NaN to 0)
    assert (_plain3("vec_only", 1) == 2147483647).all()
    assert (_plain3("vec_only", 3) == 0).all()
    assert (_plain3("vec_scal", 1) == -2147474943).all()      # INT32_MAX + p + tc + tags[0]
    assert (_plain3("vec_scal", 3) == 9416).all()
    x = torch.tensor([float("nan"), float("inf"), -float("inf"), 3e9, -3e9, -2.5, 2.5])
    assert pb._sat_int32(x).tolist() == [0, 2**31 - 1, -2**31, 2**31 - 1, -2**31, -2, 2]


def test_probe3_unwritten_scratch_and_flips():
    # at K = 0 tags[0] is unwritten: INT32_MIN; big_smem adds two unwritten
    # tags (wrapping to 0), and tags[17407] stays unwritten below K = 17408
    for name in ("walk_1d", "walk_dec_real", "scal_only", "walk_u8", "walk_pair_u4",
                 "walk_dec_full", "walk_enc_real"):
        assert int(_plain3(name, 0)[0, 0]) == pb.INT_MIN, name
    assert int(_plain3("walk_il4", 0)[0, 0]) == pb.INT_MIN + 11 + 217 + 3001   # its chains' starts
    assert int(_plain3("walk_enc", 0)[0, 0]) == 0                # tb1[0] + tb2[0]
    assert int(_plain3("big_smem", 0)[0, 0]) == 0
    assert int(_plain3("big_smem", 1)[0, 0]) == -2147483604
    # inrow_round: floor(K / 2) flips of bit 0; the constructed input's
    # pointers jump within their rows
    k0, k1, k3 = (FIXTURE[f"mosaic_probe3c.inrow_round__k{k}"] for k in (0, 1, 3))
    assert (k3 != k0).all() and (k1 != k0).sum() < 8
    c0, c1 = (FIXTURE[f"mosaic_probe3c.inrow_round__inrow_k{k}"] for k in (0, 1))
    assert (c1 != c0).sum() > 512
    # the colliding scatter adds several values into one bin
    hist = _plain3("scatter_oc256_e2048_l2", 1, FIXTURE["case_collide"])
    assert int(hist.max()) > int(FIXTURE["case_collide"][:16].max())


def test_scan_tril_drops_bit_24_of_a_row_total():
    # case_rowfull's rows 0 and 3 total 2^24 at odd i; scan_tril carries row
    # totals in three 8-bit limbs, so rows 1-7 see them as 0 (the JAX
    # answer), where a 32-bit carry would add 2^24
    x = (FIXTURE["case_rowfull"][:8] & 0x1FFFF).astype(np.int64)
    assert (x[[0, 3]] == 0x1FFFF).all()

    def acc(k, mod):
        out = np.zeros((8, 128), np.int64)
        for i in range(k):
            s = np.cumsum(x + (i & 1), axis=1)
            tot = s[:, -1] & mod
            out += s + (np.cumsum(tot) - tot)[:, None]
        return ((out + 2**31) % 2**32 - 2**31).astype(np.int32)

    want = FIXTURE["mosaic_probe3.scan_tril__rowfull_k3"]
    assert np.array_equal(want, acc(3, 0xFFFFFF))
    assert (want[1:] != acc(3, -1)[1:]).all() and np.array_equal(want[0], acc(3, -1)[0])
    got = _plain3("scan_tril", 3, FIXTURE["case_rowfull"])
    assert np.array_equal(got.numpy(), want)


def test_bound_counts_what_each_probe_reads():
    # a walk reads its table and no input; the others read the input rows
    # they use and no table (the bound's bytes: reads, K and the output)
    for name, p in pb.PROBES.items():
        short = name.split(".")[1]
        if p.lib != "probe3":
            assert p.reads <= max(p.rows, 1) * 128, name
        elif short.startswith(("walk", "scal_only", "big_smem")):
            assert p.reads == p.table > 0, name
        elif short.startswith(("gather", "gv2")):
            assert p.reads == int(re.search(r"_r(\d+)_", short).group(1)) * 128, name
        else:
            want = {"vec_only": 128 * 128, "vec_scal": 128 * 128 + pb.N1D,
                    "scatter_oc256_e2048_l2": 2048, "scatter_oc256_e2048_l4": 2048,
                    "taa_ax0_128x2048": 128}.get(short, 256 * 128)
            assert p.reads == want, name
    assert pb.PROBES["mosaic_probe.vpu_dense"].reads == 8 * 128
    ms, by = pb._bound("mosaic_probe3.walk_1d", pb.PROBES["mosaic_probe3.walk_1d"].k_hi)
    assert by == "bytes" and ms == 4 * (pb.N1D + 1 + 8 * 128) / pb.HBM_BYTES_PER_S * 1e3
    ms, by = pb._bound("mosaic_probe3b.scatter_oc256_e2048_l2", 1024)
    assert by == "operations" and ms == 1024 * 2048 / pb.OPS_PER_S * 1e3


def test_smem_cap_plain_equals_the_interpreter():
    for rows, ok in zip(FIXTURE["smem_cap_rows"], FIXTURE["smem_cap_ok"]):
        assert pb.smem_cap(int(rows), device="cpu") == bool(ok)
        out = pb.probe("smem_cap", int(rows), pb.inputs("smem_cap"), device="cpu")
        assert (out == 2).all()


def test_unwritten_scratch_reads_as_the_interpreters_fill():
    # at K = 0 the probes that read scratch they never wrote answer INT32_MIN
    d = pb.inputs("walk_ldst")
    for name in ("walk_ldst", "walk_vst", "row_write", "walk_smem_st", "row_write_al"):
        assert int(pb.probe(name, 0, d, device="cpu")[0, 0]) == pb.INT_MIN, name
    # before its first refill the windowed walk adds INT32_MIN every step
    assert int(pb.probe("smem_window_dma", 2, d, device="cpu")[0, 0]) == 2


def test_table_names_existing_jax_sites_and_cuda_entries():
    cu = {lib: (ROOT / "csnappy_tpu_torch" / "csrc" / f"{lib}.cu").read_text()
          for lib in ("probe", "probe3")}
    assert set(pb.SITES) == {p.call for p in pb.PROBES.values()}
    assert len(pb.SITES) == 7
    assert {p.lib for p in pb.PROBES.values()} == set(cu)
    factory = re.compile(r"def (_mk_gather|_mk_scatter|_mk_taa|_mk_gv2)\(")
    for name, p in pb.PROBES.items():
        module, short = name.split(".")
        for site in (p.site, p.call):
            path, line = site.split(":")
            assert path == f"tools/{module}.py", name
            text = (ROOT / path).read_text().splitlines()[int(line) - 1]
            if site == p.call:
                assert "pl.pallas_call(" in text, (name, text)
            elif p.entry == "walk":
                assert text.startswith("def walk_kern("), (name, text)
            elif re.match(rf"def (k_)?{short}\(", text) is None:
                # a factory-made probe: its factory's def, and the JAX
                # PROBES entry calls that factory
                assert factory.match(text), (name, text)
                src = (ROOT / path).read_text()
                assert re.search(rf'"{short}": \(\s*{factory.match(text).group(1)}\(', src), name
        if p.lib == "probe":
            assert f"int probe_{p.entry}_launch(" in cu["probe"] or \
                f"PROBE_ENTRY({p.entry}," in cu["probe"], name
        else:
            assert p.entry == short and re.search(
                rf"^(PROBE3|WALK|GATHER)_ENTRY\({short},", cu["probe3"], re.M), name
            assert p.table in (0, pb.N1D, pb.NBIG) and p.rows == pb.ROWS, name
        assert p.k_lo <= p.k_hi and p.space in ("shared", "global", "registers")
        if p.entry == "walk":
            assert p.space == ("global" if p.rows * 512 > 232448 else "shared"), name
    # the k ranges and walk tables of the JAX tables; a factory-made
    # probe's shape (R, E, limbs, int8; R, C, axis) in its plain version
    for module in MAKER.PROBE3_FILES:
        jax_probes = MAKER.probe_module(module).PROBES
        src = (ROOT / "tools" / f"{module}.py").read_text()
        names = [n for n in pb.PROBES if n.startswith(module + ".")]
        assert len(names) == len(jax_probes) == {"mosaic_probe3": 20, "mosaic_probe3b": 11,
                                                 "mosaic_probe3c": 8}[module]
        for name in names:
            p, short = pb.PROBES[name], name.split(".")[1]
            assert jax_probes[short][2] == (p.k_lo, p.k_hi), name
            if module == "mosaic_probe3":
                assert jax_probes[short][4] == p.table, name
            g = re.search(rf'"{short}": \(\s*_mk_gather\((\d+), (\d+), (\d+)(, s8=True)?\)', src) \
                or re.search(rf'"{short}": \(\s*_mk_gv2\((\d+), (\d+), (\d+)()\)', src)
            if g:
                rows, e, limbs = map(int, g.groups()[:3])
                assert p.plain.args == (rows, (7 if g.group(4) else 8) * limbs) and p.ops == e, name
            t = re.search(rf'"{short}": \(_mk_taa\((\d+), (\d+), (\d)\)', src)
            if t:
                assert p.plain.args == tuple(map(int, t.groups())), name


def test_resolve_and_input_checks():
    assert pb.resolve("walk_c2_r288") == "mosaic_probe5.walk_c2_r288"
    assert pb.resolve("mosaic_probe.roll_static") == "mosaic_probe.roll_static"
    with pytest.raises(KeyError):
        pb.resolve("walk")
    with pytest.raises(ValueError, match="int32"):
        pb.probe("walk_load", 3, pb.inputs("walk_load")[:16], device="cpu")
    with pytest.raises(ValueError, match="k must be"):
        pb.probe("walk_load", -1, pb.inputs("walk_load"), device="cpu")
    with pytest.raises(ValueError, match="needs its walk table"):
        pb.probe("walk_1d", 3, pb.inputs("walk_1d"), device="cpu")
    with pytest.raises(ValueError, match="walk table must be"):
        pb.probe("walk_1d", 3, pb.inputs("walk_1d"), pb.walk_table("big_smem"), device="cpu")
    with pytest.raises(ValueError, match="takes no walk table"):
        pb.probe("inrow_round", 3, pb.inputs("inrow_round"), pb.walk_table("walk_1d"),
                 device="cpu")


def test_cli_on_the_cpu_prints_the_keys(capsys):
    assert pb.main(["walk_smem", "roll_dyn", "walk_c1_r144", "--smem", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 5
    recs = [json.loads(s) for s in lines[:4]]
    assert [r["probe"] for r in recs] == ["mosaic_probe.walk_smem", "mosaic_probe.roll_dyn",
                                          "mosaic_probe5.walk_c1_r144", "mosaic_probe5.smem_cap"]
    for r in recs:
        assert {"ns_per_iter", "cycles_per_iter", "k_lo", "k_hi", "space",
                "result_equals_plain"} <= set(r)
        assert r["ns_per_iter"] is None and r["cycles_per_iter"] is None   # not measured here
        assert r["result_equals_plain"] is True and r["device"] == "cpu"
    assert set(json.loads(lines[-1])) == {r["probe"] for r in recs}


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pb.probe("walk_load", 3, pb.inputs("walk_load"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pb.main(["walk_load"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pb.smem_capacity()

