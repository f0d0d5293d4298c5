"""The port's latency and capacity probes (``csnappy_tpu_torch/tools/probe.py``) on the CPU.

* each probe's plain version against the JAX probes' own answers, stored by
  ``tools/make_torch_fixtures.py --group probes``
  (``tests/data/torch_ref/probes.npz``): every named probe of
  ``tools/mosaic_probe.py`` and ``tools/mosaic_probe2.py`` at K in
  ``PROBE_KS``, the five walks of ``tools/mosaic_probe5.py`` at N in
  ``WALK_NS``, and ``smem_cap``; 0 differing elements;
* the inputs rebuilt from the seed equal the stored ones (drift check);
* the ``PROBES`` table: every entry names an existing JAX site and an entry
  of ``csrc/probe.cu``;
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
CASES = [(name, k) for name, p in pb.PROBES.items() if p.entry not in ("walk", "smem_cap")
         for k in MAKER.PROBE_KS]
CASES += [(name, n) for name, p in pb.PROBES.items() if p.entry == "walk" for n in MAKER.WALK_NS]


@pytest.mark.parametrize("name, k", CASES, ids=[f"{n.split('.')[1]}-k{k}" for n, k in CASES])
def test_plain_equals_the_jax_probe(name, k):
    got = pb.probe(name, k, pb.inputs(name), device="cpu")
    want = FIXTURE[f"{name}__k{k}"]
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape == pb.OUT_SHAPE
    assert int((got.numpy() != want).sum()) == 0


def test_every_probe_has_fixture_cases():
    names = {key.split("__")[0] for key in FIXTURE if "__k" in key}
    assert names == {n for n, p in pb.PROBES.items() if p.entry != "smem_cap"}
    assert len(CASES) == 19 * len(MAKER.PROBE_KS) + 5 * len(MAKER.WALK_NS)


def test_inputs_match_the_stored_inputs():
    assert np.array_equal(pb.inputs("walk_load"), FIXTURE["data"])
    assert np.array_equal(MAKER.build_probe_inputs()["data"], FIXTURE["data"])
    walks = [n for n, p in pb.PROBES.items() if p.entry == "walk"]
    assert {pb.PROBES[n].rows for n in walks} == {144, 288, 576}
    for name in walks:
        assert np.array_equal(pb.inputs(name), FIXTURE[f"walk_r{pb.PROBES[name].rows}"])


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
    cu = (ROOT / "csnappy_tpu_torch" / "csrc" / "probe.cu").read_text()
    assert set(pb.SITES) == {p.call for p in pb.PROBES.values()}
    assert len(pb.SITES) == 4
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
            else:
                assert re.match(rf"def (k_)?{short}\(", text), (name, text)
        assert f"int probe_{p.entry}_launch(" in cu or f"PROBE_ENTRY({p.entry}," in cu, name
        assert p.k_lo <= p.k_hi and p.space in ("shared", "global", "registers")
        if p.entry == "walk":
            assert p.space == ("global" if p.rows * 512 > 232448 else "shared"), name


def test_resolve_and_input_checks():
    assert pb.resolve("walk_c2_r288") == "mosaic_probe5.walk_c2_r288"
    assert pb.resolve("mosaic_probe.roll_static") == "mosaic_probe.roll_static"
    with pytest.raises(KeyError):
        pb.resolve("walk")
    with pytest.raises(ValueError, match="int32"):
        pb.probe("walk_load", 3, pb.inputs("walk_load")[:16], device="cpu")
    with pytest.raises(ValueError, match="k must be"):
        pb.probe("walk_load", -1, pb.inputs("walk_load"), device="cpu")


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

