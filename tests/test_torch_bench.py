"""The port's bench line, phase profile and records step, on the CPU.

* ``bench_torch.py``: one JSON line with ``bench.py``'s keys (read from
  ``bench.py`` with ``ast``, so the two cannot drift), exact outputs, the
  refusal of absurd rates, no CPU fallback;
* ``tools/phaseprof.py``: the rows of synthetic stamps, in the row format of
  the JAX tool's committed records;
* ``tools/records.py``: a failed or empty run writes no file;
* ``tools/zramsim.corpus_tree`` and the device in ``benchtable``'s first line.
"""
import ast
import json
import math
import pathlib

import numpy as np
import pytest
import torch

import bench_torch
from csnappy_tpu_torch.ops import decode_fused, encode_fused
from csnappy_tpu_torch.tools import benchtable, phaseprof, records, timing, zramsim

# the suite runs in parallel worker processes: one intra-op thread each keeps
# the torch ops here from contending with every other worker
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = ["--device", "cpu", "--reps", "1"]


def _bench_py_keys() -> tuple:
    """The keys of the ``result`` dict that ``bench.py`` prints."""
    for node in ast.walk(ast.parse((ROOT / "bench.py").read_text())):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and [getattr(t, "id", None) for t in node.targets] == ["result"]:
            return tuple(k.value for k in node.value.keys)
    raise AssertionError("bench.py has no result dict")


# --------------------------------------------------------------- bench_torch


def test_bench_line_has_bench_py_keys(capsys):
    assert bench_torch.main(CPU) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert tuple(line) == _bench_py_keys() == bench_torch.KEYS and len(line) == 15
    assert line["compressed_bytes"] == 354567 and line["ref_compressed_bytes"] == 357267
    assert line["device"] == "cpu" and line["roofline_utilization_pct"] is None
    assert list(line["decode_GBps_by_batch"]) == ["64"] and line["batch_blocks"] == 64
    assert line["hbm_traffic_MB_per_call"] == round(3128696 / 1e6, 2)
    assert min(line[k] for k in ("value", "wholestream_decompress_GBps",
                                 "wholestream_host_e2e_GBps", "compress_GBps")) > 0


@pytest.mark.parametrize("field", [0, 1, 2], ids=["byte", "produced", "status"])
def test_bench_refuses_a_decode_that_differs(monkeypatch, capsys, field):
    real = decode_fused.decode_blocks

    def wrong(*a, **k):
        got = [t.clone() for t in real(*a, **k)]
        got[field].view(-1)[1] ^= 1              # block 0's second byte, or block 1's count
        return tuple(got)

    monkeypatch.setattr(decode_fused, "decode_blocks", wrong)
    with pytest.raises(RuntimeError, match="differs from its source"):
        bench_torch.main(CPU)
    assert capsys.readouterr().out == ""


def test_bench_refuses_a_stream_that_differs(monkeypatch, capsys):
    real = encode_fused.encode_blocks

    def wrong(*a, **k):
        comp, lens = real(*a, **k)
        comp = comp.clone()
        comp[3, 100] ^= 1
        return comp, lens

    monkeypatch.setattr(encode_fused, "encode_blocks", wrong)
    with pytest.raises(RuntimeError, match="JAX package's"):
        bench_torch.main(CPU)
    assert capsys.readouterr().out == ""


def test_bench_refuses_an_absurd_rate(monkeypatch, capsys):
    monkeypatch.setattr(bench_torch, "_device_s", lambda *a: 1e-12)
    with pytest.raises(RuntimeError, match="exceeds 100x the reference"):
        bench_torch.main(CPU)
    assert capsys.readouterr().out == ""


def test_bench_without_a_card_raises(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_torch.main([])
    assert capsys.readouterr().out == ""


# ----------------------------------------------------------------- phaseprof


def _jax_row_keys(which: str) -> list:
    path = ROOT / "records" / f"phaseprof_r4_end_{which}.jsonl"
    return [set(json.loads(x)) for x in path.read_text().splitlines()]


def _check_rows(rows, names, cycles, mhz, which):
    assert [r["phase"] for r in rows] == list(names)
    assert math.isclose(sum(r["delta_ms"] for r in rows), rows[-1]["cum_ms"], rel_tol=1e-12)
    slow = int(np.argmax(cycles.sum(1)))
    for i, r in enumerate(rows):
        assert r["cycles"] == cycles[slow, i] and r["median_cycles"] == int(np.median(cycles[:, i]))
        assert r["delta_ms"] == pytest.approx(cycles[slow, i] / (mhz * 1e3), rel=1e-12)
    assert rows[-1]["slowest_block"] == slow
    phase_keys = _jax_row_keys(which)[0]
    assert all(phase_keys <= set(r) for r in rows)      # phase, cum_ms, delta_ms
    return slow


def test_phaseprof_decode_rows_from_stamps():
    rng = np.random.default_rng(0)
    st = np.zeros((32, decode_fused.STAMPS), np.int64)
    n = len(decode_fused.PHASES)
    st[:, :n] = rng.integers(100, 30000, (32, n))
    st[:, -3:] = rng.integers(1, 4000, (32, 3))
    rows = phaseprof.decode_rows(st, 1980.0)
    slow = _check_rows(rows, decode_fused.PHASES, st[:, :n], 1980.0, "decode")
    assert {k: rows[-1][k] for k in decode_fused.COUNTS} == dict(
        zip(decode_fused.COUNTS, st[slow, -3:].tolist()))
    assert json.loads(json.dumps(rows)) == rows


def test_phaseprof_encode_rows_from_stamps():
    rng = np.random.default_rng(1)
    n = len(encode_fused.PHASES)
    st = np.zeros((22, encode_fused.STAMPS), np.int64)
    st[:, : n + 1] = 10**9 + np.cumsum(rng.integers(0, 20000, (22, n + 1)), axis=1)
    rows = phaseprof.encode_rows(st, 1755.0)
    _check_rows(rows, encode_fused.PHASES, np.diff(st[:, : n + 1], axis=1), 1755.0, "encode")
    assert _jax_row_keys("encode")[-1] == {"MBps_full"}


def test_phaseprof_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        phaseprof.main(["decode"])


# ------------------------------------------------------------------- records


def _written(text: str):
    return lambda: records._printed(lambda argv: print(text, end="") or 0, [])


def _failing(kind: str):
    def main(argv):
        if kind == "raises":
            raise RuntimeError("stub run failed")
        return 0 if kind == "prints nothing" else 3

    return lambda: records._printed(main, [])


@pytest.mark.parametrize("kind", ["prints nothing", "raises", "exits 3"])
def test_records_write_nothing_when_a_run_fails(tmp_path, monkeypatch, kind):
    runs = {name: _written(f"{name}\n") for name in records.RUNS}
    runs["torch_bench.json"] = _failing(kind)              # the last run, after four good ones
    monkeypatch.setattr(records, "RUNS", runs)
    out = tmp_path / "records"
    assert records.main(["--out", str(out)]) != 0
    assert not out.exists()
    out.mkdir()
    (out / "torch_benchtable.txt").write_text("kept")
    assert records.main(["--out", str(out)]) != 0
    assert [p.name for p in out.iterdir()] == ["torch_benchtable.txt"]
    assert (out / "torch_benchtable.txt").read_text() == "kept"


def test_records_write_every_file(tmp_path, monkeypatch):
    monkeypatch.setattr(records, "RUNS", {name: _written(f"{name}\n") for name in records.RUNS})
    assert records.main(["--out", str(tmp_path)]) == 0
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(records.RUNS) == sorted(
        ["torch_benchtable.txt", "torch_zramsim.json", "torch_phaseprof_decode.jsonl",
         "torch_phaseprof_encode.jsonl", "torch_bench.json"])
    assert all((tmp_path / n).read_text() == f"{n}\n" for n in records.RUNS)


# ------------------------------------------------------------- tree, table


def test_corpus_tree_copies_the_corpus_to_its_size(tmp_path, monkeypatch):
    from csnappy_tpu_torch.tools import corpus

    files = {"urls.10K": b"u" * 700, "b": b"b" * 300, "a": b"a" * 500}
    monkeypatch.setattr(corpus, "corpus", lambda: dict(files))
    assert zramsim.corpus_tree(str(tmp_path), 3000) == ["a", "b", "urls.10K"]
    sizes = {str(p.relative_to(tmp_path)): p.stat().st_size
             for p in tmp_path.rglob("*") if p.is_file()}
    assert sizes == {"copy000/a": 500, "copy000/b": 300, "copy000/urls.10K": 700,
                     "copy001/a": 500, "copy001/b": 300, "copy001/urls.10K": 700}
    assert zramsim.corpus_tree(str(tmp_path / "cut"), 1000) == ["a", "b", "urls.10K"]
    assert (tmp_path / "cut" / "copy000" / "urls.10K").stat().st_size == 200


def test_benchtable_names_the_device(tmp_path, capsys):
    p = tmp_path / "x"
    p.write_bytes((ROOT / "tests" / "data" / "urls.10K").read_bytes()[:5000])
    assert benchtable.main(["-b", "torch", "--device", "cpu", str(p)]) == 0
    assert capsys.readouterr().out.splitlines()[0] == "backend=torch device=cpu"
    assert timing.card("cpu") == "cpu"
