"""The port's tools (``csnappy_tpu_torch/tools``), mirroring ``tests/test_tools.py``.

``benchtable -b native/py``, ``zramsim``, ``corpus`` and ``movebench`` on
the CPU.  The corpus is compared file by file with the JAX package's
generator (numpy only); movebench's plain versions are compared with the
frozen outputs of the JAX package's Pallas kernels (rows 12-13 of the
kernel table, ``tests/data/torch_ref/movebench.npz``), at R = 16 and 64.
"""
import json
import pathlib

import numpy as np
import pytest
import torch

from csnappy_tpu.tools import corpus as jax_corpus
from csnappy_tpu_torch.tools import benchtable, corpus, movebench, timing, zramsim

DATA = pathlib.Path(__file__).parent / "data"
ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mb_ref():
    with np.load(DATA / "torch_ref" / "movebench.npz") as z:
        return {k: z[k] for k in z.files}


# ------------------------------------------------ mirrored from test_tools.py


def test_benchtable_native(capsys):
    assert benchtable.main(["-b", "native", str(DATA / "urls.10K")]) == 0
    out = capsys.readouterr().out
    assert "urls.10K" in out and "MB/s" in out


def test_zramsim_roundtrip(tmp_path, urls10k):
    (tmp_path / "a.bin").write_bytes(urls10k[:50000])
    (tmp_path / "sub").mkdir()
    (tmp_path / "sub" / "b.bin").write_bytes(urls10k[50000:120000])
    r = zramsim.run(str(tmp_path), page_size=4096, device="cpu")
    assert r["nr_files"] == 2
    assert r["orig_data_size"] == 120000
    assert 0 < r["compr_data_size"] < r["orig_data_size"]


def test_corpus_deterministic_and_diverse():
    c1 = corpus.corpus()
    c2 = corpus.corpus()
    assert set(c1) == set(c2) and all(c1[k] == c2[k] for k in c1)
    assert len(c1) >= 8
    import zlib

    ratios = {k: len(zlib.compress(v[:65536], 1)) / min(len(v), 65536) for k, v in c1.items()}
    assert min(ratios.values()) < 0.35      # highly compressible member
    assert max(ratios.values()) > 0.95      # incompressible member


def test_benchtable_py_backend(tmp_path, capsys):
    p = tmp_path / "x"
    p.write_bytes(b"hello world " * 400)
    assert benchtable.main(["-b", "py", str(p)]) == 0
    out = capsys.readouterr().out
    assert "MB/s" in out and "ratio" in out


def test_movebench_runs(capsys):
    assert movebench.main(["2048", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("elem_per_s") == 5
    names = [json.loads(line)["strategy"] for line in out.splitlines()]
    assert names == ["torch_gather", "gather_kernel", "sort", "dense", "scan_kernel"]


# ------------------------------------------------------------- the port


def test_corpus_equals_jax_file_by_file():
    ours, theirs = corpus.corpus(), jax_corpus.corpus()
    assert list(ours) == list(theirs)
    for name in theirs:
        assert ours[name] == theirs[name], name


def test_benchtable_torch_backend_on_cpu(tmp_path, capsys):
    p = tmp_path / "x"
    p.write_bytes((DATA / "urls.10K").read_bytes()[:40000])
    assert benchtable.main(["-b", "torch", "--device", "cpu", str(p)]) == 0
    out = capsys.readouterr().out
    assert out.startswith("backend=torch") and "MB/s" in out


def test_zramsim_main_prints_key_value(tmp_path, capsys, urls10k):
    (tmp_path / "a.bin").write_bytes(urls10k[:9000])
    assert zramsim.main([str(tmp_path), "--device", "cpu"]) == 0
    keys = [line.split(":")[0] for line in capsys.readouterr().out.splitlines()]
    assert keys == ["nr_files", "orig_data_size", "compr_data_size", "ratio", "codec_seconds",
                    "wall_seconds"]


@pytest.mark.parametrize("R", [16, 64])
def test_gather_plain_equals_jax(mb_ref, R):
    got = movebench.gather_flat(mb_ref[f"tbl{R}"], mb_ref[f"idx{R}"], 16, device="cpu")
    assert np.array_equal(got.numpy(), mb_ref[f"gather{R}"])


@pytest.mark.parametrize("R", [16, 64])
def test_gather_masks_and_clips_as_jax(mb_ref, R):
    # values up to 2^31 keep their low 16 bits, as the JAX kernel's two
    # 8-bit limbs do; indices outside [0, n) are clipped
    wide, oob = mb_ref[f"wide{R}"], mb_ref[f"idx_oob{R}"]
    assert wide.max() >= 1 << 16 and oob.min() < 0 and oob.max() >= wide.size
    got = movebench.gather_flat(wide, oob, 16, device="cpu").numpy()
    assert np.array_equal(got, mb_ref[f"gather_wide{R}"])
    assert got.max() < 1 << 16


@pytest.mark.parametrize("R", [16, 64])
def test_scan_plain_equals_jax(mb_ref, R):
    got = movebench.scan_max(mb_ref[f"scan{R}"], device="cpu")
    assert np.array_equal(got.numpy(), mb_ref[f"scanned{R}"])


@pytest.mark.parametrize("bits, mask", [(8, 0xFF), (12, 0xFFFF), (16, 0xFFFF), (24, 0xFFFFFF),
                                        (31, -1), (32, -1)])
def test_gather_keeps_whole_limbs(bits, mask):
    tbl = torch.tensor([[-1, 0x12345678, 7, -(1 << 31)]], dtype=torch.int32)
    idx = torch.tensor([[0, 1, 2, 3, 9, -4]], dtype=torch.int32)
    got = movebench.gather_flat(tbl, idx, bits, device="cpu")
    want = tbl.reshape(-1)[torch.tensor([0, 1, 2, 3, 3, 0])] & mask
    assert torch.equal(got, want.reshape(1, 6))


def test_scan_plain_equals_cummax_with_negatives():
    x = torch.from_numpy(np.random.default_rng(5).integers(
        -(1 << 31), 1 << 31, 5000, dtype=np.int64).astype(np.int32))
    assert torch.equal(movebench.scan_max(x, device="cpu"), torch.cummax(x, 0).values)


def test_movebench_refuses_other_types():
    with pytest.raises(TypeError):
        movebench.scan_max(np.zeros(4, np.int64), device="cpu")
    with pytest.raises(ValueError):
        movebench.gather_flat(np.zeros(0, np.int32), np.zeros(4, np.int32), device="cpu")


def test_slope_time_is_seconds_per_step():
    calls = []

    def step(k):
        calls.append(k)
        return torch.tensor(k)

    assert timing.slope_time(step, device="cpu") > 0
    assert len(calls) == 1 + 2 * (2 + 8)        # warm-up, then reps x (k_lo + k_hi)
    sec, aux = timing.slope_time_keyed("k", lambda k, a: (a.sum() + k, a * 2),
                                       (torch.ones(3),), device="cpu")
    assert sec > 0 and torch.equal(aux, torch.full((3,), 2.0))
    assert timing.time_ms(lambda: None, n=3, device="cpu") >= 0
