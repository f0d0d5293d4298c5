"""The port's tools (``csnappy_tpu_torch/tools``), mirroring ``tests/test_tools.py``.

``benchtable -b native/py``, ``zramsim``, ``corpus`` and ``movebench`` on
the CPU.  The corpus is compared file by file with the JAX package's
generator (numpy only); movebench's plain versions are compared with the
frozen outputs of the JAX package's Pallas kernels (rows 12-13 of the
kernel table, ``tests/data/torch_ref/movebench.npz``), at R = 16 and 64.
A numpy model of the scan kernel's one pass (tiles by ticket, a decoupled
look-back over 64-bit status words) is held to ``np.maximum.accumulate``
and to the same fixture, in seeded orders of completion.  The profiler's
retake rule (``timing.fullest_trace``) and its sentinels' bracket
(``timing.bracketed``) are held to traces made up here.
"""
import json
import pathlib

import numpy as np
import pytest
import torch

from csnappy_tpu.tools import corpus as jax_corpus
from csnappy_tpu_torch.tools import benchtable, corpus, movebench, profiler_loss, timing, zramsim

# the suite runs in parallel worker processes: one intra-op thread each keeps
# the torch ops here from contending with every other worker
torch.set_num_threads(1)

DATA = pathlib.Path(__file__).parent / "data"
ROOT = pathlib.Path(__file__).resolve().parents[1]


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


@pytest.mark.parametrize("order, kept", [
    ([True] * 8 + [False, False, True], True),             # every record
    ([True] * 6 + [False, False, True], True),             # the first two records lost
    ([False, True], False),                    # no sentinel before the calls' first record
    ([True, False], False),                    # no sentinel after the calls' last record
    ([True] * 9, True),                                    # calls that run nothing on the card
    ([], False),                                           # every record lost
])
def test_a_trace_counts_only_between_sentinels(order, kept):
    assert timing.bracketed(order) is kept


WHOLE, PART = {"k": (9.0, 10), "m": (1.0, 20)}, {"k": (5.0, 7), "m": (1.0, 20)}


NEVER = [{}] * timing.TRACE_TRIES


@pytest.mark.parametrize("traces, takes, want", [
    ([WHOLE], 1, WHOLE),                                   # whole at once: no retake
    ([{}, PART, WHOLE], 3, WHOLE),                         # empty, then partial, then whole
    ([PART] + NEVER[1:], timing.TRACE_TRIES, PART),        # never whole: the fullest kept
    (NEVER, timing.TRACE_TRIES, {}),                       # nothing seen: not measured
    ([{"k": (1.0, 3)}, PART] + NEVER[2:], timing.TRACE_TRIES, PART),  # a fuller partial wins
])
def test_fullest_trace_retakes_until_every_count_is_whole(traces, takes, want):
    it, slept = iter(traces), []
    assert timing.fullest_trace(lambda: next(it), reps=10, sleep=slept.append) == want
    # a pause that doubles before each retake
    assert slept == [timing.TRACE_PAUSE_S * 2 ** i for i in range(takes - 1)]
    assert len(list(it)) == len(traces) - takes


def _sessions(lost=(), short=(), n=12, dt=0.5, drift=None):
    """Canned judged sessions: ``lost`` indices not whole, ``short`` ones
    missing leading sentinels, a probe's skew every other session."""
    return [{"i": i, "t": i * dt, "whole": i not in lost, "held": 30,
             "lead": 5 if i in short else timing.TRACE_LEAD, "trail": 1, "skew_us": 8.0,
             "probe_skew_us": (7.0 + drift * i * dt) if drift is not None and i % 2 == 0
             else None} for i in range(n)]


@pytest.mark.parametrize("lost, pattern, first, bursts", [
    ((), "none", None, []),
    ((5, 6, 7, 8, 9, 10, 11), "persistent", 5, [[5, 7]]),       # every session from the first loss
    ((2, 3, 7), "bursts", 2, [[2, 2], [7, 1]]),                 # whole sessions between losses
    ((11,), "persistent", 11, [[11, 1]]),                       # the last session only
])
def test_sessions_summary_finds_the_first_loss_and_its_pattern(lost, pattern, first, bursts):
    s = profiler_loss.summarize(_sessions(lost, short=lost[:1], drift=-40.0))
    assert (s["sessions"], s["lost"], s["pattern"], s["bursts"]) == (12, len(lost), pattern,
                                                                     bursts)
    assert s["first_loss"] == (None if first is None else {"index": first, "seconds": first * 0.5})
    assert s["first_short_lead"] == (None if not lost else {"index": first,
                                                            "seconds": first * 0.5})
    assert s["drift_us_per_s"] == pytest.approx(-40.0)
    assert s["probe_skew_us"] == {"first": 7.0, "last": 7.0 - 40.0 * 5.0, "min": -193.0,
                                  "max": 7.0}


def test_sessions_judge_reads_the_sentinels_around_the_calls():
    lead, call, end = [True] * timing.TRACE_LEAD, [False] * 30, [True]
    assert profiler_loss.judge(lead + call + end, 9.0, 30) == {
        "held": 30, "lead": 8, "trail": 1, "skew_us": 9.0, "whole": True}
    assert profiler_loss.judge(lead[3:] + call + end, 9.0, 30)["lead"] == 5
    assert not profiler_loss.judge(call + end, None, 30)["whole"]          # no leading sentinel
    assert not profiler_loss.judge(lead + call[1:] + end, 9.0, 30)["whole"]  # a launch lost
    assert profiler_loss.judge([], None, 30) == {"held": 0, "lead": 0, "trail": 0,
                                                 "skew_us": None, "whole": False}


def test_fresh_processes_summary_indexes_on_and_keeps_each_process():
    one = _sessions(n=6, drift=-10.0)
    late = _sessions((4, 5), n=6, drift=-30.0)
    s = profiler_loss.summarize_fresh([one, late, one])
    assert (s["sessions"], s["lost"], s["processes"], s["processes_with_loss"]) == (18, 2, 3, 1)
    # the first loss by process and its own index and seconds; indices run on across processes
    assert s["first_loss"] == {"process": 1, "index": 4, "seconds": 2.0}
    assert s["bursts"] == [[10, 2]] and s["pattern"] == "bursts"
    assert s["longest_process_s"] == 2.5
    assert s["drift_us_per_s"] == [pytest.approx(-10.0), pytest.approx(-30.0),
                                   pytest.approx(-10.0)]
    assert [e["lost"] for e in s["each"]] == [0, 2, 0]
    assert profiler_loss.summarize_fresh([one, one])["first_loss"] is None


# ------------------------------------------- the one-pass scan, modelled

AGGREGATE, PREFIX = 1, 2
INT_MIN = -(1 << 31)


def one_pass_scan_model(x: np.ndarray, tile: int, window: int, rng) -> tuple[np.ndarray, dict]:
    """A numpy model of ``csrc/movebench.cu``'s scan on int32 ``x``: tiles
    of ``tile`` elements take tickets in order; a tile that has scanned its
    elements publishes its aggregate (tile 0 its inclusive prefix), then
    looks back ``window`` words at a time (the kernel: 32, one a lane), each
    word read as unpublished (the window waits), aggregate or inclusive
    prefix, takes the maximum of the aggregates up to the nearest prefix, and
    publishes its own prefix.  ``rng`` picks which tile moves next: the
    next ticket, a tile that publishes its aggregate, or a window step of a
    tile that is looking back.  Returns the output and counts of what the
    windows saw."""
    n = x.size
    nt = -(-n // tile)
    local = [np.maximum.accumulate(x[t * tile : (t + 1) * tile]) for t in range(nt)]
    words = [None] * nt                          # (status, value), None = all zero
    scanning = []                                # tiles with a ticket, aggregate unpublished
    looking = {}                                 # tile -> (next predecessor, prefix so far)
    out = np.empty_like(x)
    seen = {"windows": 0, "waited": 0, "aggregates": 0, "prefixes": 0}
    started = done = 0
    while done < nt:
        moves = ([("start", started)] if started < nt else []) + \
            [("publish", t) for t in scanning] + [("look", t) for t in looking]
        kind, t = moves[int(rng.integers(len(moves)))]
        if kind == "start":
            started += 1
            scanning.append(t)
            continue
        if kind == "publish":
            scanning.remove(t)
            words[t] = (PREFIX if t == 0 else AGGREGATE, int(local[t][-1]))
            if t == 0:
                out[:tile] = local[0]
                done += 1
            else:
                looking[t] = (t - 1, INT_MIN)
            continue
        j, prefix = looking[t]
        read = [words[p] if p >= 0 else (PREFIX, INT_MIN) for p in range(j, j - window, -1)]
        seen["windows"] += 1
        if any(w is None for w in read):
            seen["waited"] += 1                  # a lane spins: the window waits
            continue
        stop = next((k for k, w in enumerate(read) if w[0] == PREFIX), None)
        upto = read if stop is None else read[: stop + 1]
        seen["aggregates"] += sum(w[0] == AGGREGATE for w in upto)
        prefix = max([prefix] + [w[1] for w in upto])
        if stop is None:
            looking[t] = (j - window, prefix)
            continue
        seen["prefixes"] += 1
        del looking[t]
        words[t] = (PREFIX, max(prefix, int(local[t][-1])))
        out[t * tile : (t + 1) * tile] = np.maximum(local[t], prefix)
        done += 1
    return out, seen


@pytest.mark.parametrize("seed", range(8))
def test_one_pass_scan_model_equals_maximum_accumulate(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 3000))
    kinds = [rng.integers(-(1 << 31), 1 << 31, n, dtype=np.int64).astype(np.int32),
             np.arange(n, 0, -1, dtype=np.int32) - (1 << 30),          # descending
             np.full(n, INT_MIN, np.int32)]
    total = {"waited": 0, "aggregates": 0, "prefixes": 0}
    for x in kinds:
        for tile, window in ((7, 3), (64, 32), (1, 4)):
            got, seen = one_pass_scan_model(x, tile, window, rng)
            assert np.array_equal(got, np.maximum.accumulate(x)), (tile, window)
            for k in total:
                total[k] += seen[k]
    # the seeded orders reach every state a word can be read in
    assert all(v > 0 for v in total.values()), total


@pytest.mark.parametrize("R", [16, 64])
def test_one_pass_scan_model_equals_jax(mb_ref, R):
    flat = mb_ref[f"scan{R}"].reshape(-1)
    got, _ = one_pass_scan_model(flat, 100, 32, np.random.default_rng(R))
    assert np.array_equal(got.reshape(R, 128), mb_ref[f"scanned{R}"])


def test_scan_buffer_holds_the_output_and_the_workspace():
    # the output padded to 16 bytes, then the ticket and one word a tile
    tile = movebench.SCAN_TILE
    assert movebench.scan_words(1) == 4 + 2 * 2
    assert movebench.scan_words(tile) == tile + 2 * 2
    assert movebench.scan_words(tile + 1) == tile + 4 + 2 * 3
    assert movebench.scan_words(1 << 24) == (1 << 24) + 2 * (1 + (1 << 24) // tile)
