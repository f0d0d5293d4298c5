"""``chip_smoke.py``'s phase runner on the CPU, with canned children.

The parent runs each phase group in a child process (``--phase GROUP``) and
merges the children's result lines.  Here a fake runner stands in for the
children: the groups cover phases 2-16 once each, in order; the merged
``kernels`` rows and the values that cross groups come out as the single
process made them; a child that fails, is cut or prints no result line
stops the run with a non-zero exit; a child with no card exits 2.
"""
import json

import pytest
import torch

import chip_smoke

# the suite runs in parallel worker processes: one intra-op thread each keeps
# the torch ops here from contending with every other worker
torch.set_num_threads(1)


def _row(name, **kw):
    return {"name": name, "route": "cuda", **kw}


# each group's pieces, as its child reports them
DECODE = [_row("decode_blocks", GBps=23.4, ms=0.09, chain_steps=482),
          _row("decode_segments", ms=0.1, chain_steps=461),
          _row("decode_blocks_wide"), _row("decode_segments_wide"),
          _row("encode_blocks", ms=0.16, chain_steps=276)]
STREAMS = [_row("decode_ws", ms=0.087),
           _row("decode_stream", ms=0.158, chain_links={"702KB": [44, 0]},
                streams={"702KB": {"chunk_us": 0.451, "segment_us": 0.2}})]
CONTAINER = {"decode_blocks": 339, "encode_blocks": 435}
MOVEBENCH = [_row("gather_flat"), _row("encode_blocks")]    # a name of an earlier row
PRIMS = [_row(f"prim{i}") for i in range(6)]
PROBES = [_row(f"probe{c}") for c in "abcdefghi"]
KL = [_row("kernel_lib"), _row("gather_rows_multi")]
SHARDED = {"decode_blocks": 2, "decode_segments": 2, "encode_blocks": 2}
STEP = 42.94

RESULTS = {
    "decode": {"rows": DECODE},
    "streams": {"rows": STREAMS},
    "container": {"annotate": {"launches_container": CONTAINER}},
    "movebench": {"rows": MOVEBENCH},
    "primitives": {"rows": PRIMS},
    "probes": {"rows": PROBES, "values": {"walk_smem_cycles": STEP}},
    "kernel_lib": {"rows": KL},
    "scaleout": {"annotate": {"launches_sharded": SHARDED}},
    "hygiene": {},
    "bench": {"values": {"bench_block_decode_GBps": 22.9}},
}


def _child_text(group: str, traces=(3, 1, 0)) -> str:
    """A child's output: a line of its own, its [phase] line, its result."""
    out = RESULTS[group]
    t = dict(zip(("taken", "retaken", "lost"), traces))
    return (f"[{group}] some line\n[phase] {group}: 1.5 s, traces {t['taken']}, retaken "
            f"{t['retaken']}, lost {t['lost']}\n"
            + json.dumps({chip_smoke.RESULT: {
                "group": group, "rows": json.loads(json.dumps(out.get("rows", []))),
                "annotate": out.get("annotate", {}), "values": out.get("values", {}),
                "seconds": 1.5, "traces": t}}) + "\n")


def _single_process_rows() -> list:
    """The rows as one process built them, all phases in turn:
    phase 6's rows after phases 2-5's; the container's launches on those;
    movebench's, the primitives', the probes' and kernel_lib's rows; the
    sharded launches on every row so far."""
    rows = json.loads(json.dumps(DECODE + STREAMS))
    for row in rows:
        if row["name"] in CONTAINER:
            row["launches_container"] = CONTAINER[row["name"]]
    rows += json.loads(json.dumps(MOVEBENCH + PRIMS + PROBES + KL))
    for row in rows:
        if row["name"] in SHARDED:
            row["launches_sharded"] = SHARDED[row["name"]]
    return rows


def test_every_phase_lies_in_one_group_in_order():
    phases = [p for group, _ in chip_smoke.GROUPS.values() for p in group]
    assert phases == list(range(2, 17))
    assert all(callable(run) for _, run in chip_smoke.GROUPS.values())


def test_the_parent_merges_the_children_as_one_process_did(capsys):
    asked = []

    def runner(group, limit):
        asked.append((group, limit))
        return 0, _child_text(group)

    rc, results = chip_smoke.run_groups(runner)
    assert rc == 0 and [g for g, _ in asked] == list(chip_smoke.GROUPS)
    assert dict(asked)["hygiene"] > dict(asked)["decode"] == chip_smoke.GROUP_LIMIT_S
    rows = chip_smoke.merge(results)
    assert rows == _single_process_rows()
    later = rows[len(DECODE) + len(STREAMS) + 1]       # annotated only by a later group
    assert later["name"] == "encode_blocks" and "launches_container" not in later
    assert later["launches_sharded"] == 2
    lines = chip_smoke.chain_lines(rows, STEP, "1980 MHz")
    assert [line.split(":")[0] for line in lines] == [
        "[chain] decode_blocks", "[chain] decode_segments", "[chain] encode_blocks",
        "[chain] decode_stream"]
    assert f"482 serial steps x one walk_smem step ({STEP:.2f} SM cycles at 1980 MHz" in lines[0]
    assert f"= {482 * STEP / 1980e3:.4f} ms" in lines[0]
    assert chip_smoke.trace_totals(results) == {"seconds": 1.5 * len(results), "taken": 30,
                                                "retaken": 10, "lost": 0}


@pytest.fixture
def fake_card(monkeypatch):
    """The parent's calls to the card and the build, answered here."""
    from csnappy_tpu_torch.ops import _build
    from csnappy_tpu_torch.tools import timing

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(_build, "build", lambda *a, **k: {})
    monkeypatch.setattr(_build, "CUDA_NAMES", ())
    monkeypatch.setattr(timing, "smi", lambda q: "NVIDIA H100 80GB HBM3, 700.00 W, 1980 MHz"
                        if "clocks" in q else "NVIDIA H100 80GB HBM3, 700.00 W")


def test_the_parent_prints_the_kernels_line_and_the_result_last(fake_card, capsys):
    assert chip_smoke.main([], runner=lambda g, limit: (0, _child_text(g))) == 0
    out = capsys.readouterr().out.splitlines()
    assert json.loads(out[-1]) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
    assert out[-2] == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert json.loads(out[-3]) == {"kernels": _single_process_rows()}
    assert out[-4].startswith("[phase] total: 15.0 s in 10 children, traces 30, retaken 10, "
                              "lost 0")
    assert any(line.startswith("[bench] block decode 22.9 GB/s beside row 1's 23.4000 GB/s")
               for line in out)


@pytest.mark.parametrize("failure", [
    (1, "Traceback ...\nAssertionError: phase 14\n"),      # the child failed
    (0, "[scaleout] all fine\n"),                           # no result line
    (None, "[scaleout] half way\n"),                        # cut at its own limit
])
def test_a_failed_child_fails_the_parent(fake_card, capsys, failure):
    def runner(group, limit):
        return failure if group == "scaleout" else (0, _child_text(group))

    assert chip_smoke.main([], runner=runner) == 1
    out = capsys.readouterr().out
    assert "phase group scaleout" in out and failure[1] in out
    assert '"ok": true' not in out and '{"kernels"' not in out


def test_a_failed_child_prints_its_tail_and_no_later_group_runs(capsys):
    asked = []

    def runner(group, limit):
        asked.append(group)
        return (3, "x" * 5000 + "the end") if group == "probes" else (0, _child_text(group))

    rc, results = chip_smoke.run_groups(runner)
    assert rc == 1 and asked[-1] == "probes" and len(results) == 5
    out = capsys.readouterr().out
    assert "phase group probes exited 3" in out and out.rstrip().endswith("the end")
    assert "x" * (chip_smoke.TAIL - len("the end")) in out and "x" * chip_smoke.TAIL not in out


def test_a_result_line_counts_only_once():
    text = _child_text("probes")
    assert chip_smoke.result_of(text)["values"] == {"walk_smem_cycles": STEP}
    assert chip_smoke.result_of(text + text) is None
    assert chip_smoke.result_of("[probes] nothing\n") is None


@pytest.mark.parametrize("argv", [["--phase", "kernel_lib"], []])
def test_no_card_exits_2(argv, capsys):
    assert chip_smoke.main(argv, runner=pytest.fail) == 2
    assert "no CUDA device" in capsys.readouterr().err


@pytest.mark.parametrize("op, name", [
    ("void (anonymous namespace)::chain_kernel<false>(unsigned char const*, int)", "chain_kernel"),
    ("decode_kernel(unsigned char const*, long const*)", "decode_kernel"),
    ("void scan_kernel<13>(unsigned char const*)", "scan_kernel"),
    ("ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgsStorage<4096ul>)",
     "ncclDevKernel_AllGather_RING_LL"),
])
def test_a_trace_record_reads_as_its_kernel_name(op, name):
    assert chip_smoke._kernel_name(op) == name


def test_the_wrappers_counts_must_agree_with_the_trace():
    ops = {"void chain_kernel<false>(int)": 1.0, "segment_kernel(int)": 1.0,
           "Memset (Device)": 1.0}
    text, n = chip_smoke._agree("stream", ops, {"decode_stream": 1})
    assert n == 2 and text.endswith("agreed")
    with pytest.raises(AssertionError):
        chip_smoke._agree("stream", ops, {"decode_stream": 2})
    # kernels no wrapper launches (NCCL's) are not held; the named ones are
    sharded = {"encode_kernel(int)": 1.0, "ncclDevKernel_AllGather(int)": 3.0}
    assert chip_smoke._agree("sharded", sharded, {"encode_blocks": 1})[1] == 1
    with pytest.raises(AssertionError):
        chip_smoke._agree("sharded", sharded, {"encode_blocks": 1, "decode_kernel": 1})
    # a count whose kernels have no fixed name: the kernels of the trace in all
    assert chip_smoke._agree("prim", {"lane_gather_kernel(int)": 1.0},
                             {"primitives.table_gather": 1})[1] == 1
    with pytest.raises(AssertionError):
        chip_smoke._agree("prim", {"a(int)": 1.0, "b(int)": 1.0}, {"primitives.table_gather": 1})
    # a trace with no kernel record: not measured, the caller decides
    text, _ = chip_smoke._agree("lost", {}, {"encode_blocks": 1})
    assert "not measured" in text and "agreed" not in text


def test_a_child_prints_its_phase_line_and_its_result_last(fake_card, monkeypatch, capsys):
    from csnappy_tpu_torch.tools import timing

    def group(torch_, np, dev, card):
        assert dev.type == "cuda" and card.endswith("1980 MHz")
        timing.traces.update(taken=4, retaken=2, lost=0)
        print("[probes] a line of the group")
        return RESULTS["probes"]

    monkeypatch.setitem(chip_smoke.GROUPS, "probes", ((12,), group))
    monkeypatch.setattr(timing, "traces", {"taken": 0, "retaken": 0, "lost": 0})
    assert chip_smoke.main(["--phase", "probes"]) == 0
    out = capsys.readouterr().out
    lines = out.splitlines()
    assert lines[0] == "[probes] a line of the group"
    assert lines[1].startswith("[phase] probes: ") and lines[1].endswith(
        " s, traces 4, retaken 2, lost 0")
    res = chip_smoke.result_of(out)
    assert res["group"] == "probes" and res["rows"] == PROBES and res["annotate"] == {}
    assert res["values"] == {"walk_smem_cycles": STEP}
    assert res["traces"] == {"taken": 4, "retaken": 2, "lost": 0}
