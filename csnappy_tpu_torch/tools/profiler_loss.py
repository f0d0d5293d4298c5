"""How often the card's ``torch.profiler`` loses device records.

``timing.device_profile`` and the device-operation counts of
``chip_smoke.py`` read kernels from ``torch.profiler`` traces.  On the card
a trace now and then comes back with fewer records than the calls it
covered launched, or none.  This tool traces ten different elementwise
kernels (one launch each) ``rounds`` times in each of four ways, with a
large product on the card between rounds, and counts the traces that held
all ten, some or none:

  scheduled       — a session of two steps, the first a warm-up step of the
                    schedule (``schedule(wait=0, warmup=1, active=1)``)
  plain           — one session, the calls at once
  padded          — one session held open ``timing.TRACE_PAD_S`` on the
                    host before the first call and after the last

  device_profile  — ``timing.fullest_trace`` over ``timing.device_trace``
                    (padded sessions of three calls, opened and closed by
                    sentinel kernels): retaken until the sentinels bracket
                    the calls and every operation was seen a whole number of
                    times a call, at most ``timing.TRACE_TRIES`` traces
                    (held: each kernel's count over three)

For each lost trace it says which launches were lost (the first ones, the
last ones or others, against a whole trace's order), and for every trace
of the first three ways the skew: the first kernel's device start less the
first launch's host start, on the trace's one clock (below zero, the
kernel appears to start before it was launched).

Run:  python -m csnappy_tpu_torch.tools.profiler_loss [--rounds N]
Prints one JSON line: for each way, traces by how many launches they held,
the lost traces (round, launches held, which were lost, seconds from the
start), the skew's quantiles in us, and the card.

``--sessions N`` asks where a long process starts to lose traces.  It
opens N sessions of ``timing.trace_session`` (the sessions
``timing.device_trace`` reads: ``TRACE_LEAD`` sentinels, the calls, one
sentinel, each end held open ``TRACE_PAD_S``) over three calls of the ten
kernels, and between sessions does what a long ``chip_smoke.py`` process
does (``--between``, a comma list): ``libs`` runs the next
``LIBS_PER_GAP`` cases of ``hygiene.cases`` (every kernel library of the
port, loaded by ctypes and launched), ``churn`` allocates and frees card
tensors of 1 KiB-256 MiB (``empty_cache`` every ``CHURN_EMPTY`` gaps);
every ``PROC_EVERY`` gaps ``cli`` runs ``python -m csnappy_tpu_torch.cli
file -S c`` in a subprocess, ``ctx`` a process that only makes a CUDA
context on the card, ``smi`` ``nvidia-smi`` (``PROCESSES``); ``--group`` first joins a 1-rank NCCL
group (as ``chip_smoke.py``'s scale-out phase does) and all-reduces a
tensor in every gap.  A session is lost where ``device_trace`` would not
keep it whole: no sentinel before the calls' first record or after their
last, or not every launch seen.  Every ``PROBE_EVERY`` sessions a probe
session (one kernel, each end held open ``PROBE_PAD_S``) reads the skew:
the kernel's device start less its launch's host start, on the trace's one
clock.  ``--fresh K`` spreads the N sessions over K fresh processes, one
after another.  Prints one JSON line: the summary (``summarize``: the
first loss's session index and seconds, bursts or persistent loss, the
probes' skew and its drift in us a second), each session as [index,
seconds, launches held, leading sentinels held, closing sentinels held,
skew us, probe skew us], and the card.
"""
from __future__ import annotations

import argparse
import collections
import itertools
import json
import random
import subprocess
import sys
import time

import torch

from ..config import resolve_device
from . import timing


def _ops(x: torch.Tensor) -> list:
    return [lambda: x.add_(1), lambda: x.mul_(1.0001), lambda: x.sub_(1),
            lambda: x.div_(1.0001), lambda: x.neg_(), lambda: x.abs_(), lambda: x.relu_(),
            lambda: x.sigmoid_(), lambda: x.tanh_(), lambda: x.exp_()]


def session(ops: list, pad_s: float = 0.0, scheduled: bool = False) -> tuple[list, float]:
    """Trace one launch of each of ``ops``: the kernels' names in the order
    they started on the card, and the skew (us) of the first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    got = []

    def read(p) -> None:
        dev = sorted((e.time_range.start, e.name) for e in p.events()
                     if e.device_type == DeviceType.CUDA and not e.name.startswith("ProfilerStep"))
        host = [e.time_range.start for e in p.events()
                if e.device_type == DeviceType.CPU and e.name.startswith("aten::")]
        got.append(([n for _, n in dev], dev[0][0] - min(host) if dev and host else None))

    def run() -> None:
        time.sleep(pad_s)
        for op in ops:
            op()
        torch.cuda.synchronize()
        time.sleep(pad_s)

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    if scheduled:
        with profile(activities=acts, schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=read) as p:
            for _ in range(2):
                run()
                p.step()
    else:
        with profile(activities=acts) as p:
            run()
        read(p)
    return got[0] if got else ([], None)


# --sessions: the calls of a session, the gaps' work, the probes
SESSION_REPS = 3
LIBS_PER_GAP = 3
CHURN_EMPTY = 25
PROC_EVERY = 100
PROBE_EVERY = 10
PROBE_PAD_S = 0.25
BETWEEN = ("libs", "churn", "cli", "ctx", "smi")
# the processes of the gaps that start one (every PROC_EVERY gaps): the CLI
# on the card, a bare CUDA context, nvidia-smi
PROCESSES = {"cli": [sys.executable, "-m", "csnappy_tpu_torch.cli", "file", "-S", "c"],
             "ctx": [sys.executable, "-c", "import torch; torch.ones(1, device='cuda').sum().item()"],
             "smi": ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]}


def judge(order: list, skew_us, n: int) -> dict:
    """One session's device records in the order they started (True for a
    sentinel's): the calls' launches held, the sentinels held before the
    first of them and after the last, and whether ``device_trace`` keeps it
    whole (bracketed, ``n`` launches held)."""
    own = [i for i, sentinel in enumerate(order) if not sentinel]
    lead = sum(order[: own[0]]) if own else sum(order)
    trail = sum(order[own[-1] + 1:]) if own else 0
    return {"held": len(own), "lead": lead, "trail": trail, "skew_us": skew_us,
            "whole": timing.bracketed(order) and len(own) == n}


def _bursts(lost: list) -> list:
    """Runs of consecutive session indices: [first index, length]."""
    out = []
    for i in lost:
        if out and out[-1][0] + out[-1][1] == i:
            out[-1][1] += 1
        else:
            out.append([i, 1])
    return out


def _drift(points: list):
    """Least-squares slope of (seconds, skew us): us of skew a second."""
    if len(points) < 2 or len({t for t, _ in points}) < 2:
        return None
    mt = sum(t for t, _ in points) / len(points)
    ms = sum(s for _, s in points) / len(points)
    return (sum((t - mt) * (s - ms) for t, s in points)
            / sum((t - mt) ** 2 for t, _ in points))


def summarize(sessions: list) -> dict:
    """Sessions ({"i", "t", "whole", "lead", "probe_skew_us", ...}, in order)
    summed up: how many were lost, the first loss (index, seconds), whether
    every session after it was lost too ("persistent") or some were whole
    again ("bursts", each [first index, length]), the first session that
    lost a leading sentinel, and the probes' skew (first, last, least,
    most) with its drift in us a second."""
    lost = [r for r in sessions if not r["whole"]]
    first = lost[0] if lost else None
    pattern = ("none" if not lost else
               "persistent" if all(not r["whole"] for r in sessions if r["i"] >= first["i"])
               else "bursts")
    short = next((r for r in sessions if r["lead"] < timing.TRACE_LEAD), None)
    probes = [(r["t"], r["probe_skew_us"]) for r in sessions
              if r.get("probe_skew_us") is not None]
    skews = [s for _, s in probes]
    return {"sessions": len(sessions), "lost": len(lost),
            "first_loss": {"index": first["i"], "seconds": first["t"]} if first else None,
            "pattern": pattern, "bursts": _bursts([r["i"] for r in lost]),
            "first_short_lead": {"index": short["i"], "seconds": short["t"]} if short else None,
            "probe_skew_us": {"first": skews[0], "last": skews[-1], "min": min(skews),
                              "max": max(skews)} if skews else None,
            "drift_us_per_s": _drift(probes)}


def summarize_fresh(processes: list) -> dict:
    """The sessions of fresh processes (a list of session lists, each
    indexed and timed from its own process's start) summed up as one run of
    ``summarize`` over the sessions in order, indexed on, with each
    process's own summary and the longest process's span."""
    flat, base = [], 0
    for sessions in processes:
        flat += [dict(r, i=base + r["i"]) for r in sessions]
        base += len(sessions)
    each = [summarize(sessions) for sessions in processes]
    out = summarize(flat)
    out["first_loss"] = next(({"process": k, **s["first_loss"]}
                              for k, s in enumerate(each) if s["first_loss"]), None)
    out.update(processes=len(processes),
               processes_with_loss=sum(s["lost"] > 0 for s in each),
               longest_process_s=max((ss[-1]["t"] for ss in processes if ss), default=0.0),
               drift_us_per_s=[s["drift_us_per_s"] for s in each],
               each=[{k: s[k] for k in ("sessions", "lost", "first_loss", "pattern")}
                     for s in each])
    return out


def _between(kinds: tuple, group: bool, dev):
    """The work of one gap between sessions, as ``gap(k)`` for gap ``k``."""
    import os

    import torch.distributed as dist

    rng = random.Random(0)
    cases = []
    if "libs" in kinds:
        from . import hygiene

        cases = itertools.cycle([c for fam in hygiene.cases(0, small=True).values()
                                 for c in fam])
    env = dict(os.environ)

    def gap(k: int) -> None:
        if "libs" in kinds:
            for case in itertools.islice(cases, LIBS_PER_GAP):
                case.run(dev)()
        if "churn" in kinds:
            held = [torch.empty(rng.randint(1 << 10, 1 << 28), dtype=torch.uint8,
                                device=dev).fill_(k & 0xFF) for _ in range(4)]
            del held
            if k % CHURN_EMPTY == 0:
                torch.cuda.empty_cache()
        for kind in PROCESSES:
            if kind in kinds and k % PROC_EVERY == PROC_EVERY - 1:
                subprocess.run(PROCESSES[kind], check=True, capture_output=True, timeout=300,
                               env=env)
        if group:
            t = torch.ones(1024, device=dev)
            dist.all_reduce(t)
            assert int(t[0]) == dist.get_world_size()
        torch.cuda.synchronize()

    return gap


def sessions_in_process(n: int, kinds: tuple, group: bool) -> list:
    """``n`` judged sessions in this process, the gaps' work between them."""
    from torch.autograd import DeviceType

    dev = resolve_device(None)
    x = torch.rand(1 << 20, device=dev)
    ops = _ops(x)

    def each_once() -> None:
        for op in ops:
            op()

    if group:
        from ..parallel import multihost

        multihost.init(f"localhost:{multihost.free_port()}", 1, 0, timeout=60)
    try:
        gap = _between(kinds, group, dev)
        out = []
        t0 = time.perf_counter()
        for i in range(n):
            t = time.perf_counter() - t0
            p = timing.trace_session(each_once, SESSION_REPS)
            recs = timing.device_records(p)
            host = [e.time_range.start for e in p.events()      # the first call's first launch
                    if e.device_type == DeviceType.CPU and e.name == "aten::add_"]
            own = [s for s, name in recs if timing.SENTINEL not in name]
            r = judge([timing.SENTINEL in name for _, name in recs],
                      own[0] - min(host) if own and host else None, len(ops) * SESSION_REPS)
            r.update(i=i, t=round(t, 3))
            if i % PROBE_EVERY == 0:
                r["probe_skew_us"] = session([ops[0]], PROBE_PAD_S)[1]
            out.append(r)
            gap(i)
        return out
    finally:
        if group:
            import torch.distributed as dist

            dist.destroy_process_group()


ROW = ("i", "t", "whole", "held", "lead", "trail", "skew_us", "probe_skew_us")


def _row(r: dict) -> list:
    return [r.get(k) for k in ROW]


def _sessions_main(args) -> int:
    from .probe import clocks

    kinds = tuple(k for k in args.between.split(",") if k)
    bad = set(kinds) - set(BETWEEN)
    if bad:
        raise SystemExit(f"--between: unknown {sorted(bad)}; choose from {BETWEEN}")
    t0 = time.perf_counter()
    if args.fresh:
        per = -(-args.sessions // args.fresh)
        processes = []
        for _ in range(args.fresh):
            argv = [sys.executable, "-m", "csnappy_tpu_torch.tools.profiler_loss",
                    "--sessions", str(per), "--between", args.between] + (
                        ["--group"] if args.group else [])
            p = subprocess.run(argv, check=True, capture_output=True, text=True,
                               timeout=3600)
            rows = json.loads(p.stdout.splitlines()[-1])["session_rows"]
            processes.append([dict(zip(ROW, row)) for row in rows])
        summary = summarize_fresh(processes)
        rows = [_row(r) for ss in processes for r in ss]
    else:
        sessions = sessions_in_process(args.sessions, kinds, args.group)
        summary = summarize(sessions)
        rows = [_row(r) for r in sessions]
    line = {"mode": "fresh" if args.fresh else "one process", "sessions": args.sessions,
            "processes": args.fresh or 1, "between": list(kinds), "group": args.group,
            "seconds": time.perf_counter() - t0, "torch": torch.__version__,
            "summary": summary, "row": list(ROW), "session_rows": rows, "card": clocks()}
    print(json.dumps(line))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--rounds", type=int, default=1000)
    ap.add_argument("--sessions", type=int, default=0,
                    help="judge this many device_trace sessions (the long-process mode)")
    ap.add_argument("--between", default="libs,churn,cli",
                    help=f"work between sessions, a comma list of {BETWEEN}")
    ap.add_argument("--group", action="store_true", help="join a 1-rank NCCL group first")
    ap.add_argument("--fresh", type=int, default=0,
                    help="spread the sessions over this many fresh processes")
    args = ap.parse_args(argv)
    if args.sessions:
        return _sessions_main(args)
    from .probe import clocks

    dev = resolve_device(None)
    x = torch.rand(1 << 20, device=dev)
    a = torch.randn(4096, 4096, device=dev)
    ops = _ops(x)
    n = len(ops)

    def each_once() -> None:
        for op in ops:
            op()

    ways = {"scheduled": lambda: session(ops, scheduled=True),
            "plain": lambda: session(ops),
            "padded": lambda: session(ops, timing.TRACE_PAD_S),
            "device_profile": lambda: (
                [k for k, (_, c) in timing.fullest_trace(lambda: timing.device_trace(
                    each_once, 3), 3).items() for _ in range(c // 3)], None)}
    held = {w: collections.Counter() for w in ways}
    lost = {w: [] for w in ways}
    skew = {w: [] for w in ways}
    ref = None
    t0 = time.perf_counter()
    for r in range(args.rounds):
        for _ in range(3):
            a @ a
        for w, take in ways.items():
            names, sk = take()
            held[w][len(names)] += 1
            if sk is not None:
                skew[w].append(sk)
            if len(names) == n and w != "device_profile":
                ref = ref or names
            elif len(names) != n:
                k = len(names)
                where = ("all" if k == 0 else "first" if ref and names == ref[n - k:] else
                         "last" if ref and names == ref[:k] else "others")
                lost[w].append([r, k, where, round(time.perf_counter() - t0, 1)])

    def quantiles(v: list) -> list | None:
        if not v:
            return None
        v = sorted(v)
        return [round(v[int(q * (len(v) - 1))], 1) for q in (0, 0.01, 0.5, 0.99, 1)]

    print(json.dumps({"rounds": args.rounds, "launches": n,
                      "seconds": time.perf_counter() - t0, "torch": torch.__version__,
                      "traces_by_launches_held": {w: dict(sorted(c.items()))
                                                  for w, c in held.items()},
                      "lost": lost,
                      "skew_us_quantiles_0_1_50_99_100": {w: quantiles(v) for w, v in skew.items()
                                                          if v},
                      "card": clocks()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
