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
"""
from __future__ import annotations

import argparse
import collections
import json
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--rounds", type=int, default=1000)
    args = ap.parse_args(argv)
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
