#!/usr/bin/env python3
"""Where the port's block codec and primitives spend their device time, on one CUDA card.

    python3 tools/torch_profile.py [--out FILE.json] [--root TREE] [--scan-split] [--stream-split]
                                   [--wide]

Runs the main path's batch (B=64 blocks of 32 KiB of urls.10K, block i =
``urls[(i % 21) * 32768 : ...]``, as bench.py and chip_smoke.py make it)
through ``encode_fused.encode_blocks`` and ``decode_fused.decode_blocks``
(one call each on card tensors, as a user makes it, and the decoder's
launch alone), ``decode_fused.decode_segments`` over urls.10K.snappy's 22
segments (one call), the six wrappers of ``ops/primitives.py`` on their
inputs at the same batch (``movebench.primitive_inputs(64)``, on the card)
and movebench's two kernels (``gather_flat``, ``scan_max``) at n = 32768
and 2^24 under ``torch.profiler`` after a warm-up, and prints for each the
device time per call of every kernel, copy and fill it ran, their sum, and the
call's CUDA-event time (the gap is device idle), with the card's name and
power limit; then the whole-stream slice the same way: one
``decode_ws.scan_segments`` and one ``decode_ws.decompress_noheader_ws``
call on card tensors of urls.10K.snappy, of urls.10K x 24 (16 MiB,
compressed on the card) and, for the scan, of a 16 MiB stream whose two tag
chains never merge; one ``decode_stream.decode_stream`` call on
urls.10K.snappy, unaligned_uint64_test.snappy and the 16 MiB stream; then the host time of a lone call of each codec entry,
of those whole-stream calls and of the host scan (``native.scan_segments``)
(synchronised before and after, median of 50; 10 at 16 MiB), and the host
split of one ``decompress_noheader_ws`` call on urls.10K.snappy, step by
step (µs), and of one ``table_gather`` and one ``scan_max`` call
(:func:`primitive_host_split`); last, phases 10 and 11 of the tree's own
``chip_smoke.py`` (movebench's kernels and the primitives).  ``--root``
imports ``csnappy_tpu_torch`` from another tree (an unpacked parent commit)
to compare two versions in one run.
``--scan-split`` builds ``--root``'s ``csrc/scan_segments.cu`` when it is
the one-block walk (commit bde1c5d and before) with ``clock64()`` stamps
added around its three phases (staging a window, parse and fuse, thread 0's
walk) and prints each phase's SM cycles summed over the windows, on
urls.10K.snappy and the 16 MiB stream.  ``--stream-split`` does the same
for ``--root``'s ``csrc/decode_stream.cu`` when it is the one-block decoder
(commit cc6d3e5 and before): staging a window, thread 0's walk, the
literals, warp 0's copies and the flush.  ``--wide`` times only the block
decoder's rows past 32 KiB in ``--root``'s tree (``decode_wide_kernel`` at
commit 9452537 and before, ``csrc/decode_wide.cu`` after): rows of
urls.10K data at 49,152, 65,536, 70,000 and 131,072 B, one row and 64
rows, urls.10K.snappy's body as one row of 702,087 B and urls.10K x 24's
body as one row of 16,850,088 B, each launch (CUDA events), kernels alone
(torch.profiler) and a lone call, with ``decode_stream.cu``'s launch and
kernels on the two whole bodies, one JSON line a case (a tree that refuses
a width says so).  Imports nothing of the
JAX package.
Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
B, BS = 64, 32768


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the result as JSON to this file")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--root", default=str(ROOT),
                    help="import csnappy_tpu_torch from this tree (default: this checkout)")
    ap.add_argument("--scan-split", action="store_true",
                    help="the one-block scan's phases in --root, with clock64() stamps added")
    ap.add_argument("--stream-split", action="store_true",
                    help="the one-block stream decoder's phases in --root, with clock64() stamps")
    ap.add_argument("--wide", action="store_true",
                    help="only the block decoder's rows past 32 KiB in --root's tree")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, args.root)
    from csnappy_tpu_torch.models import pymodel, wire
    from csnappy_tpu_torch.ops import decode_fused, encode_fused
    from csnappy_tpu_torch.runtime import native
    from csnappy_tpu_torch.ops.primitives import PRIMITIVES
    from csnappy_tpu_torch.tools.movebench import primitive_inputs
    from csnappy_tpu_torch.tools.timing import device_profile

    dev = torch.device("cuda")
    urls = (ROOT / "tests" / "data" / "urls.10K").read_bytes()
    if args.wide:
        return _wide(torch, np, dev, pathlib.Path(args.root), urls)
    blocks = [urls[(i % 21) * BS : (i % 21 + 1) * BS] for i in range(B)]
    data = torch.zeros((B, BS), dtype=torch.uint8)
    for i, b in enumerate(blocks):
        data[i, : len(b)] = torch.frombuffer(bytearray(b), dtype=torch.uint8)
    data = data.to(dev)
    blens = torch.full((B,), BS, dtype=torch.int32, device=dev)
    frags = [pymodel.compress_fragment(b) for b in blocks[:21]]
    frags = [frags[i % 21] for i in range(B)]
    comp = torch.zeros((B, max(len(f) for f in frags)), dtype=torch.uint8)
    for i, f in enumerate(frags):
        comp[i, : len(f)] = torch.frombuffer(bytearray(f), dtype=torch.uint8)
    flat = comp.to(dev).reshape(-1)
    offs = torch.arange(B, device=dev, dtype=torch.int64) * comp.shape[1]
    lens = torch.tensor([len(f) for f in frags], dtype=torch.int32, device=dev)
    dlim = torch.full((B,), BS, dtype=torch.int32, device=dev)
    blens_np = blens.cpu().numpy()
    comp_dev, lens_np = comp.to(dev), lens.cpu().numpy()
    golden = (ROOT / "tests" / "data" / "urls.10K.snappy").read_bytes()
    body = golden[wire.varint_decode(golden)[1]:]
    _, soffs, _ = native.scan_segments(body, len(urls), BS)
    slens = np.diff(np.append(soffs, len(body)))
    sdl = np.minimum(BS, len(urls) - np.arange(len(soffs)) * BS)
    body_dev = torch.frombuffer(bytearray(body), dtype=torch.uint8).to(dev)
    calls = {
        "encode_blocks": lambda: encode_fused.encode_blocks(data, blens_np),
        "decode_blocks": lambda: decode_fused.decode_blocks(comp_dev, lens_np, BS),
        "decode_segments": lambda: decode_fused.decode_segments(body_dev, soffs, slens, sdl),
    }

    result = {f"{k} (one call)": device_profile(fn, args.reps) for k, fn in calls.items()}
    result["decode_blocks (the launch)"] = device_profile(lambda: decode_fused._launch(
        decode_fused.decode_blocks, flat, offs, lens, dlim, BS), args.reps)
    for name, arrays in primitive_inputs(B).items():
        on_card = [torch.from_numpy(a).to(dev) for a in arrays]
        result[name] = device_profile(lambda: PRIMITIVES[name].wrapper(*on_card), args.reps)
    from csnappy_tpu_torch.tools import movebench as mb

    for n in (32768, 1 << 24):
        tbl, idx = mb.inputs(n, dev)
        x = torch.from_numpy(np.random.default_rng(n).integers(0, 1 << 31, (n // 128, 128),
                                                                dtype=np.int32)).to(dev)
        result[f"gather_flat n={n}"] = device_profile(
            lambda tbl=tbl, idx=idx: mb.gather_flat(tbl, idx, 16, dev), args.reps)
        result[f"scan_max n={n}"] = device_profile(lambda x=x: mb.scan_max(x, dev), args.reps)
    result["primitives host split (us)"] = primitive_host_split(torch, dev)
    from csnappy_tpu_torch.ops import decode_ws

    big = urls * 24
    big_comp = encode_fused.compress_np(big, device=dev)
    bbody = big_comp[wire.varint_decode(big_comp)[1]:]
    never = b"\x00a" + b"\x01\x01" * ((len(bbody) - 2) // 2)   # odd and even chains never merge
    whole = {}
    for label, b, dst in (("urls.10K.snappy", body, len(urls)), ("16 MiB", bbody, len(big)),
                          ("never-merging 16 MiB", never, 1 + 2 * (len(never) - 2))):
        bd = torch.frombuffer(bytearray(b), dtype=torch.uint8).to(dev)
        nseg = -(-dst // BS)
        whole[f"scan_segments on {label}"] = (
            lambda bd=bd, nseg=nseg: decode_ws.scan_segments(bd, nseg + 1, dev), b, dst)
        if not label.startswith("never"):
            whole[f"decode_ws on {label}"] = (
                lambda bd=bd, dst=dst: decode_ws.decompress_noheader_ws(bd, dst, dev), b, dst)
            whole[f"host scan on {label}"] = (
                lambda b=b, dst=dst: native.scan_segments(b, dst, BS), b, dst)
    from csnappy_tpu_torch.ops import decode_stream

    unaligned = (ROOT / "tests" / "data" / "unaligned_uint64_test.snappy").read_bytes()
    for label, b, dst in (("urls.10K.snappy", body, len(urls)),
                          ("unaligned_uint64_test.snappy", unaligned[wire.varint_decode(unaligned)[1]:],
                           wire.varint_decode(unaligned)[0]), ("16 MiB", bbody, len(big))):
        bd = torch.frombuffer(bytearray(b), dtype=torch.uint8).to(dev)
        whole[f"decode_stream on {label}"] = (
            lambda bd=bd, dst=dst: decode_stream.decode_stream(bd, dst, dev), b, dst)
    for k, (fn, _, _) in whole.items():
        if not k.startswith("host"):
            result[f"{k} (one call)"] = device_profile(fn, args.reps)

    lone_ms = {k: _lone(torch, fn, 50) for k, fn in calls.items()}
    lone_ms.update({k: _lone(torch, fn, 10 if "16 MiB" in k else 50)
                    for k, (fn, _, _) in whole.items()})
    result["lone_ms"] = lone_ms
    if hasattr(decode_ws, "_carve"):
        result["decode_ws host split, urls.10K.snappy (us)"] = _ws_split(
            torch, decode_ws, decode_fused, body_dev, len(urls))
    if args.stream_split:
        result["one-block stream decoder split (SM cycles)"] = _stream_split(
            torch, pathlib.Path(args.root), dev,
            {"urls.10K.snappy": (body, len(urls)), "16 MiB": (bbody, len(big))})
    if args.scan_split:
        result["one-block scan split (SM cycles)"] = _scan_split(
            torch, pathlib.Path(args.root), dev, {"urls.10K.snappy": body, "16 MiB": bbody})
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    result["card"] = card
    print(f"tree {args.root}")
    for title, res in result.items():
        if title.startswith(("decode_ws host split", "one-block scan split", "one-block stream",
                             "primitives host split")):
            print(f"{title} ({card}): {res}")
            continue
        if title == "lone_ms":
            for k, ms in res.items():
                print(f"{k}, a lone call (host clock, synchronised; median of "
                      f"{10 if '16 MiB' in k else 50}; {card}): "
                      f"{ms:.4f} ms")
            continue
        if title == "card":
            continue
        batch = "B=64 x 32 KiB; " if " on " not in title and " n=" not in title else ""
        print(f"{title}  ({batch}{card}): CUDA events {res['event_ms']:.4f} ms, "
              f"kernels {res['device_ms']:.4f} ms")
        for k, ms in res["kernels"].items():
            print(f"  {ms:10.4f}  {k[:110]}")
        if not res["kernels"]:
            print("  no device time in the trace: not measured")
    print(json.dumps(result))
    _smoke_phases(torch, np, pathlib.Path(args.root), dev, card)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(result, indent=1))
    return 0


def _wide(torch, np, dev, root: pathlib.Path, urls: bytes) -> int:
    """``--wide``: the block decoder of ``root``'s tree on rows past 32 KiB,
    one JSON line a case (the rows ``chip_smoke.py`` phase 5 times)."""
    import inspect

    from csnappy_tpu_torch import api
    from csnappy_tpu_torch.models import pymodel, wire
    from csnappy_tpu_torch.ops import decode_fused
    from csnappy_tpu_torch.ops import decode_stream as ds
    from csnappy_tpu_torch.tools.timing import device_profile, smi, time_ms

    card = smi("name,power.limit")
    golden = (ROOT / "tests" / "data" / "urls.10K.snappy").read_bytes()
    long = urls * 2
    cases = []
    for width in (49152, 65536, 70000, 131072):
        rows = [b"".join(pymodel.compress_fragment(long[o + i : o + min(i + BS, width)])
                         for i in range(0, width, BS))
                for o in range(0, 64 * 9973, 9973)]
        cases += [(f"{width} B x 1", rows[:1], width), (f"{width} B x 64", rows, width)]
    big = api.compress(urls * 24)
    cases += [("urls.10K.snappy body as one row", [golden[wire.varint_decode(golden)[1]:]],
               len(urls)),
              ("urls.10K x 24 body as one row", [big[wire.varint_decode(big)[1]:]], 24 * len(urls))]
    takes_plan = "plan" in inspect.signature(decode_fused._launch).parameters
    for label, frags, width in cases:
        n = len(frags)
        comp = torch.zeros((n, max(len(f) for f in frags)), dtype=torch.uint8)
        for i, f in enumerate(frags):
            comp[i, : len(f)] = torch.frombuffer(bytearray(f), dtype=torch.uint8)
        lens = np.array([len(f) for f in frags], np.int32)
        rec = {"tree": str(root), "case": label, "B": n, "width": width, "card": card}
        try:
            want = decode_fused.decode_blocks(comp, lens, width, device="cpu")
        except ValueError as e:                     # a tree with a width ceiling
            rec["refused"] = str(e)
            print(json.dumps(rec), flush=True)
            continue
        cdev = comp.to(dev)
        args = (cdev.reshape(-1), torch.arange(n, device=dev, dtype=torch.int64) * comp.shape[1],
                torch.from_numpy(lens).to(dev), torch.full((n,), width, dtype=torch.int32,
                                                           device=dev))
        extra = {}
        if takes_plan and width > decode_fused.FAST_MAX:
            extra["plan"] = decode_fused.plan_on(dev, lens, [width] * n, width)
        got = decode_fused._launch(decode_fused.decode_blocks, *args, width, **extra)
        assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want)), label
        call = lambda: decode_fused.decode_blocks(cdev, lens, width)   # noqa: E731
        prof = device_profile(call, 10)
        rec.update(
            launch_ms=time_ms(lambda: decode_fused._launch(decode_fused.decode_blocks, *args,
                                                           width, **extra)),
            kernels_ms=sum(v for k, v in prof["kernels"].items()
                           if not k.startswith(("Memcpy", "Memset"))) or None,
            kernels=prof["kernels"], lone_ms=_lone(torch, call, 20))
        if label.endswith("body as one row"):      # decode_stream.cu on the same body
            bd = args[0]
            cap, limit = ds._limits(bd.numel(), width)
            dsp = device_profile(lambda: ds.decode_stream(bd, width, dev), 10)
            rec["decode_stream"] = {"launch_ms": time_ms(lambda: ds._launch(bd, cap, limit)),
                                    "kernels_ms": dsp["device_ms"] or None}
        print(json.dumps(rec), flush=True)
    return 0


def _lone(torch, fn, n: int) -> float:
    """Host milliseconds of one ``fn()`` alone, synchronised before and
    after: the upper median of ``n``."""
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def _smoke_phases(torch, np, root: pathlib.Path, dev, card: str) -> None:
    """Phases 10 and 11 of ``root``'s own ``chip_smoke.py`` (movebench's
    kernels and the primitives: each call beside its library call, the
    kernels alone, launch counts), which print their lines."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("smoke_of_root", root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    print(f"chip_smoke.py phases 10-11 of {root}", flush=True)
    smoke._movebench(torch, np, dev, card)
    smoke._primitives(torch, np, dev, card)


def _ws_split(torch, decode_ws, decode_fused, bdev, dst: int, n: int = 200) -> dict:
    """Host microseconds of each step of one ``decompress_noheader_ws`` call
    on card tensors (median of ``n``; the copies wait for the kernels)."""
    nseg = decode_ws.plan(bdev.numel(), dst)
    st = {}

    def carve():
        st["v"] = decode_ws._carve(
            bdev.device, (torch.int64, 4), (torch.int64, 3 + 2 * nseg), (torch.int64, nseg),
            (torch.int32, nseg + 1), (torch.int32, nseg), (torch.int32, nseg),
            decode_ws._work(bdev.numel()))

    def scan():
        meta, check, offs, seg, lens, dlims, work = st["v"]
        decode_ws._launch(bdev, seg, meta, work, (offs, lens, dlims, check[: 3 + nseg]), dst)

    def decode():
        meta, check, offs, seg, lens, dlims, _ = st["v"]
        ps = check[3 + nseg :].view(torch.int32)
        st["out"] = decode_fused._launch(decode_fused.decode_segments, bdev, offs, lens, dlims,
                                         decode_ws.SEG, outs=(ps[:nseg], ps[nseg:]))[0]

    steps = {"allocate and view": carve, "scan launch": scan, "decode launch": decode,
             "check copy (waits for both kernels)": lambda: st["v"][1].cpu(),
             "bytes copy": lambda: st["out"].reshape(-1)[:dst].cpu().numpy().tobytes(),
             "the whole call": lambda: decode_ws.decompress_noheader_ws(bdev, dst, bdev.device)}
    times = {k: [] for k in steps}
    for _ in range(n):
        torch.cuda.synchronize()
        for k, fn in steps.items():
            t0 = time.perf_counter()
            fn()
            times[k].append((time.perf_counter() - t0) * 1e6)
    return {k: round(statistics.median(v), 1) for k, v in times.items()}


def primitive_host_split(torch, dev, n: int = 2000, size: int = 32768) -> dict:
    """Host microseconds of each step of one ``primitives.table_gather`` call
    (a ``size``-entry table, ``size`` indices) and one ``movebench.scan_max``
    call (``size`` elements) on card tensors, as the imported tree's
    wrappers take them: each step alone ``n`` times on
    ``time.perf_counter_ns`` after a synchronise, then the whole call.
    Small inputs, so that the launches do not fill the card's queue.  The
    trees from a7e6e8b back enter a device context and build a Stream
    object; the later trees' wrappers take the path rule and launch on the
    raw stream, the scan with one allocation."""
    from csnappy_tpu_torch.ops import primitives as prim
    from csnappy_tpu_torch.tools import movebench as mb

    def us(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter_ns() - t0) / n / 1e3

    gen = torch.Generator().manual_seed(0)
    table = torch.randint(0, 1 << 16, (size,), dtype=torch.int32, generator=gen).to(dev)
    idx = torch.randint(-9, size + 9, (size,), dtype=torch.int32, generator=gen).to(dev)
    x = torch.randint(-(1 << 31), 1 << 31, (size // 128, 128), dtype=torch.int32,
                      generator=gen).to(dev)
    new = hasattr(prim, "lane_gather_mode")
    launch, check = prim._kernels()["lane_gather"]

    def ctx():
        with torch.cuda.device(dev):
            pass

    gather = {"device": (lambda: prim.card_device(None, table, idx)) if new
              else (lambda: prim.resolve_device(None)),
              "operand checks": (lambda: (prim.as_int32(table, dev, "table"),
                                          prim.as_int32(idx, dev, "idx"), prim.limb_mask(2)))
              if new else (lambda: (prim.refuse_card_tensors(dev, table, idx),
                                    prim.as_int32(table, dev, "table"),
                                    prim.as_int32(idx, dev, "idx"), prim.limb_mask(2))),
              "allocation": lambda: torch.empty_like(idx)}
    out = torch.empty_like(idx)
    if new:
        mode = prim.lane_gather_mode(1, size, size, table.data_ptr(), idx.data_ptr())
        gather["path rule"] = lambda: prim.lane_gather_mode(1, size, size, table.data_ptr(),
                                                            idx.data_ptr())
        gather["current card and stream"] = lambda: (torch._C._cuda_getDevice(),
                                                     prim._stream(dev.index))
        args = (table.data_ptr(), size, idx.data_ptr(), out.data_ptr(), 1, size, 0xFFFF, mode)
    else:
        gather["device context"] = ctx
        gather["stream"] = lambda: prim._stream(dev.index)
        args = (table.data_ptr(), size, idx.data_ptr(), out.data_ptr(), 1, size, 0xFFFF)
    gather["launch entry"] = lambda: check(launch(*args, prim._stream(dev.index)))
    gather["the whole call"] = lambda: prim.table_gather(table, idx)

    scan = {"device": (lambda: prim.card_device(None, x)) if new
            else (lambda: prim.resolve_device(None)),
            "operand checks": (lambda: prim.as_int32(x, dev, "x")) if new
            else (lambda: (prim.refuse_card_tensors(dev, x), prim.as_int32(x, dev, "x")))}
    if hasattr(mb, "scan_words"):
        slaunch, scheck = mb._scan_kernel()
        buf = torch.empty((mb.scan_words(x.numel()),), dtype=torch.int32, device=dev)
        scan["allocation"] = lambda: x.new_empty((mb.scan_words(x.numel()),))
        scan["current card and stream"] = gather["current card and stream"]
        scan["launch entry (memset and kernel)"] = lambda: scheck(
            slaunch(x.data_ptr(), buf.data_ptr(), x.numel(), prim._stream(dev.index)))
        scan["output view"] = lambda: buf.as_strided(x.shape, x.stride())
    else:
        slaunch, scheck, scratch_len = mb._scan_kernel()
        out2 = torch.empty_like(x)
        scratch = torch.empty((max(int(scratch_len(x.numel())), 1),), dtype=torch.int32,
                              device=dev)
        scan["allocation (output, scratch length, scratch)"] = lambda: (
            torch.empty_like(x), torch.empty((max(int(scratch_len(x.numel())), 1),),
                                             dtype=torch.int32, device=dev))
        scan["device context"] = ctx
        scan["Stream object"] = lambda: torch.cuda.current_stream(dev).cuda_stream
        scan["launch entry (three kernels)"] = lambda: scheck(
            slaunch(x.data_ptr(), out2.data_ptr(), x.numel(), scratch.data_ptr(),
                    prim._stream(dev.index)))
    scan["the whole call"] = lambda: mb.scan_max(x)
    res = {}
    for name, steps in (("table_gather", gather), ("scan_max", scan)):
        split = {k: round(us(fn), 2) for k, fn in steps.items()}
        split["the steps"] = round(sum(v for k, v in split.items() if k != "the whole call"), 2)
        res[name] = split
    return res


# where clock64() stamps go in the one-block scan's loop (bde1c5d)
_SPLIT_MARKS = (
    ("    const int64_t p0 = s_p;\n", "    const int64_t p0 = s_p;\n    const long long t0_ = clock64();\n"),
    ("bytes[i] = (p0 + i < slen) ? src[p0 + i] : 0;\n    __syncthreads();\n",
     "bytes[i] = (p0 + i < slen) ? src[p0 + i] : 0;\n    __syncthreads();\n"
     "    const long long t1_ = clock64();\n"),
    ("    if (threadIdx.x == 0) {\n      int64_t p = p0,",
     "    const long long t2_ = clock64();\n    if (threadIdx.x == 0) {\n      int64_t p = p0,"),
    ("      s_done = done;\n    }\n    __syncthreads();\n",
     "      s_done = done;\n    }\n    __syncthreads();\n    if (threadIdx.x == 0) {\n"
     "      g_split[0] += t1_ - t0_; g_split[1] += t2_ - t1_; g_split[2] += clock64() - t2_;\n"
     "      g_split[3] += 1;\n    }\n"),
    ("namespace {\n", "__device__ long long g_split[4];\nnamespace {\n"),
)
_SPLIT_READ = """
extern "C" int scan_split(long long* out, int reset) {
  if (reset) { long long z[4] = {0, 0, 0, 0}; return (int)cudaMemcpyToSymbol(g_split, z, sizeof z); }
  return (int)cudaMemcpyFromSymbol(out, g_split, 4 * sizeof(long long));
}
"""


def _scan_split(torch, root: pathlib.Path, dev, streams: dict) -> dict:
    """SM cycles of the one-block scan's phases (staging, parse and fuse,
    the walk; summed over its windows) and its window count, from ``root``'s
    ``scan_segments.cu`` with stamps added; one launch on each stream."""
    from csnappy_tpu_torch.ops import _build

    src = (root / "csnappy_tpu_torch" / "csrc" / "scan_segments.cu").read_text()
    for old, new in _SPLIT_MARKS:
        if src.count(old) != 1:
            return {"not measured": "not the one-block scan"}
        src = src.replace(old, new)
    out_dir = ROOT / "build" / "scan_split"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, so = out_dir / "scan_split.cu", out_dir / "libscan_split.so"
    cu.write_text(src + _SPLIT_READ)
    subprocess.run([_build.nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                    "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", str(so), str(cu)], check=True,
                   capture_output=True, timeout=600)
    lib = ctypes.CDLL(str(so))
    vp = ctypes.c_void_p
    lib.scan_segments_launch.argtypes = [vp, ctypes.c_longlong, vp, ctypes.c_int, vp, vp]
    lib.scan_split.argtypes = [vp, ctypes.c_int]
    res = {}
    for label, body in streams.items():
        bd = torch.frombuffer(bytearray(body), dtype=torch.uint8).to(dev)
        seg = torch.empty(4096, dtype=torch.int32, device=dev)
        meta = torch.empty(4, dtype=torch.int64, device=dev)
        split = (ctypes.c_longlong * 4)()
        assert lib.scan_split(split, 1) == 0
        stream = torch.cuda.current_stream(dev).cuda_stream
        assert lib.scan_segments_launch(bd.data_ptr(), bd.numel(), seg.data_ptr(), 4096,
                                        meta.data_ptr(), stream) == 0
        torch.cuda.synchronize()
        assert lib.scan_split(split, 0) == 0
        res[label] = dict(zip(("staging", "parse and fuse", "walk", "windows"), list(split)))
    return res


# where clock64() stamps go in the one-block stream decoder's loop (cc6d3e5)
_STREAM_MARKS = (
    ("    const int64_t ip0 = s_ip;\n",
     "    const int64_t ip0 = s_ip;\n    long long t0_ = clock64(), t1_ = 0, t2_ = 0, t3_ = 0, t4_ = 0;\n"),
    ("    __syncthreads();\n\n    if (threadIdx.x == 0) {\n      const uint8_t* w = win - ip0;",
     "    __syncthreads();\n    t1_ = clock64();\n\n    if (threadIdx.x == 0) {\n"
     "      const uint8_t* w = win - ip0;"),
    ("    __syncthreads();\n\n    const int nt = s_nt;",
     "    __syncthreads();\n    t2_ = t3_ = t4_ = clock64();\n\n    const int nt = s_nt;"),
    ("      __syncthreads();\n      if (warp == 0) {",
     "      __syncthreads();\n      t3_ = clock64();\n      if (warp == 0) {"),
    ("      __syncthreads();\n      const int64_t end = s_op;",
     "      __syncthreads();\n      t4_ = clock64();\n      const int64_t end = s_op;"),
    ("    __syncthreads();\n  }\n\n  if (threadIdx.x == 0) {\n    meta[0]",
     "    __syncthreads();\n    if (threadIdx.x == 0) {\n      const long long t5_ = clock64();\n"
     "      g_split[0] += t1_ - t0_; g_split[1] += t2_ - t1_;\n"
     "      if (s_solo) { g_split[2] += t5_ - t2_; } else {\n"
     "        g_split[2] += t3_ - t2_; g_split[3] += t4_ - t3_; g_split[4] += t5_ - t4_; }\n"
     "      g_split[5] += 1; g_split[6] += s_nt;\n    }\n  }\n\n  if (threadIdx.x == 0) {\n    meta[0]"),
    ("namespace {\n", "__device__ long long g_split[7];\nnamespace {\n"),
)
_STREAM_READ = """
extern "C" int stream_split(long long* out, int reset) {
  if (reset) { long long z[7] = {0, 0, 0, 0, 0, 0, 0}; return (int)cudaMemcpyToSymbol(g_split, z, sizeof z); }
  return (int)cudaMemcpyFromSymbol(out, g_split, 7 * sizeof(long long));
}
"""


def _stream_split(torch, root: pathlib.Path, dev, streams: dict) -> dict:
    """SM cycles of the one-block stream decoder's phases (staging, thread
    0's walk, the literals, warp 0's copies, the flush; summed over its
    rounds), its rounds and tags, from ``root``'s ``decode_stream.cu`` with
    stamps added; one launch on each (body, dst_len)."""
    from csnappy_tpu_torch.ops import _build

    src = (root / "csnappy_tpu_torch" / "csrc" / "decode_stream.cu").read_text()
    for old, new in _STREAM_MARKS:
        if src.count(old) != 1:
            return {"not measured": "not the one-block stream decoder"}
        src = src.replace(old, new)
    out_dir = ROOT / "build" / "stream_split"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, so = out_dir / "stream_split.cu", out_dir / "libstream_split.so"
    cu.write_text(src + _STREAM_READ)
    subprocess.run([_build.nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                    "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", str(so), str(cu)], check=True,
                   capture_output=True, timeout=600)
    lib = ctypes.CDLL(str(so))
    vp = ctypes.c_void_p
    lib.decode_stream_launch.argtypes = [vp, ctypes.c_longlong, vp, ctypes.c_longlong,
                                         ctypes.c_longlong, vp, vp]
    lib.stream_split.argtypes = [vp, ctypes.c_int]
    res = {}
    for label, (body, dst) in streams.items():
        bd = torch.frombuffer(bytearray(body), dtype=torch.uint8).to(dev)
        out = torch.empty(dst, dtype=torch.uint8, device=dev)
        meta = torch.empty(2, dtype=torch.int64, device=dev)
        split = (ctypes.c_longlong * 7)()
        assert lib.stream_split(split, 1) == 0
        stream = torch.cuda.current_stream(dev).cuda_stream
        assert lib.decode_stream_launch(bd.data_ptr(), bd.numel(), out.data_ptr(), dst,
                                        -(-dst // BS) * BS, meta.data_ptr(), stream) == 0
        torch.cuda.synchronize()
        assert lib.stream_split(split, 0) == 0 and meta.tolist() == [dst, 0], meta.tolist()
        res[label] = dict(zip(("staging", "walk", "literals", "copies", "flush", "rounds", "tags"),
                              list(split)))
    return res


if __name__ == "__main__":
    sys.exit(main())
