#!/usr/bin/env python3
"""Where the port's block codec spends its device time, on one CUDA card.

    python3 tools/torch_profile.py [--out FILE.json]

Runs the main path's batch (B=64 blocks of 32 KiB of urls.10K, block i =
``urls[(i % 21) * 32768 : ...]``, as bench.py and chip_smoke.py make it)
through ``encode_fused.encode_blocks`` and ``decode_fused.decode_blocks``
under ``torch.profiler`` after a warm-up, and prints for each the device
time per call of every kernel, copy and fill it ran, their sum, and the
call's CUDA-event time (the gap is device idle), with the card's name and
power limit.
Imports nothing of the JAX package.  Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
B, BS = 64, 32768


def _self_device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def profile(torch, fn, reps: int) -> dict:
    """Device time per call of each kernel (and copy or fill) ``fn`` runs,
    the sum of them, and the call's CUDA-event time (their gap is idle)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as prof

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = {}
    for evt in p.key_averages():
        us = _self_device_us(evt)
        if evt.device_type == DeviceType.CUDA and us > 0:
            rows[evt.key] = us / reps / 1e3
    rows = dict(sorted(rows.items(), key=lambda kv: -kv[1]))
    return {"event_ms": a.elapsed_time(b) / reps, "device_ms": sum(rows.values()),
            "kernels": rows}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the result as JSON to this file")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from csnappy_tpu_torch.models import pymodel
    from csnappy_tpu_torch.ops import decode_fused, encode_fused

    dev = torch.device("cuda")
    urls = (ROOT / "tests" / "data" / "urls.10K").read_bytes()
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
    ow = encode_fused.ocap(BS)

    result = {
        "encode_blocks (prep + kernel)": profile(torch, lambda: encode_fused._launch(
            data, blens, *encode_fused.prep(data, blens), ow), args.reps),
        "decode_blocks": profile(torch, lambda: decode_fused._launch(
            decode_fused.decode_blocks, flat, offs, lens, dlim, BS), args.reps),
    }
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    result["card"] = card
    for title, res in result.items():
        if title == "card":
            continue
        print(f"{title}  (B={B} x {BS} B; {card}): CUDA events {res['event_ms']:.4f} ms, "
              f"kernels {res['device_ms']:.4f} ms")
        for k, ms in res["kernels"].items():
            print(f"  {ms:10.4f}  {k[:110]}")
        if not res["kernels"]:
            print("  no device time in the trace: not measured")
    print(json.dumps(result))
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
