#!/usr/bin/env python3
"""Where the port's block codec and primitives spend their device time, on one CUDA card.

    python3 tools/torch_profile.py [--out FILE.json] [--root TREE]

Runs the main path's batch (B=64 blocks of 32 KiB of urls.10K, block i =
``urls[(i % 21) * 32768 : ...]``, as bench.py and chip_smoke.py make it)
through ``encode_fused.encode_blocks`` and ``decode_fused.decode_blocks``
(one call each on card tensors, as a user makes it, and the decoder's
launch alone), ``decode_fused.decode_segments`` over urls.10K.snappy's 22
segments (one call), and the six wrappers of ``ops/primitives.py`` on their
inputs at the same batch (``movebench.primitive_inputs(64)``, on the card)
under ``torch.profiler`` after a warm-up, and prints for each the device
time per call of every kernel, copy and fill it ran, their sum, and the
call's CUDA-event time (the gap is device idle), with the card's name and
power limit; then the host time of a lone call of each codec entry
(synchronised before and after, median of 50).  ``--root`` imports ``csnappy_tpu_torch`` from another tree
(an unpacked parent commit) to compare two versions in one run.
Imports nothing of the JAX package.  Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import json
import pathlib
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
    lone_ms = {}
    for k, fn in calls.items():
        lone = []
        for _ in range(50):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            lone.append((time.perf_counter() - t0) * 1e3)
        lone_ms[k] = sorted(lone)[len(lone) // 2]
    result["lone_ms"] = lone_ms
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    result["card"] = card
    print(f"tree {args.root}")
    for title, res in result.items():
        if title == "lone_ms":
            for k, ms in res.items():
                print(f"{k}, a lone call (host clock, synchronised; median of 50; {card}): "
                      f"{ms:.4f} ms")
            continue
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
