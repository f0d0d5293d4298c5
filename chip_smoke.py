#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``csnappy_tpu_torch``) on one H100.

    python3 chip_smoke.py

Builds the port's kernels from the sources in this checkout, then, in order:

1. build   — every native source, one compiler each, all started together;
2. decode  — ``decode_blocks`` on B=64 blocks of urls.10K (32 KiB each, as
             bench.py makes them) and on malformed and error-priority
             vectors at four output limits; ``decode_segments`` on
             urls.10K.snappy's body.  Each kernel result must equal the plain
             version run on CPU copies: every output byte, ``produced`` and
             ``status`` (exact: bytes have no tolerance);
3. encode  — ``encode_blocks`` on the same B=64 x 32 KiB batch, equal byte
             for byte to the plain version, and ``compress_np(urls.10K)``
             byte-identical to the JAX package's stream (the committed
             fixture, 354,567 B);
4. main path — with every launch count set to 0, through the entry points a
             user calls (device=None, so the card): ``encode_blocks`` and
             ``decode_blocks`` on the B=64 batch from host arrays,
             ``api.compress(urls.10K)`` equal to the fixture,
             ``api.decompress(urls.10K.snappy)`` equal to urls.10K, a 32 KiB
             fragment and the unaligned vector round-trip; every kernel of
             the path must have launched;
5. times   — median of 20 CUDA-event-timed launches after warm-up for each
             kernel at the main path's shapes (inputs resident in L2), the
             plain version's time on the host, and the bound: the larger of
             the bytes the function must move over 3.35 TB/s and one
             operation per byte over 67 TOP/s (H100 SXM data sheet).  The
             serial chain (tags or commits of the longest block) is counted
             and printed beside it, with a design-floor estimate of its
             time from an assumed shared-memory load latency (printed only,
             never in the ``kernels`` line, which holds measured numbers);
6. the ``kernels`` JSON line, the card's name and power limit, and the
   result line.

Any failure raises and exits non-zero; with no card, or without the
package beside this script, it exits non-zero before printing a result.
"""
from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
DATA = ROOT / "tests" / "data"
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate (NVIDIA data sheet)
OPS_PER_S = 67e12             # H100 SXM 32-bit rate outside the tensor cores
SMEM_LOAD_CYCLES = 30         # dependent shared-memory load latency per chain step (assumed)
B, BS = 64, 32768             # the main path's batch: 64 blocks of 32 KiB


def _time_ms(torch, fn, n: int = 20, warm: int = 3) -> float:
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _host_ms(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def _tags(frag: bytes) -> tuple[int, int]:
    """(tags, copies) of a valid headerless stream."""
    ip = tags = copies = 0
    while ip < len(frag):
        tag = frag[ip]
        kind = tag & 3
        tags += 1
        if kind == 0:
            u = tag >> 2
            nb = max(0, u - 59)
            ln = int.from_bytes(frag[ip + 1 : ip + 1 + nb], "little") + 1 if nb else u + 1
            ip += 1 + nb + ln
        else:
            copies += 1
            ip += (2, 3, 5)[kind - 1]
    return tags, copies


def _smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def _same(name, got, want) -> int:
    """Hold a kernel's (out, produced, status) against the plain version's;
    returns the largest absolute byte difference (must be 0)."""
    out, prod, st = (t.cpu() for t in got)
    pout, pprod, pst = want
    if not (prod == pprod).all() or not (st == pst).all():
        bad = (prod != pprod) | (st != pst)
        raise AssertionError(f"{name}: produced/status differ at blocks "
                             f"{bad.nonzero().reshape(-1).tolist()[:10]}")
    err = int((out.int() - pout.int()).abs().max()) if out.numel() else 0
    if err:
        raise AssertionError(f"{name}: output bytes differ (max abs err {err})")
    return err


def _pack(torch, frags):
    arr = torch.zeros((len(frags), max(len(f) for f in frags)), dtype=torch.uint8)
    for i, f in enumerate(frags):
        arr[i, : len(f)] = torch.frombuffer(bytearray(f), dtype=torch.uint8)
    return arr, torch.tensor([len(f) for f in frags], dtype=torch.int32)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "csnappy_tpu_torch" / "__init__.py").exists():
        print("chip_smoke: csnappy_tpu_torch is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from csnappy_tpu_torch import api
    from csnappy_tpu_torch.models import pymodel, wire
    from csnappy_tpu_torch.ops import _build, decode_fused, encode_fused
    from csnappy_tpu_torch.runtime import native

    dev = torch.device("cuda")
    card = _smi("name,power.limit,clocks.max.sm")
    name_, power_, clock_ = (s.strip() for s in card.split(","))
    step_ns = SMEM_LOAD_CYCLES / (float(clock_.split()[0]) * 1e6) * 1e9
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; card: {card}", flush=True)

    # ------------------------------------------------------------ 1. build
    t0 = time.perf_counter()
    _build.build()
    print(f"[build] {time.perf_counter() - t0:.1f} s", flush=True)
    for name in _build.CUDA_NAMES:
        for line in _build.log_path(name).read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}", flush=True)

    urls = (DATA / "urls.10K").read_bytes()
    golden = (DATA / "urls.10K.snappy").read_bytes()
    fixture = (DATA / "torch_ref" / "urls.10K.jax.snappy").read_bytes()
    unaligned = (DATA / "unaligned_uint64_test.bin").read_bytes()
    baddata3 = (DATA / "baddata3.snappy").read_bytes()

    # ----------------------------------------------------------- 2. decode
    distinct = [urls[i * BS : (i + 1) * BS] for i in range(21)]
    frag_of = [pymodel.compress_fragment(b) for b in distinct]
    blocks = [distinct[i % 21] for i in range(B)]
    frags = [frag_of[i % 21] for i in range(B)]
    comp, lens = _pack(torch, frags)
    got = decode_fused.decode_blocks(comp.to(dev), lens, BS, device=dev)
    torch.cuda.synchronize()
    err_dec = _same("decode_blocks B=64", got, decode_fused.decode_blocks(
        comp, lens, BS, device="cpu"))
    for i, b in enumerate(blocks):
        assert int(got[1][i]) == len(b) and got[0][i, : len(b)].cpu().numpy().tobytes() == b
    tags = [_tags(f)[0] for f in frags]
    print(f"[decode] B=64 x 32 KiB equal to plain and to the source; tags/block max "
          f"{max(tags)} mean {sum(tags) / B:.0f}; compressed {int(lens.sum())} B", flush=True)

    rng = np.random.default_rng(7)
    prio = bytearray()                       # bad offset before the overrun point
    wire.emit_literal(prio, b"ab")
    prio += bytes([wire.TAG_COPY_1, 50])
    wire.emit_literal(prio, b"c" * 60)
    bad = [baddata3[wire.varint_decode(baddata3)[1]:], b"\xc4foooooo", bytes(prio),
           pymodel.compress_fragment(b"y" * 5000)[:-1]]   # overrun before the truncated end
    for _ in range(12):
        m = bytearray(frag_of[int(rng.integers(0, 21))])
        for _k in range(int(rng.integers(1, 6))):
            m[int(rng.integers(0, len(m)))] = int(rng.integers(0, 256))
        bad.append(bytes(m))
    mcomp, mlens = _pack(torch, bad)
    statuses = {}
    for cap in (0, 4, 4096, BS):
        g = decode_fused.decode_blocks(mcomp.to(dev), mlens, cap, device=dev)
        torch.cuda.synchronize()
        _same(f"decode_blocks malformed cap={cap}", g,
              decode_fused.decode_blocks(mcomp, mlens, cap, device="cpu"))
        statuses[cap] = g[2].cpu().tolist()
    assert statuses[4][2] == -5 and statuses[4096][3] == -3 and statuses[BS][1] == -5, statuses
    print(f"[decode] {len(bad)} malformed/priority vectors equal to plain at caps 0, 4, 4096, "
          f"32768; statuses at 32768: {statuses[BS]}", flush=True)

    body = golden[wire.varint_decode(golden)[1]:]
    rc, offs, produced = native.scan_segments(body, len(urls), BS)
    assert rc == 0 and produced == len(urls), (rc, produced)
    slens = np.diff(np.append(offs, len(body)))
    sdl = np.minimum(BS, len(urls) - np.arange(len(offs)) * BS)
    body_dev = torch.frombuffer(bytearray(body), dtype=torch.uint8).to(dev)
    gseg = decode_fused.decode_segments(body_dev, offs, slens, sdl, device=dev)
    torch.cuda.synchronize()
    err_seg = _same("decode_segments", gseg, decode_fused.decode_segments(
        body, offs, slens, sdl, device="cpu"))
    assert gseg[0].reshape(-1)[: len(urls)].cpu().numpy().tobytes() == urls
    seg_tags = [_tags(body[o : o + n])[0] for o, n in zip(offs, slens)]
    print(f"[decode] decode_segments over urls.10K.snappy ({len(offs)} segments) equal to "
          f"plain and to urls.10K; tags/segment max {max(seg_tags)}", flush=True)

    # ----------------------------------------------------------- 3. encode
    data = torch.zeros((B, BS), dtype=torch.uint8)
    for i, b in enumerate(blocks):
        data[i, : len(b)] = torch.frombuffer(bytearray(b), dtype=torch.uint8)
    blens = torch.full((B,), BS, dtype=torch.int32)
    ec, en = encode_fused.encode_blocks(data.to(dev), blens, device=dev)
    torch.cuda.synchronize()
    pc, pn = encode_fused.encode_blocks(data, blens, device="cpu")
    assert (en.cpu() == pn).all(), "encode lengths differ"
    err_enc = int((ec.cpu().int() - pc.int()).abs().max())
    assert err_enc == 0, f"encode bytes differ (max abs err {err_enc})"
    commits = [_tags(ec[i, : int(en[i])].cpu().numpy().tobytes())[1] for i in range(B)]
    stream = encode_fused.compress_np(urls, device=dev)
    assert stream == fixture, f"compress_np: {len(stream)} B, not the fixture's {len(fixture)} B"
    print(f"[encode] B=64 x 32 KiB equal to plain ({int(en.sum())} B); compress_np(urls.10K) "
          f"= {len(stream)} B, byte-identical to the JAX fixture; commits/block max "
          f"{max(commits)}", flush=True)

    # -------------------------------------------------------- 4. main path
    wrappers = {"decode_blocks": decode_fused.decode_blocks,
                "decode_segments": decode_fused.decode_segments,
                "encode_blocks": encode_fused.encode_blocks}
    for w in wrappers.values():
        w.launches = 0
    mc, ml = encode_fused.encode_blocks(data.numpy(), blens.numpy())
    assert torch.equal(mc.cpu(), pc) and torch.equal(ml.cpu(), pn)
    mo, mp, ms_ = decode_fused.decode_blocks(comp.numpy(), lens.numpy(), BS)
    assert (ms_.cpu() == 0).all() and torch.equal(mo.cpu(), got[0].cpu())
    assert api.compress(urls) == fixture
    assert api.decompress(golden) == urls
    assert api.decompress(fixture) == urls
    assert api.decompress_noheader(api.compress_fragment(urls[:BS]), BS) == urls[:BS]
    assert api.decompress(api.compress(unaligned)) == unaligned
    launches = {k: w.launches for k, w in wrappers.items()}
    assert all(n > 0 for n in launches.values()), launches
    print(f"[main] B=64 batch and api compress/decompress end to end on the card; "
          f"launches {launches}", flush=True)

    # ------------------------------------------------------------ 5. times
    flat = comp.to(dev).reshape(-1)
    offs_b = torch.arange(B, device=dev, dtype=torch.int64) * comp.shape[1]
    lens_b = lens.to(dev)
    dl_b = torch.full((B,), BS, dtype=torch.int32, device=dev)
    dec_ms = _time_ms(torch, lambda: decode_fused._launch(
        decode_fused.decode_blocks, flat, offs_b, lens_b, dl_b, BS))
    dec_plain = _host_ms(lambda: decode_fused.decode_blocks(comp, lens, BS, device="cpu"))
    offs_s = torch.as_tensor(offs, dtype=torch.int64, device=dev)
    lens_s = torch.as_tensor(slens, dtype=torch.int32, device=dev)
    dl_s = torch.as_tensor(sdl, dtype=torch.int32, device=dev)
    seg_ms = _time_ms(torch, lambda: decode_fused._launch(
        decode_fused.decode_segments, body_dev, offs_s, lens_s, dl_s, BS))
    seg_plain = _host_ms(lambda: decode_fused.decode_segments(body, offs, slens, sdl,
                                                              device="cpu"))
    data_dev, blens_dev = data.to(dev), blens.to(dev)
    in1, nc = encode_fused.prep(data_dev, blens_dev)
    ow = encode_fused.ocap(BS)
    kern_ms = _time_ms(torch, lambda: encode_fused._launch(data_dev, blens_dev, in1, nc, ow))
    prep_ms = _time_ms(torch, lambda: encode_fused.prep(data_dev, blens_dev))
    enc_ms = _time_ms(torch, lambda: encode_fused._launch(
        data_dev, blens_dev, *encode_fused.prep(data_dev, blens_dev), ow))
    enc_plain = _host_ms(lambda: encode_fused.encode_blocks(data, blens, device="cpu"))

    rows = []
    # bytes each function must move: every input tensor read once (per-block
    # offsets, lengths and limits included), every output tensor written once
    nseg = len(offs)
    for name, replaces, ms, plain_ms, nin, nout, steps, err in (
        ("decode_blocks", "csnappy_tpu/ops/decode_fused.py:714", dec_ms, dec_plain,
         int(lens.sum()) + 16 * B, B * BS + 8 * B, max(tags), err_dec),
        ("decode_segments", "csnappy_tpu/ops/decode_fused.py:782", seg_ms, seg_plain,
         len(body) + 16 * nseg, nseg * BS + 8 * nseg, max(seg_tags), err_seg),
        ("encode_blocks", "csnappy_tpu/ops/encode_fused.py:602", enc_ms, enc_plain,
         B * BS + 4 * B, B * ow + 8 * B, max(commits), err_enc),
    ):
        bytes_ms = (nin + nout) / HBM_BYTES_PER_S * 1e3
        ops_ms = (nin + nout) / OPS_PER_S * 1e3
        chain_ms = steps * step_ns * 1e-6
        src = "csnappy_tpu_torch/csrc/" + ("encode" if name == "encode_blocks" else "decode") \
            + "_blocks.cu"
        useful = B * BS if name != "decode_segments" else len(urls)   # uncompressed bytes
        row = {"name": name, "route": "cuda", "source": src, "replaces": replaces,
               "launches": launches[name], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
               "library_ms": None, "GBps": useful / (ms * 1e-3) / 1e9,
               "bytes": nin + nout, "chain_steps": steps}
        if name == "encode_blocks":
            row.update(kernel_ms=kern_ms, prep_ms=prep_ms)
        rows.append(row)
        print(f"[times] {name}: {ms:.4f} ms ({row['GBps']:.3f} GB/s of uncompressed bytes), "
              f"plain {plain_ms:.1f} ms (host CPU), bound {row['bound_ms']:.5f} ms by "
              f"{row['bound_by']} ({nin + nout} B), serial chain {steps} steps, design-floor "
              f"estimate {chain_ms:.4f} ms at an assumed {SMEM_LOAD_CYCLES} cycles a step"
              + (f"; kernel {kern_ms:.4f} ms + prep {prep_ms:.4f} ms"
                 if name == "encode_blocks" else ""), flush=True)
    print(f"[times] card {name_}, power limit {power_}, max SM clock {clock_}", flush=True)

    # ---------------------------------------------------------- 6. result
    print(json.dumps({"kernels": rows}), flush=True)
    print(_smi("name,power.limit"), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
