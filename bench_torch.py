#!/usr/bin/env python3
"""The port's bench line: ONE JSON line with the keys of ``bench.py``.

    python3 bench_torch.py [--full] [--reps N] [--device cpu]

The counterpart of ``bench.py`` for ``csnappy_tpu_torch`` on one card: the
same 15 keys (``KEYS``) with the same meanings, measured through the
port's kernels.  It imports torch, numpy and the port only.

* ``value`` — block decode GB/s (uncompressed bytes out a second) of
  ``decode_blocks.cu`` on B=64 blocks of 32 KiB: block i is urls.10K's
  slice i % 21, compressed by the oracle (``models/pymodel``), packed as
  uint8 rows.  The median of ``--reps`` launches on card tensors, each
  timed with CUDA events, after three warm-up ones, the output's
  allocation included (``tools/timing.time_ms``): the "ms" of PERF.md's
  kernel table, row 1.  ``vs_baseline`` divides by the reference C's
  645.5 MB/s; ``decode_GBps_by_batch`` adds B=16 and B=256 with ``--full``.
* ``hbm_traffic_MB_per_call`` — the bytes a B=64 launch must move: the
  compressed bytes and 16 B a block of offsets, lengths and limits in, the
  rows and 8 B a block of ``produced`` and ``status`` out (3,128,696 B);
  ``roofline_utilization_pct`` — those bytes a second over the H100's
  3.35 TB/s (null on the CPU).
* ``wholestream_decompress_GBps`` — a ``decode_ws.decompress_noheader_ws``
  call on urls.10K.snappy's body already on the card (the scan kernel, one
  ``decode_segments`` launch, the check and the bytes back to the host),
  CUDA events; ``wholestream_host_e2e_GBps`` — ``api.decompress_noheader``
  from host bytes to host bytes, the median of ``--reps`` host-clock calls.
* ``compress_GBps`` — ``encode_blocks.cu`` launched on urls.10K's 22
  blocks of 32 KiB (the last one short), CUDA events; ``compressed_bytes``
  — the varint header and the rows' lengths: 354,567, and the stream is
  the JAX package's byte for byte (``tests/data/torch_ref/urls.10K.jax.snappy``).
* ``device`` — the card's name and power limit as ``nvidia-smi
  --query-gpu=name,power.limit --format=csv,noheader`` prints them, or
  "cpu" with ``--device cpu``, which runs the kernels' plain versions.

Every output byte, length and status is checked, and a rate above 100x
the reference C's is refused: either raises before the line is printed,
and the run exits non-zero.  With no card and no ``--device cpu`` it raises.
Progress marks go to stderr.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import sys
import time

import numpy as np
import torch

from csnappy_tpu_torch import api
from csnappy_tpu_torch.config import resolve_device
from csnappy_tpu_torch.models import pymodel, wire
from csnappy_tpu_torch.ops import decode_fused, decode_ws, encode_fused
from csnappy_tpu_torch.tools.timing import HBM_BYTES_PER_S, card, time_ms

DATA_DIR = pathlib.Path(__file__).resolve().parent / "tests" / "data"
REF_DECOMPRESS_GBPS = 0.6455    # the reference C on urls.10K (userspace_benchmark.txt:101)
REF_COMPRESS_GBPS = 0.2401
REF_SIZE = 357267
BS = wire.BLOCK_SIZE
KEYS = ("metric", "value", "unit", "vs_baseline", "wholestream_decompress_GBps",
        "wholestream_host_e2e_GBps", "compress_GBps", "compress_vs_baseline",
        "compressed_bytes", "ref_compressed_bytes", "batch_blocks", "decode_GBps_by_batch",
        "hbm_traffic_MB_per_call", "roofline_utilization_pct", "device")


def _mark(msg, _t0=[None]):
    """Per-leg stderr timestamps so a timeout names the leg that took it."""
    if _t0[0] is None:
        _t0[0] = time.time()
    print(f"[bench_torch +{time.time() - _t0[0]:7.1f}s] {msg}", file=sys.stderr, flush=True)


def _device_s(fn, reps: int, dev: torch.device) -> float:
    """Median seconds of one ``fn()``: CUDA events on the card, the host
    clock on the CPU, after three warm-up calls."""
    return time_ms(fn, n=reps, device=dev) / 1e3


def _host_s(fn, reps: int) -> float:
    """Median host-clock seconds of one ``fn()`` that returns host bytes."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"bench_torch: {what}")


def _refuse(name: str, gbps: float, ref: float) -> None:
    """A timing harness that broke must fail the run, never publish."""
    if gbps > 100.0 * ref:
        raise RuntimeError(f"bench sanity: {name} {gbps:.3f} GB/s exceeds 100x the reference "
                           f"({ref} GB/s); timing harness broken, refusing to publish")


def _dec_inputs(data: bytes, B: int):
    """bench.py's batch: block i is the 32 KiB slice i % 21, compressed by
    the oracle; (blocks, uint8[B, P] rows, int32[B] lengths)."""
    distinct = [data[j * BS : (j + 1) * BS] or data[:BS] for j in range(min(B, 21))]
    frag_of = [pymodel.compress_fragment(b) for b in distinct]
    blocks = [distinct[i % 21] for i in range(B)]
    frags = [frag_of[i % 21] for i in range(B)]
    comp = np.zeros((B, max(len(f) for f in frags)), np.uint8)
    for i, f in enumerate(frags):
        comp[i, : len(f)] = np.frombuffer(f, np.uint8)
    return blocks, comp, np.array([len(f) for f in frags], np.int32)


def bench_block_decode(data: bytes, B: int, reps: int, dev: torch.device):
    """(GB/s, seconds a launch, bytes a launch must move) at B blocks."""
    blocks, comp, lens = _dec_inputs(data, B)
    comp_t = torch.from_numpy(comp).to(dev)
    out, prod, status = (t.cpu().numpy() for t in decode_fused.decode_blocks(comp_t, lens, BS,
                                                                              device=dev))
    for i, b in enumerate(blocks):
        _require(status[i] == 0 and prod[i] == len(b) and out[i, : len(b)].tobytes() == b,
                 f"decode B={B}: block {i} differs from its source")
    if dev.type == "cuda":          # the launch alone, its operands on the card
        args = (comp_t.reshape(-1), torch.arange(B, dtype=torch.int64, device=dev) * comp.shape[1],
                torch.from_numpy(lens).to(dev), torch.full((B,), BS, dtype=torch.int32, device=dev))
        t = _device_s(lambda: decode_fused._launch(decode_fused.decode_blocks, *args, BS), reps,
                      dev)
    else:
        t = _device_s(lambda: decode_fused.decode_blocks(comp_t, lens, BS, device=dev), reps, dev)
    traffic = int(lens.sum()) + 16 * B + B * BS + 8 * B
    return sum(len(b) for b in blocks) / t / 1e9, t, traffic


def bench_whole_stream(data: bytes, golden: bytes, reps: int, dev: torch.device):
    """(decode_ws GB/s on the card-resident body, host-to-host GB/s of the API)."""
    ulen, hdr = wire.varint_decode(golden)
    body = golden[hdr:]
    body_t = torch.frombuffer(bytearray(body), dtype=torch.uint8).to(dev)
    _require(decode_ws.decompress_noheader_ws(body_t, ulen, dev) == data,
             "decode_ws: the whole stream differs from urls.10K")
    t_ws = _device_s(lambda: decode_ws.decompress_noheader_ws(body_t, ulen, dev), reps, dev)
    _require(api.decompress_noheader(body, ulen, device=dev) == data,
             "api.decompress_noheader: the whole stream differs from urls.10K")
    t_host = _host_s(lambda: api.decompress_noheader(body, ulen, device=dev), reps)
    return ulen / t_ws / 1e9, ulen / t_host / 1e9


def bench_compress(data: bytes, fixture: bytes, reps: int, dev: torch.device):
    """(GB/s, compressed bytes) of urls.10K's blocks of 32 KiB, the last one short."""
    n = len(data)
    nb = (n + BS - 1) // BS
    pages = np.zeros((nb, BS), np.uint8)
    pages.reshape(-1)[:n] = np.frombuffer(data, np.uint8)
    blens = np.full((nb,), BS, np.int32)
    blens[-1] = n - (nb - 1) * BS
    pages_t = torch.from_numpy(pages).to(dev)
    comp, clens = (t.cpu().numpy() for t in encode_fused.encode_blocks(pages_t, blens, device=dev))
    stream = wire.varint_encode(n) + b"".join(comp[i, : clens[i]].tobytes() for i in range(nb))
    _require(stream == fixture,
             f"compress: {len(stream)} B, not the JAX package's {len(fixture)}-byte stream")
    _require(pymodel.decompress(stream) == data, "compress: the stream does not decode to urls.10K")
    if dev.type == "cuda":          # the launch alone, its operands on the card
        blens_t = torch.from_numpy(blens).to(dev)
        ow, cap = encode_fused.ocap(BS), encode_fused.walk_cap(BS)
        t = _device_s(lambda: encode_fused._launch(pages_t, blens_t, BS, ow, cap), reps, dev)
    else:
        t = _device_s(lambda: encode_fused.encode_blocks(pages_t, blens, device=dev), reps, dev)
    return n / t / 1e9, len(stream)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--full", action="store_true", help="add the B=16 and B=256 decode rows")
    ap.add_argument("--reps", type=int, default=20, help="timed calls of each figure")
    ap.add_argument("--device", default=None, help="default: the card; cpu = plain versions")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    _require(args.reps >= 1, "--reps must be at least 1")
    _mark(f"start on {dev}")
    data = (DATA_DIR / "urls.10K").read_bytes()
    golden = (DATA_DIR / "urls.10K.snappy").read_bytes()
    fixture = (DATA_DIR / "torch_ref" / "urls.10K.jax.snappy").read_bytes()

    scaling = {}
    for B in (16, 64, 256) if args.full else (64,):
        gbps, t, traffic = bench_block_decode(data, B, args.reps, dev)
        _refuse(f"decode B={B}", gbps, REF_DECOMPRESS_GBPS)
        _mark(f"decode B={B}: {gbps:.4f} GB/s")
        scaling[B] = round(gbps, 4)
        if B == 64:
            dec_gbps, t_dec, dec_traffic = gbps, t, traffic
    util = 100.0 * dec_traffic / t_dec / HBM_BYTES_PER_S if dev.type == "cuda" else None

    ws_gbps, host_gbps = bench_whole_stream(data, golden, args.reps, dev)
    _refuse("wholestream", ws_gbps, REF_DECOMPRESS_GBPS)
    _refuse("wholestream host e2e", host_gbps, REF_DECOMPRESS_GBPS)
    _mark(f"wholestream: {ws_gbps:.4f} GB/s, host e2e {host_gbps:.4f} GB/s")

    enc_gbps, comp_size = bench_compress(data, fixture, args.reps, dev)
    _refuse("compress", enc_gbps, REF_COMPRESS_GBPS)
    _mark(f"compress: {enc_gbps:.4f} GB/s")

    result = {
        "metric": "block_decompress_GBps_per_chip",
        "value": round(dec_gbps, 4),
        "unit": "GB/s",
        "vs_baseline": round(dec_gbps / REF_DECOMPRESS_GBPS, 3),
        "wholestream_decompress_GBps": round(ws_gbps, 4),
        "wholestream_host_e2e_GBps": round(host_gbps, 4),
        "compress_GBps": round(enc_gbps, 4),
        "compress_vs_baseline": round(enc_gbps / REF_COMPRESS_GBPS, 3),
        "compressed_bytes": comp_size,
        "ref_compressed_bytes": REF_SIZE,
        "batch_blocks": 64,
        "decode_GBps_by_batch": scaling,
        "hbm_traffic_MB_per_call": round(dec_traffic / 1e6, 2),
        "roofline_utilization_pct": None if util is None else round(util, 2),
        "device": card(dev),
    }
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
