"""Memory hygiene harness: every CUDA kernel of the port in poisoned, guarded
memory, on seeded varied inputs, under a perturbed block schedule.

    python -m csnappy_tpu_torch.tools.hygiene [--seed S] [--seconds T]
        [--families decode,stream,scan,encode,primitives,movebench,kernel_lib,probes]
        [--repeat N] [--checked]
    python -m csnappy_tpu_torch.tools.hygiene campaign --minutes M [--out DIR]

A check that the kernels' ordinary tests cannot make.  Those run in
PyTorch's caching allocator, which hands a repeated call the block the last
identical call freed, already holding the right answer, so a byte that no
kernel writes reads right; and on a quiet card one batch draws its tickets
in one order.  Here:

* every tensor comes from the hygiene allocator (``csrc/hygiene.cu``,
  loaded through ``torch.cuda.memory.CUDAPluggableAllocator`` before any
  CUDA allocation of the process): its own ``cudaMalloc``, filled with the
  call's poison byte (0xA5 or 0x5A: a byte a kernel should write but does
  not reads wrong in one of the two), between guard regions that are
  checked after every call; a freed block stays quarantined until then;
* each case's expected answer comes once from the kernel's plain version on
  the CPU, and every call is held to it: every output byte, ``produced``,
  status, lengths and flags, within each wrapper's contract;
* every decoder case, the scan and the look-back scan also run behind the
  occupier (``hygiene_occupy``): 1, 33, 66 or 131 SMs held for 0.1-2 ms
  from a second, higher-priority stream once the call's inputs are on the
  card, and in half the calls a late wave (``hygiene_occupy_late``) whose
  blocks take SMs in the middle of the call as its blocks free them, so the
  call's blocks start staggered, on fewer SMs, and take their tickets in
  other orders (``schedule`` measures it, and how much of the segment pass
  ran while SMs were held);
* every call, its read-backs and its guard check run under a watchdog, a
  thread of its own: a call that has not finished by its host deadline
  prints ``{"hygiene_hang": ...}`` and the process exits 3, wherever the
  host waits for the card (an event, a copy inside a wrapper);
* ``--checked`` loads the chained decoders' checked builds
  (``decode_wide_checked``, ``decode_stream_checked``: device asserts of
  what their protocols rely on, and thread 0 of each block sleeping 0-16 us
  at random before its ticket, its reads of entries and flags and its
  publications; ``csrc/decode_chain.cuh``).

It prints one JSON line per kernel (``{"hygiene": kernel, "cases", "calls",
"occupied", "differed", "guard_violations", ...}``), then ``{"hygiene_summary":
...}``, and exits 1 on any difference or guard violation.  Nothing on the
main path imports this module or loads its library.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import functools
import itertools
import json
import os
import pathlib
import random
import subprocess
import sys
import threading
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..models import pymodel, wire
from ..ops import _build

DATA = pathlib.Path(__file__).resolve().parents[2] / "tests" / "data"
POISONS = (0xA5, 0x5A)
GUARDS = {0xA5: 0x3C, 0x5A: 0xC3}
OCCUPY_SMS = (1, 33, 66, 131)
# an occupier block's hold: long enough to outlast the wrappers' host work
# between the gate and their launch (small synchronous copies of lengths,
# limits and plans; the inputs are on the card before the occupier starts),
# so the call starts on the SMs left; 20-200 us holds ended before it
OCCUPY_NS = (100_000, 2_000_000)
LATE_NS = (20_000, 1_500_000)  # the late wave's delay: it lands in the middle of a call
SCHEDULE_HOLD = (1_000_000, 2_000_000)   # schedule()'s holds: past a 16 MiB row's chain pass
GATE_TIMEOUT_NS = 2_000_000
DEADLINE_S = 60.0              # a call's host deadline (the watchdog)
FAMILIES = ("decode", "stream", "scan", "encode", "primitives", "movebench", "kernel_lib", "probes")
# the kernels of the port, keyed as the JSON lines name them: (source, the
# TPU kernel's pallas_call it replaces)
KERNELS = {
    "decode_kernel": ("csrc/decode_blocks.cu", "csnappy_tpu/ops/decode_fused.py:714, :782"),
    "decode_wide": ("csrc/decode_wide.cu", "csnappy_tpu/ops/decode_fused.py:714, :782"),
    "encode_kernel": ("csrc/encode_blocks.cu", "csnappy_tpu/ops/encode_fused.py:602"),
    "scan_segments": ("csrc/scan_segments.cu", "csnappy_tpu/ops/decode_ws.py:268"),
    "decode_stream": ("csrc/decode_stream.cu", "csnappy_tpu/ops/decode_stream.py:531"),
    "primitives.lane_gather": ("csrc/primitives.cu", "csnappy_tpu/ops/primitives.py:94, :283, :328"),
    "primitives.scatter_or": ("csrc/primitives.cu", "csnappy_tpu/ops/primitives.py:132"),
    "primitives.compose_round": ("csrc/primitives.cu", "csnappy_tpu/ops/primitives.py:187"),
    "primitives.row_gather": ("csrc/primitives.cu", "csnappy_tpu/ops/primitives.py:231"),
    "movebench.gather": ("csrc/primitives.cu", "csnappy_tpu/tools/movebench.py:62"),
    "movebench.scan_kernel": ("csrc/movebench.cu", "csnappy_tpu/tools/movebench.py:92"),
    "kernel_lib.shift": ("csrc/kernel_lib.cu", "tests/test_kernel_lib.py:16"),
    "kernel_lib.scan": ("csrc/kernel_lib.cu", "tests/test_kernel_lib.py:16"),
    "kernel_lib.gather": ("csrc/kernel_lib.cu", "tests/test_kernel_lib.py:16, :137"),
    "kernel_lib.scatter": ("csrc/kernel_lib.cu", "tests/test_kernel_lib.py:16"),
    "probe": ("csrc/probe.cu", "tools/mosaic_probe.py, mosaic_probe2.py, mosaic_probe5.py"),
    "probe3": ("csrc/probe3.cu", "tools/mosaic_probe3.py, mosaic_probe3b.py, mosaic_probe3c.py"),
    "probe4": ("csrc/probe4.cu", "tools/mosaic_probe4.py, mosaic_probe6.py"),
}
DECODERS = ("decode_kernel", "decode_wide", "decode_stream", "scan_segments")


class Case(NamedTuple):
    """One input of one kernel wrapper."""
    kernel: str                 # the KERNELS key it drives
    name: str
    run: Callable               # run(dev) -> go: copies the inputs to the card; go() -> [tensors]
                                # calls the wrapper on them
    plain: Callable             # plain() -> [tensors]: the plain version on the CPU
    protocol: bool = False      # its blocks wait on each other: also behind the occupier
    rows: tuple = ()            # a decoder's (stream, limit) a row, for the oracle (CPU tests)


# ------------------------------------------------------------------ streams


@functools.cache
def _urls() -> bytes:
    return (DATA / "urls.10K").read_bytes()


@functools.cache
def _urls_frag(start: int, n: int) -> bytes:
    """urls.10K from byte ``start`` (cyclic), n <= 32768 bytes, as one fragment."""
    u = _urls()
    data = (u[start:] + u)[:n]
    return pymodel.compress_fragment(data)


def _urls_stream(rng: random.Random, n: int) -> bytes:
    """A valid stream of exactly n bytes: urls.10K as 32 KiB fragments from a
    random 32 KiB boundary (each fragment's copies stay inside it)."""
    nfr = len(_urls()) // 32768
    first = rng.randrange(nfr)
    out = bytearray()
    for i in range(n // 32768):
        out += _urls_frag(((first + i) % nfr) * 32768, 32768)
    if n % 32768:
        out += _urls_frag(((first + n // 32768) % nfr) * 32768, n % 32768)
    return bytes(out)


def _literal(rng: random.Random, n: int) -> bytes:
    out = bytearray()
    if n:
        wire.emit_literal(out, rng.randbytes(n))
    return bytes(out)


def _run(rng: random.Random, n: int) -> bytes:
    """An offset-1 run of n bytes (n >= 1): one literal byte, then COPY_2s of offset 1."""
    out = bytearray()
    wire.emit_literal(out, bytes([rng.randrange(256)]))
    left = n - 1
    while left:
        k = min(64, left)
        out += bytes([wire.TAG_COPY_2 | ((k - 1) << 2), 1, 0])
        left -= k
    return bytes(out)


def _copy(out: bytearray, off: int, length: int, kind: int) -> None:
    """A copy tag of ``kind`` (1, 2 or 4 byte offset field) of any offset."""
    if kind == 1:
        out += bytes([wire.TAG_COPY_1 | ((length - 4) << 2) | ((off >> 8) << 5), off & 0xFF])
    elif kind == 2:
        out += bytes([wire.TAG_COPY_2 | ((length - 1) << 2)]) + off.to_bytes(2, "little")
    else:
        out += bytes([wire.TAG_COPY_4 | ((length - 1) << 2)]) + off.to_bytes(4, "little")


def _synthetic(rng: random.Random, n: int, max_off: int = 1 << 31, done: int = 0) -> bytes:
    """A valid stream of exactly n bytes of random tags: literals of 1 to 300
    bytes (long headers too), COPY_1, COPY_2 and COPY_4 of offsets from 1
    to what was written (``done`` bytes precede it in its row), capped at
    ``max_off``; short offsets are common, so copies chain deep."""
    out = bytearray()
    op = 0
    while op < n:
        left = n - op
        have = min(op + done, max_off)
        if have == 0 or rng.random() < 0.3:
            k = min(left, rng.choice((1, 2, 3, rng.randrange(1, 61), rng.randrange(61, 301))))
            wire.emit_literal(out, rng.randbytes(k))
        else:
            off = rng.choice((1, 2, 3, 4, rng.randrange(1, 64), rng.randrange(1, have + 1)))
            off = min(off, have)
            k = min(left, rng.randrange(1, 65))
            kinds = [4] + ([2] if off < 65536 else []) + ([1] if off < 2048 and 4 <= k <= 11 else [])
            _copy(out, off, k, rng.choice(kinds))
        op += k
    return bytes(out)


def _far(rng: random.Random, n: int, done: int = 0) -> bytes:
    """A valid stream of exactly n bytes: a random literal of up to half the
    row, then COPY_4 reads of 1 to 64 bytes from anywhere written before."""
    lit = max(1, min(n, 200000) // 2)
    out = bytearray(_literal(rng, lit))
    op = lit
    while op < n:
        k = min(64, n - op)
        _copy(out, rng.randrange(1, op + done + 1), k, 4)
        op += k
    return bytes(out)


STREAM_KINDS = ("urls", "random", "run", "far", "synthetic", "longlit", "mixed")


def valid_stream(rng: random.Random, kind: str, n: int, max_off: int = 1 << 31,
                 done: int = 0) -> bytes:
    """A valid headerless stream of exactly n bytes of ``kind`` (its copies
    reach at most ``max_off`` back; ``done`` bytes precede it in its row)."""
    if n <= 0:
        return b""
    if kind == "urls":
        return _urls_stream(rng, n)
    if kind == "random":
        return _literal(rng, n)
    if kind == "run":
        return _run(rng, n)
    if kind == "far":
        return _far(rng, n, done) if max_off >= 1 << 31 else _synthetic(rng, n, max_off, done)
    if kind == "synthetic":
        return _synthetic(rng, min(n, 1 << 18), max_off, done) + \
            valid_stream(rng, "urls", n - min(n, 1 << 18), max_off)
    if kind == "longlit":                        # a literal of 40,000 to 100,000 bytes inside
        lit = min(n, rng.randrange(40000, 100001))
        a = rng.randrange(0, n - lit + 1)
        return (valid_stream(rng, "urls", a) + _literal(rng, lit)
                + valid_stream(rng, "run", n - a - lit))
    # mixed: urls, a long literal, random tags and an offset-1 run, back to back
    cuts = sorted(rng.randrange(0, n + 1) for _ in range(3))
    parts = ("urls", "longlit", "synthetic", "run")
    out, at = bytearray(), 0
    for part, end in zip(parts, cuts + [n]):
        out += valid_stream(rng, part, end - at, max_off, done + at)
        at = end
    return bytes(out)


EVENTS = (None, "bad-first", "bad-middle", "bad-last", "cut-first", "cut-middle", "cut-last",
          "zero-offset")


def event_stream(rng: random.Random, kind: str, n: int, event: str | None,
                 max_off: int = 1 << 31) -> bytes:
    """A stream of n bytes of ``kind`` with ``event`` at an output position in
    its first 32 KiB segment, a middle one or the last: a copy whose offset
    passes the bytes written (``bad``; ``zero-offset``: offset 0), then the
    rest of the row; or the input cut inside a literal (``cut``)."""
    if event is None or n < 2:
        return valid_stream(rng, kind, n, max_off)
    where = event.split("-")[-1]
    t = {"first": rng.randrange(0, min(n, 32768)), "middle": n // 2 + rng.randrange(-64, 65),
         "last": n - 1 - rng.randrange(0, min(n - 1, 200) + 1)}.get(where, rng.randrange(n))
    t = max(0, min(n - 1, t))
    head = valid_stream(rng, kind, t, max_off)
    bad = bytearray()
    if event.startswith("cut"):
        wire.emit_literal(bad, rng.randbytes(100))
        return head + bytes(bad[: rng.randrange(1, 60)])
    off = 0 if event == "zero-offset" else t + 1 + rng.randrange(0, 1000)
    _copy(bad, off, min(64, max(1, n - t)), 2 if off < 65536 else 4)
    return head + bytes(bad) + valid_stream(rng, "urls", max(0, n - t - 64), max_off)


def limit_for(rng: random.Random, n: int, how: str) -> int:
    """A row's limit for a stream of n bytes: exact, short (an overrun) or long."""
    if how == "short":
        return max(0, n - rng.randrange(1, min(n, 5000) + 1)) if n else 0
    if how == "long":
        return n + rng.randrange(1, 5001)
    return n


# ----------------------------------------------------------------- decoders


def _t(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))


def _bytes_on(b: bytes, dev) -> torch.Tensor:
    # not torch.frombuffer, which refuses an empty buffer (an empty body is a case)
    return torch.from_numpy(np.frombuffer(b, np.uint8).copy()).to(dev)


def _staged(fn, arrays, *rest, **kw) -> Callable:
    """A case's ``run`` for the wrapper ``fn(*arrays on the card, *rest, **kw)``."""
    def run(dev):
        on = [_t(a).to(dev) for a in arrays]
        return lambda: _tup(fn(*on, *rest, **kw))
    return run


def _pack(frags: list, pad: int = 0):
    P = max([len(f) for f in frags] + [1]) + pad
    comp = np.zeros((len(frags), P), np.uint8)
    for i, f in enumerate(frags):
        comp[i, : len(f)] = np.frombuffer(f, np.uint8)
    return comp, np.array([len(f) for f in frags], np.int64)


def _route(width: int) -> str:
    from ..ops import decode_fused

    return "decode_kernel" if width <= decode_fused.FAST_MAX else "decode_wide"


def blocks_case(name: str, frags: list, width: int, pad: int = 1) -> Case:
    """``decode_blocks`` over fragments zero-padded to an odd row pitch (rows
    at unaligned offsets) with block_out ``width``."""
    from ..ops import decode_fused

    comp, lens = _pack(frags, pad + (1 - (max([len(f) for f in frags] + [1]) + pad) % 2))

    def run(dev):
        src = _t(comp).to(dev)
        return lambda: list(decode_fused.decode_blocks(src, lens, width))

    return Case(_route(width), name, run,
                lambda: list(decode_fused.decode_blocks(comp, lens, width, device="cpu")),
                True, tuple((f, width) for f in frags))


def segments_case(name: str, frags: list, dlims: list, rng: random.Random,
                  on_card: bool = True, before=None) -> Case:
    """``decode_segments`` over fragments back to back in one body with 0 to
    15 random bytes between them (unaligned offsets), each at its limit;
    the body from a card tensor or from host bytes.  ``before``: a call made
    first, into the same pool (its outputs dropped)."""
    from ..ops import decode_fused

    body, offs = bytearray(), []
    for f in frags:
        body += rng.randbytes(rng.randrange(16))
        offs.append(len(body))
        body += f
    body = bytes(body)
    lens = [len(f) for f in frags]
    width = max(dlims)

    def run(dev):
        if before is not None:
            before(dev)
        src = _bytes_on(body, dev) if on_card else body
        return lambda: list(decode_fused.decode_segments(src, offs, lens, dlims))

    return Case(_route(width), name + ("" if on_card else " (from host bytes)"), run,
                lambda: list(decode_fused.decode_segments(body, offs, lens, dlims, device="cpu")),
                True, tuple(zip(frags, dlims)))


def empty_body_case() -> Case:
    """``decode_segments`` of one empty segment in an empty body from a card
    tensor at limit 0: seed 224's case #152 (B=1, width 7, a "long" row of
    0 bytes, no padding), which once failed to stage."""
    from ..ops import decode_fused

    def run(dev):
        src = _bytes_on(b"", dev)
        return lambda: list(decode_fused.decode_segments(src, [0], [0], [0]))

    return Case("decode_kernel", "an empty body from a card tensor", run,
                lambda: list(decode_fused.decode_segments(b"", [0], [0], [0], device="cpu")),
                True, ((b"", 0),))


WIDTHS = (1, 7, 64, 1000, 4096, 32767, 32768, 32769, 40000, 65536, 100003, 1 << 18, 1 << 20)


def _row(rng: random.Random, width: int):
    """A random row for a call of rows of ``width`` bytes: (stream, its
    decoded length, the limit it asks for)."""
    kind = rng.choice(STREAM_KINDS)
    event = rng.choice(EVENTS) if rng.random() < 0.4 else None
    how = rng.choice(("exact", "exact", "short", "long"))
    n = {"exact": width, "short": width + rng.randrange(1, 5001),
         "long": max(0, width - rng.randrange(1, min(width, 5000) + 1))}[how]
    return event_stream(rng, kind, n, event), n, f"{kind}/{event or 'ok'}/{how}"


def main_path_batch() -> tuple:
    """The main path's ``decode_segments`` batch of rows past 32 KiB (as
    ``chip_smoke.main_path_batch``): urls.10K.snappy's body (limit 702,087),
    urls.10K's first 32 KiB as one fragment (limit 32,768) and the first
    w256k row of ``wide.npz`` (limit 2^18), back to back: (rows, limits)."""
    golden = (DATA / "urls.10K.snappy").read_bytes()
    with np.load(DATA / "torch_ref" / "wide.npz") as z:
        w256 = z["w256k_comp"][0, : z["w256k_lens"][0]].tobytes()
    rows = [golden[wire.varint_decode(golden)[1]:], pymodel.compress_fragment(_urls()[:32768]), w256]
    return rows, [len(_urls()), 32768, 1 << 18]


def _dirty_pool(dev) -> None:
    """One ``encode_blocks`` call of urls.10K's first 64 x 32 KiB, dropped:
    the pool a main-path decode finds after the encoder ran."""
    from ..ops import encode_fused

    u = _urls()
    data = np.frombuffer((u * 3)[: 64 * 32768], np.uint8).reshape(64, 32768).copy()
    encode_fused.encode_blocks(_t(data).to(dev), [32768] * 64)


def decode_cases(seed: int, max_width: int = 1 << 20, big: int = 1 << 24, n: int = 200,
                 max_bytes: int = 8 << 20) -> list:
    """Cases of ``decode_blocks`` and ``decode_segments``: the fixed ones
    (the main path's wide batch first, in a pool dirtied by the encoder;
    one row of ``big`` bytes; a batch mixing widths; an empty body), then ``n`` seeded
    ones at widths up to ``max_width``, B from 1 to 64 (at most
    ``max_bytes`` of rows a call), every stream kind, event and limit."""
    rng = random.Random(seed)
    rows, dl = main_path_batch()
    out = [segments_case("main_path_batch after encode_blocks", rows, dl, rng, False,
                         before=_dirty_pool)]
    if big:
        s = valid_stream(rng, "urls", big)
        out.append(blocks_case(f"one row of {big} B", [s], big))
        out.append(segments_case(f"one row of {big} B, short limit", [s], [big - 4097], rng))
    mixed = [(valid_stream(rng, k, w), w) for k, w in
             (("urls", 70000), ("run", 4096), ("far", min(max_width, 1 << 18)), ("longlit", 100003),
              ("synthetic", 32768), ("random", 1))]
    out.append(segments_case("mixed widths", [f for f, _ in mixed], [w for _, w in mixed], rng))
    out.append(empty_body_case())
    widths = [w for w in WIDTHS if w <= max_width]
    for i in range(n):
        width = rng.choice(widths)
        cap = max(1, max_bytes // max(width, 1))
        B = min(rng.choice((1, 2, 3, 5, 17, 64)), cap)
        made = [_row(rng, width) for _ in range(B)]
        label = f"#{i} B={B} width={width} " + ",".join(sorted({m[2] for m in made}))
        if rng.random() < 0.5:
            out.append(blocks_case("blocks " + label, [m[0] for m in made], width,
                                   pad=rng.randrange(1, 32)))
        else:
            dl = [limit_for(rng, m[1], rng.choice(("exact", "short", "long"))) for m in made]
            out.append(segments_case("segments " + label, [m[0] for m in made], dl, rng,
                                     rng.random() < 0.5))
    return out


def stream_case(name: str, body: bytes, dst: int, oracle: bool = True) -> Case:
    """``decode_stream`` of one stream at limit ``dst``: out[:produced],
    produced and status (its contract says nothing past produced)."""
    from ..ops import decode_stream as ds

    def cut(r):
        out, prod, st = r
        return [out[: int(prod)].cpu(), prod.reshape(1).long().cpu(), st.reshape(1).long().cpu()]

    def run(dev):
        src = _bytes_on(body, dev)
        return lambda: cut(ds.decode_stream(src, dst))

    return Case("decode_stream", name, run,
                lambda: cut(ds.decode_stream(body, dst, device="cpu")), True,
                ((body, dst),) if oracle else ())


def _fixture_streams(name: str):
    with np.load(DATA / "torch_ref" / name) as z:
        lim = z["limits"] if "limits" in z.files else z["dst_len"][:, None]
        return [(str(z["names"][i]), z["body"][z["offs"][i] : z["offs"][i + 1]].tobytes(),
                 [int(x) for x in np.atleast_1d(lim[i])]) for i in range(len(z["names"]))]


def stream_cases(seed: int, max_width: int = 1 << 22, n: int = 100, fixtures: bool = True) -> list:
    """Cases of ``decode_stream``: the groups of ``streams.npz`` and
    ``stream_adv.npz`` at their limits, then ``n`` seeded crossing streams
    (copies up to 32,768 back) with events, at exact, short and
    multiple-of-32768 limits."""
    from ..ops import decode_stream as ds

    rng = random.Random(seed + 1)
    out = []
    if fixtures:
        for group in ("streams.npz", "stream_adv.npz"):
            for name, body, lims in _fixture_streams(group):
                out += [stream_case(f"{group} {name} @ {d}", body, d, False) for d in lims]
    widths = [w for w in (1, 100, 32768, 32769, 65536 + 7, 1 << 18, 1 << 20, 1 << 22) if w <= max_width]
    for i in range(n):
        w = rng.choice(widths)
        kind = rng.choice(("urls", "random", "run", "synthetic", "longlit", "mixed"))
        event = rng.choice(EVENTS) if rng.random() < 0.4 else None
        body = event_stream(rng, kind, w, event, ds.MAX_OFFSET)
        how = rng.choice(("exact", "short", "multiple"))
        d = w if how == "exact" else limit_for(rng, w, "short") if how == "short" else \
            max(32768, w // 32768 * 32768)
        out.append(stream_case(f"#{i} {kind}/{event or 'ok'}/{how} {w} B", body, d,
                               how != "multiple"))
    return out


def scan_cases(seed: int, n: int = 40, fixtures: bool = True) -> list:
    """Cases of the boundary scan (``scan_segments`` at nslot nseg + 1, 2 and
    1: seg and meta[:3]) and of ``decode_ws`` (bytes or None): the groups of
    ``streams.npz`` and ``scan_adv.npz``, then seeded streams."""
    from ..ops import decode_ws

    rng = random.Random(seed + 2)
    items = []
    if fixtures:
        for group in ("streams.npz", "scan_adv.npz"):
            items += [(f"{group} {nm}", b, lims[0]) for nm, b, lims in _fixture_streams(group)]
    for i in range(n):
        w = rng.choice((1, 8192, 32768, 65536, 100000, 1 << 20))
        kind = rng.choice(("urls", "urls", "run", "synthetic", "longlit"))
        event = rng.choice(EVENTS) if rng.random() < 0.3 else None
        items.append((f"#{i} {kind}/{event or 'ok'} {w} B", event_stream(rng, kind, w, event, 32768), w))
    out = []
    for name, body, d in items:
        nseg = d // 32768 + 1
        arr = np.frombuffer(body, np.uint8).copy()
        for nslot in (nseg + 1, 2, 1):
            out.append(Case("scan_segments", f"scan {name} nslot={nslot}",
                            _staged(lambda b, s: _scan(decode_ws.scan_segments(b, s)), [arr], nslot),
                            (lambda b, s: lambda: _scan(decode_ws.scan_segments(b, s, device="cpu")))(body, nslot),
                            True))
        out.append(Case("scan_segments", f"decode_ws {name}",
                        _staged(lambda b, d: _ws(decode_ws.decompress_noheader_ws(b, d)), [arr], d),
                        (lambda b, d: lambda: _ws(decode_ws.decompress_noheader_ws(b, d, device="cpu")))(body, d),
                        True))
    return out


def _scan(r):
    seg, meta = r
    return [seg, meta[:3]]


def _ws(r):
    return [torch.tensor([r is None]), torch.from_numpy(np.frombuffer(r or b"", np.uint8).copy())]


# ---------------------------------------------------------- encoder and the rest


def encode_rows(seed: int, bs: int, B: int) -> tuple[np.ndarray, np.ndarray, str]:
    """B rows of up to ``bs`` bytes (0 B to bs): urls.10K slices, random
    bytes, periodic rows and zeros: (data uint8[B, bs], lengths, kinds)."""
    rng = random.Random(seed)
    u = _urls()
    data = np.zeros((B, bs), np.uint8)
    lens = np.zeros(B, np.int64)
    kinds = []
    for i in range(B):
        n = rng.choice((0, 1, 4, 15, 16, 17, 100, bs // 2, bs - 1, bs, rng.randrange(bs + 1)))
        kind = rng.choice(("urls", "random", "periodic", "zeros"))
        if kind == "urls":
            a = rng.randrange(len(u) - n + 1)
            row = u[a : a + n]
        elif kind == "random":
            row = rng.randbytes(n)
        elif kind == "periodic":
            p = rng.choice((1, 2, 3, 7, 64, 300, 4099))
            unit = rng.randbytes(p)
            row = (unit * (n // p + 1))[:n]
        else:
            row = bytes(n)
        data[i, :n] = np.frombuffer(row, np.uint8)
        lens[i] = n
        kinds.append(kind)
    return data, lens, ",".join(sorted(set(kinds)))


def encode_cases(seed: int, n: int = 12) -> list:
    """``encode_blocks`` on rows of 0 B to 32 KiB at 4 KiB and 32 KiB widths:
    every stream byte (zero past each stream's length) and the lengths."""
    from ..ops import encode_fused

    rng = random.Random(seed + 3)
    out = []
    for i in range(n):
        bs = rng.choice((4096, 32768))
        B = rng.choice((1, 3, 17, 64))
        data, lens, kinds = encode_rows(seed * 1000 + i, bs, B)
        out.append(Case("encode_kernel", f"#{i} B={B} bs={bs} {kinds}",
                        _staged(encode_fused.encode_blocks, [data], lens),
                        (lambda d, l: lambda: list(encode_fused.encode_blocks(d, l, device="cpu")))(data, lens),
                        False, tuple(zip((data[j, : lens[j]].tobytes() for j in range(B)), lens.tolist()))))
    return out


def _tup(x):
    return list(x) if isinstance(x, (tuple, list)) else [x]


def primitive_cases(seed: int) -> list:
    """The six wrappers of ``ops/primitives.py`` on every case of
    ``primitives.npz`` and on one seeded case at the main path's shapes."""
    from ..ops import primitives as prim
    from .movebench import primitive_inputs

    out = []
    with np.load(DATA / "torch_ref" / "primitives.npz") as z:
        for case, fn, limbs in zip(z["cases"], z["fns"], z["limbs"]):
            case, fn, limbs = str(case), str(fn), int(limbs)
            args = [z[f"{case}__{a}"] for a in prim.PRIMITIVES[fn].args]
            kw = {"limbs": limbs} if limbs else {}
            out.append(_prim_case(prim, fn, f"primitives.npz {case}", args, kw))
    for fn, args in primitive_inputs(64, seed).items():
        out.append(_prim_case(prim, fn, f"seeded B=64 x 32 KiB ({seed})", list(args), {}))
    return out


def _prim_case(prim, fn: str, name: str, args: list, kw: dict) -> Case:
    p = prim.PRIMITIVES[fn]
    return Case(f"primitives.{p.entry}", f"{fn} {name}", _staged(p.wrapper, args, **kw),
                lambda: _tup(p.wrapper(*[_t(a) for a in args], **kw, device="cpu")))


def movebench_cases(seed: int) -> list:
    """``gather_flat`` and the one-pass ``scan_max`` (a decoupled look-back:
    also behind the occupier) on ``movebench.npz`` and seeded arrays at the
    scan's tile edges."""
    from . import movebench as mb

    out = []
    with np.load(DATA / "torch_ref" / "movebench.npz") as z:
        a = {k: z[k] for k in z.files}
    for r in (16, 64):
        for tbl, idx in ((f"tbl{r}", f"idx{r}"), (f"tbl{r}", f"idx_oob{r}"), (f"wide{r}", f"idx{r}")):
            out.append(_mb_case(mb.gather_flat, "movebench.gather", f"{tbl}[{idx}]", (a[tbl], a[idx])))
        out.append(_mb_case(mb.scan_max, "movebench.scan_kernel", f"scan{r}", (a[f"scan{r}"],), True))
    rng = np.random.default_rng(seed)
    for n in (1, mb.SCAN_TILE, mb.SCAN_TILE + 1, 3 * mb.SCAN_TILE - 5, (1 << 20) + 3):
        x = rng.integers(-(2**31), 2**31, n, dtype=np.int64).astype(np.int32)
        out.append(_mb_case(mb.scan_max, "movebench.scan_kernel", f"seeded n={n}", (x,), True))
    t = rng.integers(0, 2**31, 32768, dtype=np.int64).astype(np.int32)
    i = rng.integers(-7, 32768 + 7, 1 << 16, dtype=np.int64).astype(np.int32)
    out.append(_mb_case(mb.gather_flat, "movebench.gather", "seeded 32768 x 65536", (t, i)))
    return out


def _mb_case(fn, kernel: str, name: str, args: tuple, protocol: bool = False) -> Case:
    return Case(kernel, f"{fn.__name__} {name}", _staged(fn, args),
                lambda: _tup(fn(*[_t(a) for a in args], device="cpu")), protocol)


def kernel_lib_cases(seed: int) -> list:
    """Every helper of ``ops/kernel_lib.HELPERS`` on every case of
    ``kernel_lib.npz``, and every configuration of ``SHIFT_SCAN_RUNS`` on a
    seeded (2,048, 128) tile."""
    from ..ops import kernel_lib as kl

    out = []
    for case, helper, arrays, params, _ in kl.read_cases(DATA / "torch_ref" / "kernel_lib.npz"):
        out.append(Case(f"kernel_lib.{kl.HELPERS[helper].kind}", f"{helper} kernel_lib.npz {case}",
                        _staged(lambda *v, h=helper, names=tuple(arrays), p=params:
                                kl.call(h, dict(zip(names, v)), p), list(arrays.values())),
                        (lambda h, a, p: lambda: kl.call(h, {k: _t(v) for k, v in a.items()}, p, device="cpu"))(helper, arrays, params)))
    x = np.random.default_rng(seed).integers(-(2**31), 2**31, (2048, 128), dtype=np.int64).astype(np.int32)
    for helper, args, kw in kl.SHIFT_SCAN_RUNS:
        fn = kl.HELPERS[helper].wrapper
        out.append(Case(f"kernel_lib.{kl.HELPERS[helper].kind}", f"{helper}{args}{kw} (2048, 128)",
                        _staged(fn, [x], *args, **kw),
                        (lambda f, a, k: lambda: _tup(f(_t(x), *a, **k, device="cpu")))(fn, args, kw)))
    return out


def probe_cases(seed: int) -> list:
    """Every probe of ``tools/probe.PROBES`` with a kernel at its smallest K
    (0 and 1; the capacity probe at 256 rows), against its plain version."""
    from . import probe as pb

    out = []
    for name, pr in pb.PROBES.items():
        if pr.fails:
            continue
        d = pb.inputs(name, seed)
        t = pb.second_input(name, seed)
        for k in ((256,) if pr.entry == "smem_cap" else (0, 1)):
            out.append(Case(pr.lib, f"{name} K={k}",
                            _staged(lambda d, *t, n=name, k=k: pb.probe(n, k, d, *(t or (None,))),
                                    [d] + ([] if t is None else [t])),
                            (lambda n, k, d, t: lambda: [pb.probe(n, k, d, t, device="cpu")])(name, k, d, t)))
    return out


def cases(seed: int, families=FAMILIES, small: bool = False) -> dict[str, list]:
    """Every family's cases for ``seed`` (``small``: widths and counts cut
    for the CPU tests)."""
    make = {
        "decode": lambda: decode_cases(seed, 1 << 17, 0, 24, 1 << 19) if small else decode_cases(seed),
        "stream": lambda: stream_cases(seed, 1 << 17, 12, False) if small else stream_cases(seed),
        "scan": lambda: scan_cases(seed, 4, False) if small else scan_cases(seed),
        "encode": lambda: encode_cases(seed, 4 if small else 12),
        "primitives": lambda: primitive_cases(seed),
        "movebench": lambda: movebench_cases(seed),
        "kernel_lib": lambda: kernel_lib_cases(seed),
        "probes": lambda: probe_cases(seed),
    }
    return {f: make[f]() for f in families}


# ------------------------------------------------------------------- results


def same(got: list, want: list) -> bool:
    """Every output equal: dtype, shape and every element."""
    if len(got) != len(want):
        return False
    return all(g.dtype == w.dtype and tuple(g.shape) == tuple(w.shape) and torch.equal(g, w)
               for g, w in zip(got, want))


class Tally:
    """Counts of one kernel's runs."""

    def __init__(self):
        self.cases = self.calls = self.occupied = self.differed = self.guards = 0
        self.poisons: set[int] = set()
        self.first_bad: list[str] = []

    def add(self, case: Case, ok: bool, guards: int, occupied: bool, poison: int,
            sizes=()) -> None:
        """One call: whether it equalled the plain answer and its changed
        guard bytes (in blocks of ``sizes`` bytes)."""
        self.calls += 1
        self.occupied += occupied
        self.differed += 0 if ok else 1
        self.guards += guards
        self.poisons.add(poison)
        if (not ok or guards) and len(self.first_bad) < 5:
            self.first_bad.append(f"{case.name} (poison {poison:#04x}"
                                  f"{', occupied' if occupied else ''}"
                                  f"{f', guards of blocks of {list(sizes)} B' if guards else ''})")

    def line(self, kernel: str, checked: bool) -> dict:
        src, replaces = KERNELS[kernel]
        return {"hygiene": kernel, "source": src, "replaces": replaces, "cases": self.cases,
                "calls": self.calls, "occupied": self.occupied, "differed": self.differed,
                "guard_violations": self.guards,
                "poisons": [f"{p:#04x}" for p in sorted(self.poisons)], "checked": checked,
                "first_bad": self.first_bad}


def summary(lines: list[dict]) -> tuple[dict, int]:
    """The summary line of the per-kernel lines and the exit code: 0 when no
    call differed and no guard changed, else 1 (a hang ends the process with
    3 before any summary)."""
    tot = {k: sum(l[k] for l in lines) for k in ("cases", "calls", "occupied", "differed",
                                                  "guard_violations")}
    tot["decoder_calls"] = sum(l["calls"] for l in lines if l["hygiene"] in DECODERS)
    tot["decoder_occupied"] = sum(l["occupied"] for l in lines if l["hygiene"] in DECODERS)
    tot["kernels"] = len(lines)
    bad = tot["differed"] or tot["guard_violations"]
    return {"hygiene_summary": tot, "ok": not bad}, 1 if bad else 0


# ----------------------------------------------------------------- the card


@functools.cache
def _lib():
    lib = _build.load("hygiene")
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    lib.hygiene_set.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.hygiene_check.restype = ll
    lib.hygiene_violations.argtypes = [vp, ctypes.c_int]
    lib.hygiene_stats.argtypes = [vp]
    lib.hygiene_fill.argtypes = [vp, ll, ctypes.c_int, vp]
    lib.hygiene_occupy.argtypes = [ctypes.c_int, ctypes.c_uint, ll, ll, ll, vp, vp]
    lib.hygiene_occupy_late.argtypes = [ctypes.c_int, ll, ctypes.c_uint, ll, ll, vp]
    lib.hygiene_released.argtypes = [vp]
    lib.hygiene_error_string.restype = ctypes.c_char_p
    return lib


def _rc(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}: {_lib().hygiene_error_string(rc).decode()}")


def install_allocator() -> None:
    """Make the hygiene allocator this process's CUDA allocator.  Must run in
    a fresh process, before any CUDA allocation; raises without a card."""
    if not torch.cuda.is_available():
        raise RuntimeError("the hygiene allocator needs a CUDA card (torch.cuda.is_available() "
                           "is False); run the harness on the card")
    path = _build.build(("hygiene",))["hygiene"]
    alloc = torch.cuda.memory.CUDAPluggableAllocator(str(path), "hygiene_malloc", "hygiene_free")
    torch.cuda.memory.change_current_allocator(alloc)
    _lib()


def allocator_stats() -> dict:
    st = (ctypes.c_longlong * 5)()
    _lib().hygiene_stats(st)
    return dict(zip(("allocations", "bytes", "failed", "live", "quarantined"), st))


def use_checked() -> None:
    """Point this process's chained decoders at their checked builds
    (``_build.CHECKED``): their wrappers' binders return the checked
    library's launch, with the timed one's argument types."""
    from ..ops import decode_fused, decode_stream

    for mod, attr, name in ((decode_fused, "_wide_kernel", "decode_wide_checked"),
                            (decode_stream, "_kernel", "decode_stream_checked")):
        launch, check = _build.kernel(name)
        launch.argtypes = getattr(mod, attr)()[0].argtypes
        setattr(mod, attr, lambda bound=(launch, check): bound)


def poison_pool(byte: int, sizes=(), device=None) -> list[tuple[int, int]]:
    """Poison PyTorch's caching allocator (for checks that keep it, as
    ``chip_smoke.wide_repeats`` does): hold and free blocks of ``sizes``
    bytes (so the pool has room for a call of them), then fill every
    inactive block of the current stream's pool with ``byte`` on that
    stream.  Returns the poisoned (start, end) address ranges."""
    dev = torch.device(device or "cuda")
    held = [torch.empty((n,), dtype=torch.uint8, device=dev) for n in sizes]
    del held
    stream = torch.cuda.current_stream(dev).cuda_stream
    ranges = []
    for seg in torch.cuda.memory_snapshot():
        if seg.get("device", dev.index or 0) != (dev.index or 0) or \
                seg.get("stream", stream) != stream:
            continue
        at = seg["address"]
        for blk in seg["blocks"]:
            start = blk.get("address", at)
            if blk["state"] == "inactive":
                _rc(_lib().hygiene_fill(start, blk["size"], byte, stream), "hygiene_fill")
                ranges.append((start, start + blk["size"]))
            at = start + blk["size"]
    return ranges


def in_ranges(t: torch.Tensor, ranges) -> bool:
    """Whether all of ``t``'s bytes lie inside one of ``ranges``."""
    a = t.data_ptr()
    b = a + t.numel() * t.element_size()
    return any(lo <= a and b <= hi for lo, hi in ranges)


class Card:
    """Runs cases on the card: the poison, the occupier, the watchdog and the
    guard check around each call."""

    def __init__(self, seed: int, deadline: float = DEADLINE_S):
        self.dev = torch.device("cuda")
        self.rng = random.Random(seed ^ 0x5EED)
        self.deadline = deadline
        self._watched = None            # (what, monotonic deadline) of the call under way
        # the calls run on a stream of their own (none synchronises with
        # the occupier's, as the legacy default stream could)
        self.stream = torch.cuda.Stream()
        self.occ_stream = torch.cuda.Stream(priority=-1)
        self.late_stream = torch.cuda.Stream(priority=-1)
        threading.Thread(target=self._watchdog, daemon=True).start()

    def _watchdog(self) -> None:
        # a thread of its own, so a host blocked in any wait for the card
        # (CUDA calls release the GIL) is still ended at its deadline
        while True:
            time.sleep(0.05)
            w = self._watched
            if w is not None and time.monotonic() > w[1]:
                print(json.dumps({"hygiene_hang": w[0], "deadline_s": self.deadline}), flush=True)
                os._exit(3)

    @contextlib.contextmanager
    def watched(self, what: str):
        """Everything inside runs under the deadline: past it the process
        prints ``{"hygiene_hang": what}`` and exits 3."""
        self._watched = (what, time.monotonic() + self.deadline)
        try:
            with torch.cuda.stream(self.stream):
                yield
        finally:
            self._watched = None

    def _hold(self) -> tuple[int, int]:
        lo = self.rng.randrange(OCCUPY_NS[0], OCCUPY_NS[1] // 2)
        return lo, self.rng.randrange(lo + 1000, OCCUPY_NS[1] + 1)

    def occupy(self, nsm: int = 0, late: int = -1, delay: int = 0, hold=None) -> None:
        """Hold ``nsm`` SMs (drawn from ``OCCUPY_SMS`` if 0) before the call,
        then, if ``late`` (-1: drawn, one call in two), hold ``late`` SMs
        from ``delay`` ns after the launch (drawn from ``LATE_NS`` if 0).
        Each block holds its SM for a time in ``hold`` = [lo, hi) ns, drawn
        within ``OCCUPY_NS`` if None."""
        nsm = nsm or self.rng.choice(OCCUPY_SMS)
        _rc(_lib().hygiene_occupy(nsm, self.rng.getrandbits(32), *(hold or self._hold()),
                                  GATE_TIMEOUT_NS,
                                  self.occ_stream.cuda_stream,
                                  torch.cuda.current_stream().cuda_stream), "hygiene_occupy")
        if late < 0:
            late = self.rng.choice(OCCUPY_SMS) if self.rng.random() < 0.5 else 0
        if late:
            _rc(_lib().hygiene_occupy_late(late, delay or self.rng.randrange(*LATE_NS),
                                           self.rng.getrandbits(32), *(hold or self._hold()),
                                           self.late_stream.cuda_stream), "hygiene_occupy_late")

    def call(self, case: Case, poison: int, occupied: bool):
        """(outputs on the host, changed guard bytes, the sizes of the blocks
        whose guards changed).  The inputs reach the card before the
        occupier starts, so its hold falls on the call's kernels."""
        with self.watched(case.name):
            _lib().hygiene_set(poison, GUARDS[poison])
            go = case.run(self.dev)
            self.stream.synchronize()
            if occupied:
                self.occupy()
            got = [g.cpu() for g in go()]
            guards = int(_lib().hygiene_check())
        if guards < 0:
            raise RuntimeError(f"{case.name}: the card is in error after the call")
        sizes = ()
        if guards:
            buf = (ctypes.c_longlong * 16)()
            sizes = buf[: min(16, _lib().hygiene_violations(buf, 16))]
        return got, guards, sizes


def schedule(card: Card, seed: int, n: int = 1 << 24) -> dict:
    """What the occupier does to the wide decoder's blocks: one stamped
    ``decode_blocks`` call of an n-byte urls row (n / 32768 + 1 segments),
    quiet, behind each occupier size, and behind 1 and 66 SMs with a late
    wave of 132 blocks 0.3 ms after the gate, each equal to the quiet
    call's bytes.  The inputs, plan and stamps are on the card before the
    occupier starts; its blocks hold 1-2 ms (``SCHEDULE_HOLD``).  For each: the segments' flags published out of
    ticket order (adjacent inversions of their ``%globaltimer`` stamps),
    the span from the first flag to the last and the chunk chain's span
    (us), the call's host ms with the occupier's launch, and against the
    occupier's own stamps (``hygiene_released``: its first block's start,
    its first and last block's release), the segment flags published while
    every held SM was still held and while any was, and the time from the
    first flag to the last release (us; negative: all released first)."""
    from ..ops import decode_fused

    s = valid_stream(random.Random(seed), "urls", n)
    dev = card.dev
    args = (torch.frombuffer(bytearray(s), dtype=torch.uint8).to(dev),
            torch.zeros((1,), dtype=torch.int64, device=dev),
            torch.tensor([len(s)], dtype=torch.int32, device=dev),
            torch.tensor([n], dtype=torch.int32, device=dev))
    plan = decode_fused.plan_on(dev, np.array([len(s)]), np.array([n]), n)
    out, first = {}, None
    for nsm, late in ((0, 0),) + tuple((m, 0) for m in OCCUPY_SMS) + ((1, 132), (66, 132)):
        with card.watched(f"schedule, {nsm} SMs held"):
            st = torch.zeros((decode_fused.wide_stamp_count(*plan[1:]),), dtype=torch.int64, device=dev)
            card.stream.synchronize()
            t0 = time.perf_counter()
            if nsm:
                card.occupy(nsm, late, 300_000, SCHEDULE_HOLD)
            got = decode_fused._launch(decode_fused.decode_blocks, *args, n, st, plan=plan)
            card.stream.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            chunks, segs = decode_fused.split_wide_stamps(st, plan[1])
            card.occ_stream.synchronize()
            card.late_stream.synchronize()
            rel = (ctypes.c_longlong * 3)()
            _rc(_lib().hygiene_released(rel), "hygiene_released")
            if first is None:
                first = got[0].cpu()
            equal = bool(torch.equal(got[0].cpu(), first))
        ns = segs[:, 12]
        cns = chunks[chunks[:, 4] == 1, 7]
        row = {"segments": len(ns), "inversions": int((np.diff(ns) < 0).sum()),
               "flag_span_us": float(ns.max() - ns.min()) / 1e3,
               "chain_span_us": float(cns.max() - cns.min()) / 1e3, "call_ms": ms, "equal": equal}
        if nsm:
            _, lo, hi = rel
            row.update(flags_all_held=int((ns < lo).sum()), flags_any_held=int((ns < hi).sum()),
                       last_release_after_first_flag_us=float(hi - ns.min()) / 1e3)
        out[f"held_{nsm}" + (f"_late_{late}" if late else "")] = row
    return out


def run(seed: int, seconds: float, families=FAMILIES, repeat: int = 1, checked: bool = False,
        out=sys.stdout) -> int:
    """Run every family's cases for ``seed`` on the card, round-robin over
    the families, until ``seconds`` are spent (every family's first case
    runs whatever the budget); print the JSON lines; return the exit code."""
    install_allocator()
    if checked:
        use_checked()
    card = Card(seed)
    t0 = time.monotonic()
    by_family = cases(seed, families)
    tallies = {}
    for case in (c for group in itertools.zip_longest(*by_family.values()) for c in group if c):
        if time.monotonic() - t0 > seconds and case.kernel in tallies:
            continue                    # past the budget: only kernels not run yet
        want = case.plain()
        tally = tallies.setdefault(case.kernel, Tally())
        tally.cases += 1
        for poison in POISONS:
            for occupied in (False, True) if case.protocol else (False,):
                for _ in range(repeat if case.protocol else 1):
                    try:
                        got, guards, sizes = card.call(case, poison, occupied)
                    except Exception as e:           # a launch refused, a device assert
                        print(json.dumps({"hygiene_error": case.name, "kernel": case.kernel,
                                          "error": str(e)[:2000]}), flush=True)
                        os._exit(4)
                    tally.add(case, same(got, want), guards, occupied, poison, sizes)
    lines = [tallies[k].line(k, checked) for k in KERNELS if k in tallies]
    for line in lines:
        print(json.dumps(line), file=out, flush=True)
    summ, rc = summary(lines)
    if "decode" in families:
        sched = schedule(card, seed)
        print(json.dumps({"hygiene_schedule": sched}), file=out, flush=True)
        if not all(v["equal"] for v in sched.values()):
            summ["ok"], rc = False, 1
    summ["hygiene_summary"].update(seed=seed, seconds=round(time.monotonic() - t0, 1),
                                   repeat=repeat, checked=checked, allocator="hygiene",
                                   card=torch.cuda.get_device_name(0),
                                   allocator_stats=allocator_stats())
    print(json.dumps(summ), file=out, flush=True)
    return rc


CHECKED_EVERY = 4    # a campaign's passes on the checked builds: the first, then one in four
PASS_SECONDS = 240   # a campaign pass's budget (a seed's cases take 40-75 s on an H100)
PASS_REPEAT = 3      # a campaign pass's calls of each protocol case in each poison and schedule


def campaign(minutes: float, out_dir: pathlib.Path, first_seed: int = 1) -> int:
    """Passes of the harness in fresh processes (``--repeat PASS_REPEAT``),
    seed after seed, until ``minutes`` are spent; the first pass and one in
    ``CHECKED_EVERY`` after it load the checked builds (device asserts and
    a jittered schedule).  Every pass's lines go to
    ``out_dir/pass_<seed>.jsonl``; the totals are printed as one
    ``{"hygiene_campaign": ...}`` line.  Returns nonzero if any pass
    failed."""
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.monotonic()
    seed, rc_all, passes, tot = first_seed, 0, [], {}
    while time.monotonic() - t0 < minutes * 60:
        left = minutes * 60 - (time.monotonic() - t0)
        secs = max(30.0, min(PASS_SECONDS, left - 60))
        checked = (seed - first_seed) % CHECKED_EVERY == 0
        cmd = [sys.executable, "-m", "csnappy_tpu_torch.tools.hygiene", "--seed", str(seed),
               "--seconds", str(secs), "--repeat", str(PASS_REPEAT)] + (["--checked"] if checked else [])
        try:
            p = subprocess.run(cmd, capture_output=True, text=True, timeout=secs + 900)
            rc, text = p.returncode, p.stdout + p.stderr
        except subprocess.TimeoutExpired as e:     # the pass's own watchdog did not end it
            rc, text = "timeout", "".join(x.decode() if isinstance(x, bytes) else x or ""
                                          for x in (e.stdout, e.stderr))
        (out_dir / f"pass_{seed}.jsonl").write_text(text)
        summ = [json.loads(l) for l in text.splitlines() if l.startswith('{"hygiene_summary"')]
        rec = {"seed": seed, "rc": rc, "checked": checked}
        if summ:
            s = summ[-1]["hygiene_summary"]
            rec.update({k: s[k] for k in ("calls", "decoder_calls", "decoder_occupied", "differed",
                                          "guard_violations", "seconds")})
            for k in ("cases", "calls", "occupied", "decoder_calls", "decoder_occupied",
                      "differed", "guard_violations"):
                tot[k] = tot.get(k, 0) + s[k]
        else:
            rec["tail"] = text[-1500:]
        print(json.dumps({"hygiene_pass": rec}), flush=True)
        passes.append(rec)
        rc_all |= rc != 0
        seed += 1
    print(json.dumps({"hygiene_campaign": {**tot, "passes": len(passes),
                                           "checked_passes": sum(p["checked"] for p in passes),
                                           "failed_passes": sum(p["rc"] != 0 for p in passes),
                                           "minutes": round((time.monotonic() - t0) / 60, 2)}}),
          flush=True)
    return 1 if rc_all else 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ["campaign"]:
        ap = argparse.ArgumentParser(prog="hygiene campaign")
        ap.add_argument("--minutes", type=float, default=30)
        ap.add_argument("--out", default="build/hygiene")
        ap.add_argument("--seed", type=int, default=1)
        a = ap.parse_args(argv[1:])
        return campaign(a.minutes, pathlib.Path(a.out), a.seed)
    ap = argparse.ArgumentParser(prog="hygiene")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seconds", type=float, default=60)
    ap.add_argument("--families", default=",".join(FAMILIES))
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--checked", action="store_true")
    a = ap.parse_args(argv)
    fams = tuple(f for f in a.families.split(",") if f)
    unknown = set(fams) - set(FAMILIES)
    if unknown:
        raise SystemExit(f"unknown families {sorted(unknown)}; families: {', '.join(FAMILIES)}")
    return run(a.seed, a.seconds, fams, a.repeat, a.checked)


if __name__ == "__main__":
    sys.exit(main())
