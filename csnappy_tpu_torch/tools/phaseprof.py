"""Per-phase profile of the fused decode and encode kernels on the card;
port of ``csnappy_tpu/tools/phaseprof.py`` with its row format.

The JAX tool cut each fused kernel's pipeline short with a static
``phases`` knob, slope-timed each prefix and took the differences.  The
port's kernels have no such knob, and none is added: given a ``stamps``
tensor, each kernel writes its blocks' SM clock (``clock64()``) at its
phase boundaries (``decode_fused._launch(..., stamps)``,
``encode_fused._launch(..., stamps)``), so one stamped launch gives every
phase at once and the stamps take the place of the prefix slopes.

A row is a phase of the slowest block (the most cycles over all phases),
in kernel order: ``delta_ms`` its cycles at the card's maximum SM clock
(``nvidia-smi clocks.max.sm``), ``cum_ms`` the phases up to it, ``cycles``
and, beside them, the median block's ``median_cycles``.  The last phase
row also carries the slowest block's index and, for decode, its counts
(``windows``, ``tags``, ``rounds``).  The final row is the rate of an
unstamped launch timed with CUDA events (``GBps_full`` for decode,
``MBps_full`` for encode) with the card's name and power limit.

The shapes are the JAX tool's: decode on B=32 blocks of 32 KiB of the data
compressed by the oracle (blocks past its end repeat its first), encode on
its blocks of 32 KiB (the last one short; the JAX tool padded the batch to
a multiple of 8, a TPU shape policy).

``wide`` profiles the kernels of rows past 32 KiB (``csrc/decode_wide.cu``)
on the data's whole compressed body as one row: each kernel's rows, the
slowest chunk's and the slowest segment's, with the chains' spans.

Run:  python -m csnappy_tpu_torch.tools.phaseprof [decode|encode|wide] [data_file]

The stamps exist only in the kernels, so it runs on the card and raises
with none.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np
import torch

from ..config import resolve_device
from ..models import pymodel, wire
from ..ops import decode_fused, encode_fused
from .timing import card, sm_clock_mhz, time_ms

BS = wire.BLOCK_SIZE
DECODE_BATCH = 32            # the JAX tool's B


def summary(cycles: np.ndarray, names, counts: dict | None = None) -> dict:
    """The slowest block of ``cycles`` (int[B, len(names)], each phase's SM
    cycles a block): its index, its cycles in all, each phase's cycles
    beside the median block's, and each of ``counts`` ({name: int[B]}) at it."""
    tot = cycles.sum(1)
    slow = int(np.argmax(tot))
    out = {"slowest_block": slow, "cycles": int(tot[slow]),
           "phases": {n: [int(cycles[slow, i]), int(np.median(cycles[:, i]))]
                      for i, n in enumerate(names)}}
    out.update({k: int(v[slow]) for k, v in (counts or {}).items()})
    return out


def decode_summary(stamps: np.ndarray) -> dict:
    """:func:`summary` of ``decode_kernel``'s stamps (int64[B, STAMPS]: each
    phase's cycles, then ``decode_fused.COUNTS``)."""
    names = decode_fused.PHASES
    counts = dict(zip(decode_fused.COUNTS, stamps[:, -len(decode_fused.COUNTS):].T))
    return summary(stamps[:, : len(names)], names, counts)


def wide_summary(chain: np.ndarray, seg: np.ndarray) -> dict:
    """:func:`summary` of each wide kernel's stamps
    (``decode_fused.split_wide_stamps``: a chunk's
    ``WIDE_CHAIN_STAMPS``, a segment's ``WIDE_SEG_STAMPS``, phases first),
    by kernel, with their counts at the slowest block and the chains' spans:
    the ns from the first chunk's exit to the last's, and from the first
    segment's flag to the last's (``%globaltimer``)."""
    out = {}
    for kernel, st, names, nph in (("wide_chain_kernel", chain, decode_fused.WIDE_CHAIN_STAMPS, 4),
                                   ("wide_segment_kernel", seg, decode_fused.WIDE_SEG_STAMPS, 8)):
        counts = dict(zip(names[nph:-1], st[:, nph:-1].T))
        out[kernel] = summary(st[:, :nph], names[:nph], counts)
        ns = st[:, -1][st[:, -1] > 0]
        out[kernel]["span_ns"] = int(ns.max() - ns.min()) if ns.size else 0
    return out


def encode_summary(stamps: np.ndarray) -> dict:
    """:func:`summary` of ``encode_blocks.cu``'s stamps (int64[B, STAMPS]: the
    SM clock at a block's start, then after each of ``encode_fused.PHASES``)."""
    clk = stamps[:, : len(encode_fused.PHASES) + 1]
    return summary(np.diff(clk, axis=1), encode_fused.PHASES)


def rows(s: dict, mhz: float) -> list[dict]:
    """The JSON rows of a :func:`summary`, one a phase, at ``mhz``."""
    out, cum = [], 0.0
    for name, (cyc, med) in s["phases"].items():
        delta = cyc / (mhz * 1e3)
        cum += delta
        out.append({"phase": name, "cum_ms": cum, "delta_ms": delta, "cycles": cyc,
                    "median_cycles": med})
    out[-1].update({k: v for k, v in s.items() if k not in ("cycles", "phases")})
    return out


def decode_rows(stamps: np.ndarray, mhz: float) -> list[dict]:
    """The phase rows of one stamped ``decode_kernel`` launch."""
    return rows(decode_summary(stamps), mhz)


def wide_rows(chain: np.ndarray, seg: np.ndarray, mhz: float) -> list[dict]:
    """The phase rows of one stamped wide call, each with its ``kernel``."""
    return [dict(r, kernel=k) for k, s in wide_summary(chain, seg).items() for r in rows(s, mhz)]


def encode_rows(stamps: np.ndarray, mhz: float) -> list[dict]:
    """The phase rows of one stamped ``encode_kernel`` launch."""
    return rows(encode_summary(stamps), mhz)


def stamped_decode(wrapper, args, width: int):
    """One stamped launch of ``decode_kernel`` on ``args`` (the card's flat
    source, offsets, lengths and limits, as ``decode_fused._launch`` takes
    them): its result and the stamps (int64[B, STAMPS], on the host)."""
    st = torch.zeros((args[1].numel(), decode_fused.STAMPS), dtype=torch.int64,
                     device=args[0].device)
    got = decode_fused._launch(wrapper, *args, width, st)
    return got, st.cpu().numpy()


def stamped_wide(wrapper, args, width: int):
    """One stamped call of the wide kernels on ``args`` (as
    :func:`stamped_decode`, rows wider than ``decode_fused.FAST_MAX``): its
    result and the stamps (chunks int64[nchunks, 8], segments
    int64[nseg, 13], on the host)."""
    dev = args[0].device
    plan = decode_fused.plan_on(dev, args[2].cpu().numpy(), args[3].cpu().numpy(), width)
    st = torch.zeros((decode_fused.wide_stamp_count(*plan[1:]),), dtype=torch.int64, device=dev)
    got = decode_fused._launch(wrapper, *args, width, st, plan=plan)
    return got, decode_fused.split_wide_stamps(st, plan[1])


def stamped_encode(data: torch.Tensor, blens: torch.Tensor, bs: int):
    """One stamped launch of ``encode_blocks.cu`` over ``data`` (uint8[B, bs]
    on the card) as blocks of ``bs`` bytes: (comp, clen, fail) and the stamps
    (int64[B, STAMPS], on the host)."""
    st = torch.zeros((len(blens), encode_fused.STAMPS), dtype=torch.int64, device=data.device)
    got = encode_fused._launch(data, blens, bs, encode_fused.ocap(bs), encode_fused.walk_cap(bs),
                               st)
    return got, st.cpu().numpy()


def profile_decode(data: bytes) -> list[dict]:
    dev = resolve_device(None)          # the card; no plain version has phases
    blocks = [data[i * BS : (i + 1) * BS] or data[:BS] for i in range(DECODE_BATCH)]
    frags = [pymodel.compress_fragment(b) for b in blocks]
    comp = np.zeros((len(frags), max(len(f) for f in frags)), np.uint8)
    for i, f in enumerate(frags):
        comp[i, : len(f)] = np.frombuffer(f, np.uint8)
    B, P = comp.shape
    args = (torch.from_numpy(comp).to(dev).reshape(-1),
            torch.arange(B, dtype=torch.int64, device=dev) * P,
            torch.tensor([len(f) for f in frags], dtype=torch.int32, device=dev),
            torch.full((B,), BS, dtype=torch.int32, device=dev))
    (out, prod, status), st = stamped_decode(decode_fused.decode_blocks, args, BS)
    out, prod, status = out.cpu().numpy(), prod.cpu().tolist(), status.cpu().tolist()
    for i, b in enumerate(blocks):
        if status[i] != 0 or prod[i] != len(b) or out[i, : len(b)].tobytes() != b:
            raise RuntimeError(f"phaseprof decode: block {i} differs from its source")
    ms = time_ms(lambda: decode_fused._launch(decode_fused.decode_blocks, *args, BS), device=dev)
    total = sum(len(b) for b in blocks)
    return decode_rows(st, sm_clock_mhz()) + [{"GBps_full": total / ms / 1e6,
                                               "device": card(dev)}]


def profile_wide(body: bytes, ulen: int) -> list[dict]:
    """The wide kernels on ``body`` decoded as one row of ``ulen`` bytes (a
    whole stream's body is one valid fragment)."""
    dev = resolve_device(None)
    args = (torch.frombuffer(bytearray(body), dtype=torch.uint8).to(dev),
            torch.zeros((1,), dtype=torch.int64, device=dev),
            torch.tensor([len(body)], dtype=torch.int32, device=dev),
            torch.tensor([ulen], dtype=torch.int32, device=dev))
    (out, prod, status), (chain, seg) = stamped_wide(decode_fused.decode_blocks, args, ulen)
    if int(status[0]) != 0 or int(prod[0]) != ulen:
        raise RuntimeError(f"phaseprof wide: status {int(status[0])}, produced {int(prod[0])}")
    if out[0].cpu().numpy().tobytes() != pymodel.decompress_noheader(body, ulen):
        raise RuntimeError("phaseprof wide: the row differs from the oracle's")
    plan = decode_fused.plan_on(dev, [len(body)], [ulen], ulen)
    ms = time_ms(lambda: decode_fused._launch(decode_fused.decode_blocks, *args, ulen, plan=plan),
                 device=dev)
    return wide_rows(chain, seg, sm_clock_mhz()) + [{"GBps_full": ulen / ms / 1e6,
                                                     "device": card(dev)}]


def profile_encode(data: bytes) -> list[dict]:
    dev = resolve_device(None)          # the card; no plain version has phases
    n = len(data)
    nb = (n + BS - 1) // BS
    pages = np.zeros((nb, BS), np.uint8)
    pages.reshape(-1)[:n] = np.frombuffer(data, np.uint8)
    lens = np.full((nb,), BS, np.int32)
    lens[-1] = n - (nb - 1) * BS
    pages_dev, lens_dev = torch.from_numpy(pages).to(dev), torch.from_numpy(lens).to(dev)
    (comp, clen, fail), st = stamped_encode(pages_dev, lens_dev, BS)
    comp, clen = comp.cpu().numpy(), clen.cpu().tolist()
    if bool(fail.any()):
        raise RuntimeError("phaseprof encode: the walk exhausted its bound")
    for i in range(nb):
        if pymodel.decompress_noheader(comp[i, : clen[i]].tobytes(), int(lens[i])) \
                != pages[i, : lens[i]].tobytes():
            raise RuntimeError(f"phaseprof encode: block {i} does not decode to its source")
    ow, cap = encode_fused.ocap(BS), encode_fused.walk_cap(BS)
    ms = time_ms(lambda: encode_fused._launch(pages_dev, lens_dev, BS, ow, cap), device=dev)
    return encode_rows(st, sm_clock_mhz()) + [{"MBps_full": n / ms / 1e3, "device": card(dev)}]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("which", nargs="?", default="decode", choices=["decode", "encode", "wide"])
    ap.add_argument("data_file", nargs="?",
                    default=str(pathlib.Path(__file__).parents[2] / "tests" / "data" / "urls.10K"))
    args = ap.parse_args(argv)
    data = pathlib.Path(args.data_file).read_bytes()
    if args.which == "wide":                        # the data's stream body as one row
        stream = pymodel.compress(data)
        ulen, hdr = wire.varint_decode(stream)
        got = profile_wide(stream[hdr:], ulen)
    else:
        got = profile_decode(data) if args.which == "decode" else profile_encode(data)
    for r in got:
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
