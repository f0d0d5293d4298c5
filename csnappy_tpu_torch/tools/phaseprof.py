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

Run:  python -m csnappy_tpu_torch.tools.phaseprof [decode|encode] [data_file]

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


def decode_summary(stamps: np.ndarray, names=decode_fused.PHASES) -> dict:
    """:func:`summary` of ``decode_blocks.cu``'s stamps (int64[B, STAMPS]:
    each phase's cycles, then ``decode_fused.COUNTS``); ``names`` is
    ``WIDE_PHASES`` for ``decode_wide_kernel``."""
    counts = dict(zip(decode_fused.COUNTS, stamps[:, -len(decode_fused.COUNTS):].T))
    return summary(stamps[:, : len(names)], names, counts)


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


def encode_rows(stamps: np.ndarray, mhz: float) -> list[dict]:
    """The phase rows of one stamped ``encode_kernel`` launch."""
    return rows(encode_summary(stamps), mhz)


def stamped_decode(wrapper, args, width: int, kernel=None):
    """One stamped launch of ``decode_blocks.cu`` on ``args`` (the card's
    flat source, offsets, lengths and limits, as ``decode_fused._launch``
    takes them): its result and the stamps (int64[B, STAMPS], on the host)."""
    st = torch.zeros((args[1].numel(), decode_fused.STAMPS), dtype=torch.int64,
                     device=args[0].device)
    got = decode_fused._launch(wrapper, *args, width, st, kernel=kernel)
    return got, st.cpu().numpy()


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
    ap.add_argument("which", nargs="?", default="decode", choices=["decode", "encode"])
    ap.add_argument("data_file", nargs="?",
                    default=str(pathlib.Path(__file__).parents[2] / "tests" / "data" / "urls.10K"))
    args = ap.parse_args(argv)
    data = pathlib.Path(args.data_file).read_bytes()
    for r in profile_decode(data) if args.which == "decode" else profile_encode(data):
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
