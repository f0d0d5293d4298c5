"""CLI harness of the PyTorch port — capability parity with the reference's
drivers (C7, C8); port of ``csnappy_tpu/cli.py`` with the same subcommands,
exit codes and messages.

``cl-tester``-style file/stdin [de]compression and the two selftests
(cl_tester.c:240-304), plus a ``block`` subcommand mirroring
block_compressor's paged container driver with codec selection and
codec-only timing (block_compressor.c:396-438).

The encode-contract selftest (cl_tester.c:127-165) adapts the reference's
guard-page SIGSEGV oracle into explicit size assertions: the compressor must
stay within max_compressed_length (SURVEY.md §7.6).

Backends: ``torch`` (the default; the kernels on ``--device``), ``py`` (the
oracle) and ``native`` (the host C++ codec).  ``--device`` defaults to the
card; ``--device cpu`` runs the kernels' plain versions.

    python -m csnappy_tpu_torch.cli file -c urls.10K urls.snappy
    python -m csnappy_tpu_torch.cli block -c -p 4096 image.bin image.blk
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from . import api, errors
from .config import BACKENDS
from .models import wire
from .runtime import container

FAKE = b"\x32\xc4foooooo"  # truncated-literal vector (cl_tester.c:167)


def _read(path: str | None) -> bytes:
    if path in (None, "-"):
        return sys.stdin.buffer.read()
    with open(path, "rb") as f:
        return f.read()


def _write(path: str | None, data: bytes) -> None:
    if path in (None, "-"):
        sys.stdout.buffer.write(data)
    else:
        with open(path, "wb") as f:
            f.write(data)


def selftest_compression(backend: str, device=None) -> int:
    rng = np.random.default_rng()
    data = rng.integers(0, 256, size=4096 + 100, dtype=np.uint8).tobytes()
    comp = api.compress(data, backend=backend, device=device)
    bound = api.max_compressed_length(len(data)) + wire.MAX_VARINT32_BYTES
    if len(comp) > bound:
        print(f"FAIL: compressed {len(comp)} exceeds bound {bound}", file=sys.stderr)
        return 1
    if api.decompress(comp, backend=backend, device=device) != data:
        print("FAIL: roundtrip mismatch", file=sys.stderr)
        return 1
    print("Compression selftest passed.", file=sys.stderr)
    return 0


def selftest_decompression(backend: str, device=None) -> int:
    rng = np.random.default_rng()
    data = rng.integers(0, 256, size=4096 + 100, dtype=np.uint8).tobytes()
    comp = api.compress(data, backend=backend, device=device)
    checks = []

    def expect(code, fn):
        try:
            fn()
            checks.append(("expected error", False))
        except errors.SnappyError as e:
            checks.append((f"code {e.code}", code is None or e.code == code))

    kw = dict(backend=backend, device=device)
    expect(errors.E_OUTPUT_INSUF, lambda: api.decompress(comp, len(data) - 1, **kw))
    hdr = wire.varint_decode(comp)[1]
    expect(
        errors.E_OUTPUT_OVERRUN,
        lambda: api.decompress_noheader(comp[hdr:], len(data) - 1, **kw),
    )
    expect(None, lambda: api.decompress(FAKE, **kw))
    expect(None, lambda: api.decompress_noheader(FAKE, 4096, **kw))
    ok = all(c[1] for c in checks)
    print(
        ("Decompression selftest passed." if ok else f"FAIL: {checks}"),
        file=sys.stderr,
    )
    return 0 if ok else 1


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="cl-tester", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    dev = argparse.ArgumentParser(add_help=False)
    dev.add_argument("--device", default=None,
                     help="where the torch backend runs (default: the card; cpu = plain versions)")
    sub = ap.add_subparsers(dest="cmd")

    f = sub.add_parser("file", parents=[dev], help="file/stdin [de]compression (cl_tester parity)")
    mode = f.add_mutually_exclusive_group(required=False)
    mode.add_argument("-c", action="store_true", help="compress")
    mode.add_argument("-d", action="store_true", help="decompress (default)")
    f.add_argument("-S", choices=["c", "d"], help="run selftest instead")
    f.add_argument(
        "-b", "--backend", default=api.DEFAULT_BACKEND, choices=list(BACKENDS)
    )
    f.add_argument("infile", nargs="?", help="input file or - for stdin")
    f.add_argument("outfile", nargs="?", help="output file or - for stdout")

    b = sub.add_parser("block", parents=[dev],
                       help="paged container driver (block_compressor parity)")
    b.add_argument("-m", "--method", default="snappy", choices=["snappy", "zlib"])
    bmode = b.add_mutually_exclusive_group(required=True)
    bmode.add_argument("-c", action="store_true", help="compress")
    bmode.add_argument("-d", action="store_true", help="decompress")
    b.add_argument("-p", "--page-size", type=int, default=4096)
    b.add_argument("infile")
    b.add_argument("outfile")

    args = ap.parse_args(argv)
    if args.cmd is None:
        ap.print_help(sys.stderr)
        return 2

    if args.cmd == "file":
        if args.S:
            return (
                selftest_compression(args.backend, args.device)
                if args.S == "c"
                else selftest_decompression(args.backend, args.device)
            )
        try:
            data = _read(args.infile)
        except OSError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
        try:
            t0 = time.perf_counter()
            out = (
                api.compress(data, backend=args.backend, device=args.device)
                if args.c
                else api.decompress(data, backend=args.backend, device=args.device)
            )
            dt = time.perf_counter() - t0
        except errors.SnappyError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
        _write(args.outfile, out)
        mb = (len(data) if args.c else len(out)) / 1e6
        print(
            f"{'compressed' if args.c else 'decompressed'} {len(data)} -> {len(out)} "
            f"bytes in {dt * 1e3:.1f} ms ({mb / dt:.1f} MB/s)",
            file=sys.stderr,
        )
        return 0

    # block container driver
    try:
        data = _read(args.infile)
    except OSError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    try:
        if args.c:
            out, stats = container.compress_blocks(data, args.page_size, args.method,
                                                   device=args.device)
        else:
            out, stats = container.decompress_blocks(data, args.page_size, args.method,
                                                     device=args.device)
    except errors.SnappyError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    _write(args.outfile, out)
    h = stats.histogram
    print(
        f"pages={stats.nr_pages} in={len(data)} out={len(out)} "
        f"codec_seconds={stats.codec_seconds:.4f} "
        f"histogram: expanded={h[0]} >50%={h[1]} <=50%={h[2]}",
        file=sys.stderr,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
