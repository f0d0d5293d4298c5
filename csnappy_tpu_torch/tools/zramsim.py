"""zram-style end-to-end harness — zramtest2.sh parity (C16); port of
``csnappy_tpu/tools/zramsim.py`` with the same keys and output.

The reference benchmark creates a zram device, untars a tree onto it, syncs,
and md5-verifies every file read back through the kernel codec
(zramtest2.sh:15-39), reporting orig_data_size / compr_data_size /
mem_used_total.  This harness simulates the same store: every file under a
directory is stored page-by-page through the 4 KiB block container (the
exact shape of the kernel integration path, SURVEY.md §3.3), read back, and
hash-verified.

The snappy pages run on ``device`` (default: the card; ``--device cpu``
runs the kernels' plain versions).

Usage:  python -m csnappy_tpu_torch.tools.zramsim DIR [--page-size 4096] [--device cpu]
"""
from __future__ import annotations

import argparse
import hashlib
import os
import sys
import time

from ..runtime import container

TREE_BYTES = 256 << 20         # the corpus tree: 65,536 pages of 4 KiB


def corpus_tree(root: str, total: int = TREE_BYTES) -> list[str]:
    """Copy the port's corpus (``tools/corpus.py``, urls.10K among it) under
    ``root``, one subdirectory ``copy000``, ``copy001``, ... a copy, until
    ``total`` bytes are written (the last file cut short).  Returns the
    corpus's file names."""
    from .corpus import corpus

    files = sorted(corpus().items())
    written, copy = 0, 0
    while written < total:
        sub = os.path.join(root, f"copy{copy:03d}")
        os.makedirs(sub)
        for name, data in files:
            part = data[: total - written]
            if not part:
                break
            with open(os.path.join(sub, name), "wb") as f:
                f.write(part)
            written += len(part)
        copy += 1
    return [name for name, _ in files]


def run(root: str, page_size: int = 4096, codec: str = "snappy", device=None) -> dict:
    files = []
    for dirpath, _, names in os.walk(root):
        for n in names:
            p = os.path.join(dirpath, n)
            if os.path.isfile(p) and not os.path.islink(p):
                files.append(p)
    orig = comp = 0
    codec_s = 0.0
    t0 = time.perf_counter()
    for p in files:
        with open(p, "rb") as f:
            data = f.read()
        digest = hashlib.md5(data).hexdigest()
        cont, st_c = container.compress_blocks(data, page_size, codec, device)
        back, st_d = container.decompress_blocks(cont, page_size, codec, device)
        if hashlib.md5(back).hexdigest() != digest:
            raise RuntimeError(f"md5 mismatch reading back {p}")
        orig += len(data)
        comp += len(cont)
        codec_s += st_c.codec_seconds + st_d.codec_seconds
    wall = time.perf_counter() - t0
    return dict(
        nr_files=len(files),
        orig_data_size=orig,
        compr_data_size=comp,
        ratio=100.0 * comp / max(orig, 1),
        codec_seconds=codec_s,
        wall_seconds=wall,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("dir")
    ap.add_argument("--page-size", type=int, default=4096)
    ap.add_argument("-m", "--method", default="snappy", choices=["snappy", "zlib"])
    ap.add_argument("--device", default=None, help="default: the card; cpu = plain versions")
    args = ap.parse_args(argv)
    r = run(args.dir, args.page_size, args.method, args.device)
    for k, v in r.items():
        print(f"{k}: {v:.4f}" if isinstance(v, float) else f"{k}: {v}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
