"""The port's committed records, made on the card: the counterpart of the
``records`` and ``profiles`` targets of the repo's ``Makefile``.

    python -m csnappy_tpu_torch.tools.records [--out records/]

writes five files under ``--out``, each naming the card and its power limit:

* ``torch_benchtable.txt`` — ``benchtable --corpus``, torch backend (the
  first line names the backend and the card);
* ``torch_zramsim.json`` — ``zramsim.run`` at 4 KiB pages over the 256 MiB
  tree of ``zramsim.corpus_tree`` (the corpus copied under subdirectories),
  md5 readback of every file;
* ``torch_phaseprof_decode.jsonl``, ``torch_phaseprof_encode.jsonl`` —
  ``phaseprof decode`` and ``phaseprof encode``;
* ``torch_bench.json`` — the line of ``bench_torch.py --full``.

Every run goes first, its output held in memory.  A run that raises or
prints nothing stops the step, which exits non-zero before any file is
written.  Then each file is written under a temporary name in ``--out`` and
renamed to its own once complete, so no partial file is left.  The runs
take the card; with none the step fails.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib.util
import io
import json
import os
import pathlib
import sys
import tempfile
import traceback

from . import benchtable, phaseprof, zramsim
from .timing import card

ROOT = pathlib.Path(__file__).resolve().parents[2]


def _printed(main, argv) -> str:
    """What ``main(argv)`` prints; a non-zero exit raises."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    if rc:
        raise RuntimeError(f"exit {rc}")
    return buf.getvalue()


def zram() -> str:
    with tempfile.TemporaryDirectory(prefix="zram_tree_") as root:
        zramsim.corpus_tree(root)
        rec = zramsim.run(root, page_size=4096)
    return json.dumps(dict(rec, page_size=4096, device=card())) + "\n"


def bench() -> str:
    """``bench_torch.py --full``, loaded from the checkout beside the package."""
    spec = importlib.util.spec_from_file_location("bench_torch", ROOT / "bench_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return _printed(mod.main, ["--full"])


RUNS = {"torch_benchtable.txt": lambda: _printed(benchtable.main, ["--corpus"]),
        "torch_zramsim.json": zram,
        "torch_phaseprof_decode.jsonl": lambda: _printed(phaseprof.main, ["decode"]),
        "torch_phaseprof_encode.jsonl": lambda: _printed(phaseprof.main, ["encode"]),
        "torch_bench.json": bench}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default=str(ROOT / "records"))
    args = ap.parse_args(argv)
    texts = {}
    for name, run in RUNS.items():
        print(f"[records] {name} ...", file=sys.stderr, flush=True)
        try:
            texts[name] = run()
        except Exception:           # the step's boundary: report, write nothing, exit non-zero
            traceback.print_exc()
            print(f"[records] {name}: the run failed; no file written", file=sys.stderr)
            return 1
        if not texts[name].strip():
            print(f"[records] {name}: empty output; no file written", file=sys.stderr)
            return 1
    os.makedirs(args.out, exist_ok=True)
    for name, text in texts.items():
        path = os.path.join(args.out, name)
        tmp = f"{path}.tmp{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                f.write(text)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        print(f"[records] wrote {path} ({len(text)} B)", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
