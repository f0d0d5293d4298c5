"""Build and load the port's native sources at first use.

Each source under ``csnappy_tpu_torch/csrc/`` becomes one shared library
with a plain C interface, loaded with :mod:`ctypes`:

* ``*.cu``  — ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared``
  (Hopper kernels; built only where a CUDA toolkit is installed);
* ``*.cpp`` — ``c++ -O3 -shared`` (host runtime).

Libraries go to ``csnappy_tpu_torch/build/`` under a name that carries a
hash of the source, of every local header it includes (``#include "..."``,
followed through headers) and of the command, so an edited source or
header is rebuilt and a stale library is never loaded.  Concurrent builds (test workers) each
write a private file and rename it into place.  ``build()`` starts one
compiler per missing library, all at once, and waits for them together.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import re
import shutil
import subprocess

PKG = pathlib.Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD = PKG / "build"

SOURCES = {
    "decode_blocks": CSRC / "decode_blocks.cu",
    "encode_blocks": CSRC / "encode_blocks.cu",
    "scan_segments": CSRC / "scan_segments.cu",
    "decode_stream": CSRC / "decode_stream.cu",
    "decode_wide": CSRC / "decode_wide.cu",
    "movebench": CSRC / "movebench.cu",
    "primitives": CSRC / "primitives.cu",
    "probe": CSRC / "probe.cu",
    "probe3": CSRC / "probe3.cu",
    "kernel_lib": CSRC / "kernel_lib.cu",
    "probe4": CSRC / "probe4.cu",
    "hygiene": CSRC / "hygiene.cu",
    "decode_wide_checked": CSRC / "decode_wide.cu",
    "decode_stream_checked": CSRC / "decode_stream.cu",
    "csnappy_host": CSRC / "host" / "csnappy_host.cpp",
}
CUDA_NAMES = ("decode_blocks", "decode_wide", "encode_blocks", "scan_segments", "decode_stream",
              "movebench", "primitives", "probe", "probe3", "kernel_lib", "probe4", "hygiene",
              "decode_wide_checked", "decode_stream_checked")
# the checked builds of the chained decoders: the same source with its
# device asserts compiled in (CSNAPPY_CHECKED), loaded only by the hygiene
# harness (tools/hygiene.use_checked); the timed libraries and their
# ``ptxas -v`` lines are the plain names'
CHECKED = {"decode_wide_checked": "decode_wide", "decode_stream_checked": "decode_stream"}
# libraries whose every entry returns at once (a launch, no wait): loaded as
# ctypes.PyDLL, whose calls keep the GIL rather than release and retake it
GIL_KEPT = ("primitives", "movebench")
_LOCAL_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    return str(pathlib.Path(home) / "bin" / "nvcc")


def _command(name: str, out: pathlib.Path) -> list[str]:
    src = SOURCES[name]
    if src.suffix == ".cu":
        return [nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                "-Xptxas=-v", *(["-DCSNAPPY_CHECKED", "-lineinfo"] if name in CHECKED else []),
                "-shared", "-Xcompiler", "-fPIC", "-o", str(out), str(src)]
    return [os.environ.get("CXX", "c++"), "-O3", "-std=c++17", "-fPIC", "-shared",
            "-o", str(out), str(src)]


def local_headers(src: pathlib.Path) -> list[pathlib.Path]:
    """The local headers ``src`` includes (``#include "..."``, resolved
    beside the including file), and theirs, each once, in order."""
    found, todo = [], [src]
    while todo:
        f = todo.pop(0)
        for inc in _LOCAL_INCLUDE.findall(f.read_text()):
            h = (f.parent / inc).resolve()
            if h not in found:
                found.append(h)
                todo.append(h)
    return found


def target(name: str) -> pathlib.Path:
    h = hashlib.sha256(SOURCES[name].read_bytes())
    for header in local_headers(SOURCES[name]):
        h.update(header.read_bytes())
    h.update(" ".join(_command(name, pathlib.Path("x"))[1:]).encode())
    return BUILD / f"lib{name}_{h.hexdigest()[:12]}.so"


def log_path(name: str) -> pathlib.Path:
    """Compiler output of the last build of ``name`` (register and shared
    memory use of each kernel, from ``-Xptxas=-v``)."""
    return BUILD / f"{name}.log"


def build(names=tuple(SOURCES)) -> dict[str, pathlib.Path]:
    """Build every library of ``names`` that is missing, in parallel."""
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = target(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(_command(name, tmp), stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        text, _ = proc.communicate()
        log_path(name).write_text(text)
        if proc.returncode != 0:
            failed.append(f"{name} (rc {proc.returncode}):\n{text}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("build failed: " + "\n".join(failed))
    return {name: target(name) for name in names}


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The library built from ``SOURCES[name]``, built first if missing
    (``GIL_KEPT`` ones as ``ctypes.PyDLL``)."""
    return (ctypes.PyDLL if name in GIL_KEPT else ctypes.CDLL)(str(build((name,))[name]))


@functools.cache
def kernel(name: str, entry: str = ""):
    """Bind ``<name>_launch`` (``<name>_<entry>_launch`` for a library with
    several) and ``<name>_error_string`` of a CUDA library; returns (launch,
    check), where check(rc) raises on a CUDA error code.  A checked build
    (``CHECKED``) exports its source's names."""
    lib = load(name)
    sym = CHECKED.get(name, name)
    err = getattr(lib, f"{sym}_error_string")
    err.restype = ctypes.c_char_p
    err.argtypes = [ctypes.c_int]
    launch = getattr(lib, f"{sym}_{entry}_launch" if entry else f"{sym}_launch")
    launch.restype = ctypes.c_int

    def check(rc: int) -> None:
        if rc != 0:
            raise RuntimeError(f"{name}: CUDA error {rc}: {err(rc).decode()}")

    return launch, check
