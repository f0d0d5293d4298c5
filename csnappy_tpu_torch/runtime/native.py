"""ctypes binding to the port's host runtime (``csrc/host/csnappy_host.cpp``).

* the ``"native"`` backend: a host codec (``compress``,
  ``compress_fragment``, ``decompress``, ``decompress_noheader``) whose
  streams are byte-identical to ``csnappy_tpu.runtime.native``, the same
  C++ algorithm; errors raise :class:`SnappyError` with the reference's codes;
* the whole-stream boundary scan that routes a stream to the segment decoder;
* the compactor that concatenates the device's padded rows into one stream.

The library is built with ``c++`` at first use
(:mod:`csnappy_tpu_torch.ops._build`); the JAX package's
``csrc/libcsnappy_host.so`` is never loaded.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np

from ..errors import raise_for_code
from ..ops import _build

SCAN_SEGMENTABLE = 0
SCAN_CROSSING = 1
SCAN_FAR_OFFSET = 2

_u8p = ctypes.POINTER(ctypes.c_uint8)
_u32p = ctypes.POINTER(ctypes.c_uint32)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("csnappy_host")
    lib.csnappy_torch_scan_segments.restype = ctypes.c_int
    lib.csnappy_torch_scan_segments.argtypes = [
        _u8p, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
        _u32p, ctypes.c_uint32, _u32p, _u32p,
    ]
    lib.csnappy_torch_compact.restype = ctypes.c_uint64
    lib.csnappy_torch_compact.argtypes = [_u8p, ctypes.c_uint32, ctypes.c_uint32, _u32p, _u8p]
    lib.csnappy_torch_max_compressed.restype = ctypes.c_uint64
    lib.csnappy_torch_max_compressed.argtypes = [ctypes.c_uint64]
    for name in ("compress", "compress_fragment"):
        fn = getattr(lib, f"csnappy_torch_{name}")
        fn.restype = ctypes.c_int
        fn.argtypes = [_u8p, ctypes.c_uint32, _u8p, _u32p]
    lib.csnappy_torch_decompress.restype = ctypes.c_int
    lib.csnappy_torch_decompress.argtypes = [_u8p, ctypes.c_uint32, _u8p, ctypes.c_uint32, _u32p]
    lib.csnappy_torch_decompress_noheader.restype = ctypes.c_int
    lib.csnappy_torch_decompress_noheader.argtypes = [_u8p, ctypes.c_uint32, _u8p, _u32p]
    return lib


@functools.cache
def available() -> bool:
    """True when the host library builds and loads; False when the compiler
    is missing or fails, or the library does not load.  The answer is kept,
    so a failed build is tried once a process."""
    try:
        _lib()
        return True
    except (OSError, RuntimeError):
        return False


def _src(data) -> np.ndarray:
    src = np.frombuffer(data, np.uint8) if isinstance(data, (bytes, bytearray, memoryview)) \
        else np.ascontiguousarray(data, np.uint8)
    if len(src) >= 1 << 32:
        raise ValueError("the host codec takes inputs below 4 GiB")
    return src


def _encode(name: str, data) -> bytes:
    lib = _lib()
    src = _src(data)
    out = np.empty(int(lib.csnappy_torch_max_compressed(len(src))) + 8, np.uint8)
    olen = ctypes.c_uint32(0)
    rc = getattr(lib, f"csnappy_torch_{name}")(
        src.ctypes.data_as(_u8p), len(src), out.ctypes.data_as(_u8p), ctypes.byref(olen))
    raise_for_code(rc)
    return out[: olen.value].tobytes()


def compress(data) -> bytes:
    """Whole stream: varint preamble + 32 KiB fragments."""
    return _encode("compress", data)


def compress_fragment(data) -> bytes:
    """One headerless fragment of at most 32 KiB."""
    return _encode("compress_fragment", data)


def decompress(data, dst_cap: int) -> bytes:
    """Whole stream with its header, into at most ``dst_cap`` bytes."""
    src = _src(data)
    out = np.empty(max(dst_cap, 1), np.uint8)
    produced = ctypes.c_uint32(0)
    rc = _lib().csnappy_torch_decompress(src.ctypes.data_as(_u8p), len(src),
                                         out.ctypes.data_as(_u8p), dst_cap, ctypes.byref(produced))
    raise_for_code(rc)
    return out[: produced.value].tobytes()


def decompress_noheader(data, dst_cap: int) -> bytes:
    """Headerless stream into at most ``dst_cap`` bytes."""
    src = _src(data)
    out = np.empty(max(dst_cap, 1), np.uint8)
    dlen = ctypes.c_uint32(dst_cap)
    rc = _lib().csnappy_torch_decompress_noheader(src.ctypes.data_as(_u8p), len(src),
                                                  out.ctypes.data_as(_u8p), ctypes.byref(dlen))
    raise_for_code(rc)
    return out[: dlen.value].tobytes()


def scan_segments(data: np.ndarray | bytes, dst_cap: int, seg: int = 32768):
    """One-pass tag-boundary scan of a headerless stream.

    Returns (rc, seg_offs int64[nseg], produced): rc 0 = the stream splits
    into independent ``seg``-output blocks starting at compressed offsets
    ``seg_offs``; rc 1 = legal but a tag straddles a boundary or a copy
    reaches a prior segment; rc 2 = legal with a copy offset above 32768;
    any negative rc is the exact E_* error, decided in stream order."""
    src = np.ascontiguousarray(
        np.frombuffer(data, np.uint8) if isinstance(data, (bytes, bytearray)) else data,
        np.uint8,
    )
    if not 0 <= dst_cap < 1 << 32 or len(src) >= 1 << 32:
        raise ValueError("scan_segments takes streams and limits below 4 GiB")
    max_segs = dst_cap // seg + 2
    offs = np.zeros(max_segs, np.uint32)
    nseg = ctypes.c_uint32(0)
    produced = ctypes.c_uint32(0)
    rc = _lib().csnappy_torch_scan_segments(
        src.ctypes.data_as(_u8p), len(src), dst_cap, seg,
        offs.ctypes.data_as(_u32p), max_segs, ctypes.byref(nseg), ctypes.byref(produced),
    )
    return rc, offs[: nseg.value].astype(np.int64), int(produced.value)


def compact(padded: np.ndarray, lens: np.ndarray) -> bytes:
    """Concatenate ``padded[i, :lens[i]]`` over the rows."""
    padded = np.ascontiguousarray(padded, np.uint8)
    lens32 = np.ascontiguousarray(lens, np.uint32)
    if padded.ndim != 2 or lens32.shape != (padded.shape[0],):
        raise ValueError("compact takes a [B, W] matrix and B lengths")
    if (lens32 > padded.shape[1]).any():
        raise ValueError("a length exceeds the row width")
    out = np.empty(int(lens32.sum(dtype=np.uint64)), np.uint8)
    n = _lib().csnappy_torch_compact(
        padded.reshape(-1).ctypes.data_as(_u8p), padded.shape[0], padded.shape[1],
        lens32.ctypes.data_as(_u32p), out.ctypes.data_as(_u8p),
    )
    return out[:n].tobytes()
