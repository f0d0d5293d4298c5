"""Batched independent-block Snappy decode: the CUDA kernel and its plain version.

Port of ``csnappy_tpu/ops/decode_fused.py``.  One kernel,
``csrc/decode_blocks.cu``, serves both of the TPU kernel's modes:

* :func:`decode_blocks` — block mode (``_compiled``): a ``[B, P]`` matrix of
  zero-padded fragments, one output row of ``block_out`` bytes each;
* :func:`decode_segments` — stream mode (``_compiled_streamed``): the
  segments of ONE contiguous stream, read in place at their compressed
  offsets, one launch.

The source comment of ``decode_blocks.cu`` says what bounds the kernel on
the card and what its design does about it.

Contract, identical in both versions.  For each block the stream is decoded
against its limit ``dlim`` exactly as the oracle does
(``models/pymodel.decompress_noheader``): tags in order, the first error
event in output order wins, and within a tag the offset check comes before
the space check (csnappy_decompress.c:295-317).  ``status`` is 0,
E_OUTPUT_OVERRUN or E_DATA_MALFORMED; ``produced`` is 0 unless the status is
0; each output row holds the decoded bytes and is zero past ``produced``.
COPY_4 offsets keep their full 32-bit value.

On a CUDA tensor the kernel runs; on a CPU tensor the plain version runs
(:func:`decode_plain`); a CUDA tensor with ``device="cpu"`` raises.  Nothing
falls back from one to the other.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..config import refuse_card_tensors, resolve_device
from ..errors import SnappyError
from ..models import pymodel
from . import _build

MAX_BLOCK_OUT = 1 << 17   # output row bytes one thread block holds in shared memory


def _u8_tensor(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        t = x
    else:
        a = np.frombuffer(x, np.uint8) if isinstance(x, (bytes, bytearray, memoryview)) else np.asarray(x)
        t = torch.from_numpy(a if a.flags.writeable else a.copy())
    if t.dtype != torch.uint8:
        raise TypeError(f"compressed input must be uint8, got {t.dtype}")
    return t.to(device).contiguous()


def _host_ints(x, n: int, what: str) -> np.ndarray:
    a = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    a = np.broadcast_to(a.astype(np.int64), (n,)) if a.ndim == 0 else a.astype(np.int64)
    if a.shape != (n,):
        raise ValueError(f"{what} must have {n} entries, got shape {a.shape}")
    return np.ascontiguousarray(a)


def decode_blocks(comp, src_lens, block_out: int, device=None):
    """Decode B independent fragments.

    comp: uint8[B, P] zero-padded fragments; src_lens: int[B], each <= P;
    block_out: each block's output limit and row width (<= MAX_BLOCK_OUT).
    Returns (out uint8[B, block_out], produced int32[B], status int32[B]),
    on ``device`` (None = cuda).
    """
    dev = resolve_device(device)
    refuse_card_tensors(dev, comp, src_lens)
    comp = _u8_tensor(comp, dev)
    if comp.dim() != 2:
        raise ValueError("comp must be [B, P]")
    B, P = comp.shape
    lens = _host_ints(src_lens, B, "src_lens")
    if ((lens < 0) | (lens > P)).any():
        raise ValueError("src_lens must lie in [0, P]")
    if not 0 <= block_out <= MAX_BLOCK_OUT:
        raise ValueError(f"block_out must lie in [0, {MAX_BLOCK_OUT}]")
    offs = np.arange(B, dtype=np.int64) * P
    dlims = np.full((B,), block_out, np.int64)
    return _decode(decode_blocks, comp.reshape(-1), offs, lens, dlims, block_out)


def decode_segments(body, offs, lens, dlim, device=None):
    """Decode the independent segments of one contiguous stream in one launch.

    body: uint8[n], the headerless stream; offs/lens: int[S], each segment's
    compressed offset and length inside ``body``; dlim: int or int[S], each
    segment's output limit.  Returns (out uint8[S, max(dlim)], produced,
    status).  The segments are read in place; ``body`` is not copied into a
    padded matrix.
    """
    dev = resolve_device(device)
    refuse_card_tensors(dev, body, offs, lens, dlim)
    body = _u8_tensor(body, dev).reshape(-1)
    offs = np.asarray(offs, np.int64).reshape(-1)
    S = len(offs)
    lens = _host_ints(lens, S, "lens")
    dlims = _host_ints(dlim, S, "dlim")
    if ((offs < 0) | (lens < 0) | (offs + lens > body.numel())).any():
        raise ValueError("segments must lie inside body")
    if ((dlims < 0) | (dlims > MAX_BLOCK_OUT)).any():
        raise ValueError(f"dlim must lie in [0, {MAX_BLOCK_OUT}]")
    width = int(dlims.max()) if S else 0
    return _decode(decode_segments, body, offs, lens, dlims, width)


def _decode(wrapper, src: torch.Tensor, offs, lens, dlims, width: int):
    if lens.size and int(lens.max()) >= 1 << 31:
        raise ValueError("a block's compressed length must be below 2 GiB")
    if len(offs) == 0:
        i32 = torch.zeros((0,), dtype=torch.int32, device=src.device)
        return torch.zeros((0, width), dtype=torch.uint8, device=src.device), i32, i32.clone()
    if src.device.type == "cpu":
        return decode_plain(src, offs, lens, dlims, width)
    ints = torch.from_numpy(np.stack([offs, lens, dlims])).to(src.device)
    return _launch(wrapper, src, ints[0].contiguous(), ints[1].to(torch.int32),
                   ints[2].to(torch.int32), width)


@functools.cache
def _kernel():
    launch, check = _build.kernel("decode_blocks")
    vp = ctypes.c_void_p
    launch.argtypes = [vp, vp, vp, vp, vp, ctypes.c_longlong, vp, vp, ctypes.c_int, vp]
    return launch, check


def _launch(wrapper, src, offs_t, lens_t, dlims_t, width: int):
    """Launch ``decode_blocks.cu`` on the current stream and count it on
    ``wrapper.launches``.  All tensors are on the card: the flat source,
    int64 offsets, int32 lengths and limits (validated by the caller)."""
    dev = src.device
    B = offs_t.numel()
    out = torch.empty((B, width), dtype=torch.uint8, device=dev)
    produced = torch.empty((B,), dtype=torch.int32, device=dev)
    status = torch.empty((B,), dtype=torch.int32, device=dev)
    launch, check = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        check(launch(src.data_ptr(), offs_t.data_ptr(), lens_t.data_ptr(), dlims_t.data_ptr(),
                     out.data_ptr(), width, produced.data_ptr(), status.data_ptr(), B, stream))
    wrapper.launches += 1
    return out, produced, status


decode_blocks.launches = 0
decode_segments.launches = 0


# ------------------------------------------------------------ plain version


def decode_plain(src: torch.Tensor, offs, lens, dlims, width: int):
    """Plain version of ``decode_blocks.cu`` on CPU tensors (same arguments
    as the launch: the flat source, per-block offsets, lengths, limits).
    Each block goes through the oracle; its error code is the status."""
    flat = src.numpy().tobytes()
    B = len(offs)
    out = torch.zeros((B, width), dtype=torch.uint8)
    produced = torch.zeros((B,), dtype=torch.int32)
    status = torch.zeros((B,), dtype=torch.int32)
    for b in range(B):
        o, ln = int(offs[b]), int(lens[b])
        try:
            got = pymodel.decompress_noheader(flat[o : o + ln], int(dlims[b]))
        except SnappyError as e:
            status[b] = e.code
            continue
        produced[b] = len(got)
        if got:
            out[b, : len(got)] = torch.frombuffer(bytearray(got), dtype=torch.uint8)
    return out, produced, status
