"""Public codec API of the PyTorch port — the ``csnappy.h`` surface.

Same entry points and contracts as ``csnappy_tpu/api.py``; errors raise
:class:`SnappyError` with the reference's numeric codes.

Backends: ``"torch"`` (default) runs the block codec's kernels on
``device`` (None = cuda; with no card that raises); ``"py"`` is the oracle;
``"native"`` is the host C++ codec (``runtime/native.py``), whose streams are
byte-identical to the JAX package's ``native`` backend.

Routes of the ``torch`` backend, in the order of ``csnappy_tpu/api.py``:

* fragments and whole streams of at most 32 KiB output decode in one
  ``decode_blocks`` launch; the kernel decides every input exactly, including
  ``dst_len == 0`` (any produced byte overruns);
* longer streams first try ``decode_ws``, on the card end to end: the
  boundary-scan kernel, then one ``decode_segments`` launch.  It returns
  the bytes of every stream a 32 KiB fragment encoder emits, and None for
  anything it cannot verify;
* on None, the host boundary scan (``runtime/native.scan_segments``)
  decides: an error code is the exact answer; a segmentable stream decodes
  in one ``decode_segments`` launch over the stream in place; a stream with
  copy offsets above 32768 goes to the general decoder ``decode_jnp``
  (torch ops on the card); a crossing stream (a tag or copy across a 32 KiB
  output boundary) goes to the ``decode_stream`` kernel, and to
  ``decode_jnp`` when that answers E_DATA_MALFORMED (a legal literal beyond
  its 2^24-byte envelope);
* without the host library (``native.available()`` false: no compiler, or
  the library does not load) the scan is skipped and the stream goes to
  ``decode_stream``, then to ``decode_jnp`` on E_DATA_MALFORMED.

A segment decoder that disagrees with the host scan (a bad status, a short
segment, or a total other than the scan's) on a stream the scan proved
legal is a fault of ``decode_segments``.  On the card it raises
``RuntimeError``, so a wrong kernel is never hidden; with ``device="cpu"``
the general decoder ``decode_jnp`` re-decides the stream, as
``csnappy_tpu/api.py`` does.

Header-mode :func:`decompress` also checks that the stream produced exactly
the header-declared length (E_DATA_MALFORMED otherwise).  The oracle's own
header mode (``pymodel.decompress``) reports E_INPUT_NOT_CONSUMED when the
output is exactly full and tags remain; this API folds that case into
E_OUTPUT_OVERRUN, as the reference C does.
"""
from __future__ import annotations

import numpy as np

from .config import DEFAULT, CodecConfig, resolve_device
from .errors import E_DATA_MALFORMED, E_HEADER_BAD, E_OK, E_OUTPUT_INSUF, SnappyError, raise_for_code
from .models import pymodel, wire


DEFAULT_BACKEND = DEFAULT.backend


def _cfg(config):
    return config if config is not None else DEFAULT


def _device(cfg: CodecConfig, device):
    return device if device is not None else cfg.device


def max_compressed_length(source_len: int) -> int:
    """csnappy_max_compressed_length (csnappy_compress.c:612-616)."""
    return wire.max_compressed_length(source_len)


def get_uncompressed_length(src: bytes) -> tuple[int, int]:
    """csnappy_get_uncompressed_length: (length, header_bytes) or E_HEADER_BAD."""
    try:
        return wire.varint_decode(bytes(src[: wire.MAX_VARINT32_BYTES + 1]))
    except ValueError as e:
        raise SnappyError(E_HEADER_BAD, str(e)) from None


def compress_fragment(data: bytes, backend: str | None = None,
                      config: CodecConfig | None = None, device=None) -> bytes:
    """Headerless compression of one fragment <= 32 KiB (csnappy.h:46-52)."""
    cfg = _cfg(config)
    backend = backend or cfg.backend
    if len(data) > wire.BLOCK_SIZE:
        raise ValueError("fragment larger than 32 KiB")
    if backend == "py":
        return pymodel.compress_fragment(data)
    if backend == "native":
        from .runtime import native

        return native.compress_fragment(data)
    from .ops import encode_fused

    bs = max(1024, (len(data) + 1023) // 1024 * 1024)
    buf = np.zeros((1, bs), np.uint8)
    buf[0, : len(data)] = np.frombuffer(data, np.uint8)
    comp, lens = encode_fused.encode_blocks(buf, np.array([len(data)], np.int32),
                                            cfg.hash_bits, _device(cfg, device))
    frag = comp[0, : int(lens[0])].cpu().numpy().tobytes()
    if cfg.debug_checks:
        assert pymodel.decompress_noheader(frag, len(data)) == data, "oracle mismatch"
    return frag


def compress(data: bytes, backend: str | None = None,
             config: CodecConfig | None = None, device=None) -> bytes:
    """Whole-stream compression: varint preamble + config.block_size
    fragments (csnappy_compress.c:621-656)."""
    cfg = _cfg(config)
    backend = backend or cfg.backend
    if backend == "py":
        return pymodel.compress(data)
    if backend == "native":
        from .runtime import native

        return native.compress(data)
    from .ops import encode_fused

    out = encode_fused.compress_np(data, cfg.block_size, cfg.hash_bits, _device(cfg, device))
    if cfg.debug_checks:
        assert pymodel.decompress(out) == bytes(data), "oracle mismatch"
    return out


def _decompress_stream_routed(src: bytes, dst_len: int, device) -> tuple[int, bytes]:
    """Whole-stream decode for dst_len > one block (csnappy_tpu/api.py:107-210)."""
    from .ops import decode_fused, decode_jnp, decode_stream, decode_ws
    from .runtime import native

    body = np.frombuffer(src, np.uint8)
    res = decode_ws.decompress_noheader_ws(body, dst_len, device)
    if res is not None:
        return E_OK, res
    rc = None
    if native.available():
        rc, offs, produced = native.scan_segments(body, dst_len, wire.BLOCK_SIZE)
    if rc is not None and rc < 0:
        return rc, b""                      # the exact error, no device pass
    if rc == native.SCAN_FAR_OFFSET:
        out, _, status = decode_jnp.decompress_noheader_np(body, dst_len, device)
        return status, out.tobytes()
    if rc == native.SCAN_SEGMENTABLE:
        nseg = len(offs)
        if nseg == 0:
            return E_OK, b""
        lens = np.diff(np.append(offs, len(body)))
        dlims = np.minimum(wire.BLOCK_SIZE,
                           dst_len - np.arange(nseg, dtype=np.int64) * wire.BLOCK_SIZE)
        out, prod, status = decode_fused.decode_segments(body, offs, lens, dlims, device)
        prod, status = prod.cpu().numpy(), status.cpu().numpy()
        if (status != E_OK).any() or (prod[:-1] != wire.BLOCK_SIZE).any() \
                or int(prod.sum()) != produced:
            # the scan proved the stream legal, so the segment decoder is at
            # fault: on the card that is a kernel fault to surface; on the
            # CPU the general decoder re-decides it, as the JAX package does
            if resolve_device(device).type != "cpu":
                raise RuntimeError("decode_segments disagrees with the host boundary scan")
            out, _, status = decode_jnp.decompress_noheader_np(body, dst_len, device)
            return status, out.tobytes()
        # every segment but the last is full, so the rows are the stream
        return E_OK, out.reshape(-1)[:produced].cpu().numpy().tobytes()
    # a crossing stream, or no host scan
    out, _, status = decode_stream.decompress_noheader_np(body, dst_len, device)
    if status == E_DATA_MALFORMED:
        # a legal stream outside the stream kernel's envelope (a literal
        # beyond 2^24 bytes), or no scan ran: the general decoder decides it
        out, _, status = decode_jnp.decompress_noheader_np(body, dst_len, device)
    return status, out.tobytes()


def decompress_noheader(src: bytes, dst_len: int, backend: str | None = None,
                        config: CodecConfig | None = None, device=None) -> bytes:
    """Safe headerless decode into at most ``dst_len`` bytes (csnappy.h:107-119)."""
    cfg = _cfg(config)
    backend = backend or cfg.backend
    if backend == "py":
        return pymodel.decompress_noheader(src, dst_len)
    if backend == "native":
        from .runtime import native

        return native.decompress_noheader(src, dst_len)
    dev = _device(cfg, device)
    if dst_len <= wire.BLOCK_SIZE:
        from .ops import decode_fused

        arr = np.frombuffer(src, np.uint8)[None, :] if src else np.zeros((1, 1), np.uint8)
        out, produced, status = decode_fused.decode_blocks(
            arr, np.array([len(src)], np.int32), dst_len, dev)
        st = int(status[0])
        res = out[0, : int(produced[0])].cpu().numpy().tobytes()
    else:
        st, res = _decompress_stream_routed(src, dst_len, dev)
    raise_for_code(st)
    if cfg.debug_checks:
        assert pymodel.decompress_noheader(src, dst_len) == res, "oracle mismatch"
    return res


def decompress(src: bytes, dst_len: int | None = None, backend: str | None = None,
               config: CodecConfig | None = None, device=None) -> bytes:
    """Whole-stream decode with header parse + DoS length guard
    (csnappy_decompress.c:394-411)."""
    ulen, hdr = get_uncompressed_length(src)
    # a hostile 5-byte header can claim 2^32-1 bytes; no valid stream expands
    # beyond 64 output bytes per 3 compressed bytes (a COPY_2 of length 64),
    # so reject an impossible header before sizing any buffer
    body_len = len(src) - hdr
    if ulen > (body_len // 3 + 1) * 64:
        raise SnappyError(E_HEADER_BAD, f"header length {ulen} impossible for {body_len}-byte stream")
    if dst_len is None:
        dst_len = ulen
    if ulen > dst_len:
        raise SnappyError(E_OUTPUT_INSUF, f"header says {ulen}, buffer {dst_len}")
    out = decompress_noheader(src[hdr:], ulen, backend=backend, config=config, device=device)
    if len(out) != ulen:
        raise SnappyError(E_DATA_MALFORMED, f"produced {len(out)}, header said {ulen}")
    return out
