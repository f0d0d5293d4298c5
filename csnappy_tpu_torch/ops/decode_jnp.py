"""General Snappy decoder as torch ops (port of ``csnappy_tpu/ops/decode_jnp.py``).

The JAX module is XLA only, with no Pallas kernel, so this port is tensor
ops that run wherever their tensors lie: on the card by default, on the CPU
with ``device="cpu"``.  It serves the streams no fast kernel takes: copy
offsets above 32768 (``runtime/native.scan_segments`` rc 2) and the
``E_DATA_MALFORMED`` re-decide after ``decode_stream``.

Both sequential chains of the format are broken by pointer doubling:

* tag boundaries: every byte position is parsed as if a tag started there,
  which defines a successor ``nxt[p]``; the real tags are the orbit of 0,
  marked by doubled jump pointers (a scatter "amax" frontier), and each
  tag's output start falls out of the doubled suffix sums;
* copies: every output byte gets its covering tag (scatter, then cummax);
  literal bytes point into the input, copy bytes ``offset`` back into the
  output, and that parent chain is doubled down to a literal byte.

The JAX module's own rules are kept, where they differ from the oracle's:
any reached malformed tag or copy beats an overrun whatever the order; a
literal is too big when it is longer than the padded input ``P``; a copy
error past ``out_cap = _bucket(dst_len)`` goes unseen; COPY_4 offsets of
2^31 or more wrap negative in int32 (and are malformed).  Arithmetic is
int32 where the JAX code's is; indices are int64, as torch's gathers need.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import refuse_card_tensors, resolve_device
from ..errors import E_DATA_MALFORMED, E_OK, E_OUTPUT_OVERRUN
from ..models import wire

I32 = torch.int32


def _ceil_log2(n: int) -> int:
    return max(1, int(n - 1).bit_length())


def _parse_all_positions(comp: torch.Tensor, src_len: int, out_cap: int) -> dict:
    """Speculative parse of a tag at every position of ``comp`` (int32[P], 0..255)."""
    P = comp.shape[0]
    ext = torch.cat([comp, comp.new_zeros(4)])
    b1, b2, b3, b4 = (ext[k : k + P] for k in range(1, 5))
    kind = comp & 3
    u = comp >> 2
    is_lit = kind == wire.TAG_LITERAL

    # literal length: inline (u < 60) or 1-4 LE trailer bytes holding len-1,
    # in uint32 arithmetic (int64 here): len wraps to 0 iff the trailer is 2^32-1
    extra = (u - 59).clamp(0, 4)
    le4 = (b1.long() | (b2.long() << 8) | (b3.long() << 16) | (b4.long() << 24))
    trailer = torch.where(extra > 0, le4 & ((1 << (8 * extra.clamp(min=1).long())) - 1), 0)
    lit_len_u = (trailer + 1) & 0xFFFFFFFF
    lit_too_big = (u >= 60) & ((lit_len_u == 0) | (lit_len_u > P))
    lit_len = torch.where(u >= 60, lit_len_u.clamp(max=P).to(I32), u + 1)

    hdr = torch.where(is_lit, 1 + extra, torch.where(
        kind == wire.TAG_COPY_1, 2, torch.where(kind == wire.TAG_COPY_2, 3, 5)).to(I32))
    copy_len = torch.where(kind == wire.TAG_COPY_1, (u & 7) + wire.MIN_MATCH, u + 1)
    off4 = torch.where(le4 >= 1 << 31, le4 - (1 << 32), le4).to(I32)   # int32 wrap
    copy_off = torch.where(kind == wire.TAG_COPY_1, ((u >> 3) << 8) | b1,
                           torch.where(kind == wire.TAG_COPY_2, b1 | (b2 << 8), off4))

    produced = torch.where(is_lit, lit_len, copy_len)
    advance = hdr + torch.where(is_lit, lit_len, 0)
    pos = torch.arange(P, dtype=I32, device=comp.device)
    in_range = pos < src_len
    tag_err = in_range & ((pos + advance > src_len) | (is_lit & lit_too_big))
    usable = in_range & ~tag_err
    return dict(
        pos=pos, kind=kind, copy_off=copy_off, tag_err=tag_err,
        nxt=torch.where(usable, (pos + advance).clamp(max=P), P),
        produced=torch.where(usable, produced.clamp(max=out_cap + 1), 0).to(I32),
        lit_src=pos + hdr,                      # literal payload starts after the header
    )


def _resolve_tag_chain(nxt: torch.Tensor, produced: torch.Tensor):
    """Pointer doubling over the successor graph: (is_tag[P], out_start[P], total_out)."""
    P = nxt.shape[0]
    J = torch.cat([nxt.long(), nxt.new_full((1,), P).long()])   # sentinel P: a self-loop
    S = torch.cat([produced, produced.new_zeros(1)])
    m = torch.zeros(P + 1, dtype=I32, device=nxt.device)
    m[0] = 1
    for _ in range(_ceil_log2(P + 1) + 1):
        m = m.scatter_reduce(0, J, m, "amax", include_self=True)
        S = S + S[J]
        J = J[J]
        if bool((J == P).all()):      # every chain is at the sentinel: later rounds change nothing
            break
    total_out = S[0]
    return m[:P] > 0, total_out - S[:P], total_out


def _materialize(comp, tags, is_tag, out_start, total_out, out_cap: int):
    """Output bytes (int32[out_cap]) and whether any reached copy is malformed."""
    P = comp.shape[0]
    dev = comp.device
    # covering tag of every output byte: tag ids at their output starts, then
    # a forward fill (real tags produce >= 1 byte, so starts never collide)
    scat = torch.where(is_tag & (out_start >= 0) & (out_start < out_cap), out_start, out_cap)
    cover = torch.full((out_cap + 1,), -1, dtype=I32, device=dev).scatter_reduce(
        0, scat.long(), torch.where(is_tag, tags["pos"], -1), "amax", include_self=True)[:out_cap]
    cover = torch.cummax(cover, 0).values
    cp = cover.clamp(0, P - 1).long()
    t_kind, t_os = tags["kind"][cp], out_start[cp]
    t_off, t_lit_src = tags["copy_off"][cp], tags["lit_src"][cp]

    o = torch.arange(out_cap, dtype=I32, device=dev)
    live = (o < total_out) & (cover >= 0)
    is_copy = live & (t_kind != wire.TAG_LITERAL)
    parent = torch.where(is_copy, o - t_off, o)
    copy_err = is_copy & ((t_off <= 0) | (parent < 0))
    parent = parent.clamp(0, out_cap - 1).long()
    for _ in range(_ceil_log2(out_cap) + 1):
        nxt = parent[parent]
        if torch.equal(nxt, parent):  # every chain is at its literal byte
            break
        parent = nxt
    # parent is now a literal byte: its input position, then its value
    root_src = (t_lit_src + (o - t_os)).clamp(0, P - 1).long()
    out = torch.where(live, comp[root_src[parent]], 0)
    return out, copy_err.any()


def _decode_core(comp: torch.Tensor, src_len: int, dst_limit: int, out_cap: int):
    """comp: int32[P] (0..255).  Returns (out int32[out_cap], produced, status), 0-d tensors."""
    tags = _parse_all_positions(comp, src_len, out_cap)
    is_tag, out_start, total_out = _resolve_tag_chain(tags["nxt"], tags["produced"])
    out, copy_err = _materialize(comp, tags, is_tag, out_start, total_out, out_cap)
    # a tag that overshoots src_len is in tag_err and still reached, so every
    # truncation is malformed; landing exactly on src_len is the clean exit
    malformed = (is_tag & tags["tag_err"]).any() | copy_err
    status = torch.where(malformed, E_DATA_MALFORMED,
                         torch.where(total_out > dst_limit, E_OUTPUT_OVERRUN, E_OK))
    return out, torch.where(status == E_OK, total_out, 0), status


def _bucket(n: int, quantum: int = 4096) -> int:
    """The JAX module's shape buckets: powers of two with two mid-points.  The
    port keeps them because they are semantics here: ``P`` bounds a literal."""
    n = max(n, quantum)
    p = 1 << (n - 1).bit_length()
    for cand in (p // 2, p * 5 // 8, p * 3 // 4, p):
        if cand >= n and cand % quantum == 0:
            return cand
    return p


def _counted(wrapper, dev: torch.device) -> None:
    if dev.type == "cuda":
        wrapper.launches += 1


def decompress_noheader_np(src, dst_len: int, device=None) -> tuple[np.ndarray, int, int]:
    """Decode a headerless tag stream (uint8 array, bytes or tensor) on ``device``.

    Returns (out uint8[produced], produced, status) — status in the
    CSNAPPY error codes; on error ``out`` is empty and ``produced`` 0.
    """
    dev = resolve_device(device)
    refuse_card_tensors(dev, src)
    flat = (src if isinstance(src, torch.Tensor)
            else torch.from_numpy(np.frombuffer(bytes(src), np.uint8).copy())).reshape(-1)
    n = flat.numel()
    P = _bucket(max(n, 8))
    comp = torch.zeros(P, dtype=I32, device=dev)
    comp[:n] = flat.to(dev)
    out, produced, status = _decode_core(comp, n, dst_len, _bucket(max(dst_len, 8)))
    _counted(decompress_noheader_np, dev)
    status = int(status)
    if status != E_OK:
        return np.zeros(0, np.uint8), 0, status
    produced = int(produced)
    return out[:produced].to(torch.uint8).cpu().numpy(), produced, status


def decode_blocks(comp, src_lens, block_out: int, device=None):
    """Batched headerless decode of independent blocks (zram mode).

    comp: uint8[B, P]; src_lens: int[B]; each block may produce at most
    ``block_out`` bytes.  Returns (out uint8[B, block_out], produced int32[B],
    status int32[B]) on ``device``.
    """
    dev = resolve_device(device)
    refuse_card_tensors(dev, comp, src_lens)
    comp = torch.as_tensor(np.asarray(comp) if not isinstance(comp, torch.Tensor) else comp)
    lens = (src_lens.cpu() if isinstance(src_lens, torch.Tensor)
            else torch.as_tensor(np.asarray(src_lens))).tolist()
    rows = comp.to(dev).to(I32)
    outs, prods, stats = [], [], []
    for b in range(rows.shape[0]):
        o, p, s = _decode_core(rows[b], int(lens[b]), block_out, block_out)
        outs.append(o.to(torch.uint8))
        prods.append(p)
        stats.append(s)
    _counted(decode_blocks, dev)
    return torch.stack(outs), torch.stack(prods).to(I32), torch.stack(stats).to(I32)


decompress_noheader_np.launches = 0
decode_blocks.launches = 0
