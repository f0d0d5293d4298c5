"""Mesh scale-out — data-parallel block codec over a ``torch.distributed`` group.

Port of ``csnappy_tpu/parallel/mesh.py``.  No back-reference crosses a
32 KiB block boundary (csnappy_compress.c:75-87), so blocks are independent
(SURVEY.md §2) and the design is the JAX package's (SURVEY.md §5):

  * every rank gets ``per = ceil(nb / world)`` consecutive blocks, its shard
    padded to ``per`` rows with empty ones;
  * each rank runs ONE codec kernel on its shard, on its own device, with no
    halo exchange: ``encode_fused.encode_blocks`` to compress,
    ``decode_fused.decode_segments`` to decompress;
  * the ranks all-gather the per-block lengths (a cheap int32 vector), from
    which every rank computes the same in-order offsets, then the payload
    rows, cut to the longest gathered length, and assemble them in block
    order.

The "mesh" is a process group, one process a rank.  The API is SPMD: every
rank of the group calls with the same arguments and gets the same answer.
Each call first all-gathers its arguments' sizes, so that ranks that
disagree, or a rank given invalid arguments, raise ``ValueError`` on every
rank instead of hanging the next collective.

The collectives' tensors follow the group's backend
(:func:`comm_device`): under NCCL they lie on the rank's card; under gloo,
which gathers no CUDA tensor, on the host, and a rank that runs its kernel
on the card (several ranks on one card, where NCCL refuses a second rank)
copies its lengths and rows to the host explicitly for the collective.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..config import resolve_device
from ..errors import raise_for_code
from ..models import wire
from ..ops import decode_fused, encode_fused


def default_mesh(n: int | None = None):
    """The world group, or with ``n`` the group of the first ``n`` ranks
    (``dist.new_group``, which every rank of the world must call).  Raises
    ``RuntimeError`` without an initialized process group: the port never
    runs quietly as one rank."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("no torch.distributed process group: call "
                           "csnappy_tpu_torch.parallel.multihost.init first")
    if n is None:
        return dist.group.WORLD
    world = dist.get_world_size()
    if not 1 <= n <= world:
        raise ValueError(f"n must lie in [1, {world}], got {n}")
    return dist.new_group(list(range(n)))


def comm_device(group) -> torch.device:
    """Where ``group``'s collectives take their tensors: the current card
    under NCCL, the host under gloo."""
    backend = dist.get_backend(group)
    if backend == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    if backend == "gloo":
        return torch.device("cpu")
    raise ValueError(f"unsupported backend {backend!r}")


def _rank(group) -> int:
    rank = dist.get_rank(group)
    if rank < 0:
        raise ValueError("this process is not a rank of the group")
    return rank


def all_gather(x: torch.Tensor, group, comm: torch.device) -> torch.Tensor:
    """Every rank's ``x`` (one shape on all), stacked in rank order on
    ``comm``.  ``x`` is copied to ``comm`` first where it lies elsewhere."""
    x = x.to(comm).contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.stack(parts)


def agree(group, comm: torch.device, values: list[int], error: str | None) -> None:
    """Gather every rank's argument sizes ``values`` and its ``error`` (None
    when its arguments are valid); raise ``ValueError`` on every rank when
    some rank's arguments are invalid or the ranks' ``values`` differ."""
    mine = torch.tensor([error is not None, *values], dtype=torch.int64)
    got = all_gather(mine, group, comm).cpu()
    if got[:, 0].any():
        bad = got[:, 0].nonzero().reshape(-1).tolist()
        raise ValueError(error or f"ranks {bad} were given invalid arguments")
    if not (got[:, 1:] == got[0, 1:]).all():
        raise ValueError(f"the ranks' arguments differ: {got[:, 1:].tolist()}")


def compress_sharded(data, mesh=None, bs: int = wire.BLOCK_SIZE, device=None) -> bytes:
    """Whole-stream compress with the blocks data-parallel over the group.

    Every rank passes the same ``data`` and gets the same stream, byte for
    byte the stream of ``encode_fused.compress_np(data, bs)``.  ``mesh``: a
    process group (None: :func:`default_mesh`); ``device``: where this rank
    runs its one ``encode_blocks`` launch (None: the current card, which
    ``multihost.init`` sets; raising without one)."""
    group = mesh if mesh is not None else default_mesh()
    rank, world = _rank(group), dist.get_world_size(group)
    dev, comm = resolve_device(device), comm_device(group)
    buf = np.frombuffer(data, np.uint8)
    n = len(buf)
    agree(group, comm, [n, bs],
          None if 1 <= bs <= wire.BLOCK_SIZE else f"bs must lie in [1, {wire.BLOCK_SIZE}]")
    out = bytearray(wire.varint_encode(n))
    if n == 0:
        return bytes(out)
    nb = -(-n // bs)
    per = -(-nb // world)
    lo, hi = min(rank * per, nb), min(rank * per + per, nb)
    pages = np.zeros((per, bs), np.uint8)
    mine = buf[lo * bs : hi * bs]
    pages.reshape(-1)[: len(mine)] = mine
    blens = np.zeros((per,), np.int32)              # padding rows: blen 0
    blens[: hi - lo] = bs
    if hi == nb > lo:
        blens[hi - lo - 1] = n - (nb - 1) * bs
    comp, clen = encode_fused.encode_blocks(torch.from_numpy(pages), blens, device=dev)
    # the gathered rows past nb are the shards' padding: cut them before compaction
    lens = all_gather(clen, group, comm).reshape(-1)[:nb]
    width = int(lens.max())
    rows = all_gather(comp[:, :width], group, comm).reshape(world * per, width)[:nb]
    out += encode_fused._compact(rows, lens)
    return bytes(out)


def decompress_fragments_sharded(frags, out_lens, mesh=None, device=None) -> list[bytes]:
    """Decode independent headerless fragments data-parallel over the group.

    Every fragment keeps its own limit ``out_lens[i]`` (in [0,
    ``decode_fused.MAX_WIDTH``]): one producing more is
    ``E_OUTPUT_OVERRUN``.  Each rank concatenates its fragments into one body
    and decodes them in place with one ``decode_segments`` launch.  The first
    failing fragment in global order raises ``SnappyError`` on every rank."""
    group = mesh if mesh is not None else default_mesh()
    rank, world = _rank(group), dist.get_world_size(group)
    dev, comm = resolve_device(device), comm_device(group)
    frags = [bytes(f) for f in frags]
    out_lens = [int(x) for x in out_lens]
    nb = len(frags)
    error = None
    if len(out_lens) != nb:
        error = f"{nb} fragments but {len(out_lens)} out_lens"
    elif any(not 0 <= x <= decode_fused.MAX_WIDTH for x in out_lens):
        error = f"out_lens must lie in [0, {decode_fused.MAX_WIDTH}]"
    agree(group, comm, [nb, sum(map(len, frags)), sum(out_lens)], error)
    if nb == 0:
        return []
    per = -(-nb // world)
    mine, lims = frags[rank * per : rank * per + per], out_lens[rank * per : rank * per + per]
    lens = np.zeros((per,), np.int64)              # padding rows: empty, limit 0
    dlims = np.zeros((per,), np.int64)
    lens[: len(mine)] = [len(f) for f in mine]
    dlims[: len(mine)] = lims
    offs = np.cumsum(lens) - lens
    out, produced, status = decode_fused.decode_segments(
        b"".join(mine) or b"\0", offs, lens, dlims, device=dev)
    meta = all_gather(torch.stack([produced, status]), group, comm).cpu()
    produced = meta[:, 0].reshape(-1)[:nb]
    status = meta[:, 1].reshape(-1)[:nb]
    failed = status.nonzero().reshape(-1)
    if failed.numel():
        i = int(failed[0])
        raise_for_code(int(status[i]), f"fragment {i}")
    width = int(produced.max())
    if width == 0:
        return [b""] * nb
    rows = (out[:, :width] if out.shape[1] >= width
            else torch.nn.functional.pad(out, (0, width - out.shape[1])))
    rows = all_gather(rows, group, comm).reshape(world * per, width)[:nb].cpu().numpy()
    return [rows[i, : int(produced[i])].tobytes() for i in range(nb)]
