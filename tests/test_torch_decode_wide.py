"""Rows past 32 KiB in the port's block decoder (``ops/decode_fused``) on the CPU.

The plain version (``device="cpu"``), which carries the contract of the
card's wide kernels (``csrc/decode_wide.cu``), on the ``wide`` group of
``tests/data/torch_ref/wide.npz``: the ``w64k`` rows against what the JAX
package's ``decode_blocks`` returned at block_out 65,536 (but its known
faults, ``JAX_DECODE_FAULTS``), the periodic ``w70k`` row, where the JAX
kernel returns zeros from byte 69,632 with status 0, against the oracle and
not JAX, and the ``w256k`` and ``w1m`` rows against the oracle's stored
answers; every row also against the JAX package's own oracle
(``csnappy_tpu.models.pymodel``), live.  Then a numpy model of the wide
kernels' decomposition: the tag chain over chunks (pointer jumping, one
lookup a chunk, each segment's covering tag) held to a serial walk, and the
segments (covering tags, judgement as one minimum a row, 32-bit words of
values, local indices and earlier-row positions, local pointer jumping,
waits on the flags of the segments read) run under tickets in seeded
completion orders, held to the oracle on every ``wide`` row and on random
streams at segment sizes that make cross-segment reads common at small
sizes.  All exact: a decoder has no tolerance.
"""
import hashlib
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from csnappy_tpu_torch import errors
from csnappy_tpu_torch.models import pymodel, wire
from csnappy_tpu_torch.ops import decode_fused

# the suite runs in parallel worker processes: one intra-op thread each keeps
# the torch ops here from contending with every other worker
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = "cpu"


def _maker():
    spec = importlib.util.spec_from_file_location(
        "make_torch_fixtures", ROOT / "tools" / "make_torch_fixtures.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


MAKER = _maker()
REF = MAKER.read_wide()
GROUPS = MAKER.WIDE_GROUPS


def _rows(group: str) -> list[bytes]:
    comp, lens = REF[f"{group}_comp"], REF[f"{group}_lens"]
    return [comp[i, : lens[i]].tobytes() for i in range(len(lens))]


def _oracle(row: bytes, dlim: int) -> tuple[bytes, int]:
    try:
        return pymodel.decompress_noheader(row, dlim), errors.E_OK
    except errors.SnappyError as e:
        return b"", e.code


def _plain(group: str):
    out, prod, status = decode_fused.decode_blocks(REF[f"{group}_comp"], REF[f"{group}_lens"],
                                                   GROUPS[group], device=CPU)
    return out.numpy(), prod.numpy(), status.numpy()


# --------------------------------------------------------- the wide group


def test_wide_inputs_have_not_drifted(urls10k):
    built = MAKER.build_wide(urls10k)
    assert sorted(built) == sorted(GROUPS)
    for group, rows in built.items():
        assert _rows(group) == rows, group


def test_wide_fixture_shape():
    # JAX answers at 65,536 and 70,000; the oracle's alone at 2^18 and 2^20,
    # where compressed rows pass 65,535 B, a COPY_4 reads 100,000 back and
    # an offset-1 run spans the row
    assert GROUPS == {"w64k": 65536, "w70k": 70000, "w256k": 1 << 18, "w1m": 1 << 20}
    assert set(MAKER.WIDE_JAX) == {"w64k", "w70k"}
    assert max(REF["w64k_lens"]) < 65536 and min(REF["w256k_lens"][:1]) > 65535
    assert set(REF["w64k_status"].tolist()) == {0, errors.E_OUTPUT_OVERRUN, errors.E_DATA_MALFORMED}


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_wide_plain_equals_stored_oracle(group):
    out, prod, status = _plain(group)
    assert prod.tolist() == REF[f"{group}_oracle_prod"].tolist()
    assert status.tolist() == REF[f"{group}_oracle_status"].tolist()
    for i in range(len(prod)):
        assert hashlib.sha256(out[i].tobytes()).digest() == \
            REF[f"{group}_oracle_sha256"][i].tobytes(), (group, i)


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_wide_plain_equals_the_jax_packages_oracle(group):
    from csnappy_tpu import errors as jerrors
    from csnappy_tpu.models import pymodel as jpymodel

    out, prod, status = _plain(group)
    for i, row in enumerate(_rows(group)):
        try:
            want, code = jpymodel.decompress_noheader(row, GROUPS[group]), 0
        except jerrors.SnappyError as e:
            want, code = b"", e.code
        assert (int(prod[i]), int(status[i])) == (len(want), code), (group, i)
        assert out[i, : len(want)].tobytes() == want and not out[i, len(want):].any(), (group, i)


def test_wide_equals_jax():
    # every w64k row but the JAX package's known faults (the port answers as
    # the oracle there); after an event the JAX row's bytes are not compared
    group = "w64k"
    out, prod, status = _plain(group)
    rows = [i for i in range(len(prod)) if i not in MAKER.JAX_DECODE_FAULTS[group]]
    assert rows == [0, 1, 2, 3, 4, 5]
    assert prod[rows].tolist() == REF[f"{group}_prod"][rows].tolist()
    assert status[rows].tolist() == REF[f"{group}_status"][rows].tolist()
    for i in rows:
        assert np.array_equal(out[i, : prod[i]], REF[f"{group}_out"][i, : prod[i]]), (group, i)


def test_the_jax_fault_row_answers_as_the_oracle():
    # the periodic row at 70,000: JAX says status 0 with zeros from byte
    # 69,632 (17 x 4096) to the end; the port answers the oracle's bytes
    (row,) = _rows("w70k")
    assert MAKER.JAX_DECODE_FAULTS["w70k"] == (0,) and len(row) == 3293
    want, code = _oracle(row, 70000)
    jout = REF["w70k_out"][0]
    assert (REF["w70k_status"][0], REF["w70k_prod"][0]) == (0, 70000) == (code, len(want))
    diff = np.nonzero(jout != np.frombuffer(want, np.uint8))[0]
    assert diff.min() == 69632 and len(diff) == 368 and not jout[diff].any()
    out, prod, status = _plain("w70k")
    assert (int(prod[0]), int(status[0])) == (70000, 0) and out[0].tobytes() == want


def test_the_long_literal_fault_rows():
    # a literal of more than 32 KiB: JAX returns its tail as 0 with status 0
    # (JAX_DECODE_FAULTS), from byte 32,896 of a 33,000-byte literal at 0 and
    # from 33,792 of a 34,000-byte literal at 1,000; the port answers the oracle
    out, prod, status = _plain("w64k")
    for i, first, end in zip(MAKER.JAX_DECODE_FAULTS["w64k"], (32896, 33792), (33000, 35000)):
        want = np.frombuffer(_oracle(_rows("w64k")[i], 65536)[0], np.uint8)
        jout = REF["w64k_out"][i]
        diff = np.nonzero(jout != want)[0]
        assert REF["w64k_status"][i] == 0 and diff.min() == first and not jout[first:end].any()
        assert (int(prod[i]), int(status[i])) == (65536, 0) and out[i].tobytes() == want.tobytes()


@pytest.mark.parametrize("width", [65536, 131073, 1 << 18, 1 << 20])
def test_decode_segments_takes_wide_limits(width):
    # the w256k and w1m rows and a urls row as segments of one stream, each
    # at its own limit and all at `width`, read in place
    rows = _rows("w256k") + _rows("w1m")[1:] + _rows("w64k")[:1]
    body = b"".join(rows)
    offs = np.cumsum([0] + [len(r) for r in rows[:-1]])
    lens = [len(r) for r in rows]
    for dlim in ([width] * len(rows), [width, 70000, 0, width, width - 1, 65536]):
        out, prod, status = decode_fused.decode_segments(body, offs, lens, dlim, device=CPU)
        assert out.shape == (len(rows), max(dlim))
        for i, row in enumerate(rows):
            want, code = _oracle(row, dlim[i])
            assert (int(prod[i]), int(status[i])) == (len(want), code), (width, i)
            assert out[i, : len(want)].numpy().tobytes() == want and not out[i, len(want):].any()


def test_decode_blocks_takes_any_width_below_2_31():
    data = b"wide " * 24000
    frag = b"".join(pymodel.compress_fragment(data[i : i + 32768]) for i in range(0, 120000, 32768))
    arr = np.frombuffer(frag, np.uint8)[None, :]
    for width in (131073, 1 << 20):
        out, prod, status = decode_fused.decode_blocks(arr, [len(frag)], width, device=CPU)
        assert (int(prod[0]), int(status[0])) == (120000, 0) and out.shape == (1, width)
        assert out[0, :120000].numpy().tobytes() == data and not out[0, 120000:].any()
    for bad in (-1, 1 << 31):
        with pytest.raises(ValueError):
            decode_fused.decode_blocks(arr, [len(frag)], bad, device=CPU)


# ---------------- a model of the wide kernels' decomposition (decode_wide.cu)


def _parse_all(body: bytes, N: int):
    """Every position of ``body`` (and past it, to N) parsed as a tag, as the
    wide kernels parse: (bad, hdr, length, lit, off, adv) int64 arrays."""
    n = len(body)
    b = np.zeros(N + 8, np.int64)
    b[:n] = np.frombuffer(body, np.uint8)
    b0, b1, b2, b3, b4 = (b[k : k + N] for k in range(5))
    kind, u = b0 & 3, b0 >> 2
    lit = kind == 0
    nb = np.where(lit & (u >= 60), u - 59, 0)
    v = np.where(nb == 0, u, b1 | np.where(nb > 1, b2 << 8, 0) | np.where(nb > 2, b3 << 16, 0)
                 | np.where(nb > 3, b4 << 24, 0))
    hdr = np.where(lit, 1 + nb, np.choose(kind, [1, 2, 3, 5]))
    length = np.where(lit, v + 1, np.where(kind == 1, (u & 7) + 4, u + 1))
    off = np.where(kind == 1, ((u >> 3) << 8) | b1,
                   np.where(kind == 2, b1 | (b2 << 8), b1 | (b2 << 8) | (b3 << 16) | (b4 << 24)))
    avail = n - np.arange(N)
    bad = (avail <= 0) | (hdr > avail) | (lit & (hdr + length > avail))
    return bad, hdr, length, lit, np.where(lit, 0, off), hdr + np.where(lit, length, 0)


def chain_model(body: bytes, nseg: int, C: int, S: int, sub: int = 256):
    """wide_chain_kernel in numpy, chunks of C positions, segments of S
    bytes: every position's stop or exit tag in its chunk by pointer jumping
    (sub-chunks, then the chunk), one lookup a chunk, and each segment's
    covering tag written by the chunk that owns its start.  Returns (covers
    as [(position, os)] * nseg, (stop position, os at the stop), chunks
    entered)."""
    n = len(body)
    N = (n // C + 1) * C
    bad, hdr, length, lit, off, adv = _parse_all(body, N)
    pos = np.arange(N, dtype=np.int64)
    cstart = pos - pos % C
    sub_end = np.minimum(cstart + (pos % C // sub + 1) * sub, cstart + C)
    exits = ~bad & (pos + adv >= cstart + C)
    STOP, EXIT = 1, 2

    def jump(J, P, F, end, max_rounds):
        for r in range(max_rounds + 1):
            live = (F == 0) & (J < end)
            if not live.any():
                return
            assert r < max_rounds, "pointer jumping did not end within its bound"
            j = J[live]
            J[live], P[live], F[live] = J[j], P[live] + P[j], F[j]

    J1 = np.where(bad | exits, pos, pos + adv)
    P1 = np.where(bad | exits, 0, length)
    F1 = np.where(bad, STOP, np.where(exits, EXIT, 0))
    jump(J1, P1, F1, sub_end, (sub // 2).bit_length())
    J, P, F = J1.copy(), P1.copy(), F1.copy()
    jump(J, P, F, cstart + C, (-(-C // sub)).bit_length() + 1)
    assert (F != 0).all()

    visited, e, pp = [], 0, 0              # (entry, pp at entry, pp at exit or stop, stops)
    while True:
        x, at = int(J[e]), pp + int(P[e])
        if F[e] == STOP:
            visited.append((e, pp, at, True))
            stop = (x, at)
            break
        ex, out = x + int(adv[x]), at + int(length[x])
        assert cstart[e] + C <= ex <= n                     # lands in a later chunk
        visited.append((e, pp, out, False))
        e, pp = ex, out

    covers = [None] * nseg
    for e, pp, out, stops in visited:
        k1 = nseg - 1 if stops else min(-(-out // S) - 1, nseg - 1)
        for k in range(-(-pp // S), k1 + 1):
            assert covers[k] is None, "a cover written twice"
            if stops and k * S >= out:
                covers[k] = stop
                continue
            x, px, hit = e, pp, False
            while not hit:                           # sub-chunk hops
                py = px + int(P1[x])
                if py > k * S:
                    break
                hit = bool(F1[x])                    # the stop or the exit tag
                x, px = int(J1[x]), py
            while not hit:                           # then tags
                z, pz = x + int(adv[x]), px + int(length[x])
                if bad[x] or pz > k * S or z >= cstart[x] + C:
                    break
                x, px = z, pz
            covers[k] = (x, px)
    assert all(c is not None for c in covers), "a segment no chunk covered"
    return covers, stop, len(visited)


def serial_chain(body: bytes, nseg: int, S: int):
    """The reference for :func:`chain_model`: a serial walk of the tag chain
    (tags that parse, events unjudged), each segment's last tag with output
    start <= k * S, and the stop."""
    bad, hdr, length, lit, off, adv = _parse_all(body, len(body) + 1)
    x = os = 0
    covers, k = [], 0
    while True:
        nxt = os + (0 if bad[x] else int(length[x]))
        while k < nseg and (bad[x] or nxt > k * S):
            covers.append((x, os))
            k += 1
        if bad[x]:
            return covers, (x, os)
        x, os = x + int(adv[x]), nxt


class _Row:
    """One row's state in the device's memory: its head and its bytes."""

    def __init__(self, body, dlim, width, S, covers, stop):
        self.body, self.dlim, self.S = body, min(dlim, width), S
        self.covers, self.stop = covers, stop
        self.nseg = self.dlim // S + 1
        self.event = None                        # min (os << 1 | overrun)
        self.out = np.full(width, -1, np.int64)  # -1: never written
        self.flags = [False] * self.nseg
        self.read_unwritten = False              # harmless only in a row with an event
        self.parsed = _parse_all(body, len(body) + 1)


def segment_start(row: _Row, k: int):
    """wide_segment_kernel's block for segment k up to its wait: reads the
    row's event (skip), judges its tags and lowers the row's minimum, covers
    and resolves its words.  Returns (segments it reads, finish), where
    finish(row) writes its bytes once those flags are up."""
    S, n, dlim = row.S, len(row.body), row.dlim
    bad, hdr, length, lit, off, adv = row.parsed
    src = np.frombuffer(row.body, np.uint8).astype(np.int64)
    base = k * S
    hi, jhi = min(S, dlim - base), min(S, dlim + 1 - base)
    nothing = (set(), lambda r: None)
    if row.event is not None and row.event >> 1 < base:
        return nothing                           # an earlier event: no bytes needed
    x, os = row.covers[k]
    tags = []
    if os < base:
        if x == row.stop[0]:
            return nothing                       # the row's stream ended before
        tags.append((x, os))                     # the straddling tag, judged before
        x, os = x + int(adv[x]), os + int(length[x])
    judged = len(tags)
    while os - base < jhi and x < n:
        tags.append((x, os))
        if bad[x]:
            break
        x, os = x + int(adv[x]), os + int(length[x])
    for x, os in tags[judged:]:
        kind = None
        if bad[x] or (not lit[x] and not 0 < off[x] <= os):
            kind = 0
        elif os + length[x] > dlim:
            kind = 1
        if kind is not None:
            key = 2 * os + kind
            row.event = key if row.event is None else min(row.event, key)
            return nothing
    T = np.array([t[0] for t in tags], np.int64).reshape(-1)
    O = np.array([t[1] for t in tags], np.int64).reshape(-1)
    start = np.clip(O - base, 0, hi)
    end = np.clip(O + length[T] - base, 0, hi)
    cnt = np.maximum(end - start, 0)
    idx = np.repeat(np.arange(len(T)), cnt)
    covered = int(cnt.sum())
    assert covered == (int(end[-1]) if len(T) else 0)          # contiguous from the start
    i = np.arange(covered)
    t = T[idx]
    j = i + base - O[idx]
    o = np.maximum(off[t], 1)
    ok = lit[t] | ((off[t] > 0) & (off[t] <= O[idx]))     # a bad covering copy: its row fails
    parent = O[idx] - o + np.where(j < o, j, j % o)           # row position
    value = np.where(lit[t], src[np.minimum(t + hdr[t] + j, n - 1)], 0)
    # a word: a value (>= 0), a local index (-2 - index) or a row position
    # before the segment (-(2^40) + position), as the kernel's 32-bit words
    EXT = -(1 << 40)
    word = np.where(lit[t] | ~ok, value,
                    np.where(parent >= base, -2 - (parent - base), EXT + parent))
    assert ((word >= -1) | (-2 - word < i) | (word < EXT + base)).all()
    rounds = 0
    while True:                                  # resolve inside the segment
        local = (word <= -2) & (word > EXT + (1 << 39))
        if not local.any():
            break
        rounds += 1
        assert rounds <= max(1, covered - 1).bit_length() + 1
        word = np.where(local, word[np.where(local, -2 - word, 0)], word)
    ext = word < 0
    reads = set(((word[ext] - EXT) // S).tolist())
    assert all(s < k for s in reads)              # every wait points backwards

    def finish(r: _Row):
        got = word.copy()
        if ext.any():
            pos = word[ext] - EXT
            assert all(r.flags[s] for s in ((pos) // S).tolist())
            got[ext] = r.out[pos]
            r.read_unwritten |= bool((got[ext] < 0).any())
        r.out[base : base + covered] = got

    return reads, finish


def wide_model(bodies, dlims, width: int, S: int, C: int, seed: int):
    """The wide kernels in numpy on rows ``bodies`` with limits ``dlims`` in
    rows of ``width`` bytes: the chain, then the segments of every row under
    tickets taken in (row, segment) order, each block started, judged, left
    waiting and finished in an order drawn from ``seed`` (a block finishes
    only once the flags of the segments it reads are up), then the finish.
    Returns (out uint8[B, width], produced, status)."""
    rng = np.random.default_rng(seed)
    rows = []
    for body, dlim in zip(bodies, dlims):
        nseg = min(dlim, width) // S + 1
        covers, stop, _ = chain_model(body, nseg, C, S)
        rows.append(_Row(body, dlim, width, S, covers, stop))
    tickets = [(r, k) for r, row in enumerate(rows) for k in range(row.nseg)]
    started, nxt = {}, 0                          # ticket -> (reads, finish)
    while len(started) < len(tickets) or any(v is not None for v in started.values()):
        ready = [g for g, v in started.items() if v is not None
                 and all(rows[tickets[g][0]].flags[s] for s in v[0])]
        can_start = nxt < len(tickets)
        assert ready or can_start, "every started block waits: a deadlock"
        if can_start and (not ready or rng.random() < 0.5):
            r, k = tickets[nxt]
            started[nxt] = segment_start(rows[r], k)
            nxt += 1
        else:
            g = ready[int(rng.integers(len(ready)))]
            r, k = tickets[g]
            started[g][1](rows[r])
            rows[r].flags[k] = True
            started[g] = None
    out = np.zeros((len(rows), width), np.uint8)
    prod = np.zeros(len(rows), np.int32)
    status = np.zeros(len(rows), np.int32)
    for r, row in enumerate(rows):                # wide_finish_kernel
        if row.event is not None:
            status[r] = errors.E_OUTPUT_OVERRUN if row.event & 1 else errors.E_DATA_MALFORMED
            continue
        prod[r] = row.stop[1]
        assert row.stop[0] == len(row.body) and prod[r] <= row.dlim
        assert (row.out[: prod[r]] >= 0).all(), "a byte below produced never written"
        assert not row.read_unwritten, "a segment read a byte no segment wrote"
        out[r, : prod[r]] = row.out[: prod[r]]
    return out, prod, status


def _check_model(bodies, dlims, width, S, C, seed):
    out, prod, status = wide_model(bodies, dlims, width, S, C, seed)
    for i, (body, dlim) in enumerate(zip(bodies, dlims)):
        want, code = _oracle(body, dlim)
        assert (int(prod[i]), int(status[i])) == (len(want), code), (S, C, seed, i)
        assert out[i, : len(want)].tobytes() == want, (S, C, seed, i)


@pytest.mark.parametrize("C", [64, 1000, 8192])
@pytest.mark.parametrize("group", sorted(GROUPS))
def test_chain_model_equals_serial_walk(group, C):
    for body in _rows(group):
        nseg = GROUPS[group] // decode_fused.SEG + 1
        covers, stop, _ = chain_model(body, nseg, C, decode_fused.SEG)
        assert (covers, stop) == serial_chain(body, nseg, decode_fused.SEG)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("group", sorted(GROUPS))
def test_wide_model_equals_oracle_on_the_wide_group(group, seed):
    # the card's sizes: 8 KiB chunks, 32 KiB segments
    bodies = _rows(group)
    _check_model(bodies, [GROUPS[group]] * len(bodies), GROUPS[group], decode_fused.SEG,
                 1 << decode_fused.CHUNK_LOG, seed)


def _random_streams(rng, count: int) -> list[bytes]:
    """Valid streams with far and overlapping copies, and mutated copies of them."""
    out = []
    for _ in range(count):
        s, op = bytearray(), 0
        for _ in range(int(rng.integers(5, 60))):
            if op == 0 or rng.random() < 0.3:
                n = int(rng.integers(1, 90))
                wire.emit_literal(s, rng.integers(97, 100, n, dtype=np.uint8).tobytes())
                op += n
            else:
                n, o = int(rng.integers(1, 65)), int(rng.integers(1, op + 1))
                kind = int(rng.integers(2, 4))
                s += bytes([kind | ((n - 1) << 2)]) + o.to_bytes(2 if kind == 2 else 4, "little")
                op += n
        out.append(bytes(s))
        bad = bytearray(s)
        for _ in range(int(rng.integers(1, 4))):
            bad[int(rng.integers(0, len(bad)))] = int(rng.integers(0, 256))
        out.append(bytes(bad[: len(bad) - int(rng.integers(0, 3))]))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_wide_model_equals_oracle_on_random_streams(seed):
    # small segments and chunks: copies read many segments back, literals
    # and copies straddle segments, chunks are skipped, rows end at edges
    rng = np.random.default_rng(1000 + seed)
    bodies = _random_streams(rng, 6)
    lens = [len(_oracle(b, 1 << 20)[0]) or 64 for b in bodies]
    dlims = [int(rng.integers(0, n + 40)) if rng.random() < 0.3 else n for n in lens]
    S, C = [(64, 16), (100, 64), (48, 1000)][seed % 3]
    _check_model(bodies, dlims, max(dlims) + int(rng.integers(0, 50)), S, C, seed)


def test_wide_plan_counts_chunks_and_segments():
    plan = decode_fused.wide_plan([0, 8191, 8192, 100000], [70000, 32768, 0, 131072], 131072)
    assert plan.tolist() == [0, 1, 2, 4, 17, 0, 3, 5, 6, 11]
    on, nchunks, nseg = decode_fused.plan_on("cpu", [0, 8191, 8192, 100000],
                                             [70000, 32768, 0, 131072], 131072)
    assert on.tolist() == plan.tolist() and (nchunks, nseg) == (17, 11)
    assert decode_fused.wide_stamp_count(17, 11) == 17 * 8 + 11 * 13
