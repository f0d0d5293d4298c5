"""Port's crossing-stream decoder (``csnappy_tpu_torch.ops.decode_stream``) on the CPU.

The thirteen cases of ``test_decode_stream.py`` through the plain version
(``device="cpu"``), which carries the CUDA kernel's contract: the JAX
kernel's envelope and event rules.  Then every stream of
``tests/data/torch_ref/streams.npz`` against what the JAX kernel returned
for it (``produced``, ``status``, sha256 of the bytes), the
exact-multiple-of-32768 case among them, where the JAX kernel and the
oracle differ; every stream of ``stream_adv.npz`` at its three limits
against the JAX kernel's answers.  Then a numpy model of the card kernel's
two-phase decomposition (``csrc/decode_stream.cu``): the tag chain over
chunks (pointer jumping, one lookup a chunk, each segment's covering tag)
held to a serial walk at chunk sizes that make skipped chunks and stops at
chunk edges occur at small sizes, and the segments (covering tags,
judgement as one minimum, parents counted from the segment before, local
resolution with external parents, then resolution in segment order) held
to ``decode_plain``.  All exact.
"""
import functools
import hashlib
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from csnappy_tpu_torch import api, errors
from csnappy_tpu_torch.models import pymodel, wire
from csnappy_tpu_torch.ops import decode_stream, encode_fused

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


STREAMS, REF = _maker().read_streams()


def _dec(body: bytes, ulen: int):
    return decode_stream.decompress_noheader_np(np.frombuffer(body, np.uint8), ulen, device=CPU)


def _split(stream: bytes):
    ulen, hdr = wire.varint_decode(stream)
    return stream[hdr:], ulen


def test_single_segment():
    data = b"hello world hello world hello"
    out, produced, status = _dec(pymodel.compress_fragment(data), len(data))
    assert status == errors.E_OK and out.tobytes() == data


def test_multisegment_own_stream(urls10k):
    big = urls10k[:150000]
    out, produced, status = _dec(*_split(pymodel.compress(big)))
    assert status == errors.E_OK and produced == len(big) and out.tobytes() == big


def test_golden_reference_stream(urls10k, urls10k_snappy):
    out, produced, status = _dec(*_split(urls10k_snappy))
    assert status == errors.E_OK and produced == len(urls10k) and out.tobytes() == urls10k


def test_straddling_literal_and_copy():
    raw = np.random.default_rng(3).integers(0, 256, 50000, dtype=np.uint8).tobytes()
    s = bytearray()
    wire.emit_literal(s, raw)
    s += bytes([wire.TAG_COPY_2 | ((64 - 1) << 2)]) + (1000).to_bytes(2, "little")
    want = raw + raw[-1000 : -1000 + 64]
    out, produced, status = _dec(bytes(s), len(want))
    assert status == errors.E_OK and out.tobytes() == want


def test_copy_across_segment_boundary():
    # copies whose sources lie in the previous segment, offset 32768 included
    raw = np.random.default_rng(6).integers(0, 256, 32768, dtype=np.uint8).tobytes()
    s = bytearray()
    wire.emit_literal(s, raw)
    s += (bytes([wire.TAG_COPY_2 | ((64 - 1) << 2)]) + (32768).to_bytes(2, "little")) * 3
    s += bytes([wire.TAG_COPY_1 | ((11 - wire.MIN_MATCH) << 2) | (7 << 5), 255])   # offset 2047
    want = bytearray(raw)
    for _ in range(3):
        want += want[-32768 : -32768 + 64]
    want += want[-2047 : -2047 + 11]
    out, produced, status = _dec(bytes(s), len(want))
    assert status == errors.E_OK and out.tobytes() == bytes(want)
    data = (b"abcdefgh" * 5000)[:40000]
    out, produced, status = _dec(*_split(pymodel.compress(data)))
    assert status == errors.E_OK and out.tobytes() == data


def test_giant_literal_decodes_bit_exact():
    # a single 100000-byte literal (an advance above 64 KiB) decodes in the
    # stream decoder, and through the API
    raw = np.random.default_rng(4).integers(0, 256, 100000, dtype=np.uint8).tobytes()
    s = bytearray()
    wire.emit_literal(s, raw)
    out, produced, status = _dec(bytes(s), len(raw))
    assert status == errors.E_OK and out.tobytes() == raw
    assert api.decompress_noheader(bytes(s), len(raw), device=CPU) == raw


def test_past_envelope_literal_rejected():
    # a literal of 2^24 + 4096 bytes is outside the envelope: E_DATA_MALFORMED,
    # never corruption (the API's re-decide on decode_jnp runs in the card
    # tests: its CPU version takes too long at this size)
    n = (1 << 24) + 4096
    raw = (b"\xa5\x5a\x01\xfe" * ((n + 3) // 4))[:n]
    s = bytearray()
    wire.emit_literal(s, raw)
    _, produced, status = _dec(bytes(s), n)
    assert (produced, status) == (0, errors.E_DATA_MALFORMED)


def test_adversarial(baddata3):
    _, _, status = _dec(_split(baddata3)[0], 1 << 20)
    assert status != errors.E_OK


def test_truncated_multisegment(urls10k):
    body, ulen = _split(pymodel.compress(urls10k[:100000]))
    _, _, status = _dec(body[:-1], ulen)
    assert status == errors.E_DATA_MALFORMED


def test_overrun_multisegment(urls10k):
    body, ulen = _split(pymodel.compress(urls10k[:100000]))
    _, _, status = _dec(body, ulen - 5000)
    assert status == errors.E_OUTPUT_OVERRUN


def test_api_wholestream(urls10k, urls10k_snappy, unaligned_bin, unaligned_snappy):
    assert api.decompress(urls10k_snappy, device=CPU) == urls10k
    assert api.decompress(unaligned_snappy, device=CPU) == unaligned_bin   # the crossing route


def test_fuzz_multisegment_vs_oracle():
    rng = np.random.default_rng(77)
    fuzz = _maker()._fuzz_stream
    for trial in range(4):
        data = fuzz(rng, trial)
        out, produced, status = _dec(*_split(pymodel.compress(data)))
        assert status == errors.E_OK and out.tobytes() == data, trial


def test_fuzz_encoder_stream_through_stream_decoder(urls10k):
    data = urls10k[:100000]
    out, produced, status = _dec(*_split(encode_fused.compress_np(data, device=CPU)))
    assert status == errors.E_OK and out.tobytes() == data


# ---------------------------------------------------- against the JAX kernel


@pytest.mark.parametrize("i", range(len(STREAMS)), ids=[s[0] for s in STREAMS])
def test_stream_equals_jax(i):
    _, body, dst = STREAMS[i]
    out, produced, status = _dec(body, dst)
    assert (produced, status) == (REF["st_prod"][i], REF["st_status"][i])
    assert hashlib.sha256(out.tobytes()).digest() == REF["st_sha"][i].tobytes()


def test_full_at_a_multiple_of_32768_is_malformed():
    # output exactly full at 65536 with tags left: the JAX kernel's
    # E_DATA_MALFORMED (not consumed), where the oracle says E_OUTPUT_OVERRUN
    i = [s[0] for s in STREAMS].index("full_at_65536_with_tags_left")
    _, body, dst = STREAMS[i]
    assert REF["st_status"][i] == errors.E_DATA_MALFORMED
    assert _dec(body, dst)[2] == errors.E_DATA_MALFORMED
    with pytest.raises(errors.SnappyError) as e:
        pymodel.decompress_noheader(body, dst)
    assert e.value.code == errors.E_OUTPUT_OVERRUN
    assert _dec(body, dst + 1)[2] == errors.E_OUTPUT_OVERRUN


def test_fixture_covers_every_status():
    assert set(REF["st_status"].tolist()) == {0, errors.E_OUTPUT_OVERRUN, errors.E_DATA_MALFORMED}


def test_zero_limit_and_empty_stream():
    assert _dec(b"", 0)[1:] == (0, errors.E_OK)
    assert _dec(b"\x00a", 0)[1:] == (0, errors.E_OUTPUT_OVERRUN)
    assert _dec(b"\x04a", 0)[1:] == (0, errors.E_DATA_MALFORMED)    # truncated before the overrun
    out, produced, status = decode_stream.decode_stream(b"\x00a", 40000, device=CPU)
    assert out.numel() == 64 and (int(produced), int(status)) == (1, errors.E_OK)


# ------------------------------------------------ the adversarial stream group

MAKER = _maker()
ADV, ADV_REF = MAKER.read_stream_adv()


def test_stream_adv_inputs_rebuild():
    assert MAKER.load_stream_adv() == ADV
    assert ADV_REF["limits"].tolist() == [list(MAKER.stream_limits(d)) for _, _, d in ADV]


@pytest.mark.parametrize("i", range(len(ADV)), ids=[s[0] for s in ADV])
def test_stream_adv_equals_jax(i):
    # every limit: exact, -5000 and the multiple of 32768
    _, body, _ = ADV[i]
    for j, cap in enumerate(ADV_REF["limits"][i].tolist()):
        out, produced, status = _dec(body, cap)
        assert (produced, status) == (ADV_REF["jax_prod"][i][j], ADV_REF["jax_status"][i][j]), cap
        assert hashlib.sha256(out.tobytes()).digest() == ADV_REF["jax_sha"][i][j].tobytes(), cap


def test_stream_adv_envelope_differs_from_the_oracle_where_expected():
    # the JAX envelope (offset 32769) and the exactly-full rule are the only
    # places where the JAX answers and the oracle's differ
    names = [s[0] for s in ADV]
    diff = {(names[i], j) for i in range(len(ADV)) for j in range(3)
            if ADV_REF["jax_status"][i][j] != ADV_REF["oracle_status"][i][j]}
    assert diff == {("late_offset_32769", 0), ("one_byte_literals_hdr1", 2),
                    ("one_byte_literals_hdr5", 2), ("full_at_163840_with_tags_left", 0),
                    ("full_at_163840_with_tags_left", 2)}


# ------------------------- a model of the card kernel's two-phase decomposition

S = decode_stream.SEG
SUB = 256            # the chain kernel's sub-chunks (kSubLog = 8)


def _parse_all(body: bytes, N: int):
    """Every position of ``body`` (and past it, to N) parsed as a tag under the
    kernel's envelope: (bad, hdr, length, lit, off, adv) int64 arrays."""
    n = len(body)
    b = np.zeros(N + 8, np.int64)
    b[:n] = np.frombuffer(body, np.uint8)
    b0, b1, b2, b3, b4 = (b[k : k + N] for k in range(5))
    kind, u = b0 & 3, b0 >> 2
    lit = kind == 0
    nb = np.where(lit & (u >= 60), u - 59, 0)
    v = np.where(nb == 0, u, b1 | np.where(nb > 1, b2 << 8, 0) | np.where(nb > 2, b3 << 16, 0))
    hdr = np.where(lit, 1 + nb, np.choose(kind, [1, 2, 3, 5]))
    length = np.where(lit, v + 1, np.where(kind == 1, (u & 7) + 4, u + 1))
    off = np.where(kind == 1, ((u >> 3) << 8) | b1,
                   np.where(kind == 2, b1 | (b2 << 8), b1 | (b2 << 8) | (b3 << 16) | (b4 << 24)))
    avail = n - np.arange(N)
    bad = (avail <= 0) | (hdr > avail) | (lit & (hdr + length > avail)) | (lit & (nb == 4) & (b4 != 0))
    return bad, hdr, length, lit, np.where(lit, 0, off), hdr + np.where(lit, length, 0)


def chain_model(body: bytes, nseg: int, C: int):
    """Phase 1 of ``csrc/decode_stream.cu`` in numpy, chunk size C: every
    position's stop or exit tag in its chunk by pointer jumping (sub-chunks,
    then the chunk), one lookup a chunk, and each segment's covering tag
    written by the chunk that owns its start.  Returns (covers as
    [(position, os)] * nseg, (stop position, os at the stop))."""
    n = len(body)
    N = (n // C + 1) * C
    bad, hdr, length, lit, off, adv = _parse_all(body, N)
    pos = np.arange(N, dtype=np.int64)
    cstart = pos - pos % C
    sub_end = np.minimum(cstart + (pos % C // SUB + 1) * SUB, cstart + C)
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
    jump(J1, P1, F1, sub_end, (SUB // 2).bit_length())
    J, P, F = J1.copy(), P1.copy(), F1.copy()
    jump(J, P, F, cstart + C, (-(-C // SUB)).bit_length() + 1)
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
    return covers, stop


def serial_chain(body: bytes, nseg: int):
    """The reference for :func:`chain_model`: a serial walk of the tag chain
    (valid tags under the envelope, copy offsets unjudged), each segment's
    last tag with output start <= k * 32768, and the stop."""
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


def segment_model(body: bytes, dst_len: int, covers, stop):
    """Phase 2 of ``csrc/decode_stream.cu`` in numpy: each 32 KiB segment from
    its covering tag, its tags judged (events as one minimum), its bytes
    covered with one-hop parents counted from segment k - 1's start, resolved
    inside the segment with external parents kept, then the externals read
    from segment k - 1's final bytes in segment order.  Returns (bytes,
    produced, status), as the plain version, and the largest resolve rounds."""
    n = len(body)
    cap, limit = decode_stream._limits(n, dst_len)
    nseg = cap // S + 1
    bad, hdr, length, lit, off, adv = _parse_all(body, n + 1)
    src = np.frombuffer(body, np.uint8).astype(np.int64)
    ev, finals, most = None, [], 0
    for k in range(nseg):
        base = k * S
        hi, jhi = min(S, cap - base), min(S, cap + 1 - base)
        x, os = covers[k]
        tags = []
        if os < base:
            if x == stop[0]:
                finals.append(np.zeros(0, np.int64))
                continue
            tags.append((x, os))                 # the straddling tag, judged before
            x, os = x + int(adv[x]), os + int(length[x])
        judged = len(tags)
        while os - base < jhi and x < n:
            tags.append((x, os))
            if bad[x]:
                break
            x, os = x + int(adv[x]), os + int(length[x])
        for x, os in tags[judged:]:
            kind = None
            if bad[x] or os >= limit or (not lit[x] and not 0 < off[x] <= min(decode_stream.MAX_OFFSET, os)):
                kind = 0
            elif os + length[x] > cap:
                kind = 1
            if kind is not None:
                key = 2 * os + kind
                ev = key if ev is None else min(ev, key)
                break
        if ev is not None:
            finals.append(np.zeros(0, np.int64))
            continue                             # an event: no bytes needed
        T = np.array([t[0] for t in tags], np.int64).reshape(-1)
        O = np.array([t[1] for t in tags], np.int64).reshape(-1)
        start = np.clip(O - base, 0, hi) if hi > 0 else O * 0
        end = np.clip(O + length[T] - base, 0, max(hi, 0))
        cnt = np.maximum(end - start, 0)
        idx = np.repeat(np.arange(len(T)), cnt)
        covered = int(cnt.sum())
        assert covered == (int(end[-1]) if len(T) else 0)          # contiguous from the start
        i = np.arange(covered)
        t = T[idx]
        j = i + base - O[idx]
        o = np.maximum(off[t], 1)
        par = np.where(lit[t], i + S, O[idx] - o + np.where(j < o, j, j % o) - (base - S))
        assert ((par >= 0) & (par < 2 * S) & (lit[t] | (par - S < i))).all()
        val = np.where(lit[t], src[np.minimum(t + hdr[t] + j, n - 1)], 0)
        rounds = 0
        while True:                              # resolve inside the segment
            internal = par >= S
            q = par.copy()
            q[internal] = par[par[internal] - S]
            move = internal & (q != par)
            if not move.any():
                break
            rounds += 1
            par = np.where(move, q, par)
        assert rounds <= max(1, covered - 1).bit_length() + 1
        most = max(most, rounds)
        ext = par < S
        assert k > 0 or not ext.any()
        out = np.where(par >= S, val[np.clip(par - S, 0, max(covered - 1, 0))], 0)
        if ext.any():
            prev = finals[k - 1]
            assert (par[ext] < len(prev)).all()
            out[ext] = prev[par[ext]]
        finals.append(out)
    allb = np.concatenate(finals) if finals else np.zeros(0, np.int64)
    if ev is not None:
        return b"", 0, (errors.E_OUTPUT_OVERRUN if ev & 1 else errors.E_DATA_MALFORMED), most
    produced = stop[1]
    assert stop[0] == n and len(allb) >= produced
    return allb[:produced].astype(np.uint8).tobytes(), produced, errors.E_OK, most


MODEL_CASES = ([("streams", n, b, d) for n, b, d in STREAMS]
               + [("stream_adv", n, b, d) for n, b, d in ADV])


@functools.cache
def _serial(i: int, nseg: int):
    return serial_chain(MODEL_CASES[i][2], nseg)


def _model_nseg(i: int) -> int:
    _, _, body, dst = MODEL_CASES[i]
    return decode_stream._limits(len(body), dst)[0] // S + 1


@pytest.mark.parametrize("C", [64, 1000, 8192])
@pytest.mark.parametrize("i", range(len(MODEL_CASES)), ids=[f"{g}-{n}" for g, n, _, _ in MODEL_CASES])
def test_chain_model_equals_serial_walk(i, C):
    # the chunked chain gives every segment's covering tag and the stop
    _, _, body, _ = MODEL_CASES[i]
    nseg = _model_nseg(i)
    assert chain_model(body, nseg, C) == _serial(i, nseg)


@pytest.mark.parametrize("i", range(len(MODEL_CASES)), ids=[f"{g}-{n}" for g, n, _, _ in MODEL_CASES])
def test_segment_model_equals_plain(i):
    # exact, -5000 and the multiple of 32768: the segments from their covers
    # give decode_plain's bytes, produced and status
    _, _, body, dst = MODEL_CASES[i]
    for cap in MAKER.stream_limits(dst):
        nseg = decode_stream._limits(len(body), cap)[0] // S + 1
        covers, stop = _serial(i, max(nseg, _model_nseg(i)))
        got, produced, status, _ = segment_model(body, cap, covers[:nseg], stop)
        out, pprod, pstatus = _dec(body, cap)
        assert (produced, status) == (pprod, pstatus), cap
        assert got == out.tobytes(), cap
