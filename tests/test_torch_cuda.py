"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is
false (decided inside the ``card`` fixture, never at import).  The machine
with the card need not have JAX, so the file brings its own data fixtures
and runs without ``tests/conftest.py``:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

The kernels build from ``csnappy_tpu_torch/csrc`` at first use.  Outputs are
bytes, compared exactly.
"""
import pathlib

import numpy as np
import pytest
import torch

from csnappy_tpu_torch import api
from csnappy_tpu_torch.models import pymodel, wire
from csnappy_tpu_torch.ops import decode_fused, encode_fused
from csnappy_tpu_torch.ops import kernel_lib as kl
from csnappy_tpu_torch.ops import primitives as prim
from csnappy_tpu_torch.tools import probe as pb

pytestmark = pytest.mark.cuda
DATA = pathlib.Path(__file__).parent / "data"


@pytest.fixture(scope="module")
def urls10k() -> bytes:
    return (DATA / "urls.10K").read_bytes()


@pytest.fixture(scope="module")
def urls10k_snappy() -> bytes:
    return (DATA / "urls.10K.snappy").read_bytes()


@pytest.fixture(scope="module")
def baddata3() -> bytes:
    return (DATA / "baddata3.snappy").read_bytes()


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _pack(frags):
    arr = np.zeros((len(frags), max(1, max(len(f) for f in frags))), np.uint8)
    for i, f in enumerate(frags):
        arr[i, : len(f)] = np.frombuffer(f, np.uint8)
    return arr, np.array([len(f) for f in frags], np.int32)


def _mutants(base: bytes, n: int, seed: int):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        b = bytearray(base)
        for _k in range(int(rng.integers(1, 6))):
            b[int(rng.integers(0, len(b)))] = int(rng.integers(0, 256))
        out.append(bytes(b))
    return out


@pytest.mark.parametrize("cap", [0, 4, 4096, 32768])
def test_decode_kernel_equals_plain(card, urls10k, baddata3, cap):
    frags = [pymodel.compress_fragment(urls10k[i * 32768 : (i + 1) * 32768]) for i in range(3)]
    frags += [b"", b"\xc4foooooo", baddata3[wire.varint_decode(baddata3)[1]:],
              pymodel.compress_fragment(b"a" * 32768)]
    frags += _mutants(frags[0], 8, seed=cap)
    arr, lens = _pack(frags)
    got = decode_fused.decode_blocks(torch.from_numpy(arr).to(card), lens, cap, device=card)
    torch.cuda.synchronize()
    want = decode_fused.decode_blocks(arr, lens, cap, device="cpu")
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("cap", [100, 32768])
def test_decode_kernel_fuzz_equals_plain(card, urls10k, cap):
    # random bytes, truncations and byte mutations of valid fragments: the
    # kernel must decide each exactly as the plain version does
    rng = np.random.default_rng(cap + 1)
    base = [pymodel.compress_fragment(urls10k[i * 4096 : (i + 1) * 4096]) for i in range(16)]
    frags = [rng.integers(0, 256, int(rng.integers(1, 64)), dtype=np.uint8).tobytes()
             for _ in range(64)]
    frags += [f[: int(rng.integers(1, len(f)))] for f in base]
    for f in base:
        frags += _mutants(f, 8, seed=int(rng.integers(1 << 30)))
    arr, lens = _pack(frags)
    got = decode_fused.decode_blocks(arr, lens, cap, device=card)
    torch.cuda.synchronize()
    want = decode_fused.decode_blocks(arr, lens, cap, device="cpu")
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert set(want[2].tolist()) >= {-5}


@pytest.mark.parametrize("cap", [70000, decode_fused.MAX_BLOCK_OUT])
def test_decode_kernel_wide_rows_and_far_copy4(card, cap):
    # rows wider than 64 KiB, and a COPY_4 offset above 65535 kept at 32 bits
    lit = np.random.default_rng(cap).integers(0, 256, 66000, dtype=np.uint8).tobytes()
    far = bytearray()
    wire.emit_literal(far, lit)
    far += bytes([wire.TAG_COPY_4 | ((64 - 1) << 2)]) + (66000).to_bytes(4, "little")
    run = bytearray(b"\x04ab") + bytes([wire.TAG_COPY_2 | (63 << 2), 2, 0]) * 937   # 59970 B
    frags = [bytes(far), bytes(run), bytes(far[:-1])]
    arr, lens = _pack(frags)
    got = decode_fused.decode_blocks(arr, lens, cap, device=card)
    torch.cuda.synchronize()
    want = decode_fused.decode_blocks(arr, lens, cap, device="cpu")
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert got[2].tolist() == [0, 0, -5]
    assert got[0][0, : int(got[1][0])].cpu().numpy().tobytes() == \
        pymodel.decompress_noheader(bytes(far), cap)


def test_decode_segments_kernel_equals_plain(card, urls10k_snappy, urls10k):
    from csnappy_tpu_torch.runtime import native

    body = urls10k_snappy[wire.varint_decode(urls10k_snappy)[1]:]
    rc, offs, _ = native.scan_segments(body, len(urls10k))
    lens = np.diff(np.append(offs, len(body)))
    dl = np.minimum(32768, len(urls10k) - np.arange(len(offs)) * 32768)
    got = decode_fused.decode_segments(body, offs, lens, dl, device=card)
    torch.cuda.synchronize()
    want = decode_fused.decode_segments(body, offs, lens, dl, device="cpu")
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("bs", [1024, 32768])
def test_encode_kernel_equals_plain(card, urls10k, bs):
    rng = np.random.default_rng(bs)
    B = 8
    data = np.zeros((B, bs), np.uint8)
    blens = rng.integers(0, bs + 1, B).astype(np.int32)
    blens[0] = bs
    for i in range(B):
        row = (np.frombuffer(urls10k[i * bs : (i + 1) * bs], np.uint8) if i % 2 == 0
               else rng.integers(0, 4, bs, dtype=np.uint8) * 65)
        data[i, : blens[i]] = row[: blens[i]]
    got = encode_fused.encode_blocks(torch.from_numpy(data).to(card), blens, device=card)
    torch.cuda.synchronize()
    want = encode_fused.encode_blocks(data, blens, device="cpu")
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def test_api_runs_the_kernels(card, urls10k, urls10k_snappy):
    wrappers = (decode_fused.decode_blocks, decode_fused.decode_segments,
                encode_fused.encode_blocks)
    before = [w.launches for w in wrappers]
    comp = api.compress(urls10k)                  # device=None: the card
    assert api.decompress(comp) == urls10k
    assert api.decompress(urls10k_snappy) == urls10k
    assert api.decompress_noheader(api.compress_fragment(urls10k[:1000]), 1000) == urls10k[:1000]
    assert all(w.launches > b for w, b in zip(wrappers, before))


def test_card_tensor_with_cpu_device_raises(card, urls10k):
    # a tensor on the card is never copied back to run the plain version
    frag = pymodel.compress_fragment(urls10k[:1000])
    arr, lens = _pack([frag])
    comp = torch.from_numpy(arr).to(card)
    with pytest.raises(ValueError, match="CUDA tensor"):
        decode_fused.decode_blocks(comp, lens, 1000, device="cpu")
    with pytest.raises(ValueError, match="CUDA tensor"):
        decode_fused.decode_segments(comp.reshape(-1), [0], lens, 1000, device="cpu")
    data = torch.from_numpy(np.frombuffer(urls10k[:1024], np.uint8).copy()[None, :]).to(card)
    with pytest.raises(ValueError, match="CUDA tensor"):
        encode_fused.encode_blocks(data, [1024], device="cpu")


def test_card_never_takes_the_plain_version(card, monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("plain version called for a CUDA tensor")

    monkeypatch.setattr(decode_fused, "decode_plain", refuse)
    monkeypatch.setattr(encode_fused, "emit_plain", refuse)
    frag = api.compress_fragment(b"hello hello hello hello")
    assert api.decompress_noheader(frag, 100) == b"hello hello hello hello"


# ------------------------------------------------------ the whole-stream slice


@pytest.fixture(scope="module")
def streams():
    """The fixture streams of ``tests/data/torch_ref/streams.npz``: (name, body, dst_len)."""
    with np.load(DATA / "torch_ref" / "streams.npz") as z:
        return [(str(z["names"][i]), z["body"][z["offs"][i] : z["offs"][i + 1]].tobytes(),
                 int(z["dst_len"][i])) for i in range(len(z["names"]))]


def _u8(b: bytes) -> torch.Tensor:
    return torch.frombuffer(bytearray(b), dtype=torch.uint8)


def _fuzz_bodies(urls10k: bytes, seed: int):
    """Random bytes, truncations and bit flips of whole streams, at lengths
    around the scan kernel's 16 KiB windows."""
    rng = np.random.default_rng(seed)
    base = pymodel.compress(urls10k[:200000])
    base = base[wire.varint_decode(base)[1]:]
    out = [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in (1, 5, 16383, 16384, 16389)]
    out += [base[: int(rng.integers(1, len(base)))] for _ in range(4)]
    for _ in range(8):
        b = bytearray(base)
        for _k in range(int(rng.integers(1, 8))):
            b[int(rng.integers(0, len(b)))] ^= 1 << int(rng.integers(0, 8))
        out.append(bytes(b))
    run = b"\x04ab" + bytes([wire.TAG_COPY_1 | (0 << 2), 2]) * 40000   # 40001 tiny tags
    return out + [run]


def test_scan_kernel_equals_plain(card, streams, urls10k):
    from csnappy_tpu_torch.ops import decode_ws

    cases = [(b, d) for _, b, d in streams] + [(b, 200000) for b in _fuzz_bodies(urls10k, 5)]
    for body, dst in cases:
        nslot = -(-dst // 32768) + 1
        seg, meta = decode_ws.scan_segments(_u8(body).to(card), nslot, device=card)
        torch.cuda.synchronize()
        pseg, pmeta = decode_ws.scan_plain(_u8(body), nslot)
        assert torch.equal(seg.cpu(), pseg) and torch.equal(meta[:3].cpu(), pmeta[:3]), len(body)


@pytest.mark.parametrize("limit", ["exact", "short", "multiple"])
def test_stream_kernel_equals_plain(card, streams, urls10k, limit):
    from csnappy_tpu_torch.ops import decode_stream

    cases = [(b, d) for _, b, d in streams] + [(b, 200000) for b in _fuzz_bodies(urls10k, 6)]
    for body, dst in cases:
        cap = {"exact": dst, "short": max(0, dst - 5000), "multiple": dst // 32768 * 32768}[limit]
        out, produced, status = decode_stream.decode_stream(_u8(body).to(card), cap, device=card)
        torch.cuda.synchronize()
        pout, pprod, pstatus = decode_stream.decode_stream(body, cap, device="cpu")
        p = int(pprod)
        assert (int(produced), int(status)) == (p, int(pstatus)), (len(body), cap)
        assert torch.equal(out[:p].cpu(), pout[:p])


def test_stream_kernel_literal_envelope(card):
    # a 100000-byte literal decodes; one of 2^24 + 4096 bytes is outside the
    # envelope, and the API re-decides it on decode_jnp on the card
    from csnappy_tpu_torch.ops import decode_jnp, decode_stream

    raw = np.random.default_rng(4).integers(0, 256, 100000, dtype=np.uint8).tobytes()
    s = bytearray()
    wire.emit_literal(s, raw)
    out, produced, status = decode_stream.decode_stream(bytes(s), len(raw), device=card)
    assert (int(produced), int(status)) == (len(raw), 0) and out.cpu().numpy().tobytes() == raw
    n = (1 << 24) + 4096
    raw = (b"\xa5\x5a\x01\xfe" * ((n + 3) // 4))[:n]
    s = bytearray()
    wire.emit_literal(s, raw)
    assert int(decode_stream.decode_stream(bytes(s), n, device=card)[2]) == -5
    before = decode_jnp.decompress_noheader_np.launches
    assert api.decompress_noheader(bytes(s), n) == raw
    assert decode_jnp.decompress_noheader_np.launches == before + 1


def test_decode_jnp_on_card_equals_cpu(card, streams):
    from csnappy_tpu_torch.ops import decode_jnp

    for name, body, dst in streams:
        got = decode_jnp.decompress_noheader_np(_u8(body).to(card), dst, device=card)
        want = decode_jnp.decompress_noheader_np(body, dst, device="cpu")
        assert got[1:] == want[1:] and np.array_equal(got[0], want[0]), name


def test_api_whole_stream_routes_launch_their_kernels(card, urls10k, urls10k_snappy, monkeypatch):
    from csnappy_tpu_torch.ops import decode_jnp, decode_stream, decode_ws
    from csnappy_tpu_torch.runtime import native

    host = []
    scan = native.scan_segments
    monkeypatch.setattr(native, "scan_segments", lambda *a, **k: host.append(1) or scan(*a, **k))
    wrappers = {"scan": decode_ws.scan_segments, "segments": decode_fused.decode_segments,
                "stream": decode_stream.decode_stream, "jnp": decode_jnp.decompress_noheader_np}

    def launched(fn):
        before = {k: w.launches for k, w in wrappers.items()}
        nhost = len(host)
        fn()
        got = {k: w.launches - before[k] for k, w in wrappers.items() if w.launches > before[k]}
        return dict(got, host=len(host) - nhost)

    unaligned = (DATA / "unaligned_uint64_test.snappy").read_bytes()
    lit = bytes(range(256)) * 160
    far = bytearray()
    wire.emit_literal(far, lit)
    far += bytes([wire.TAG_COPY_4 | ((8 - 1) << 2)]) + (40000).to_bytes(4, "little")
    assert launched(lambda: api.decompress(urls10k_snappy)) == {"scan": 1, "segments": 1, "host": 0}
    assert launched(lambda: api.decompress(unaligned)) == \
        {"scan": 1, "segments": 1, "stream": 1, "host": 1}
    assert launched(lambda: api.decompress_noheader(bytes(far), len(lit) + 8)) == \
        {"scan": 1, "segments": 1, "jnp": 1, "host": 1}
    assert api.decompress(urls10k_snappy) == urls10k


def test_segment_decoder_fault_raises_on_the_card(card, urls10k, urls10k_snappy, monkeypatch):
    # the host-scan segmentable route on the card: with decode_ws answering
    # None the scan sends urls.10K.snappy to one decode_segments launch and
    # decode_jnp never runs; a segment decoder that disagrees with the scan
    # raises instead of being re-decided by decode_jnp
    from csnappy_tpu_torch.ops import decode_jnp, decode_ws

    monkeypatch.setattr(decode_ws, "decompress_noheader_ws", lambda *a, **k: None)
    jnp_calls, real_jnp = [], decode_jnp.decompress_noheader_np
    monkeypatch.setattr(decode_jnp, "decompress_noheader_np",
                        lambda *a, **k: jnp_calls.append(1) or real_jnp(*a, **k))
    before = decode_fused.decode_segments.launches
    assert api.decompress(urls10k_snappy) == urls10k
    assert decode_fused.decode_segments.launches == before + 1 and not jnp_calls
    real = decode_fused.decode_segments

    def short(*a, **k):
        out, prod, status = real(*a, **k)
        prod = prod.clone()
        prod[0] -= 1
        return out, prod, status

    short.launches = 0                  # the kernel counts on the module's decode_segments
    monkeypatch.setattr(decode_fused, "decode_segments", short)
    with pytest.raises(RuntimeError, match="disagrees with the host boundary scan"):
        api.decompress(urls10k_snappy)
    assert not jnp_calls


def test_whole_stream_never_takes_a_plain_version(card, urls10k_snappy, urls10k, monkeypatch):
    from csnappy_tpu_torch.ops import decode_stream, decode_ws

    def refuse(*_a, **_k):
        raise AssertionError("plain version called on the card path")

    for mod, name in ((decode_fused, "decode_plain"), (decode_ws, "scan_plain"),
                      (decode_stream, "decode_plain")):
        monkeypatch.setattr(mod, name, refuse)
    assert api.decompress(urls10k_snappy) == urls10k
    unaligned = (DATA / "unaligned_uint64_test.snappy").read_bytes()
    assert len(api.decompress(unaligned)) == wire.varint_decode(unaligned)[0]
    with pytest.raises(ValueError, match="CUDA tensor"):
        decode_stream.decode_stream(_u8(b"\x00a").to(card), 1, device="cpu")
    with pytest.raises(ValueError, match="CUDA tensor"):
        decode_ws.scan_segments(_u8(b"\x00a").to(card), 2, device="cpu")


# --------------------------------------------- the container and movebench slice


@pytest.mark.parametrize("n", [128, 32768, 1 << 24])
def test_gather_kernel_equals_plain(card, n):
    from csnappy_tpu_torch.tools import movebench as mb

    rng = np.random.default_rng(n)
    tbl = rng.integers(-(1 << 31), 1 << 31, (n // 128, 128), dtype=np.int64).astype(np.int32)
    idx = rng.integers(-n, 2 * n, (n // 128, 128), dtype=np.int32)      # clipped at both ends
    for bits in (8, 16, 24, 31):
        got = mb.gather_flat(torch.from_numpy(tbl).to(card), torch.from_numpy(idx).to(card),
                             bits, device=card)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), mb.gather_flat(tbl, idx, bits, device="cpu")), bits


@pytest.mark.parametrize("n", [1, 4095, 4096, 4097, 32768, 4096 * 4096 + 5, 1 << 24])
def test_movebench_scan_kernel_equals_plain(card, n):
    from csnappy_tpu_torch.tools import movebench as mb

    x = np.random.default_rng(n).integers(-(1 << 31), 1 << 31, n, dtype=np.int64).astype(np.int32)
    got = mb.scan_max(torch.from_numpy(x).to(card), device=card)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), torch.cummax(torch.from_numpy(x), 0).values)
    if n <= 32768:
        assert torch.equal(got.cpu(), mb.scan_max(x, device="cpu"))


def test_movebench_runs_its_kernels(card, capsys):
    from csnappy_tpu_torch.tools import movebench as mb

    before = mb.gather_flat.launches, mb.scan_max.launches
    assert mb.main(["4096"]) == 0
    assert capsys.readouterr().out.count("elem_per_s") == 5
    assert mb.gather_flat.launches > before[0] and mb.scan_max.launches > before[1]
    with pytest.raises(ValueError, match="CUDA tensor"):
        mb.scan_max(torch.zeros(4, dtype=torch.int32, device=card), device="cpu")


@pytest.mark.parametrize("page", [4096, 32768])
def test_container_on_card_equals_cpu(card, urls10k, page):
    from csnappy_tpu_torch.runtime import container

    rng = np.random.default_rng(page)
    data = urls10k[:100000] + rng.integers(0, 256, page + 4095, dtype=np.uint8).tobytes()
    before = encode_fused.encode_blocks.launches, decode_fused.decode_blocks.launches
    got, st = container.compress_blocks(data, page)                     # device=None: the card
    want, sw = container.compress_blocks(data, page, device="cpu")
    assert got == want and st.histogram == sw.histogram
    out, sd = container.decompress_blocks(got, page)
    assert out == data
    assert sd.histogram == container.decompress_blocks(got, page, device="cpu")[1].histogram
    assert encode_fused.encode_blocks.launches > before[0]
    assert decode_fused.decode_blocks.launches > before[1]


def test_container_fixture_on_card(card):
    from csnappy_tpu_torch.errors import SnappyError
    from csnappy_tpu_torch.runtime import container

    with np.load(DATA / "torch_ref" / "container.npz") as z:
        for i in range(len(z["names"])):
            data = z["data"][z["data_offs"][i] : z["data_offs"][i + 1]].tobytes()
            page = int(z["page_size"][i])
            cont, _ = container.compress_blocks(data, page, device=card)
            assert cont == z["cont"][z["cont_offs"][i] : z["cont_offs"][i + 1]].tobytes()
            assert container.decompress_blocks(cont, page, device=card)[0] == data
        for i in range(len(z["bad_names"])):
            cont = z["bad_cont"][z["bad_offs"][i] : z["bad_offs"][i + 1]].tobytes()
            with pytest.raises(SnappyError) as e:
                container.decompress_blocks(cont, int(z["bad_page_size"][i]), device=card)
            assert e.value.code == int(z["bad_code"][i])


# ------------------------------------------------------- the primitives slice


@pytest.fixture(scope="module")
def prim_cases():
    # the fixture tool loads here, not at import, so a fault in it cannot stop
    # the collection of the other card tests
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "make_torch_fixtures", DATA.parents[1] / "tools" / "make_torch_fixtures.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read_primitives()


def _prim_call(fn, args, limbs, device):
    got = prim.PRIMITIVES[fn].wrapper(*args, **({"limbs": limbs} if limbs else {}), device=device)
    return got if isinstance(got, tuple) else (got,)


def _prim_launches() -> list[int]:
    return [p.wrapper.launches for p in prim.PRIMITIVES.values()]


@pytest.mark.parametrize("fn", tuple(prim.PRIMITIVES))
def test_primitive_kernel_equals_fixture(card, prim_cases, fn):
    # the JAX Pallas kernels' answers, out-of-contract limbs included
    cases = [c for c in prim_cases if c[1] == fn]
    assert cases
    for case, _, limbs, inputs, outs in cases:
        args = [torch.from_numpy(inputs[a]) for a in prim.PRIMITIVES[fn].args]
        got = _prim_call(fn, [a.to(card) for a in args], limbs, card)
        torch.cuda.synchronize()
        want = _prim_call(fn, args, limbs, "cpu")
        for g, w, o in zip(got, want, outs):
            assert g.is_cuda and torch.equal(g.cpu(), w), case
            assert np.array_equal(g.cpu().numpy(), o), case


@pytest.mark.parametrize("fn", tuple(prim.PRIMITIVES))
def test_primitive_kernel_equals_plain_at_the_main_path_batch(card, fn):
    # B = 64 blocks of 32 KiB, the shapes chip_smoke.py's primitives phase runs
    from csnappy_tpu_torch.tools.movebench import primitive_inputs

    args = [torch.from_numpy(a) for a in primitive_inputs(64)[fn]]
    before = prim.PRIMITIVES[fn].wrapper.launches
    got = _prim_call(fn, [a.to(card) for a in args], 0, None)      # device=None: the card
    torch.cuda.synchronize()
    assert prim.PRIMITIVES[fn].wrapper.launches == before + 1
    for g, w in zip(got, _prim_call(fn, args, 0, "cpu")):
        assert torch.equal(g.cpu(), w)


def test_primitive_kernels_wide_values_and_edges(card):
    # full-range values at every limb count, odd row counts, widths that are
    # not multiples of 128, one-element tables, and empty inputs (no launch)
    rng = np.random.default_rng(9)

    def ints(lo, hi, shape):
        return torch.from_numpy(rng.integers(lo, hi, shape, dtype=np.int64).astype(np.int32))

    full = (-(1 << 31), 1 << 31)
    cases = [("local_gather", (ints(*full, (3, 5, 128)), ints(-300, 300, (3, 5, 128))), 0),
             ("local_scatter_or", (ints(-3, 4, (7, 128)), ints(-200, 300, (7, 128))), 0),
             ("compose_round", (ints(*full, (5, 128)), ints(*full, (5, 128)),
                                ints(*full, (5, 128)), ints(*full, (5, 128))), 0)]
    for limbs in (1, 2, 3, 4):
        cases += [("row_gather", (ints(*full, (1, 128)), ints(-2, 3, (13,))), limbs),
                  ("table_gather", (ints(*full, (1,)), ints(-2, 3, (5,))), limbs),
                  ("table_gather", (ints(*full, (1001,)), ints(-5, 1100, (7777,))), limbs),
                  ("rowwise_gather", (ints(*full, (3, 77)), ints(-9, 90, (3, 1000))), limbs)]
    for fn, args, limbs in cases:
        got = _prim_call(fn, [a.to(card) for a in args], limbs, card)
        torch.cuda.synchronize()
        for g, w in zip(got, _prim_call(fn, args, limbs, "cpu")):
            assert torch.equal(g.cpu(), w), (fn, limbs)
    before = _prim_launches()
    z = torch.zeros((0, 128), dtype=torch.int32, device=card)
    assert prim.local_gather(z, z, device=card).shape == (0, 128)
    assert prim.local_scatter_or(z, z, device=card).shape == (0, 128)
    assert all(o.shape == (0, 128) for o in prim.compose_round(z, z, z, z, device=card))
    e = torch.zeros(0, dtype=torch.int32, device=card)
    assert prim.row_gather(ints(0, 9, (4, 128)), e, device=card).shape == (0, 128)
    assert prim.table_gather(ints(0, 9, (4,)), e, device=card).shape == (0,)
    assert prim.rowwise_gather(ints(0, 9, (0, 4)), ints(0, 9, (0, 6)), device=card).shape == (0, 6)
    assert _prim_launches() == before


def test_primitives_never_take_the_plain_version(card, monkeypatch):
    from csnappy_tpu_torch.tools.movebench import primitive_inputs

    def refuse(*_a, **_k):
        raise AssertionError("plain version called for a CUDA tensor")

    for fn in prim.PRIMITIVES:
        monkeypatch.setattr(prim, f"{fn}_plain", refuse)
    before = _prim_launches()
    for fn, args in primitive_inputs(1).items():
        _prim_call(fn, [torch.from_numpy(a).to(card) for a in args], 0, card)
    torch.cuda.synchronize()
    assert _prim_launches() == [b + 1 for b in before]
    x = torch.zeros((2, 128), dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="CUDA tensor"):
        prim.local_gather(x, x, device="cpu")
    with pytest.raises(ValueError, match="CUDA tensor"):
        prim.row_gather(x, x[0], device="cpu")



# ------------------------------------------------------------- the probes slice

PROBE_NAMES = pb.TIMED                  # every probe with a kernel but smem_cap


@pytest.fixture(scope="module")
def probe_fixture():
    with np.load(DATA / "torch_ref" / "probes.npz") as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("name", PROBE_NAMES)
def test_probe_kernel_equals_plain_and_fixture(card, probe_fixture, name):
    # every fixture K (the JAX probes' own answers, on the probe's input and
    # on a constructed one) and the probe's k_hi
    pr = pb.PROBES[name]
    tbl = pb.second_input(name)
    htab = None if tbl is None else torch.from_numpy(tbl)
    tab = None if htab is None else htab.to(card)
    runs = [(key, *key.split("__")[1].rsplit("k", 1)) for key in probe_fixture
            if key.startswith(name + "__")]
    runs.append((None, "", str(pr.k_hi)))
    assert len(runs) > 1
    before = pb.probe.launches[name]
    for key, case, k in runs:
        host = torch.from_numpy(probe_fixture["case_" + case[:-1]] if case else pb.inputs(name))
        got = pb.probe(name, int(k), host.to(card), tab)   # device=None: the card
        torch.cuda.synchronize()
        want = pb.probe(name, int(k), host, htab, device="cpu")
        assert got.is_cuda and torch.equal(got.cpu(), want), (name, case, k)
        if key is not None:
            assert np.array_equal(got.cpu().numpy(), probe_fixture[key]), key
    assert pb.probe.launches[name] == before + len(runs)


def test_probe_shared_memory_capacity(card, probe_fixture):
    cap = pb.smem_capacity()
    assert cap >= 128 * 1024 and cap % 4 == 0
    optin = getattr(torch.cuda.get_device_properties(0), "shared_memory_per_block_optin", None)
    if optin is not None:
        assert cap == optin
    for rows in pb.SMEM_ROWS:
        assert pb.smem_cap(rows) == (rows * 128 * 4 <= cap), rows
    assert bool(probe_fixture["smem_cap_ok"][0]) and pb.smem_cap(256)
    out = pb.probe("smem_cap", 256, pb.inputs("smem_cap"))
    assert (out.cpu() == 2).all()
    with pytest.raises(RuntimeError, match="do not launch"):
        pb.probe("smem_cap", 2048, pb.inputs("smem_cap"))


def test_probe_slopes_are_positive(card):
    for name in PROBE_NAMES:
        rec = pb.measure(name)
        assert rec["result_equals_plain"], name
        assert rec["ns_per_iter"] > 0 and rec["cycles_per_iter"] > 0, (name, rec)
        assert rec["space"] == pb.PROBES[name].space


def test_probes_never_take_the_plain_version(card, monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("plain version called on the card")

    for name in pb.PROBES:
        monkeypatch.setitem(pb.PROBES, name, pb.PROBES[name]._replace(plain=refuse))
    data = torch.from_numpy(pb.inputs("walk_smem")).to(card)
    assert pb.probe("walk_smem", 37, data).is_cuda
    with pytest.raises(ValueError, match="CUDA tensor"):
        pb.probe("walk_smem", 37, data, device="cpu")
    table = torch.from_numpy(pb.second_input("walk_1d")).to(card)
    assert pb.probe("walk_1d", 37, data, table).is_cuda
    assert pb.probe("inrow_round", 37, data).is_cuda
    with pytest.raises(ValueError, match="CUDA tensor"):
        pb.probe("walk_1d", 37, data.cpu(), table, device="cpu")
    d4 = torch.from_numpy(pb.inputs("conv_check")).to(card)
    assert pb.probe("conv_check", 37, d4).is_cuda and pb.probe("gather_r400_l2", 37, d4).is_cuda
    d6 = torch.from_numpy(pb.inputs("el_i16")).to(card)
    idx = torch.from_numpy(pb.second_input("el_i16")).to(card)
    assert pb.probe("el_i16", 37, d6, idx).is_cuda
    with pytest.raises(ValueError, match="Incompatible shapes for broadcasting"):
        pb.probe("taa_4096x128", 37, d6, idx)


@pytest.mark.parametrize("name", [n for n in PROBE_NAMES if n.startswith("mosaic_probe4.gather_r")])
def test_resolve_gather_kernel_past_the_wrap(card, probe_fixture, name):
    # on case_p4rand the 16-bit gathers' acc passes 2^31 before WRAP_K; the
    # kernel's floor modulus must keep agreeing with the plain version there
    host = torch.from_numpy(probe_fixture["case_p4rand"])
    got = pb.probe(name, pb.WRAP_K, host.to(card))
    torch.cuda.synchronize()
    want = pb.probe(name, pb.WRAP_K, host, device="cpu")
    assert torch.equal(got.cpu(), want), name
    if name.endswith("_l2"):
        assert int(want[0, 0]) < 0, name


# ------------------------------------------------------- the kernel_lib slice


@pytest.fixture(scope="module")
def kl_cases():
    return kl.read_cases(DATA / "torch_ref" / "kernel_lib.npz")


@pytest.mark.parametrize("helper", tuple(kl.HELPERS))
def test_kernel_lib_kernel_equals_fixture(card, kl_cases, helper):
    # every stored case of the helper (the JAX helper's answer, outside its
    # contract too) on the card, one launch each, equal to the plain version
    cases = [c for c in kl_cases if c[1] == helper]
    assert cases
    before = kl.launches[helper]
    for case, _, arrays, params, outs in cases:
        got = kl.call(helper, {k: torch.from_numpy(v).to(card) for k, v in arrays.items()}, params)
        torch.cuda.synchronize()
        want = kl.call(helper, {k: torch.from_numpy(v) for k, v in arrays.items()}, params,
                       device="cpu")
        assert len(got) == len(outs) == len(want), case
        for g, o, w in zip(got, outs, want):
            assert g.is_cuda and np.array_equal(g.cpu().numpy(), o), case
            assert torch.equal(g.cpu(), w), case
    assert kl.launches[helper] == before + len(cases)


def test_kernel_lib_kernels_on_wide_tiles(card):
    # tiles larger than the JAX tests', random over all of int32, against the
    # plain versions; the scatters at the JAX fused kernels' shapes and past
    # one block's shared memory; a scan tile past it raises
    rng = np.random.default_rng(11)

    def ints(lo, hi, shape):
        return rng.integers(lo, hi, shape, dtype=np.int64).astype(np.int32)

    x = ints(-(2**31), 2**31, (96, 128))
    runs = [
        ("stream_shift_down", (x, 5000), {"fill": 3}), ("stream_shift_up", (x, 129), {}),
        ("stream_shift_up_mm", (x, 77), {"bits": 24}), ("lane_shift_up", (x, 300), {"bits": 8}),
        ("row_shift_down", (x, 40), {"fill": -1}), ("scan2d", (x,), {"op": "add"}),
        ("scan2d_mm", (x,), {"op": "addsat", "bits": 20}), ("scan2d_tril", (x,), {"bits": 24}),
        ("fill_max_rows", (x, 18, 3), {}), ("flip2d", (x,), {"bits": 31}),
        ("gather_flat", (x, ints(-10, 96 * 128 + 10, (3, 1000)), 16), {}),
        ("lane_gather", (x, ints(-300, 300, (96, 40))), {}),
        ("local_gather_rows", (x, ints(-5, 133, (96, 200))), {}),
        ("scatter_sum_tile", (ints(-9, 3000, (1, 4000)), x.reshape(-1)[:4000][None],
                              ints(0, 2, (1, 4000)), 20, 31), {}),
    ]
    for helper, args, kw in runs:
        fn = kl.HELPERS[helper].wrapper
        got = fn(*(torch.from_numpy(a).to(card) if isinstance(a, np.ndarray) else a
                   for a in args), **kw)
        want = fn(*args, **kw, device="cpu")
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        for g, w in zip(got, want):
            assert g.is_cuda and torch.equal(g.cpu(), w), helper
    idx = ints(-50, 64 * 128 + 50, (64, 128))
    tabs = [(ints(-(2**31), 2**31, (64, 128)), b) for b in (8, 16, 24, 32, 5, 12, 31, 1)]
    got = kl.gather_rows_multi([(torch.from_numpy(t).to(card), b) for t, b in tabs],
                               torch.from_numpy(idx).to(card), 7, nrows=50)
    want = kl.gather_rows_multi(tabs, idx, 7, nrows=50, device="cpu")
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
    pos, vals = ints(-100, 40 * 128 + 100, (64, 128)), ints(-(2**31), 2**31, (64, 128))
    v = torch.from_numpy(vals).to(card)
    got = kl.scatter_rows_multi(torch.from_numpy(pos).to(card), [(v, 31), (v, 9)], 3, 40,
                                nrows=60)
    want = kl.scatter_rows_multi(pos, [(vals, 31), (vals, 9)], 3, 40, nrows=60, device="cpu")
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
    # decode_fused.py:470, decode_stream.py:315, encode_fused.py:375: rows
    # 16..31 of a 64-row tile into 2-3 tables of 256 or 304 rows, duplicates
    # and out-of-range positions included
    for out_rows, bits in ((256, [31, 18]), (256, [31, 31, 31]), (304, [31, 31, 31]),
                           (1000, [7, 14, 21, 28, 32, 1, 2, 3])):
        pos = ints(-200, out_rows * 128 + 200, (64, 128))
        vals = [ints(-(2**31), 2**31, (64, 128)) for _ in bits]
        got = kl.scatter_rows_multi(torch.from_numpy(pos).to(card),
                                    [(torch.from_numpy(v).to(card), b) for v, b in zip(vals, bits)],
                                    16, out_rows, nrows=16)
        want = kl.scatter_rows_multi(pos, list(zip(vals, bits)), 16, out_rows, nrows=16,
                                     device="cpu")
        assert len(got) == len(bits) and all(g.shape == (out_rows, 128) for g in got)
        assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want)), (out_rows, bits)
    # scatter_sum_tile at 4 limbs into 256 rows (4 x 32,768 histogram words),
    # its mask as bool, uint8 and int32
    pos, val = ints(-9, 256 * 128 + 9, (1, 5000)), ints(-(2**31), 2**31, (1, 5000))
    pos[0, :300] = pos[0, 300:600]
    mask = ints(0, 2, (1, 5000)).astype(bool)
    want = kl.scatter_sum_tile(pos, val, mask, 256, 32, device="cpu")
    for m in (mask, mask.astype(np.uint8), mask.astype(np.int32)):
        got = kl.scatter_sum_tile(torch.from_numpy(pos).to(card), torch.from_numpy(val).to(card),
                                  torch.from_numpy(m).to(card), 256, 32)
        assert got.is_cuda and torch.equal(got.cpu(), want), m.dtype
    with pytest.raises(ValueError, match="shared memory"):
        kl.scan2d_mm(torch.zeros((300, 128), dtype=torch.int32, device=card))


def test_kernel_lib_never_takes_the_plain_version(card, monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("plain version called on the card")

    for fn in ("_shift_plain", "_scan_plain", "_gather_plain", "_scatter_plain"):
        monkeypatch.setattr(kl, fn, refuse)
    x = torch.arange(8 * 128, dtype=torch.int32, device=card).reshape(8, 128)
    before = sum(kl.launches.values())
    assert kl.stream_shift_down(x, 3).is_cuda and kl.scan2d_mm(x, op="add").is_cuda
    assert kl.gather_flat(x, x[:1], 16).is_cuda and kl.flip2d(x).is_cuda
    assert kl.scatter_sum_tile(x[:1], x[:1], x[:1], 8, 16).is_cuda
    assert sum(kl.launches.values()) == before + 5
    with pytest.raises(ValueError, match="CUDA tensor"):
        kl.scan2d(x, device="cpu")
