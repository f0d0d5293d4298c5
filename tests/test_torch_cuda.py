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
from csnappy_tpu_torch.errors import E_DATA_MALFORMED, SnappyError
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


@pytest.mark.parametrize("cap", [70000, 131072])
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


def _maker():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "make_torch_fixtures", DATA.parents[1] / "tools" / "make_torch_fixtures.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("group", ["d4", "d4k", "d32k", "d1k", "dadv", "far"])
def test_decode_kernel_equals_jax_fixture(card, group):
    # every decode group of blocks.npz on the card: the JAX answers on every
    # row but the JAX package's known faults, the plain version on all
    maker = _maker()
    block_out = dict(maker.DECODE_GROUPS, **maker.FAR_GROUP)[group]
    with np.load(DATA / "torch_ref" / "blocks.npz") as z:
        comp, lens = z[f"{group}_comp"], z[f"{group}_lens"]
        jout, jprod, jstat = z[f"{group}_out"], z[f"{group}_prod"], z[f"{group}_status"]
    got = decode_fused.decode_blocks(torch.from_numpy(comp).to(card), lens, block_out)
    want = decode_fused.decode_blocks(comp, lens, block_out, device="cpu")
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    out, prod, stat = (t.cpu().numpy() for t in got)
    for i in range(len(lens)):
        if i in maker.JAX_DECODE_FAULTS.get(group, ()):
            continue
        assert (prod[i], stat[i]) == (jprod[i], jstat[i]), (group, i)
        assert np.array_equal(out[i, : prod[i]], jout[i, : prod[i]]), (group, i)


def test_decode_kernel_resolve_rounds_are_bounded(card):
    # the dadv rows through the stamped launch: every row exact, the deep
    # chain (8,191 copies each reading the last) included, and no row past
    # ceil(log2 32768) = 15 resolve rounds
    rows = _dadv_rows()
    arr, lens = _pack(rows)
    B = len(rows)
    flat = torch.from_numpy(arr).to(card).reshape(-1)
    offs = torch.arange(B, device=card, dtype=torch.int64) * arr.shape[1]
    stamps = torch.zeros((B, decode_fused.STAMPS), dtype=torch.int64, device=card)
    got = decode_fused._launch(decode_fused.decode_blocks, flat, offs,
                               torch.from_numpy(lens).to(card),
                               torch.full((B,), 32768, dtype=torch.int32, device=card), 32768,
                               stamps)
    want = decode_fused.decode_blocks(arr, lens, 32768, device="cpu")
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    windows, tags, rounds = stamps[:, -3:].cpu().numpy().T
    assert (rounds <= 15).all() and rounds[0] >= 1, rounds
    assert tags[2] == 32768 and windows[3] == 196608 // 8192, (tags, windows)


def _dadv_rows():
    with np.load(DATA / "torch_ref" / "blocks.npz") as z:
        return [z["dadv_comp"][i, : n].tobytes() for i, n in enumerate(z["dadv_lens"])]


def test_decode_kernel_pages_4k_at_zram_batch(card, urls10k):
    # 200 pages of 4 KiB (the container's shape), some mutated or cut
    pages = [pymodel.compress_fragment(urls10k[i * 4096 : (i + 1) * 4096]) for i in range(180)]
    pages += _mutants(pages[0], 10, seed=4096) + [p[:-3] for p in pages[1:11]]
    arr, lens = _pack(pages)
    before = dict(decode_fused.launches_by_kernel)
    got = decode_fused.decode_blocks(torch.from_numpy(arr).to(card), lens, 4096)
    assert decode_fused.launches_by_kernel["decode_kernel"] == before["decode_kernel"] + 1
    want = decode_fused.decode_blocks(arr, lens, 4096, device="cpu")
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert (want[2][:180] == 0).all()


def test_decode_segments_unequal_limits(card, urls10k_snappy, urls10k):
    # each segment of urls.10K.snappy against its own limit: above, at and
    # below what it produces (an overrun), and 0
    from csnappy_tpu_torch.runtime import native

    body = urls10k_snappy[wire.varint_decode(urls10k_snappy)[1]:]
    _, offs, _ = native.scan_segments(body, len(urls10k))
    lens = np.diff(np.append(offs, len(body)))
    full = np.minimum(32768, len(urls10k) - np.arange(len(offs)) * 32768)
    dl = full + np.resize([0, 5000, -1, -full[0]], len(offs))
    dl = np.clip(dl, 0, 32768)
    got = decode_fused.decode_segments(_u8(body).to(card), offs, lens, dl)
    want = decode_fused.decode_segments(body, offs, lens, dl, device="cpu")
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert got[0].shape[1] == int(dl.max()) and set(want[2].tolist()) == {0, -3}


def test_decode_picks_the_kernel_by_width(card, urls10k):
    # rows up to 32,768 bytes take decode_kernel, wider ones the three wide
    # kernels, each call counted once on the wrapper's launches and each
    # kernel on launches_by_kernel; both equal the plain version
    frags = [pymodel.compress_fragment(urls10k[i * 32768 : (i + 1) * 32768]) for i in range(3)]
    arr, lens = _pack(frags)
    for width, kernels in ((32768, ("decode_kernel",)), (32769, decode_fused.WIDE_KERNELS),
                           (70000, decode_fused.WIDE_KERNELS)):
        before = dict(decode_fused.launches_by_kernel)
        n = decode_fused.decode_blocks.launches
        got = decode_fused.decode_blocks(torch.from_numpy(arr).to(card), lens, width)
        assert decode_fused.decode_blocks.launches == n + 1
        assert {k: v - before[k] for k, v in decode_fused.launches_by_kernel.items()} == \
            {k: int(k in kernels) for k in decode_fused.KERNELS}
        want = decode_fused.decode_blocks(arr, lens, width, device="cpu")
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)


def test_the_32k_kernel_never_takes_a_wider_row(card):
    # decode_kernel's launch entry refuses a row past 32,768 bytes, and the
    # wide entry one of 32,768 or less
    frag = pymodel.compress_fragment(b"abc" * 100)
    arr, lens = _pack([frag])
    flat = torch.from_numpy(arr).to(card).reshape(-1)
    offs = torch.zeros((1,), dtype=torch.int64, device=card)
    lt = torch.from_numpy(lens).to(card)
    dl = torch.full((1,), 32769, dtype=torch.int32, device=card)
    out = torch.empty((1, 32769), dtype=torch.uint8, device=card)
    ps = torch.empty((2,), dtype=torch.int32, device=card)
    launch, check = decode_fused._kernel()
    with pytest.raises(RuntimeError, match="CUDA error"):
        check(launch(flat.data_ptr(), offs.data_ptr(), lt.data_ptr(), dl.data_ptr(),
                     out.data_ptr(), 32769, ps.data_ptr(), ps[1:].data_ptr(), 1, None, None))
    launch, check = decode_fused._wide_kernel()
    with pytest.raises(RuntimeError, match="CUDA error"):
        check(launch(flat.data_ptr(), offs.data_ptr(), lt.data_ptr(), dl.data_ptr(), None,
                     out.data_ptr(), 32768, ps.data_ptr(), ps[1:].data_ptr(), 1, 1, 2, None,
                     None, None))


def _wide_ref():
    with np.load(DATA / "torch_ref" / "wide.npz") as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("group", ["w64k", "w70k", "w256k", "w1m"])
def test_wide_kernels_equal_plain_and_fixture(card, group):
    # the wide group on the card: the plain version on every row, the JAX
    # answers on every row but the JAX package's known faults, the oracle's
    # stored answers on every row
    import hashlib

    maker = _maker()
    ref = _wide_ref()
    block_out = maker.WIDE_GROUPS[group]
    comp, lens = ref[f"{group}_comp"], ref[f"{group}_lens"]
    got = decode_fused.decode_blocks(torch.from_numpy(comp).to(card), lens, block_out)
    want = decode_fused.decode_blocks(comp, lens, block_out, device="cpu")
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    out, prod, stat = (t.cpu().numpy() for t in got)
    assert prod.tolist() == ref[f"{group}_oracle_prod"].tolist()
    assert stat.tolist() == ref[f"{group}_oracle_status"].tolist()
    for i in range(len(lens)):
        assert hashlib.sha256(out[i].tobytes()).digest() == \
            ref[f"{group}_oracle_sha256"][i].tobytes(), (group, i)
        if group in maker.WIDE_JAX and i not in maker.JAX_DECODE_FAULTS.get(group, ()):
            assert (prod[i], stat[i]) == (ref[f"{group}_prod"][i], ref[f"{group}_status"][i])
            assert np.array_equal(out[i, : prod[i]], ref[f"{group}_out"][i, : prod[i]])


@pytest.mark.parametrize("width", [32769, 65536, 70000, 131073, 1 << 18, 1 << 20, 1 << 24])
def test_wide_kernels_widths_and_events(card, width):
    # every width against the plain version, events in the first and the
    # last segment; decode_segments reads the same rows in place at mixed limits
    from chip_smoke import wide_cases

    cases = wide_cases(width, width)
    arr, lens = _pack([f for _, f in cases])
    got = decode_fused.decode_blocks(torch.from_numpy(arr).to(card), lens, width)
    want = decode_fused.decode_blocks(arr, lens, width, device="cpu")
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w), [n for n, _ in cases]
    assert want[2][:3].tolist() == [0, 0, 0] and set(want[2][3:8].tolist()) == {-3, -5}
    body = b"".join(f for _, f in cases)
    offs = np.cumsum([0] + [len(f) for _, f in cases[:-1]])
    dl = np.array([width, width - 1, 40000, width, width, width + 1, width, width, 0])
    got = decode_fused.decode_segments(_u8(body).to(card), offs, lens, dl)
    want = decode_fused.decode_segments(body, offs, lens, dl, device="cpu")
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def test_wide_main_path_batch_repeats(card):
    # the main path's wide decode_segments batch (rows of 702,087, 32,768 and
    # 2^18 B at unaligned offsets), from host bytes and a card tensor in turn,
    # beside the body as one decode_blocks row: every call equal to the
    # known answers, each in a freshly poisoned pool with its three outputs
    # asserted to lie in the poison
    from chip_smoke import wide_repeats

    got = wide_repeats(20, card)
    assert got == {"calls": 40, "differed": {"segments": 0, "blocks": 0}, "poisoned": 120}


def test_wide_call_runs_three_kernels_and_one_memset(card, urls10k_snappy):
    # one decode_blocks call of a wide row: one memset of the workspace and
    # the chain, segment and finish kernels once each, no other kernel
    from csnappy_tpu_torch.tools.timing import device_profile

    body = urls10k_snappy[wire.varint_decode(urls10k_snappy)[1]:]
    arr = torch.from_numpy(np.frombuffer(body, np.uint8).copy()).to(card)[None, :]
    lens = np.array([len(body)], np.int32)
    ops = device_profile(lambda: decode_fused.decode_blocks(arr, lens, 702087), 3)["calls"]
    kernels = {k: v for k, v in ops.items() if not k.startswith(("Memcpy", "Memset"))}
    assert sorted(kernels.values()) == [1, 1, 1], ops
    for name in decode_fused.WIDE_KERNELS:
        assert any(name in k for k in kernels), (name, ops)
    assert sum(v for k, v in ops.items() if k.startswith("Memset")) == 1, ops


def test_wide_stamps_and_bounds(card):
    # the stamped call: every chunk of each row visited or skipped, every
    # segment's resolve rounds within 16, and the offset-1 run's segments
    # each reading the segment before
    from chip_smoke import wide_cases
    from csnappy_tpu_torch.tools import phaseprof

    width = 1 << 20
    cases = wide_cases(width, 5)[:3]
    arr, lens = _pack([f for _, f in cases])
    B = len(cases)
    args = (torch.from_numpy(arr).to(card).reshape(-1),
            torch.arange(B, device=card, dtype=torch.int64) * arr.shape[1],
            torch.from_numpy(lens).to(card), torch.full((B,), width, dtype=torch.int32,
                                                        device=card))
    got, (chain, seg) = phaseprof.stamped_wide(decode_fused.decode_blocks, args, width)
    want = decode_fused.decode_blocks(arr, lens, width, device="cpu")
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    plan = decode_fused.wide_plan(lens, [width] * B, width)
    assert chain.shape == (plan[B], 8) and seg.shape == (plan[-1], 13)
    names = decode_fused.WIDE_SEG_STAMPS
    rounds, ext = seg[:, names.index("rounds")], seg[:, names.index("externals")]
    assert rounds.max() <= 16
    s0, s1 = plan[B + 2], plan[B + 3]                 # the offset-1 run's segments
    assert ext[s0 + 1 : s1 - 1].all()
    summ = phaseprof.wide_summary(chain, seg)
    assert set(summ) == set(decode_fused.WIDE_KERNELS[:2])


def test_failed_wide_launch_raises_and_takes_no_plain_version(card, monkeypatch):
    frag = pymodel.compress_fragment(b"abc" * 100)
    arr, lens = _pack([frag])
    monkeypatch.setattr(decode_fused, "decode_plain", lambda *a: pytest.fail("plain version"))
    monkeypatch.setattr(decode_fused, "_wide_kernel", lambda: (lambda *a: 1, decode_fused._kernel()[1]))
    with pytest.raises(RuntimeError, match="CUDA error"):
        decode_fused.decode_blocks(torch.from_numpy(arr).to(card), lens, 40000)


@pytest.mark.parametrize("bs", [1024, 4096, 32768])
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


def _encode_rows(urls10k: bytes, bs: int, n: int, seed: int):
    # urls rows with their bytes kept past ragged lengths, one window
    # repeated, short periods, incompressible rows
    rng = np.random.default_rng(seed)
    u = np.frombuffer(urls10k, np.uint8)
    rows = []
    for i in range(n):
        kind = i % 5
        if kind == 0:
            s0 = int(rng.integers(0, len(u) - bs))
            rows.append(u[s0 : s0 + bs])
        elif kind == 1:
            rows.append(np.full(bs, int(rng.integers(0, 256)), np.uint8))
        elif kind == 2:
            rows.append(np.resize(rng.integers(0, 256, int(rng.integers(2, 70)), dtype=np.uint8), bs))
        elif kind == 3:
            rows.append(rng.integers(0, 256, bs, dtype=np.uint8))
        else:
            rows.append(rng.integers(0, 3, bs, dtype=np.uint8))
    blens = rng.choice([bs, bs, bs - 1, 0, 3, 4, 5, bs // 3], n).astype(np.int32)
    return np.stack(rows), blens


@pytest.mark.parametrize("shape", [(1, 32768), (5, 3000), (140, 32768), (300, 4096)])
def test_encode_kernel_batches_and_widths(card, urls10k, shape):
    # one block, a width the kernel pads to 1,024 itself, and batches past
    # one wave of the 132 SMs (one 32 KiB block an SM, two 4 KiB blocks)
    data, blens = _encode_rows(urls10k, shape[1], shape[0], seed=shape[0])
    before = encode_fused.encode_blocks.launches
    got = encode_fused.encode_blocks(torch.from_numpy(data).to(card), blens)
    assert encode_fused.encode_blocks.launches == before + 1
    want = encode_fused.encode_blocks(data, blens, device="cpu")
    assert torch.equal(got[1].cpu(), want[1]) and torch.equal(got[0].cpu(), want[0])


def test_encode_kernel_empty_batch(card):
    before = encode_fused.encode_blocks.launches
    comp, clen = encode_fused.encode_blocks(torch.zeros((0, 4096), dtype=torch.uint8,
                                                        device=card), [])
    assert comp.is_cuda and comp.shape == (0, encode_fused.ocap(4096)) and clen.numel() == 0
    assert encode_fused.encode_blocks.launches == before


@pytest.mark.parametrize("group", ["e1k", "e4k", "eadv"])
def test_encode_kernel_equals_jax_fixture(card, group):
    with np.load(DATA / "torch_ref" / "blocks.npz") as z:
        data, blens = z[f"{group}_data"], z[f"{group}_lens"]
        comp, clen = z[f"{group}_comp"], z[f"{group}_clen"]
    got = encode_fused.encode_blocks(torch.from_numpy(data).to(card), blens)
    assert got[1].cpu().numpy().tolist() == clen.tolist()
    assert np.array_equal(got[0].cpu().numpy(), comp)


def test_encode_kernel_walk_exhausted_raises(card, urls10k, monkeypatch):
    # a walk with more commits than its bound fails its block, and the call
    # raises the codec's data error, as the JAX encoder does
    data = torch.from_numpy(np.frombuffer(urls10k[:4096], np.uint8).copy()[None, :]).to(card)
    monkeypatch.setattr(encode_fused, "walk_cap", lambda bs: 2)
    with pytest.raises(SnappyError) as ei:
        encode_fused.encode_blocks(data, [4096])
    assert ei.value.code == E_DATA_MALFORMED and "blocks [0]" in str(ei.value)


def test_encode_never_reaches_the_plain_version(card, urls10k, monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("plain version called for a CUDA tensor")

    monkeypatch.setattr(encode_fused, "prep", refuse)
    monkeypatch.setattr(encode_fused, "emit_plain", refuse)
    data = torch.from_numpy(np.frombuffer(urls10k[:32768], np.uint8).copy()[None, :])
    comp, clen = encode_fused.encode_blocks(data.to(card), [32768])
    assert pymodel.decompress_noheader(comp[0, : int(clen[0])].cpu().numpy().tobytes(),
                                       32768) == urls10k[:32768]
    assert api.compress(urls10k[:70000]) == encode_fused.compress_np(urls10k[:70000])


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


@pytest.fixture(scope="module")
def scan_adv():
    """The adversarial scan group of ``tests/data/torch_ref/scan_adv.npz``:
    (name, body, dst_len, the JAX scan's seg[:nseg], its meta[:3])."""
    with np.load(DATA / "torch_ref" / "scan_adv.npz") as z:
        return [(str(z["names"][i]), z["body"][z["offs"][i] : z["offs"][i + 1]].tobytes(),
                 int(z["dst_len"][i]), z["jax_seg"][z["jax_seg_offs"][i] : z["jax_seg_offs"][i + 1]],
                 z["jax_meta"][i]) for i in range(len(z["names"]))]


def _u8(b: bytes) -> torch.Tensor:
    return torch.frombuffer(bytearray(b), dtype=torch.uint8)


def _fuzz_bodies(urls10k: bytes, seed: int):
    """Random bytes, truncations and bit flips of whole streams, at lengths
    around the scan kernel's chunks (8 and 16 KiB)."""
    rng = np.random.default_rng(seed)
    base = pymodel.compress(urls10k[:200000])
    base = base[wire.varint_decode(base)[1]:]
    out = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
           for n in (1, 5, 8191, 8192, 8193, 16383, 16384, 16389)]
    out += [base[: int(rng.integers(1, len(base)))] for _ in range(4)]
    for _ in range(8):
        b = bytearray(base)
        for _k in range(int(rng.integers(1, 8))):
            b[int(rng.integers(0, len(b)))] ^= 1 << int(rng.integers(0, 8))
        out.append(bytes(b))
    run = b"\x04ab" + bytes([wire.TAG_COPY_1 | (0 << 2), 2]) * 40000   # 40001 tiny tags
    return out + [run]


def test_scan_kernel_equals_plain(card, streams, scan_adv, urls10k):
    # every chunk size the kernel is built for, nslot = nseg + 1, 2 and 1;
    # the adversarial group also against the JAX scan; then a stream of 16
    # MiB whose odd and even tag chains never merge
    from csnappy_tpu_torch.ops import decode_ws

    cases = ([(b, d) for _, b, d in streams] + [(b, d) for _, b, d, _, _ in scan_adv]
             + [(b, 200000) for b in _fuzz_bodies(urls10k, 5)])
    for body, dst in cases:
        nseg = -(-dst // 32768)
        bdev = _u8(body).to(card)
        for nslot in sorted({nseg + 1, 2, 1}):
            pseg, pmeta = decode_ws.scan_plain(_u8(body), nslot)
            seg, meta = decode_ws.scan_segments(bdev, nslot, device=card)
            assert torch.equal(seg.cpu(), pseg) and torch.equal(meta[:3].cpu(), pmeta[:3]), \
                (len(body), nslot)
            for log in decode_ws.CHUNK_LOGS:
                seg = torch.empty(nslot, dtype=torch.int32, device=card)
                meta = torch.empty(4, dtype=torch.int64, device=card)
                decode_ws._launch(bdev, seg, meta, chunk_log=log)
                assert torch.equal(seg.cpu(), pseg) and torch.equal(meta[:3].cpu(), pmeta[:3]), \
                    (len(body), nslot, log)
    for _, body, dst, jseg, jmeta in scan_adv:
        nseg = -(-dst // 32768)
        seg, meta = decode_ws.scan_segments(_u8(body).to(card), nseg + 1, device=card)
        assert seg[:nseg].cpu().tolist() == jseg.tolist()
        assert meta[:3].cpu().tolist() == jmeta.tolist()
    n = (16 << 20) // 2 - 1
    body = b"\x00a" + b"\x01\x01" * n
    nseg = -(-(1 + 4 * n) // 32768)
    pseg, pmeta = decode_ws.scan_plain(_u8(body), nseg + 1)
    seg, meta = decode_ws.scan_segments(_u8(body).to(card), nseg + 1, device=card)
    assert torch.equal(seg.cpu(), pseg) and torch.equal(meta[:3].cpu(), pmeta[:3])
    assert int(meta[3]) == decode_ws.chunks(len(body))          # every chunk visited


def test_decode_ws_on_card_runs_two_kernels_and_equals_jax(card):
    # a decompress_noheader_ws call on card tensors: the scan's kernel and
    # one decode_segments kernel, no torch op between them; bytes or None
    # as the JAX pipeline answered on every fixture stream
    import hashlib

    from csnappy_tpu_torch.ops import decode_ws
    from csnappy_tpu_torch.tools.timing import device_profile

    with np.load(DATA / "torch_ref" / "streams.npz") as z:
        for i in range(len(z["names"])):
            body = z["body"][z["offs"][i] : z["offs"][i + 1]].tobytes()
            dst = int(z["dst_len"][i])
            res = decode_ws.decompress_noheader_ws(_u8(body).to(card), dst, device=card)
            assert (res is not None) == bool(z["ws_bytes"][i]), str(z["names"][i])
            assert res is None or hashlib.sha256(res).digest() == z["ws_sha"][i].tobytes()
    golden = (DATA / "urls.10K.snappy").read_bytes()
    ulen, hdr = wire.varint_decode(golden)
    bdev = _u8(golden[hdr:]).to(card)
    calls = [0]

    def call():
        calls[0] += 1
        decode_ws.decompress_noheader_ws(bdev, ulen, device=card)

    before = (decode_ws.scan_segments.launches, decode_fused.decode_segments.launches)
    ops = device_profile(call, reps=3)["calls"]
    kernels = {k: c for k, c in ops.items() if not k.startswith(("Memcpy", "Memset"))}
    assert sorted(kernels.values()) == [1, 1], kernels
    assert any("scan_kernel" in k for k in kernels) and any("decode_kernel" in k for k in kernels)
    assert (decode_ws.scan_segments.launches, decode_fused.decode_segments.launches) == \
        (before[0] + calls[0], before[1] + calls[0])


def test_failed_scan_launch_raises_and_takes_no_host_scan(card, urls10k_snappy, monkeypatch):
    from csnappy_tpu_torch.ops import decode_ws
    from csnappy_tpu_torch.runtime import native

    _, check = decode_ws._kernel()
    monkeypatch.setattr(decode_ws, "_kernel", lambda: (lambda *a: 1, check))   # cudaErrorInvalidValue
    host = []
    scan = native.scan_segments
    monkeypatch.setattr(native, "scan_segments", lambda *a, **k: host.append(1) or scan(*a, **k))
    monkeypatch.setattr(decode_ws, "scan_plain", lambda *a, **k: host.append(2))
    with pytest.raises(RuntimeError, match="scan_segments: CUDA error 1"):
        api.decompress(urls10k_snappy)
    with pytest.raises(RuntimeError, match="scan_segments: CUDA error 1"):
        decode_ws.scan_segments(_u8(urls10k_snappy).to(card), 4, device=card)
    assert not host


@pytest.fixture(scope="module")
def stream_adv():
    """The adversarial stream group of ``tests/data/torch_ref/stream_adv.npz``:
    (name, body, its three limits, and at each the JAX decode_stream's
    produced, status and sha256)."""
    with np.load(DATA / "torch_ref" / "stream_adv.npz") as z:
        return [(str(z["names"][i]), z["body"][z["offs"][i] : z["offs"][i + 1]].tobytes(),
                 z["limits"][i].tolist(), z["jax_prod"][i].tolist(), z["jax_status"][i].tolist(),
                 [bytes(h) for h in z["jax_sha"][i]]) for i in range(len(z["names"]))]


def _stream_worst_cases(urls10k: bytes):
    """16 MiB worst cases of the crossing-stream kernel, each cheap for the
    plain version: (name, body, dst_len)."""
    big = api.compress(urls10k * 24)
    ulen, hdr = wire.varint_decode(big)
    n = 1 << 24
    run = bytearray(b"\x00a")                    # an offset-1 run: every segment hangs on the last
    run += bytes([wire.TAG_COPY_2 | (63 << 2), 1, 0]) * ((n - 1) // 64)
    run += bytes([wire.TAG_COPY_2 | (((n - 1) % 64 - 1) << 2), 1, 0])
    lit = bytearray()
    wire.emit_literal(lit, (bytes(range(256)) * (n // 256))[:n])
    ones = b"".join(b"\x00" + bytes([i & 0xFF]) for i in range(1 << 21))
    return [("urls.10K x 24", big[hdr:], ulen), ("offset-1 run of 2^24", bytes(run), n),
            ("literal of 2^24", bytes(lit), n), ("2^21 one-byte literals", ones, 1 << 21)]


@pytest.mark.parametrize("limit", ["exact", "short", "multiple"])
def test_stream_kernel_equals_plain(card, streams, stream_adv, urls10k, limit):
    # streams.npz, stream_adv.npz (also against the JAX answers), the fuzz
    # bodies and the 16 MiB worst cases, at the exact, -5000 and
    # multiple-of-32768 limits
    import hashlib

    from csnappy_tpu_torch.ops import decode_stream

    j = ["exact", "short", "multiple"].index(limit)
    cases = ([(b, d) for _, b, d in streams] + [(b, lims[0]) for _, b, lims, _, _, _ in stream_adv]
             + [(b, 200000) for b in _fuzz_bodies(urls10k, 6)]
             + [(b, d) for _, b, d in _stream_worst_cases(urls10k)])
    for body, dst in cases:
        cap = {"exact": dst, "short": max(0, dst - 5000), "multiple": dst // 32768 * 32768}[limit]
        out, produced, status = decode_stream.decode_stream(_u8(body).to(card), cap, device=card)
        torch.cuda.synchronize()
        pout, pprod, pstatus = decode_stream.decode_stream(body, cap, device="cpu")
        p = int(pprod)
        assert (int(produced), int(status)) == (p, int(pstatus)), (len(body), cap)
        assert torch.equal(out[:p].cpu(), pout[:p])
    for name, body, lims, jprod, jstatus, jsha in stream_adv:
        out, produced, status = decode_stream.decode_stream(_u8(body).to(card), lims[j], device=card)
        p = int(produced)
        assert (p, int(status)) == (jprod[j], jstatus[j]), name
        assert hashlib.sha256(out[:p].cpu().numpy().tobytes()).digest() == jsha[j], name


def test_stream_kernel_literal_envelope(card):
    # a 100000-byte literal decodes; one of 2^24 + 4096 bytes is outside the
    # envelope, and the API re-decides it on decode_jnp on the card; a
    # 4-byte trailer of 2^24 - 1 decodes, the same with its top byte set is
    # E_DATA_MALFORMED; a literal from mid-segment across three boundaries
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
    body = raw[: 1 << 24]
    four = b"\xfc" + ((1 << 24) - 1).to_bytes(4, "little") + body
    out, produced, status = decode_stream.decode_stream(four, 1 << 24, device=card)
    assert (int(produced), int(status)) == (1 << 24, 0) and out.cpu().numpy().tobytes() == body
    top = b"\xfc" + ((1 << 24) - 1 + (1 << 24)).to_bytes(4, "little") + body
    assert (int(decode_stream.decode_stream(top, 1 << 24, device=card)[2])) == -5
    mid = bytearray()
    wire.emit_literal(mid, raw[:20000])
    wire.emit_literal(mid, raw[20000:120000])
    mid += bytes([wire.TAG_COPY_2 | (63 << 2)]) + (32768).to_bytes(2, "little")
    want = raw[:120000] + raw[120000 - 32768 : 120000 - 32768 + 64]
    out, produced, status = decode_stream.decode_stream(bytes(mid), len(want), device=card)
    assert (int(produced), int(status)) == (len(want), 0) and out.cpu().numpy().tobytes() == want


def test_stream_call_runs_two_kernels_and_one_memset(card, urls10k_snappy):
    # one decode_stream call on card tensors: chain_kernel and
    # segment_kernel once each, one memset of the workspace, no torch-op
    # kernel and no copy (tools/timing.device_profile, its trace taken again
    # until every operation was seen a whole number of times a call)
    from csnappy_tpu_torch.ops import decode_stream
    from csnappy_tpu_torch.tools.timing import device_profile

    unaligned = (DATA / "unaligned_uint64_test.snappy").read_bytes()
    for stream in (urls10k_snappy, unaligned):
        ulen, hdr = wire.varint_decode(stream)
        bdev = _u8(stream[hdr:]).to(card)
        calls = [0]

        def call():
            calls[0] += 1
            decode_stream.decode_stream(bdev, ulen, device=card)

        before = decode_stream.decode_stream.launches
        ops = device_profile(call, reps=3)["calls"]
        kernels = {k: v for k, v in ops.items() if not k.startswith(("Memcpy", "Memset"))}
        memsets = sum(v for k, v in ops.items() if k.startswith("Memset"))
        assert sorted(kernels.values()) == [1, 1], ops
        assert any("chain_kernel" in k for k in kernels) and any("segment_kernel" in k for k in kernels)
        assert memsets <= 1 and not any(k.startswith("Memcpy") for k in ops), ops
        assert decode_stream.decode_stream.launches == before + calls[0]


def test_failed_stream_launch_raises_and_takes_no_plain_version(card, monkeypatch):
    from csnappy_tpu_torch.ops import decode_stream

    _, check = decode_stream._kernel()
    monkeypatch.setattr(decode_stream, "_kernel", lambda: (lambda *a: 1, check))
    monkeypatch.setattr(decode_stream, "decode_plain", lambda *a, **k: pytest.fail("plain"))
    with pytest.raises(RuntimeError, match="decode_stream: CUDA error 1"):
        decode_stream.decode_stream(_u8(b"\x00a").to(card), 1, device=card)


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


@pytest.mark.parametrize("n", [1, 127, 4095, 4096, 4097, 8191, 8192, 8193, 32768,
                               4096 * 4096 + 5, 1 << 24])
def test_movebench_scan_kernel_equals_plain(card, n):
    # random, descending and all-INT32_MIN inputs, each also as a view at a
    # 4-byte offset (the kernel's scalar loads); the one-pass scan's tiles of 8,192
    from csnappy_tpu_torch.tools import movebench as mb

    assert mb.SCAN_TILE == 8192
    x = np.random.default_rng(n).integers(-(1 << 31), 1 << 31, n, dtype=np.int64).astype(np.int32)
    kinds = {"random": x, "descending": (np.arange(n, 0, -1) - (1 << 30)).astype(np.int32),
             "INT32_MIN": np.full(n, -(1 << 31), np.int32)}
    for kind, a in kinds.items():
        want = torch.cummax(torch.from_numpy(a), 0).values
        on_card = torch.from_numpy(np.concatenate([a[:1], a])).to(card)
        for xd in (on_card[1:].clone(), on_card[1:]):           # aligned, then 4 bytes off
            got = mb.scan_max(xd, device=card)
            torch.cuda.synchronize()
            assert got.shape == (n,) and torch.equal(got.cpu(), want), kind
        if n <= 32768:
            assert torch.equal(got.cpu(), mb.scan_max(a, device="cpu"))


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



def _lane_gather_cases(card):
    """(wrapper, args, expected path) for every path of lane_gather and each
    switch between them: table widths on both sides of the staging limits,
    rows whose length is not a multiple of 4 or 8, views at a 4-byte offset,
    G = 1 at 2^24, indices past both ends, full-range values."""
    rng = np.random.default_rng(15)
    S, V, T = prim.STAGED, prim.VEC_IDX, prim.VEC_TABLE

    def ints(lo, hi, n):
        return torch.from_numpy(rng.integers(lo, hi, n, dtype=np.int64).astype(np.int32)).to(card)

    def table(g, w, off=0):
        return ints(-(1 << 31), 1 << 31, g * w + off)[off:].view(g, w)

    def index(g, w, n, off=0):
        return ints(-9, w + 9, g * n + off)[off:].view(g, n)

    big = 1 << 24
    return [
        ("rowwise_gather", (table(64, 4096), index(64, 4096, 4096)), S | V | T),
        ("rowwise_gather", (table(8, prim.STAGE_MAX), index(8, prim.STAGE_MAX, prim.STAGE_MAX)),
         S | V | T),
        ("rowwise_gather", (table(8, prim.STAGE_MAX + 1),
                            index(8, prim.STAGE_MAX + 1, prim.STAGE_MAX + 4)), V),
        ("rowwise_gather", (table(64, prim.STAGE_MIN), index(64, prim.STAGE_MIN, 4096)), S | V | T),
        ("rowwise_gather", (table(64, prim.STAGE_MIN - 1), index(64, prim.STAGE_MIN - 1, 4096)),
         V),
        ("rowwise_gather", (table(64, 4096), index(64, 4096, 4097)), S | T),          # odd rows
        ("rowwise_gather", (table(64, 4096), index(64, 4096, 4100)), S | V | T),      # 4, not 8
        ("rowwise_gather", (table(64, 4096), index(64, 4096, 4096, 1)), S | T),       # idx view
        ("rowwise_gather", (table(64, 4096, 1), index(64, 4096, 4096)), S | V),       # table view
        ("rowwise_gather", (table(64, 4099), index(64, 4099, 4100)), S | V),          # odd width
        ("rowwise_gather", (table(3, 77), index(3, 77, 1001)), 0),
        ("rowwise_gather", (table(3, 77), index(3, 77, 1004, 1)), 0),
        ("local_gather", (table(300, 128), index(300, 128, 128)), V),
        ("local_gather", (table(300, 128), index(300, 128, 128, 3)), 0),
        ("table_gather", (table(1, 32768)[0], index(1, 32768, 1 << 21)[0]), S | V | T),
        ("table_gather", (table(1, 32768)[0], index(1, 32768, (1 << 21) - 1, 1)[0]), S | T),
        ("table_gather", (table(1, 32768)[0], index(1, 32768, 32768)[0]), V),
        ("table_gather", (table(1, big)[0], index(1, big, big)[0]), V),
        ("table_gather", (table(1, big, 1)[0], index(1, big, big - 3, 1)[0]), 0),
    ]


def test_lane_gather_every_path_equals_plain(card):
    for fn, args, path in _lane_gather_cases(card):
        tbl, idx = args
        groups, width = (1, tbl.numel()) if fn == "table_gather" else tbl.shape
        assert prim.lane_gather_mode(groups, width, idx.numel() // groups, tbl.data_ptr(),
                                     idx.data_ptr()) == path, (fn, tuple(tbl.shape), path)
        host = [a.cpu() for a in args]
        for limbs in ((0,) if fn == "local_gather" else (1, 2, 3, 4)):
            before = prim.PRIMITIVES[fn].wrapper.launches
            got = _prim_call(fn, args, limbs, None)                     # device=None: the card
            torch.cuda.synchronize()
            assert prim.PRIMITIVES[fn].wrapper.launches == before + 1
            want = _prim_call(fn, host, limbs, "cpu")
            assert torch.equal(got[0].cpu(), want[0]), (fn, tuple(tbl.shape), path, limbs)


def test_each_call_runs_one_kernel(card):
    # the device operations of one call (tools/timing.device_profile): one
    # kernel a wrapper of ops/primitives.py and a movebench gather, one
    # kernel and at most one memset a scan, no copy
    from csnappy_tpu_torch.tools import movebench as mb
    from csnappy_tpu_torch.tools.movebench import primitive_inputs
    from csnappy_tpu_torch.tools.timing import device_profile

    calls = {fn: (lambda fn=fn, a=[torch.from_numpy(x).to(card) for x in args]:
                  prim.PRIMITIVES[fn].wrapper(*a))
             for fn, args in primitive_inputs(64).items()}
    tbl, idx = mb.inputs(32768, card)
    calls["gather_flat"] = lambda: mb.gather_flat(tbl, idx)
    for n in (32768, 1 << 24):
        x = torch.randint(-(1 << 31), 1 << 31, (n,), dtype=torch.int32, device=card)
        calls[f"scan_max {n}"] = lambda x=x: mb.scan_max(x)
    for name, fn in calls.items():
        ops = device_profile(fn, reps=4)["calls"]
        kernels = {k: c for k, c in ops.items() if not k.startswith(("Memset", "Memcpy"))}
        memsets = sum(c for k, c in ops.items() if k.startswith("Memset"))
        assert len(kernels) == 1 and next(iter(kernels.values())) == 1, (name, ops)
        assert not any(k.startswith("Memcpy") for k in ops), (name, ops)
        if name.startswith("scan_max"):
            assert "scan_kernel" in next(iter(kernels)) and memsets <= 1.0, (name, ops)
        else:
            assert memsets == 0, (name, ops)


def test_failed_gather_and_scan_launches_raise(card, monkeypatch):
    # a launch that fails raises; no wrapper answers with its plain version
    from csnappy_tpu_torch.tools import movebench as mb

    monkeypatch.setattr(prim, "table_gather_plain", lambda *a, **k: pytest.fail("plain"))
    monkeypatch.setattr(mb, "scan_max_plain", lambda *a, **k: pytest.fail("plain"))
    launch, check = prim._kernels()["lane_gather"]
    monkeypatch.setitem(prim._kernels(), "lane_gather", (lambda *a: 1, check))
    x = torch.zeros(64, dtype=torch.int32, device=card)
    with pytest.raises(RuntimeError, match="primitives: CUDA error 1"):
        prim.table_gather(x, x)
    _, scheck = mb._scan_kernel()
    monkeypatch.setattr(mb, "_scan_kernel", lambda: (lambda *a: 1, scheck))
    with pytest.raises(RuntimeError, match="movebench: CUDA error 1"):
        mb.scan_max(x)


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
    # plain versions; the scatters and gathers at the JAX fused kernels'
    # shapes and past one block's shared memory; every shift and scan past
    # it too, with its kernels a call (_shifts_and_scans_take_the_tile)
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
        ("gather_flat", (x, ints(-10, 96 * 128 + 10, (1, 3000)), 16), {}),
        ("lane_gather", (x, ints(-300, 300, (96, 40))), {}),
        ("local_gather_rows", (x, ints(-5, 133, (96, 200))), {}),
        ("lane_gather", (x, ints(-300, 300, (1, 40))), {}),           # one row, broadcast
        ("local_gather_rows", (x, ints(-5, 133, (1, 200))), {}),
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
    # the gathers past one block's 232,448 B, one launch each:
    # gather_rows_multi at decode_fused.py:387 (8 x (256, 128)) and
    # decode_stream.py:255 (2 x (1664, 128)), indices partly out of range
    for rows_in, bits in ((256, [17, 16] * 4), (1664, [29, 17])):
        tabs = [ints(-(2**31), 2**31, (rows_in, 128)) for _ in bits]
        idx = ints(-500, rows_in * 128 + 500, (64, 128))
        before = kl.launches["gather_rows_multi"]
        got = kl.gather_rows_multi([(torch.from_numpy(t).to(card), b) for t, b in zip(tabs, bits)],
                                   torch.from_numpy(idx).to(card), 16, nrows=16)
        assert kl.launches["gather_rows_multi"] == before + 1
        want = kl.gather_rows_multi(list(zip(tabs, bits)), idx, 16, nrows=16, device="cpu")
        assert len(got) == len(bits) and all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
    big = ints(-(2**31), 2**31, (1664, 128))
    for helper, args in (("lane_gather", (big, ints(-300, 300, (1664, 128)))),
                         ("local_gather_rows", (big, ints(-5, 133, (1664, 128)))),
                         ("gather_flat", (big, ints(-10, 1664 * 128 + 10, (1, 2048)), 24)),
                         ("flip2d", (big, 16))):
        fn, before = kl.HELPERS[helper].wrapper, kl.launches[helper]
        got = fn(*(torch.from_numpy(a).to(card) if isinstance(a, np.ndarray) else a for a in args))
        assert kl.launches[helper] == before + 1, helper
        assert got.is_cuda and torch.equal(got.cpu(), fn(*args, device="cpu")), helper

    for rows in (300, 2048, 65536):
        _shifts_and_scans_take_the_tile(card, rows)


def _scan_passes(rows: int, rounds: int) -> int:
    """The scan_round grid passes the scan entry should launch: every row
    round that runs (2^r < rows, at most ``rounds``) once the totals a
    scan_finish block of 8 rows depends on (8 + 2^rounds) pass the 6,144 its
    48 KB hold."""
    rr = min(rounds, (rows - 1).bit_length())
    return rr if min(rows, 8 + (1 << rr)) > 6144 else 0


def _shifts_and_scans_take_the_tile(card, rows: int) -> None:
    """Every shift and scan helper on a (rows, 128) tile random over all of
    int32, equal to the plain version, one counted call each; one call's
    kernels from a bracketed trace (timing.device_profile): one for a
    shift; for a scan scan_totals, scan_finish and, past the window, a
    scan_round pass a round (``_scan_passes``), as many as the entry
    reports (``kl.scan_kernels``)."""
    from csnappy_tpu_torch.tools.timing import device_profile

    x = np.random.default_rng(rows).integers(-(2**31), 2**31, (rows, 128),
                                             dtype=np.int64).astype(np.int32)
    xd = torch.from_numpy(x).to(card)
    for helper, args, kw in kl.SHIFT_SCAN_RUNS:
        fn, kind = kl.HELPERS[helper].wrapper, kl.HELPERS[helper].kind
        before = kl.launches[helper]
        got = fn(xd, *args, **kw)
        torch.cuda.synchronize()
        assert kl.launches[helper] == before + 1, helper
        want = fn(x, *args, **kw, device="cpu")
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        for g, w in zip(got, want):
            assert g.is_cuda and torch.equal(g.cpu(), w), (helper, rows, kw)
        calls = device_profile(lambda: fn(xd, *args, **kw), 3)["calls"]
        kernels = {k: c for k, c in calls.items() if not k.startswith(("Memcpy", "Memset"))}
        if kind == "shift":
            assert len(kernels) == 1 and "shift_kernel" in next(iter(kernels)), calls
            assert next(iter(kernels.values())) == 1, calls
            continue
        passes = _scan_passes(rows, args[1] if helper == "fill_max_rows" else kl.ALL_ROUNDS)
        count = {name: sum(c for k, c in kernels.items() if name in k)
                 for name in ("scan_totals", "scan_round", "scan_finish")}
        assert count == {"scan_totals": 1, "scan_round": passes, "scan_finish": 1}, calls
        assert sum(kernels.values()) == kl.scan_kernels[helper] == 2 + passes, \
            (helper, rows, calls)


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


# ---------------------------------------------------------------- scale-out


def test_sharded_roundtrip_on_a_one_rank_nccl_group(card, urls10k):
    import torch.distributed as dist

    from csnappy_tpu_torch.errors import E_OUTPUT_OVERRUN
    from csnappy_tpu_torch.parallel import mesh, multihost

    assert dist.is_nccl_available()
    multihost.init(f"localhost:{multihost.free_port()}", 1, 0, timeout=60)
    try:
        assert dist.get_backend() == "nccl"
        before = encode_fused.encode_blocks.launches, decode_fused.decode_segments.launches
        fixture = (DATA / "torch_ref" / "urls.10K.jax.snappy").read_bytes()
        assert mesh.compress_sharded(urls10k) == fixture
        blocks = [urls10k[i : i + 32768] for i in range(0, len(urls10k), 32768)]
        frags = [pymodel.compress_fragment(b) for b in blocks]
        outs = mesh.decompress_fragments_sharded(frags, [len(b) for b in blocks])
        assert b"".join(outs) == urls10k
        assert (encode_fused.encode_blocks.launches, decode_fused.decode_segments.launches) == \
            (before[0] + 1, before[1] + 1)
        with pytest.raises(SnappyError) as ei:
            mesh.decompress_fragments_sharded(frags[:2], [len(blocks[0]), len(blocks[1]) - 1])
        assert ei.value.code == E_OUTPUT_OVERRUN
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------ bench line, phaseprof


def test_bench_line_on_card(card, capsys):
    import json

    import bench_torch
    from csnappy_tpu_torch.tools import timing

    assert bench_torch.main(["--reps", "3"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert tuple(line) == bench_torch.KEYS and line["compressed_bytes"] == 354567
    assert line["device"] == timing.card() and line["device"].endswith(" W")
    assert 0 < line["roofline_utilization_pct"] <= 100 and line["value"] > 0


def test_phaseprof_on_card(card, urls10k):
    import math

    from csnappy_tpu_torch.tools import phaseprof

    decode = phaseprof.profile_decode(urls10k)
    assert decode[-2]["tags"] > 0 and decode[-2]["windows"] > 0 and decode[-2]["rounds"] > 0
    for rows, names, rate in ((decode, decode_fused.PHASES, "GBps_full"),
                              (phaseprof.profile_encode(urls10k), encode_fused.PHASES, "MBps_full")):
        phases = rows[:-1]
        assert tuple(r["phase"] for r in phases) == names
        assert all(r["cycles"] >= 0 and r["median_cycles"] >= 0 for r in phases)
        assert math.isclose(sum(r["delta_ms"] for r in phases), phases[-1]["cum_ms"],
                            rel_tol=1e-12)
        assert set(rows[-1]) == {rate, "device"} and rows[-1][rate] > 0


# ------------------------------------------------------------ memory hygiene


ROOT = pathlib.Path(__file__).resolve().parents[1]


def _fresh(code: str, timeout: int = 600):
    """``code`` in a fresh Python process at the repository's root: (rc, stdout + stderr)."""
    import subprocess
    import sys

    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=timeout)
    return p.returncode, p.stdout + p.stderr


def _hygiene_lines(args, timeout=900):
    import json
    import subprocess
    import sys

    p = subprocess.run([sys.executable, "-m", "csnappy_tpu_torch.tools.hygiene", *args], cwd=ROOT,
                       capture_output=True, text=True, timeout=timeout)
    lines = [json.loads(line) for line in p.stdout.splitlines() if line.startswith("{")]
    return p.returncode, lines, (p.stdout + p.stderr)[-3000:]


def test_hygiene_harness_on_the_card(card):
    # every kernel of the port in both poisons, the decoders and scans also
    # behind the occupier: no call differs, no guard byte changes, no hang
    from csnappy_tpu_torch.tools import hygiene

    rc, lines, tail = _hygiene_lines(["--seed", "7", "--seconds", "15"])
    assert rc == 0, tail
    per = {line["hygiene"]: line for line in lines if "hygiene" in line}
    assert set(per) == set(hygiene.KERNELS), tail
    for k, line in per.items():
        assert line["poisons"] == ["0x5a", "0xa5"] and line["differed"] == 0, (k, line)
        assert line["guard_violations"] == 0, (k, line)
        assert line["occupied"] > 0 or k not in hygiene.DECODERS, (k, line)
    summ = lines[-1]["hygiene_summary"]
    assert lines[-1]["ok"] and summ["allocator"] == "hygiene"


def test_hygiene_checked_build(card):
    # the chained decoders' checked builds (device asserts) on seeded cases
    rc, lines, tail = _hygiene_lines(["--seed", "8", "--seconds", "10", "--checked",
                                      "--families", "decode,stream"])
    assert rc == 0 and lines[-1]["ok"] and lines[-1]["hygiene_summary"]["checked"], tail
    sched = next(line["hygiene_schedule"] for line in lines if "hygiene_schedule" in line)
    assert all(v["equal"] for v in sched.values()), sched


def test_hygiene_watchdog_ends_a_hung_call(card):
    # a call that waits for the card inside its launch (as the decode_ws and
    # decode_stream cases read back) on a kernel that outlasts the deadline,
    # behind the occupier: the watchdog thread prints hygiene_hang and the
    # process exits 3 long before the kernel would end
    code = """
import torch
from csnappy_tpu_torch.tools import hygiene
hygiene.install_allocator()
card = hygiene.Card(0, deadline=2.0)
def run(dev):
    x = torch.zeros(4, device=dev)
    def go():
        torch.cuda._sleep(1 << 36)            # about 35 s of SM clocks
        return [(x + 1).cpu()]
    return go
card.call(hygiene.Case("decode_stream", "a hung call", run, None, True), 0xA5, True)
print("returned", flush=True)
"""
    import time

    t0 = time.monotonic()
    rc, out = _fresh(code, timeout=300)
    assert rc == 3 and '{"hygiene_hang": "a hung call", "deadline_s": 2.0}' in out, out
    assert "returned" not in out
    print(f"exit 3 after {time.monotonic() - t0:.1f} s")


def test_hygiene_allocator_poisons_and_guards(card):
    # a fresh tensor reads as the poison byte; a write one byte past a tensor
    # changes its guard and the check counts it
    code = """
import torch
from csnappy_tpu_torch.tools import hygiene
hygiene.install_allocator()
lib = hygiene._lib()
lib.hygiene_set(0x5A, 0xC3)
x = torch.empty(1000, dtype=torch.uint8, device="cuda")
assert bool((x == 0x5A).all()), x[:8]
assert lib.hygiene_check() == 0
hygiene._rc(lib.hygiene_fill(x.data_ptr() + 1000, 2, 7, torch.cuda.current_stream().cuda_stream), "fill")
assert lib.hygiene_check() == 2
print("ok", hygiene.allocator_stats())
"""
    rc, out = _fresh(code)
    assert rc == 0 and "ok" in out, out


def test_poison_pool_fills_the_free_blocks(card):
    from csnappy_tpu_torch.tools import hygiene

    x = torch.zeros((5000,), dtype=torch.uint8, device=card)
    del x
    ranges = hygiene.poison_pool(0x77, (5000,), card)
    y = torch.empty((5000,), dtype=torch.uint8, device=card)
    assert hygiene.in_ranges(y, ranges) and bool((y == 0x77).all())


def test_main_path_never_loads_the_hygiene_allocator_or_checked_builds(card):
    # api.compress and api.decompress on the card in a fresh process: the
    # caching allocator stays, and neither libhygiene nor a checked build
    # of the chained decoders is mapped
    code = """
import pathlib, torch
from csnappy_tpu_torch import api
urls = pathlib.Path("tests/data/urls.10K").read_bytes()
assert api.decompress(api.compress(urls * 2)) == urls * 2
assert api.decompress(pathlib.Path("tests/data/urls.10K.snappy").read_bytes()) == urls
torch.cuda.synchronize()
maps = pathlib.Path("/proc/self/maps").read_text()
libs = sorted({l.split("/")[-1] for l in maps.splitlines() if "csnappy_tpu_torch/build/" in l})
print("libs", libs)
assert not any("hygiene" in l or "_checked_" in l for l in libs), libs
assert torch.cuda.memory.get_allocator_backend() == "native"
print("ok")
"""
    rc, out = _fresh(code)
    assert rc == 0 and "ok" in out, out
