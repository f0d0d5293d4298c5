"""The port's latency and capacity probes (``csnappy_tpu_torch/tools/probe.py``) on the CPU.

* each probe's plain version against the JAX probes' own answers, stored by
  ``tools/make_torch_fixtures.py --group probes``
  (``tests/data/torch_ref/probes.npz``): every named probe of
  ``tools/mosaic_probe.py`` and ``tools/mosaic_probe2.py`` at K in
  ``PROBE_KS``, the five walks of ``tools/mosaic_probe5.py`` at N in
  ``WALK_NS``, ``smem_cap``, and every probe of ``tools/mosaic_probe3.py``,
  ``mosaic_probe3b.py`` and ``mosaic_probe3c.py`` at K in ``PROBE3_KS``
  (with their walk tables), also on the constructed inputs of
  ``PROBE3_CASES``, and every probe of ``tools/mosaic_probe4.py`` and
  ``mosaic_probe6.py`` with a TPU kernel at K in ``PROBE4_KS``, also on the
  constructed inputs of ``PROBE4_CASES``; 0 differing elements;
* the inputs and walk tables rebuilt from the seed equal the stored ones
  (drift check);
* the answers that hinge on XLA's float convert (saturation, NaN to 0), on
  unwritten scratch, on ``inrow_round``'s flip and on ``scan_tril``'s row
  totals mod 2^24; the resolve-phase gathers' floor modulus past the int32
  wrap of their sum; ``mosaic_probe6.taa_4096x128`` raising JAX's error;
* the bound's bytes: what each probe reads, not its whole input; one SM's
  bound of the product probes in cycles an iteration; the SASS reader
  that counts the wgmma probes' instructions in their loops;
  ``mm_small``'s check words, which see what its all-zero output hides;
* the ``PROBES`` table: every entry names an existing JAX site (a factory's
  ``def`` for a factory-made probe) and an entry of ``csrc/probe.cu``,
  ``csrc/probe3.cu`` or ``csrc/probe4.cu``;
* the CLI with ``--device cpu``, and ``device=None`` raising without a card.

The kernels themselves are held against these plain versions on the card
(``test_torch_cuda.py``, ``chip_smoke.py``).
"""
import importlib.util
import json
import pathlib
import re

import numpy as np
import pytest
import torch

from csnappy_tpu_torch.tools import probe as pb

# the suite runs in parallel worker processes: one intra-op thread each keeps
# the torch ops here from contending with every other worker
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _maker():
    spec = importlib.util.spec_from_file_location(
        "make_torch_fixtures", ROOT / "tools" / "make_torch_fixtures.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


MAKER = _maker()
FIXTURE = MAKER.read_probes()
CASES = [(name, k) for name, p in pb.PROBES.items()
         if p.entry not in ("walk", "smem_cap") and p.lib == "probe" for k in MAKER.PROBE_KS]
CASES += [(name, n) for name, p in pb.PROBES.items() if p.entry == "walk" for n in MAKER.WALK_NS]
CASES3 = [(name, "", k) for name, p in pb.PROBES.items() if p.lib == "probe3"
          for k in MAKER.PROBE3_KS]
CASES3 += [(name, case, k) for name, case in MAKER.PROBE3_CASES.items() for k in MAKER.PROBE3_KS]
CASES4 = [(name, case, k) for name in pb.TIMED if pb.PROBES[name].lib == "probe4"
          for case in ("",) + MAKER.PROBE4_CASES.get(name, ()) for k in MAKER.PROBE4_KS]


def _plain3(name, k, data=None):
    second = pb.second_input(name)
    return pb.probe(name, k, pb.inputs(name) if data is None else data, second, device="cpu")


@pytest.mark.parametrize("name, k", CASES, ids=[f"{n.split('.')[1]}-k{k}" for n, k in CASES])
def test_plain_equals_the_jax_probe(name, k):
    got = pb.probe(name, k, pb.inputs(name), device="cpu")
    want = FIXTURE[f"{name}__k{k}"]
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape == pb.OUT_SHAPE
    assert int((got.numpy() != want).sum()) == 0


@pytest.mark.parametrize("name, case, k", CASES3,
                         ids=[f"{n.split('.')[0][12:]}.{n.split('.')[1]}-{c or 'seed0'}-k{k}"
                              for n, c, k in CASES3])
def test_plain_equals_the_jax_probe3(name, case, k):
    # mosaic_probe3.py, mosaic_probe3b.py, mosaic_probe3c.py: the JAX
    # main()s' inputs and walk tables, or a constructed input
    got = _plain3(name, k, FIXTURE["case_" + case] if case else None)
    want = FIXTURE[f"{name}__{case + '_' if case else ''}k{k}"]
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape == pb.OUT_SHAPE
    assert int((got.numpy() != want).sum()) == 0


@pytest.mark.parametrize("name, case, k", CASES4,
                         ids=[f"{n.split('.')[0][12:]}.{n.split('.')[1]}-{c or 'seed0'}-k{k}"
                              for n, c, k in CASES4])
def test_plain_equals_the_jax_probe4(name, case, k):
    # mosaic_probe4.py and mosaic_probe6.py: the JAX main()s' inputs (and
    # mosaic_probe6's index), or a constructed input
    got = _plain3(name, k, FIXTURE["case_" + case] if case else None)
    want = FIXTURE[f"{name}__{case + '_' if case else ''}k{k}"]
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape == pb.OUT_SHAPE
    assert int((got.numpy() != want).sum()) == 0


def test_every_probe_has_fixture_cases():
    names = {key.split("__")[0] for key in FIXTURE if "__k" in key}
    assert names == set(pb.TIMED)
    assert len(CASES) == 19 * len(MAKER.PROBE_KS) + 5 * len(MAKER.WALK_NS)
    assert len(CASES3) == (39 + 7) * len(MAKER.PROBE3_KS)
    # 20 probes with a kernel on their own inputs, and 16 + 2 + 4 constructed runs
    assert len(CASES4) == (20 + 22) * len(MAKER.PROBE4_KS)
    assert {key for key in FIXTURE if key.startswith(("mosaic_probe4", "mosaic_probe6"))} == {
        f"{n}__{c + '_' if c else ''}k{k}" for n, c, k in CASES4}
    assert any((k // 2) % 2 for k in MAKER.PROBE3_KS)       # inrow_round's flip shows
    assert {key for key in FIXTURE if key.startswith("mosaic_probe3")} == {
        f"{n}__{c + '_' if c else ''}k{k}" for n, c, k in CASES3}


def test_inputs_match_the_stored_inputs():
    assert np.array_equal(pb.inputs("walk_load"), FIXTURE["data"])
    rebuilt = MAKER.build_probe_inputs()
    for key, arr in rebuilt.items():
        assert arr.dtype == FIXTURE[key].dtype and np.array_equal(arr, FIXTURE[key]), key
    walks = [n for n, p in pb.PROBES.items() if p.entry == "walk"]
    assert {pb.PROBES[n].rows for n in walks} == {144, 288, 576}
    for name in walks:
        assert np.array_equal(pb.inputs(name), FIXTURE[f"walk_r{pb.PROBES[name].rows}"])
    # the probe module's own inputs and tables, one probe of each kind
    for name, data, table in (("walk_1d", "data", "p3_t16384"), ("big_smem", "data", "p3_t36864"),
                              ("walk_u8", "data", "p3b_t36864"), ("inrow_round", "p3c_data", None),
                              ("conv_check", "p4_data", None), ("el_i16", "p6_tab", "p6_idx")):
        assert np.array_equal(pb.inputs(name), FIXTURE[data]), name
        t = pb.second_input(name)
        assert (t is None) if table is None else np.array_equal(t, FIXTURE[table]), name
    # the constructed inputs show the mechanism the seed-0 data hides
    par = FIXTURE["case_inrow"][:256] & 32767
    assert ((par >> 7) == np.arange(256)[:, None]).mean() > 0.8
    pos = FIXTURE["case_collide"][:16].reshape(-1)
    assert (pos < 1024).all() and len(np.unique(pos)) < len(pos) // 3
    # mosaic_probe4's own data is j % 251 at every flat j: every gather
    # answers alike whatever its rows and limbs, and pointer jumping is at a
    # fixed point; the constructed inputs part them
    same = {int(FIXTURE[f"mosaic_probe4.gather_r{r}_l{l}__k37"][0, 0])
            for r in (32, 64, 128, 160, 288, 400) for l in (1, 2)}
    parted = {int(FIXTURE[f"mosaic_probe4.gather_r{r}_l{l}__p4rand_k300"][0, 0])
              for r in (32, 64, 128, 160, 288, 400) for l in (1, 2)}
    assert same == {4190} and len(parted) == 12
    assert (FIXTURE["mosaic_probe4.conv_check__k300"] == 0).all()
    assert [int(FIXTURE[f"mosaic_probe4.conv_check__p4path_k{k}"][0, 0]) for k in (1, 3)] == [
        16, 16 + 256 + 4095]
    # mosaic_probe6 keeps the low 8 bits of a table value
    wide = FIXTURE["case_p6wide"]
    assert wide.min() < 0 and wide.max() > 255


def test_float_convert_saturates_and_maps_nan_to_zero():
    # vec_only's bf16 carry passes int32's range at K = 1 (XLA saturates)
    # and is NaN from K = 3 (inf x 0; XLA converts NaN to 0)
    assert (_plain3("vec_only", 1) == 2147483647).all()
    assert (_plain3("vec_only", 3) == 0).all()
    assert (_plain3("vec_scal", 1) == -2147474943).all()      # INT32_MAX + p + tc + tags[0]
    assert (_plain3("vec_scal", 3) == 9416).all()
    x = torch.tensor([float("nan"), float("inf"), -float("inf"), 3e9, -3e9, -2.5, 2.5])
    assert pb._sat_int32(x).tolist() == [0, 2**31 - 1, -2**31, 2**31 - 1, -2**31, -2, 2]


def test_probe3_unwritten_scratch_and_flips():
    # at K = 0 tags[0] is unwritten: INT32_MIN; big_smem adds two unwritten
    # tags (wrapping to 0), and tags[17407] stays unwritten below K = 17408
    for name in ("walk_1d", "walk_dec_real", "scal_only", "walk_u8", "walk_pair_u4",
                 "walk_dec_full", "walk_enc_real"):
        assert int(_plain3(name, 0)[0, 0]) == pb.INT_MIN, name
    assert int(_plain3("walk_il4", 0)[0, 0]) == pb.INT_MIN + 11 + 217 + 3001   # its chains' starts
    assert int(_plain3("walk_enc", 0)[0, 0]) == 0                # tb1[0] + tb2[0]
    assert int(_plain3("big_smem", 0)[0, 0]) == 0
    assert int(_plain3("big_smem", 1)[0, 0]) == -2147483604
    # inrow_round: floor(K / 2) flips of bit 0; the constructed input's
    # pointers jump within their rows
    k0, k1, k3 = (FIXTURE[f"mosaic_probe3c.inrow_round__k{k}"] for k in (0, 1, 3))
    assert (k3 != k0).all() and (k1 != k0).sum() < 8
    c0, c1 = (FIXTURE[f"mosaic_probe3c.inrow_round__inrow_k{k}"] for k in (0, 1))
    assert (c1 != c0).sum() > 512
    # the colliding scatter adds several values into one bin
    hist = _plain3("scatter_oc256_e2048_l2", 1, FIXTURE["case_collide"])
    assert int(hist.max()) > int(FIXTURE["case_collide"][:16].max())


def test_scan_tril_drops_bit_24_of_a_row_total():
    # case_rowfull's rows 0 and 3 total 2^24 at odd i; scan_tril carries row
    # totals in three 8-bit limbs, so rows 1-7 see them as 0 (the JAX
    # answer), where a 32-bit carry would add 2^24
    x = (FIXTURE["case_rowfull"][:8] & 0x1FFFF).astype(np.int64)
    assert (x[[0, 3]] == 0x1FFFF).all()

    def acc(k, mod):
        out = np.zeros((8, 128), np.int64)
        for i in range(k):
            s = np.cumsum(x + (i & 1), axis=1)
            tot = s[:, -1] & mod
            out += s + (np.cumsum(tot) - tot)[:, None]
        return ((out + 2**31) % 2**32 - 2**31).astype(np.int32)

    want = FIXTURE["mosaic_probe3.scan_tril__rowfull_k3"]
    assert np.array_equal(want, acc(3, 0xFFFFFF))
    assert (want[1:] != acc(3, -1)[1:]).all() and np.array_equal(want[0], acc(3, -1)[0])
    got = _plain3("scan_tril", 3, FIXTURE["case_rowfull"])
    assert np.array_equal(got.numpy(), want)


def test_bound_counts_what_each_probe_reads():
    # a walk reads its table and no input; the others read the input rows
    # they use and no table (the bound's bytes: reads, K and the output)
    for name, p in pb.PROBES.items():
        short = name.split(".")[1]
        if p.lib == "probe4":
            # a gather its table and 32 x 128 indices; dynslice_32 the rows
            # its windows cover; the others 32 rows; taa_4096x128 nothing
            rows = re.search(r"_r(\d+)_", short)
            want = {"base": 424, "base_i16": 424, "el_orient": 424, "el_i16": 424,
                    "dynslice_32": 200 - 32, "taa_4096x128": -32}.get(
                short, int(rows.group(1)) if rows else 0)
            assert p.reads == (want + 32) * 128, name
        elif p.lib != "probe3":
            assert p.reads <= max(p.rows, 1) * 128, name
        elif short.startswith(("walk", "scal_only", "big_smem")):
            assert p.reads == p.table > 0, name
        elif short.startswith(("gather", "gv2")):
            assert p.reads == int(re.search(r"_r(\d+)_", short).group(1)) * 128, name
        else:
            want = {"vec_only": 128 * 128, "vec_scal": 128 * 128 + pb.N1D,
                    "scatter_oc256_e2048_l2": 2048, "scatter_oc256_e2048_l4": 2048,
                    "taa_ax0_128x2048": 128}.get(short, 256 * 128)
            assert p.reads == want, name
    assert pb.PROBES["mosaic_probe.vpu_dense"].reads == 8 * 128
    ms, by = pb._bound("mosaic_probe3.walk_1d", pb.PROBES["mosaic_probe3.walk_1d"].k_hi)
    assert by == "bytes" and ms == 4 * (pb.N1D + 1 + 8 * 128) / pb.HBM_BYTES_PER_S * 1e3
    ms, by = pb._bound("mosaic_probe3b.scatter_oc256_e2048_l2", 1024)
    assert by == "operations" and ms == 1024 * 2048 / pb.OPS_PER_S * 1e3


def test_one_sm_bound_of_the_product_probes():
    # a probe is one block: its least SM cycles an iteration are its tensor
    # operations over one SM's dense rate a cycle (4,096 bf16, 8,192 int8:
    # the data sheet's rate over 132 SMs at 1,830 MHz)
    for rate, per_s in ((pb.SM_OPS_PER_CYCLE["bf16"], pb.BF16_PER_S),
                        (pb.SM_OPS_PER_CYCLE["int8"], pb.INT8_PER_S)):
        assert rate == pytest.approx(per_s / 132 / 1.83e9, rel=1e-3)
    for short, want in (("dot_bf16_256", 2048), ("dot_s8", 1024), ("mm_small", 1024)):
        b = pb.sm_bound(short)
        assert abs(b["sm_bound_cycles"] - want) <= 1 and b["sm_share"] is None, (short, b)
    half = pb.sm_bound("dot_s8", 2 * pb.sm_bound("dot_s8")["sm_bound_cycles"])
    assert half["sm_share"] == pytest.approx(0.5)
    assert pb.sm_bound("walk_1d") == {}
    assert {n.split(".")[1] for n, p in pb.PROBES.items() if pb.sm_bound(n)} == {
        "mm_small", "vec_only", "vec_scal", "dot_s8", "dot_bf16_256"}


def test_mm_small_check_words_see_what_the_cast_hides():
    # the int32 output is zero at every K (acc stays below 1); the check
    # words the kernel adds after its cycles depend on the product, the
    # carry and acc, and are exact in any summation order
    d = torch.from_numpy(pb.inputs("mm_small"))
    assert pb.words("mm_small", 0, d, device="cpu").tolist() == [0, 0, 0]
    w = {k: pb.words("mm_small", k, d, device="cpu") for k in (1, 2, 37)}
    assert not any(pb.probe("mm_small", k, d, device="cpu").any() for k in w)
    acc, c, s = pb._mm_small(37, d)
    assert float(acc.float().max()) < 1 and 0 < float(s) and float((c - c.round()).abs().max()) < 0.01
    assert int(w[1][2]) == 0 and int(w[2][2]) == 256 * int(pb._bits(pb._mm_small(1, d)[0][0, 0]))
    assert len({tuple(v.tolist()) for v in w.values()}) == 3
    # b one bit off (a kept): the product, and so acc, differ
    bad = d.clone()
    bad[:128] ^= 2
    diff = pb.words("mm_small", 2, bad, device="cpu") != w[2]
    assert diff[:2].all(), diff
    assert pb.WORDS["mosaic_probe.mm_small"][1] == len(w[1])
    with pytest.raises(ValueError, match="no check words"):
        pb.words("dot_s8", 1, d, device="cpu")


def _jax_vec_carries(d: np.ndarray, products: int) -> list[np.ndarray]:
    """The carry after each of the first ``products`` products of
    mosaic_probe3.py:175 ``_vec_chunk``, in jnp: bf16 operands, float32
    sums (``preferred_element_type``), rounded to bf16; as uint16 bits."""
    import jax
    import jax.numpy as jnp

    m = (jnp.asarray(d[0:128]) & 1).astype(jnp.bfloat16)
    x = (jnp.asarray(d[0:8]) & 1).astype(jnp.bfloat16)
    out = []
    for _ in range(products):
        x = jax.lax.dot_general(x, m, dimension_numbers=(((1,), (0,)), ((), ())),
                                preferred_element_type=jnp.float32).astype(jnp.bfloat16)
        out.append(np.asarray(jax.lax.bitcast_convert_type(x, jnp.uint16)))
    return out


@pytest.mark.parametrize("name, k", [(n, k) for n in ("vec_only", "vec_scal") for k in (0, 1, 3)])
def test_vec_check_words_hold_the_jax_carry(name, k):
    # the int32 output is INT32_MAX at K = 1 and 0 from K = 3 whatever the
    # products computed; the words are iteration 0's carry after products
    # 1-3 as the JAX body computes it, weighted by position
    d = FIXTURE["data"]
    got = pb.words(name, k, d, pb.second_input(name), device="cpu")
    assert pb.WORDS[f"mosaic_probe3.{name}"] == (pb.vec_words, pb.VEC_WORDS)
    assert got.dtype == torch.int64
    weight = np.arange(1, 8 * 128 + 1, dtype=np.int64)
    want = [int((weight * x.reshape(-1).astype(np.int64)).sum()) for x in
            _jax_vec_carries(d, pb.VEC_WORDS)] if k else [0] * pb.VEC_WORDS
    assert got.tolist() == want
    if k == 3:
        # m transposed (a fragment layout fault) or one carry bit off: the
        # output is the same, the words are not
        bad = d.copy()
        bad[:128] = (d[:128] & ~1) | (d[:128] & 1).T
        assert torch.equal(pb.probe(name, 3, bad, pb.second_input(name), device="cpu"),
                           pb.probe(name, 3, d, pb.second_input(name), device="cpu"))
        assert (pb.words(name, 3, bad, pb.second_input(name), device="cpu") != got).all()
        bad = d.copy()
        bad[0, 5] ^= 1
        assert (pb.words(name, 3, bad, pb.second_input(name), device="cpu") != got).all()


@pytest.mark.parametrize("data, k", [(c, k) for c in ("p3c_data", "case_inrow")
                                     for k in (0, 1, 3, 37)])
def test_inrow_round_words_hold_every_row(data, k):
    # the 256 words are the whole (256, 128) par after k rounds as the JAX
    # body computes it (mosaic_probe3c.py:94, take_along_axis over the whole
    # table), sum_c (c + 1) par[r, c] a row; rows 0-7 are the output
    import jax.numpy as jnp

    d = FIXTURE[data]
    par = jnp.asarray(d[0:256]) & 32767
    row = jnp.arange(256)[:, None]
    for i in range(k):
        nxt = jnp.take_along_axis(par, par & 127, axis=1)
        par = jnp.where((par >> 7) == row, nxt, par) ^ (i & 1)
    par = np.asarray(par).astype(np.int64)
    got = pb.words("inrow_round", k, d, device="cpu")
    assert got.shape == (256,) and got.tolist() == (par * np.arange(1, 129)).sum(1).tolist()
    out = pb.probe("inrow_round", k, d, device="cpu").numpy()
    assert np.array_equal(out, par[:8]) and np.array_equal(
        out, FIXTURE[f"mosaic_probe3c.inrow_round__{'inrow_' if data == 'case_inrow' else ''}k{k}"])


SASS = """
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_115mm_small_kernelEPKiiPiPx
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                 /* 0x00000a00ff017b82 */
                                                                          /* 0x000fe40000000800 */
.L_x_0:
        /*0010*/                   STS [R2], R3 ;                         /* 0x0000000302007388 */
        /*0020*/              @!P0 BRA `(.L_x_0) ;                        /* 0xfffffffc00f88947 */
.L_x_1:
        /*0030*/                   WARPGROUP.ARRIVE ;
        /*0040*/                   HGMMA.64x128x16.F32.BF16 R24, R88, gdesc[UR4], RZ, !UPT ;
        /*0050*/                   HGMMA.64x128x16.F32.BF16 R24, R92, gdesc[UR8], R24, gsb0 ;
        /*0060*/                   WARPGROUP.DEPBAR.LE gsb0, 0x0 ;
        /*0070*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0080*/               @P1 BRA `(.L_x_1) ;
        /*0090*/                   HGMMA.64x128x16.F32.BF16 R24, R88, gdesc[UR4], RZ, !UPT ;
        /*00a0*/                   EXIT ;
.L_x_2:
        /*00b0*/                   BRA `(.L_x_2);
\t\t..........
\t\tFunction : _ZN12_GLOBAL__N_110dot_kernelIaEEvPKiS2_iPiPx
        /*0000*/                   IMMA.16816.S8.S8 R4, R8.ROW, R12.COL, R4 ;
        /*0010*/                   IGMMA.64x128x32.S8.S8 R88, gdesc[UR12], RZ, !UPT, gsb0 ;
        /*0020*/               @P0 BRA 0x10 ;
        /*0030*/                   BRA 0x50 ;
        /*0040*/                   EXIT ;
"""


def test_sass_loops_reads_a_kernel_and_its_loops():
    ops, loops = pb.sass_loops(SASS, "mm_small_kernel")
    assert ops == ["LDC", "STS", "BRA", "WARPGROUP", "HGMMA", "HGMMA", "WARPGROUP", "BAR", "BRA",
                   "HGMMA", "EXIT", "BRA"]
    assert loops == [["STS", "BRA"], ["WARPGROUP", "HGMMA", "HGMMA", "WARPGROUP", "BAR", "BRA"],
                     ["BRA"]]
    ops, loops = pb.sass_loops(SASS, "dot_kernelIa")
    assert ops == ["IMMA", "IGMMA", "BRA", "BRA", "EXIT"] and loops == [["IGMMA", "BRA"]]
    with pytest.raises(ValueError, match="0 functions"):
        pb.sass_loops(SASS, "dot_kernelI13__nv_bfloat16")
    with pytest.raises(ValueError, match="2 functions"):
        pb.sass_loops(SASS, "_GLOBAL__N_")
    assert set(pb.WGMMA_KERNELS) <= {n for n, p in pb.PROBES.items() if p.tensor}
    ops, loops = pb.sass_loops(SASS, "mm_small_kernel", full=True)
    assert ops[4] == "HGMMA.64x128x16.F32.BF16" and loops[0] == ["STS", "BRA"]
    assert loops[1][-2:] == ["BAR.SYNC.DEFER_BLOCKING", "BRA"]


def test_vec_chain_on_a_permutation_holds_every_product():
    # case_vecperm's m is a permutation P (one 127-cycle and a fixed point
    # off rows 0-7), so the carry stays one exact 1 a row at every K and the
    # int32 output, x0 P^(8K), counts every product of every iteration: one
    # product more or fewer, or one computed with P transposed, moves a 1
    # (the plain versions meet these answers in test_plain_equals_the_jax_probe3)
    d = FIXTURE["case_vecperm"]
    assert sorted(np.flatnonzero(d[:128] & 1) % 128) == list(range(128))
    perm = np.argmax(d[:128] & 1, axis=1)
    seen = set()
    for k in MAKER.PROBE3_KS:
        col = np.arange(8)
        for _ in range(8 * k + 1):
            col = perm[col]
        want = np.zeros((8, 128), np.int32)
        want[np.arange(8), col] = 1
        assert np.array_equal(FIXTURE[f"mosaic_probe3.vec_only__vecperm_k{k}"], want), k
        seen.add(tuple(col))
    assert len(seen) == len(MAKER.PROBE3_KS)


def test_smem_cap_plain_equals_the_interpreter():
    for rows, ok in zip(FIXTURE["smem_cap_rows"], FIXTURE["smem_cap_ok"]):
        assert pb.smem_cap(int(rows), device="cpu") == bool(ok)
        out = pb.probe("smem_cap", int(rows), pb.inputs("smem_cap"), device="cpu")
        assert (out == 2).all()


def test_unwritten_scratch_reads_as_the_interpreters_fill():
    # at K = 0 the probes that read scratch they never wrote answer INT32_MIN
    d = pb.inputs("walk_ldst")
    for name in ("walk_ldst", "walk_vst", "row_write", "walk_smem_st", "row_write_al"):
        assert int(pb.probe(name, 0, d, device="cpu")[0, 0]) == pb.INT_MIN, name
    # before its first refill the windowed walk adds INT32_MIN every step
    assert int(pb.probe("smem_window_dma", 2, d, device="cpu")[0, 0]) == 2


def test_table_names_existing_jax_sites_and_cuda_entries():
    cu = {lib: (ROOT / "csnappy_tpu_torch" / "csrc" / f"{lib}.cu").read_text()
          for lib in ("probe", "probe3", "probe4")}
    assert set(pb.SITES) == {p.call for p in pb.PROBES.values()}
    assert len(pb.SITES) == 9
    assert {p.lib for p in pb.PROBES.values()} == set(cu)
    factory = re.compile(r"def (_mk_gather|_mk_scatter|_mk_taa|_mk_gv2)\(")
    kern4 = {"lane_gather_32x128": "lane_gather_kern", "conv_unrolled": "while_conv_kern",
             "conv_check": "while_conv_kern", "dynslice_32": "dynslice_kern"}
    for name, p in pb.PROBES.items():
        module, short = name.split(".")
        for site in (p.site, p.call):
            path, line = site.split(":")
            assert path == f"tools/{module}.py", name
            text = (ROOT / path).read_text().splitlines()[int(line) - 1]
            if site == p.call:
                assert "pl.pallas_call(" in text, (name, text)
            elif module == "mosaic_probe4":
                assert text.startswith(f"def {kern4.get(short, 'gather_kern')}("), (name, text)
            elif module == "mosaic_probe6":
                # its factory's def, and the JAX PROBES entry calls that factory
                fac = re.match(r"def (mk_\w+)\(", text).group(1)
                src = (ROOT / path).read_text()
                assert re.search(rf'"{short}": \({fac}\(', src), name
            elif p.entry == "walk":
                assert text.startswith("def walk_kern("), (name, text)
            elif re.match(rf"def (k_)?{short}\(", text) is None:
                # a factory-made probe: its factory's def, and the JAX
                # PROBES entry calls that factory
                assert factory.match(text), (name, text)
                src = (ROOT / path).read_text()
                assert re.search(rf'"{short}": \(\s*{factory.match(text).group(1)}\(', src), name
        if p.lib == "probe":
            assert f"int probe_{p.entry}_launch(" in cu["probe"] or \
                f"PROBE_ENTRY({p.entry}," in cu["probe"], name
        elif p.lib == "probe4":
            rows = re.match(r"gather_r(\d+)_l(\d)$", short)
            if p.fails:
                assert p.entry == "" and p.plain is None, name
                assert f"ENTRY({short}" not in cu["probe4"], name
            elif rows:
                r, limbs = rows.groups()
                assert p.entry == short and re.search(
                    rf"^GATHER_ENTRY\({r}, {limbs}, uint{8 * int(limbs)}_t\)", cu["probe4"], re.M), name
                assert p.plain.args == (int(rows.group(1)), int(rows.group(2))), name
            else:
                # mosaic_probe6's four gathers compute one function: one entry
                entry = "flat_gather" if module == "mosaic_probe6" else short
                assert p.entry == entry and re.search(rf"^PROBE4_ENTRY\({entry},", cu["probe4"],
                                                      re.M), name
            assert (p.rows, p.index) == ((400, 0) if module == "mosaic_probe4" else (424, 32)), name
        else:
            assert p.entry == short and re.search(
                rf"^(PROBE3|WALK|GATHER)_ENTRY\({short},", cu["probe3"], re.M), name
            assert p.table in (0, pb.N1D, pb.NBIG) and p.rows == pb.ROWS, name
        assert p.k_lo <= p.k_hi and p.space in ("shared", "global", "registers", "")
        timed = name in pb.TIMED + ("mosaic_probe5.smem_cap",)
        assert (p.space == "") == bool(p.fails) == (not timed), name
        if p.entry == "walk":
            assert p.space == ("global" if p.rows * 512 > 232448 else "shared"), name
    # the k ranges and walk tables of the JAX tables; a factory-made
    # probe's shape (R, E, limbs, int8; R, C, axis) in its plain version
    for module in MAKER.PROBE3_FILES:
        jax_probes = MAKER.probe_module(module).PROBES
        src = (ROOT / "tools" / f"{module}.py").read_text()
        names = [n for n in pb.PROBES if n.startswith(module + ".")]
        assert len(names) == len(jax_probes) == {"mosaic_probe3": 20, "mosaic_probe3b": 11,
                                                 "mosaic_probe3c": 8}[module]
        for name in names:
            p, short = pb.PROBES[name], name.split(".")[1]
            assert jax_probes[short][2] == (p.k_lo, p.k_hi), name
            if module == "mosaic_probe3":
                assert jax_probes[short][4] == p.table, name
            g = re.search(rf'"{short}": \(\s*_mk_gather\((\d+), (\d+), (\d+)(, s8=True)?\)', src) \
                or re.search(rf'"{short}": \(\s*_mk_gv2\((\d+), (\d+), (\d+)()\)', src)
            if g:
                rows, e, limbs = map(int, g.groups()[:3])
                assert p.plain.args == (rows, (7 if g.group(4) else 8) * limbs) and p.ops == e, name
            t = re.search(rf'"{short}": \(_mk_taa\((\d+), (\d+), (\d)\)', src)
            if t:
                assert p.plain.args == tuple(map(int, t.groups())), name
    # mosaic_probe6.py's PROBES: the same names and k ranges; mosaic_probe4.py's
    # main() labels, one probe each
    jax6 = MAKER.probe_module("mosaic_probe6").PROBES
    assert {n.split(".")[1] for n in pb.PROBES if n.startswith("mosaic_probe6.")} == set(jax6)
    for short, (_, kr) in jax6.items():
        p = pb.PROBES[f"mosaic_probe6.{short}"]
        assert (p.k_lo, p.k_hi) == kr, short
    assert [n.split(".")[1] for n in pb.PROBES if n.startswith("mosaic_probe4.")] == list(
        MAKER.PROBE4_NAMES)
    main4 = (ROOT / "tools" / "mosaic_probe4.py").read_text()
    # five _time calls: the lane gather, the gathers by R and limbs, two conv, dynslice
    assert len(re.findall(r"^\s+_time\(", main4, re.M)) == 5
    assert "for R in (32, 64, 128, 160, 288, 400):" in main4 and "for limbs in (1, 2):" in main4


def test_taa_4096x128_fails_to_trace_as_in_jax():
    # the JAX probe raises at trace time (mosaic_probe6.py:138); the port
    # raises the same ValueError before any launch, on either device
    msg = str(FIXTURE["p6_taa_error"])
    assert msg == pb.TAA6_ERROR
    data, idx = pb.inputs("mosaic_probe6.base"), pb.second_input("mosaic_probe6.base")
    with pytest.raises(ValueError, match=re.escape(msg)):
        pb.probe("taa_4096x128", 3, data, idx, device="cpu")
    with pytest.raises(ValueError, match=re.escape(msg)):
        pb.measure("mosaic_probe6.taa_4096x128", device="cpu")
    assert "mosaic_probe6.taa_4096x128" not in pb.TIMED


def test_resolve_gathers_take_the_floor_modulus_past_the_wrap():
    # on case_p4rand the 16-bit gathers' acc passes 2^31 before WRAP_K; from
    # there (g + acc + i) is negative and jnp's % (the divisor's sign) keeps
    # the index in the table, where C's truncating % would give a negative
    # index, clipped to 0
    d = torch.from_numpy(FIXTURE["case_p4rand"])
    first = {}
    for rows in (32, 64, 128, 160, 288, 400):
        m = rows * 128
        t = (d[:rows].reshape(-1) & 0xFFFF).tolist()
        ix, acc = int(d[0, 0]) % m, 0
        for i in range(pb.WRAP_K):
            g = t[ix]
            ix, acc = pb._i32(g + acc + i) % m, pb._i32(acc + g)
            if acc < 0 and rows not in first:
                first[rows] = i                  # the iteration whose sum wraps
        got = int(pb.probe(f"gather_r{rows}_l2", pb.WRAP_K, d, device="cpu")[0, 0])
        assert got == acc < 0, rows
    assert (min(first.values()), max(first.values())) == (56_213, 77_894)
    # the bound's reads of dynslice_32: the rows its 32-row windows cover on
    # the tool's data by k_hi (12 of the 40 bases)
    acc, rows = 0, set()
    col = pb.inputs("dynslice_32")[:, 0].tolist()
    for i in range(pb.PROBES["mosaic_probe4.dynslice_32"].k_hi):
        base = (pb._i32(acc + i) % 40) * 8
        rows |= set(range(base, base + 32))
        acc = (acc + col[base]) % 251
    assert pb.PROBES["mosaic_probe4.dynslice_32"].reads == len(rows) * 128 == 200 * 128


def test_resolve_and_input_checks():
    assert pb.resolve("walk_c2_r288") == "mosaic_probe5.walk_c2_r288"
    assert pb.resolve("mosaic_probe.roll_static") == "mosaic_probe.roll_static"
    with pytest.raises(KeyError):
        pb.resolve("walk")
    with pytest.raises(ValueError, match="int32"):
        pb.probe("walk_load", 3, pb.inputs("walk_load")[:16], device="cpu")
    with pytest.raises(ValueError, match="k must be"):
        pb.probe("walk_load", -1, pb.inputs("walk_load"), device="cpu")
    with pytest.raises(ValueError, match="needs its walk table"):
        pb.probe("walk_1d", 3, pb.inputs("walk_1d"), device="cpu")
    with pytest.raises(ValueError, match="walk table must be"):
        pb.probe("walk_1d", 3, pb.inputs("walk_1d"), pb.second_input("big_smem"), device="cpu")
    with pytest.raises(ValueError, match="takes no walk table"):
        pb.probe("inrow_round", 3, pb.inputs("inrow_round"), pb.second_input("walk_1d"),
                 device="cpu")


def test_cli_on_the_cpu_prints_the_keys(capsys):
    assert pb.main(["walk_smem", "roll_dyn", "walk_c1_r144", "--smem", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 5
    recs = [json.loads(s) for s in lines[:4]]
    assert [r["probe"] for r in recs] == ["mosaic_probe.walk_smem", "mosaic_probe.roll_dyn",
                                          "mosaic_probe5.walk_c1_r144", "mosaic_probe5.smem_cap"]
    for r in recs:
        assert {"ns_per_iter", "cycles_per_iter", "k_lo", "k_hi", "space",
                "result_equals_plain"} <= set(r)
        assert r["ns_per_iter"] is None and r["cycles_per_iter"] is None   # not measured here
        assert r["result_equals_plain"] is True and r["device"] == "cpu"
    assert set(json.loads(lines[-1])) == {r["probe"] for r in recs}


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pb.probe("walk_load", 3, pb.inputs("walk_load"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pb.main(["walk_load"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pb.smem_capacity()

