"""The port's data-movement primitives (``csnappy_tpu_torch/ops/primitives.py``) on the CPU.

* against the JAX package's Pallas kernels, stored by
  ``tools/make_torch_fixtures.py --group primitives``
  (``tests/data/torch_ref/primitives.npz``), case by case, values outside
  the limbs' contract included;
* against the JAX module's jnp fallback, live, on seeded inputs inside the
  contract, function by function and for the slice as a whole at B = 2
  blocks of 32 KiB;
* batch dims, empty inputs, the errors, and a tensor on the card with
  ``device="cpu"``;
* ``lane_gather``'s path rule (``lane_gather_mode``, a pure function) at
  its switch points.

Every comparison is exact: 0 differing elements.
"""
import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csnappy_tpu.ops import primitives as jax_prim
from csnappy_tpu_torch.ops import primitives as prim
from csnappy_tpu_torch.tools.movebench import primitive_inputs

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
CASES = MAKER.read_primitives()
FNS = tuple(prim.PRIMITIVES)


def _call(mod, fn, args, limbs=0, **kw):
    got = getattr(mod, fn)(*args, **({"limbs": limbs} if limbs else {}), **kw)
    return [np.asarray(g) for g in (got if isinstance(got, tuple) else (got,))]


def _port(fn, arrays, limbs=0):
    return _call(prim, fn, [torch.from_numpy(a) for a in arrays], limbs, device="cpu")


def _jnp(fn, arrays, limbs=0):
    return _call(jax_prim, fn, [jnp.asarray(a) for a in arrays], limbs)


def _ints(rng, lo, hi, shape):
    return rng.integers(lo, hi, shape, dtype=np.int64).astype(np.int32)


@pytest.mark.parametrize("i", range(len(CASES)), ids=[c[0] for c in CASES])
def test_plain_equals_the_pallas_fixture(i):
    case, fn, limbs, inputs, outs = CASES[i]
    got = _port(fn, [inputs[a] for a in prim.PRIMITIVES[fn].args], limbs)
    assert len(got) == len(outs)
    for g, o in zip(got, outs):
        assert g.dtype == np.int32 and g.shape == o.shape and int((g != o).sum()) == 0, case


def test_fixture_holds_values_outside_the_contract():
    # the cases that tell the Pallas kernels from the jnp fallback: a table
    # value at or above 2^(8 limbs), or negative, comes back masked
    masked = 0
    for case, fn, limbs, inputs, outs in CASES:
        if fn in ("row_gather", "table_gather", "rowwise_gather") and limbs < 4:
            table = inputs[prim.PRIMITIVES[fn].args[0]]
            if (table < 0).any() and (table >= 1 << (8 * limbs)).any():
                assert (outs[0] >= 0).all() and (outs[0] < 1 << (8 * limbs)).all(), case
                masked += 1
    assert masked == 9


def _in_contract(fn, rng, shape):
    """Seeded inputs of ``fn`` inside the JAX contract (table values below
    2^(8 limbs) at the default limbs), at a [rows, 128] ``shape``."""
    C = int(np.prod(shape[:-1]))
    if fn == "local_gather":
        return _ints(rng, -(1 << 31), 1 << 31, shape), _ints(rng, -9, 140, shape)
    if fn == "local_scatter_or":
        return _ints(rng, 0, 2, shape), _ints(rng, -9, 140, shape)
    if fn == "compose_round":
        return (_ints(rng, -9, C * 128, shape), _ints(rng, 0, 1 << 23, shape),
                _ints(rng, 0, 2, shape), MAKER._chunk_end(shape))
    if fn == "row_gather":
        return _ints(rng, 0, 1 << 24, (C, 128)), _ints(rng, -3, C + 3, (8 * C,))
    if fn == "table_gather":
        return _ints(rng, 0, 1 << 16, (128 * C,)), _ints(rng, -9, 128 * C + 9, (1000,))
    return _ints(rng, 0, 1 << 24, (C, 300)), _ints(rng, -9, 309, (C, 200))


@pytest.mark.parametrize("shape", [(16, 128), (2, 3, 128)], ids=["16x128", "2x3x128"])
@pytest.mark.parametrize("fn", FNS)
def test_plain_equals_the_jnp_fallback_live(fn, shape):
    arrays = _in_contract(fn, np.random.default_rng(len(fn) * 7 + len(shape)), shape)
    for g, w in zip(_port(fn, arrays), _jnp(fn, arrays)):
        assert g.shape == w.shape and int((g != w).sum()) == 0


def test_the_slice_at_two_blocks_equals_jax():
    # the six functions on the main path's inputs, cut to B = 2 blocks of 32 KiB
    inputs = primitive_inputs(2, seed=5)
    assert inputs["local_gather"][0].shape == (2, 256, 128)
    assert inputs["table_gather"][1].shape == (65536,)
    for fn in FNS:
        for g, w in zip(_port(fn, inputs[fn]), _jnp(fn, inputs[fn])):
            assert g.shape == w.shape and int((g != w).sum()) == 0, fn


def test_batch_dims_are_rows():
    rng = np.random.default_rng(3)
    shape = (2, 3, 4, 128)
    for fn in ("local_gather", "local_scatter_or", "compose_round"):
        arrays = _in_contract(fn, rng, shape)
        flat = [a.reshape(-1, 128) for a in arrays]
        for g, w in zip(_port(fn, arrays), _port(fn, flat)):
            assert g.shape == shape and np.array_equal(g.reshape(-1, 128), w), fn
        one = [a.reshape(-1, 128)[0] for a in arrays]
        for g, w in zip(_port(fn, one), _port(fn, flat)):
            assert g.shape == (128,) and np.array_equal(g, w[0]), fn


def test_compose_round_reads_the_old_values():
    # a chain 0 -> 1 -> 2 -> 3 in one row: one round jumps each lane one
    # step of the old chain (a Jacobi round), not along already-updated lanes
    F = np.full((1, 128), 128, np.int32)
    F[0, :3] = [1, 2, 3]
    S = np.arange(128, dtype=np.int32)[None, :] + 1
    E = np.zeros((1, 128), np.int32)
    E[0, 3] = 4
    Fn, Sn, En = _port("compose_round", (F, S, E, np.full((1, 128), 128, np.int32)))
    assert Fn[0, :4].tolist() == [2, 3, 128, 128]
    assert Sn[0, :4].tolist() == [1 + 2, 2 + 3, 3 + 4, 4]
    assert En[0, :4].tolist() == [0, 0, 4, 4]


def test_limbs_mask_every_table_gather():
    t = np.array([[-1] * 128, [0x12345678] * 128], np.int32)
    for limbs, want in ((1, 0x78), (2, 0x5678), (3, 0x345678), (4, 0x12345678)):
        assert _port("row_gather", (t, np.array([1], np.int32)), limbs)[0][0, 0] == want
        assert _port("table_gather", (t[1], np.array([0], np.int32)), limbs)[0][0] == want
        assert _port("rowwise_gather", (t, np.zeros((2, 1), np.int32)), limbs)[0][1, 0] == want
        assert _port("rowwise_gather", (t, np.zeros((2, 1), np.int32)), limbs)[0][0, 0] == \
            (-1 if limbs == 4 else (1 << (8 * limbs)) - 1)


def test_empty_inputs_give_empty_results():
    before = [p.wrapper.launches for p in prim.PRIMITIVES.values()]
    z = np.zeros((0, 128), np.int32)
    e = np.zeros(0, np.int32)
    t = np.ones((4, 128), np.int32)
    assert _port("local_gather", (z, z))[0].shape == (0, 128)
    assert _port("local_scatter_or", (z, z))[0].shape == (0, 128)
    assert [o.shape for o in _port("compose_round", (z, z, z, z))] == [(0, 128)] * 3
    assert _port("row_gather", (t, e))[0].shape == (0, 128)
    assert _port("table_gather", (t[0], e))[0].shape == (0,)
    assert _port("rowwise_gather", (t, np.zeros((4, 0), np.int32)))[0].shape == (4, 0)
    assert _port("rowwise_gather", (t[:0], np.zeros((0, 5), np.int32)))[0].shape == (0, 5)
    assert [p.wrapper.launches for p in prim.PRIMITIVES.values()] == before     # the CPU never counts a launch


@pytest.mark.parametrize("fn, args, kw", [
    ("local_gather", ((2, 64), (2, 64)), {}),                      # last axis not 128
    ("local_gather", ((2, 128), (3, 128)), {}),                    # shapes differ
    ("local_scatter_or", ((0,), (0,)), {}),
    ("compose_round", ((1, 128), (1, 128), (1, 128), (2, 128)), {}),
    ("row_gather", ((0, 128), (4,)), {}),                          # empty table
    ("row_gather", ((4, 64), (4,)), {}),                           # rows of 64
    ("row_gather", ((4, 128), (2, 2)), {}),                        # rows not 1-D
    ("row_gather", ((4, 128), (4,)), {"limbs": 0}),
    ("row_gather", ((4, 128), (4,)), {"limbs": 5}),
    ("table_gather", ((0,), (4,)), {}),                            # empty table
    ("table_gather", ((4, 128), (4,)), {}),                        # table not 1-D
    ("table_gather", ((4,), (4,)), {"limbs": 0}),
    ("rowwise_gather", ((2, 0), (2, 4)), {}),                      # empty rows
    ("rowwise_gather", ((2, 8), (3, 4)), {}),                      # G differs
    ("rowwise_gather", ((2, 8), (2, 4)), {"limbs": 9}),
], ids=lambda x: str(x))
def test_meaningless_shapes_raise(fn, args, kw):
    with pytest.raises(ValueError):
        getattr(prim, fn)(*(torch.zeros(s, dtype=torch.int32) for s in args), **kw,
                          device="cpu")


def test_wrong_dtype_and_no_card_raise():
    x = torch.zeros((1, 128), dtype=torch.int32)
    with pytest.raises(TypeError):
        prim.local_gather(x.long(), x, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            prim.local_gather(x, x)                 # device=None means the card


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself as on the card."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("fn", FNS)
def test_card_tensor_with_cpu_device_raises(fn):
    arrays = _in_contract(fn, np.random.default_rng(1), (2, 128))
    args = [torch.from_numpy(a).as_subclass(_OnCard) for a in arrays]
    with pytest.raises(ValueError, match="CUDA tensor"):
        getattr(prim, fn)(*args, device="cpu")


S, V, T = prim.STAGED, prim.VEC_IDX, prim.VEC_TABLE


@pytest.mark.parametrize("groups, width, per_row, tbl_addr, idx_addr, want", [
    (16384, 128, 128, 0, 0, V),                           # row 6: narrow rows, direct
    (1, 32768, 1 << 21, 0, 0, S | V | T),                 # row 10: one table, many lookups
    (64, 32768, 32768, 0, 0, S | V | T),                  # row 11
    (1, 1 << 24, 1 << 24, 0, 0, V),                       # row 12 at 2^24: too wide to stage
    (1, 32768, 32768, 0, 0, V),                           # row 12 at 32768: few lookups
    (64, prim.STAGE_MIN - 1, 32768, 0, 0, V),             # just narrower than staging takes
    (64, prim.STAGE_MIN, 32768, 0, 0, S | V | T),
    (8, prim.STAGE_MAX, prim.STAGE_MAX, 0, 0, S | V | T),  # the widest row that fits, 8 uses
    (8, prim.STAGE_MAX + 1, prim.STAGE_MAX + 4, 0, 0, V),
    (1000, 512, prim.STAGE_STEP - 4, 0, 0, V),            # less than one staged vector step
    (1000, 512, prim.STAGE_STEP, 0, 0, S | V | T),
    (1, 32768, 8 * 32768 - 4, 0, 0, V),                   # one lookup short of 8 an entry
    (1, 32768, 8 * 32768, 0, 0, S | V | T),
    (64, 4096, 4097, 0, 0, S | T),                        # rows of an odd length: scalar indices
    (64, 4096, 4096, 0, 4, S | T),                        # indices at a 4-byte offset
    (64, 4096, 4096, 0, 8, S | T),
    (64, 4096, 4096, 4, 0, S | V),                        # the table at a 4-byte offset
    (64, 4099, 4100, 0, 0, S | V),                        # rows of a width not a multiple of 4
    (3, 77, 1001, 0, 0, 0),                               # direct, scalar
    (16384, 128, 128, 0, 12, 0),
    (16384, 128, 128, 12, 16, V),                         # the direct path ignores the table's
])
def test_lane_gather_path_rule(groups, width, per_row, tbl_addr, idx_addr, want):
    base = 1 << 20                                        # a 16-byte aligned address
    got = prim.lane_gather_mode(groups, width, per_row, base + tbl_addr, base + idx_addr)
    assert got == want
    assert prim.lane_gather_mode(groups, width, per_row, base + tbl_addr,
                                 base + idx_addr) == got          # a pure function


def test_card_device_takes_the_operands_card():
    # device=None: the card of the first CUDA operand, else the current card
    # (which raises without one); an explicit device is taken as it is, and
    # a CUDA operand with device="cpu" raises
    x = torch.zeros((1, 128), dtype=torch.int32)
    assert prim.card_device("cpu", x) == torch.device("cpu")
    with pytest.raises(ValueError, match="CUDA tensor"):
        prim.card_device("cpu", x, x.as_subclass(_OnCard))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            prim.card_device(None, x, np.zeros(3, np.int32))
