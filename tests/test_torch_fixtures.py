"""The port against the JAX package's stored outputs (``tests/data/torch_ref``).

``tools/make_torch_fixtures.py`` ran the JAX package's ``decode_blocks``,
``encode_blocks`` and ``compress_np`` (Pallas interpret mode on the CPU) on
seeded inputs and stored inputs and outputs, and its whole-stream decoders
and ``api.decompress_noheader`` on seeded streams (``streams.npz``, outputs
as sha256), its paged container (``container.npz``) and movebench's two
Pallas kernels (``movebench.npz``).  Here the inputs are rebuilt
from the seed and must equal the stored ones (drift check); then the port's
plain path must give the stored outputs exactly: the same bytes, the same
``produced`` and the same ``status``.
"""
import hashlib
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from csnappy_tpu_torch import api
from csnappy_tpu_torch.errors import SnappyError
from csnappy_tpu_torch.interop import meta_from_jax
from csnappy_tpu_torch.models import pymodel
from csnappy_tpu_torch.ops import decode_fused, encode_fused

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF = ROOT / "tests" / "data" / "torch_ref"
URLS_JAX_BYTES = 354_567


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs in parallel worker processes; one intra-op thread each
    # keeps the torch ops here from contending with every other worker
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _maker():
    spec = importlib.util.spec_from_file_location(
        "make_torch_fixtures", ROOT / "tools" / "make_torch_fixtures.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


MAKER = _maker()
DECODE_GROUPS = dict(MAKER.DECODE_GROUPS, **MAKER.FAR_GROUP)
STREAMS, STREAM_REF = MAKER.read_streams()


@pytest.fixture(scope="module")
def ref():
    with np.load(REF / "blocks.npz") as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def rebuilt(urls10k, baddata3):
    return MAKER.build_inputs(urls10k, baddata3, far=True)


def test_inputs_have_not_drifted(ref, rebuilt):
    assert set(rebuilt) <= set(ref)
    for key, arr in rebuilt.items():
        assert arr.dtype == ref[key].dtype and np.array_equal(arr, ref[key]), key


@pytest.mark.parametrize("group", sorted(MAKER.DECODE_GROUPS))
def test_decode_equals_jax(ref, group):
    out, prod, status = decode_fused.decode_blocks(
        ref[f"{group}_comp"], ref[f"{group}_lens"], DECODE_GROUPS[group], device="cpu")
    assert status.numpy().tolist() == ref[f"{group}_status"].tolist()
    assert prod.numpy().tolist() == ref[f"{group}_prod"].tolist()
    for i, n in enumerate(prod.tolist()):
        assert np.array_equal(out[i, :n].numpy(), ref[f"{group}_out"][i, :n]), (group, i)


def test_decode_groups_cover_every_outcome(ref):
    codes = set()
    for group in DECODE_GROUPS:
        codes |= set(ref[f"{group}_status"].tolist())
    assert codes == {0, -3, -5}


def test_far_copy4_matches_the_oracle_not_jax(ref):
    # the JAX kernel clamps COPY_4 offsets to 0xFFFF (decode_fused.py:218-225),
    # so an offset of 66000 fails there; the port keeps 32 bits, as the oracle
    comp = ref["far_comp"][0, : ref["far_lens"][0]].tobytes()
    assert ref["far_status"].tolist() == [-5]
    out, prod, status = decode_fused.decode_blocks(
        ref["far_comp"], ref["far_lens"], DECODE_GROUPS["far"], device="cpu")
    want = pymodel.decompress_noheader(comp, DECODE_GROUPS["far"])
    assert int(status[0]) == 0 and int(prod[0]) == len(want) == 66008
    assert out[0, : len(want)].numpy().tobytes() == want


@pytest.mark.parametrize("group", sorted(MAKER.ENCODE_GROUPS))
def test_encode_equals_jax(ref, group):
    comp, clen = encode_fused.encode_blocks(ref[f"{group}_data"], ref[f"{group}_lens"],
                                            device="cpu")
    assert clen.numpy().tolist() == ref[f"{group}_clen"].tolist()
    # rows of the same width (max_compressed_length rounded up to 1 KiB),
    # zero past the length in both
    assert comp.shape == ref[f"{group}_comp"].shape
    assert np.array_equal(comp.numpy(), ref[f"{group}_comp"])


def test_compress_np_equals_jax_stream(urls10k):
    fixture = (REF / "urls.10K.jax.snappy").read_bytes()
    assert len(fixture) == URLS_JAX_BYTES
    assert encode_fused.compress_np(urls10k, device="cpu") == fixture
    assert api.compress(urls10k, device="cpu") == fixture


def test_fixture_stream_decodes_through_the_port(urls10k):
    fixture = (REF / "urls.10K.jax.snappy").read_bytes()
    assert api.decompress(fixture, device="cpu") == urls10k


def test_stream_inputs_have_not_drifted():
    rebuilt = MAKER.load_streams()
    assert [(n, d) for n, _, d in rebuilt] == [(n, d) for n, _, d in STREAMS]
    for (name, body, _), (_, stored, _) in zip(rebuilt, STREAMS):
        assert body == stored, name


@pytest.mark.parametrize("i", range(len(STREAMS)), ids=[s[0] for s in STREAMS])
def test_whole_stream_api_equals_jax(i):
    # every fixture stream through the port's API routes (decode_ws, the host
    # scan, decode_segments, decode_stream, decode_jnp) on the CPU, against
    # what the JAX package's api.decompress_noheader answered
    _, body, dst = STREAMS[i]
    want = int(STREAM_REF["api_status"][i])
    if want:
        with pytest.raises(SnappyError) as e:
            api.decompress_noheader(body, dst, device="cpu")
        assert e.value.code == want
    else:
        got = api.decompress_noheader(body, dst, device="cpu")
        assert hashlib.sha256(got).digest() == STREAM_REF["api_sha"][i].tobytes()


def test_meta_from_jax_reads_the_fixture_layout(ref):
    # the JAX kernel's meta rows carry produced in column 0, status in 1
    meta = np.zeros((len(ref["d4k_prod"]), 8), np.int32)
    meta[:, 0], meta[:, 1] = ref["d4k_prod"], ref["d4k_status"]
    prod, status = meta_from_jax(meta)
    assert prod.tolist() == ref["d4k_prod"].tolist()
    assert status.tolist() == ref["d4k_status"].tolist()


def test_container_inputs_have_not_drifted(urls10k):
    ref = MAKER.read_container()
    good = MAKER.build_container_inputs(urls10k)
    assert [(n, p) for n, _, p in good] == \
        list(zip((str(n) for n in ref["names"]), ref["page_size"].tolist()))
    for i, (name, data, _) in enumerate(good):
        assert data == ref["data"][ref["data_offs"][i] : ref["data_offs"][i + 1]].tobytes(), name
    bad = MAKER.build_bad_containers(urls10k)
    assert [n for n, _, _ in bad] == [str(n) for n in ref["bad_names"]]
    for i, (name, cont, page) in enumerate(bad):
        assert cont == ref["bad_cont"][ref["bad_offs"][i] : ref["bad_offs"][i + 1]].tobytes(), name
        assert page == int(ref["bad_page_size"][i])


def test_movebench_inputs_have_not_drifted():
    with np.load(REF / "movebench.npz") as z:
        for key, arr in MAKER.build_movebench_inputs().items():
            assert arr.dtype == z[key].dtype and np.array_equal(arr, z[key]), key
