"""The port's paged block container (``runtime/container.py``) on the CPU.

Mirrors the container cases of ``tests/test_api.py`` (``TestContainer``) on
the plain versions (``device="cpu"``), then holds the port against the JAX
container's stored answers (``tests/data/torch_ref/container.npz``, written
by ``tools/make_torch_fixtures.py --group container``): the same bytes, the
same stats and, for malformed containers, the same error codes.  The zlib
arm and the argument checks are host code in both packages, so they are
compared live.
"""
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from csnappy_tpu.runtime import container as jax_container
from csnappy_tpu_torch import errors
from csnappy_tpu_torch.runtime import container

# the suite runs in parallel worker processes: one intra-op thread each keeps
# the torch ops here from contending with every other worker
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = dict(device="cpu")


def _maker():
    spec = importlib.util.spec_from_file_location(
        "make_torch_fixtures", ROOT / "tools" / "make_torch_fixtures.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


MAKER = _maker()
REF = MAKER.read_container()
GOOD = [str(n) for n in REF["names"]]
BAD = [str(n) for n in REF["bad_names"]]


def _stats(st):
    return [st.nr_pages, st.bytes_in, st.bytes_out, *st.histogram]


# ------------------------------------------------ mirrored from test_api.py


def test_roundtrip_snappy(urls10k):
    data = urls10k[: 4096 * 9 + 1234]  # 9 full pages + short tail
    cont, stats = container.compress_blocks(data, page_size=4096, **CPU)
    assert stats.nr_pages == 10
    out, _ = container.decompress_blocks(cont, page_size=4096, **CPU)
    assert out == data


def test_roundtrip_zlib(urls10k):
    data = urls10k[:20000]
    cont, _ = container.compress_blocks(data, page_size=4096, codec="zlib")
    out, _ = container.decompress_blocks(cont, page_size=4096, codec="zlib")
    assert out == data


def test_raw_fallback():
    rng = np.random.default_rng(2)
    data = rng.integers(0, 256, size=4096 * 4, dtype=np.uint8).tobytes()
    cont, stats = container.compress_blocks(data, page_size=4096, **CPU)
    assert stats.histogram[0] == 4  # all pages incompressible -> raw
    assert len(cont) == 4 + 16 + len(data)
    out, _ = container.decompress_blocks(cont, page_size=4096, **CPU)
    assert out == data


@pytest.mark.parametrize("tail", [4093, 4094, 4095, 100, 1])
@pytest.mark.parametrize("codec", ["snappy", "zlib"])
def test_incompressible_tail_page(tail, codec):
    # an incompressible 4093-4095-byte tail compresses to exactly page_size
    # bytes and must not be misread as a raw full page
    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, size=4096 + tail, dtype=np.uint8).tobytes()
    cont, _ = container.compress_blocks(data, page_size=4096, codec=codec, **CPU)
    out, _ = container.decompress_blocks(cont, page_size=4096, codec=codec, **CPU)
    assert out == data


def test_truncated_container_rejected(urls10k):
    cont, _ = container.compress_blocks(urls10k[:10000], page_size=4096, **CPU)
    with pytest.raises(errors.SnappyError):
        container.decompress_blocks(cont[: len(cont) - 10], page_size=4096, **CPU)
    with pytest.raises(errors.SnappyError):
        container.decompress_blocks(cont[:3], page_size=4096, **CPU)


def test_empty():
    cont, stats = container.compress_blocks(b"", page_size=4096, **CPU)
    out, _ = container.decompress_blocks(cont, page_size=4096, **CPU)
    assert out == b"" and stats.nr_pages == 0


# ------------------------------------------------------ the JAX container


@pytest.mark.parametrize("i", range(len(GOOD)), ids=GOOD)
def test_container_equals_jax(i):
    data = REF["data"][REF["data_offs"][i] : REF["data_offs"][i + 1]].tobytes()
    page = int(REF["page_size"][i])
    cont, sc = container.compress_blocks(data, page, **CPU)
    assert cont == REF["cont"][REF["cont_offs"][i] : REF["cont_offs"][i + 1]].tobytes()
    assert _stats(sc) == REF["stats_c"][i].tolist()
    out, sd = container.decompress_blocks(cont, page, **CPU)
    assert out == data
    # decompress accounts (produced, stored length), in that order
    assert _stats(sd) == REF["stats_d"][i].tolist()


@pytest.mark.parametrize("i", range(len(BAD)), ids=BAD)
def test_malformed_container_codes_equal_jax(i):
    cont = REF["bad_cont"][REF["bad_offs"][i] : REF["bad_offs"][i + 1]].tobytes()
    with pytest.raises(errors.SnappyError) as e:
        container.decompress_blocks(cont, int(REF["bad_page_size"][i]), **CPU)
    assert e.value.code == int(REF["bad_code"][i])


def test_first_failing_page_wins_across_chunks(monkeypatch, urls10k):
    # chunking is a shape policy: with 2 pages a launch the bytes and the
    # first failing page's status are those of one launch
    data = urls10k[:4096 * 5 + 7]
    whole, _ = container.compress_blocks(data, 4096, **CPU)
    i = BAD.index("bad_page_then_overrun")
    bad = REF["bad_cont"][REF["bad_offs"][i] : REF["bad_offs"][i + 1]].tobytes()
    monkeypatch.setattr(container, "MAX_PAGES_PER_LAUNCH", 2)
    assert container.compress_blocks(data, 4096, **CPU)[0] == whole
    assert container.decompress_blocks(whole, 4096, **CPU)[0] == data
    with pytest.raises(errors.SnappyError) as e:
        container.decompress_blocks(bad, 4096, **CPU)
    assert e.value.code == int(REF["bad_code"][i])


@pytest.mark.parametrize("tail", [4093, 4095, 100])
def test_zlib_arm_equals_jax_live(urls10k, tail):
    rng = np.random.default_rng(tail)
    data = urls10k[:20000] + rng.integers(0, 256, 4096 + tail, dtype=np.uint8).tobytes()
    want, sw = jax_container.compress_blocks(data, 4096, codec="zlib")
    got, sg = container.compress_blocks(data, 4096, codec="zlib")
    assert got == want and _stats(sg) == [sw.nr_pages, sw.bytes_in, sw.bytes_out, *sw.histogram]
    assert container.decompress_blocks(got, 4096, codec="zlib")[0] == \
        jax_container.decompress_blocks(want, 4096, codec="zlib")[0] == data


@pytest.mark.parametrize("codec", ["lzo", "brotli"])
def test_unknown_codecs_raise_as_jax(codec):
    for fn in (lambda m: m.compress_blocks(b"abc", 4096, codec=codec),
               lambda m: m.decompress_blocks(b"\0\0\0\0", 4096, codec=codec)):
        with pytest.raises(ValueError) as want:
            fn(jax_container)
        with pytest.raises(ValueError) as got:
            fn(container)
        assert str(got.value) == str(want.value)


def test_pages_above_32k_raise():
    # the block encoder takes at most 32 KiB; the JAX container at 64 KiB
    # pages writes a container that does not decode to its input, the port
    # refuses the page size
    with pytest.raises(ValueError, match="at most 32768"):
        container.compress_blocks(b"hello" * 100, 65536, **CPU)


def test_snappy_arm_needs_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        container.compress_blocks(b"hello" * 100, 4096)
    # zlib is host code and takes no device
    cont, _ = container.compress_blocks(b"hello" * 100, 4096, codec="zlib")
    assert container.decompress_blocks(cont, 4096, codec="zlib")[0] == b"hello" * 100


def test_stats_account_one_page_at_a_time():
    st = container.BlockStats()
    for ilen, olen in ((4096, 4096), (4096, 2049), (4096, 2048), (100, 4096)):
        st.account(ilen, olen)
    assert (st.nr_pages, st.bytes_in, st.bytes_out, st.histogram) == \
        (4, 12388, 12289, [2, 1, 1])
