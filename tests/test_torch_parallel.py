"""The port's scale-out (``csnappy_tpu_torch/parallel``) against the JAX mesh
(``csnappy_tpu/parallel``), on the CPU over gloo.

The JAX mesh's answers on the 8-device virtual CPU mesh are in
``tests/data/torch_ref/sharded.npz`` (``tools/make_torch_fixtures.py --group
sharded``).  The port's ranks are processes: one module fixture starts a
3-rank gloo group once (a file store, so no port is shared between test
workers), every rank runs every case of :func:`_rank_cases` and writes its
answers; the tests then hold each rank's answers to the JAX ones.  The first
one and two ranks of that group give the 1- and 2-rank world sizes.  Every
spawned process runs under ``multihost.launch``'s time limit, and every
collective under the group's ``TIMEOUT``.

A rank runs this file as a script:

    python tests/test_torch_parallel.py RANK STORE OUT
"""
import datetime
import hashlib
import importlib.util
import pathlib
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from csnappy_tpu_torch.errors import E_OUTPUT_OVERRUN, SnappyError
from csnappy_tpu_torch.models import pymodel
from csnappy_tpu_torch.ops import decode_fused, encode_fused
from csnappy_tpu_torch.parallel import dryrun, mesh, multihost

# the suite runs in parallel worker processes: one intra-op thread each keeps
# the torch ops here from contending with every other worker
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
DATA = ROOT / "tests" / "data"
WORLD = 3                    # ranks of the module group
TIMEOUT = multihost.TIMEOUT_S    # seconds a collective may wait
LAUNCH_S = 120               # seconds a spawned group may take in all
SHARDED_CASES = {"two": 32768 + 100, "uneven": 32768 * 4 + 777}    # bytes of urls.10K
WIDE_JAX_ROWS = (0, 1, 4, 5)     # wide.npz's w64k rows with status 0 and the JAX oracle's bytes


def _urls() -> bytes:
    return (DATA / "urls.10K").read_bytes()


def _wide_case():
    """Fragments of the wide fixture group with limits past 131,072: the
    w64k rows the JAX decoder answered with status 0, then the w256k rows."""
    with np.load(DATA / "torch_ref" / "wide.npz") as z:
        frags = [z["w64k_comp"][i, : z["w64k_lens"][i]].tobytes() for i in WIDE_JAX_ROWS]
        frags += [z["w256k_comp"][i, : z["w256k_lens"][i]].tobytes() for i in range(3)]
    return frags, [131073 + 7 * i for i in range(len(WIDE_JAX_ROWS))] + [1 << 18] * 3


def _error(fn) -> str:
    """The ValueError ``fn()`` raises ("" if none)."""
    try:
        fn()
    except ValueError as e:
        return str(e) or "ValueError"
    return ""


def _rank_cases(rank: int) -> dict:
    """Every case on this rank of the initialized WORLD-rank group."""
    urls = _urls()
    cpu = "cpu"
    res = {}
    groups = {n: mesh.default_mesh(n=n) for n in (1, 2)}    # every rank creates each
    groups[WORLD] = mesh.default_mesh()
    frags, limits = _wide_case()
    for n, group in groups.items():
        if dist.get_rank(group) >= 0:
            res[f"urls@{n}"] = mesh.compress_sharded(urls, group, device=cpu)
            res[f"wide@{n}"] = b"".join(mesh.decompress_fragments_sharded(frags, limits, group,
                                                                          device=cpu))
        else:
            res[f"outside@{n}"] = _error(lambda g=group: mesh.compress_sharded(urls, g, device=cpu))
    for name, n in SHARDED_CASES.items():
        res[name] = mesh.compress_sharded(urls[:n], device=cpu)
    res["dryrun3"] = mesh.compress_sharded(dryrun.dryrun_input(3), bs=dryrun.BS, device=cpu)
    dryrun.dryrun_multichip(WORLD, device=cpu)                  # raises on a wrong answer
    res["empty"] = mesh.compress_sharded(b"", device=cpu)
    res["no_fragments"] = len(mesh.decompress_fragments_sharded([], [], device=cpu))

    blocks = [urls[i : i + 32768] for i in range(0, len(urls), 32768)]
    outs = mesh.decompress_fragments_sharded([pymodel.compress_fragment(b) for b in blocks],
                                             [len(b) for b in blocks], device=cpu)
    res["fragments"] = b"".join(outs)
    with np.load(DATA / "torch_ref" / "sharded.npz") as z:
        res["odd"] = mesh.decompress_fragments_sharded([z["odd_frag"].tobytes()], [4608],
                                                       device=cpu)[0]
    good = urls[:32768]
    try:
        mesh.decompress_fragments_sharded([pymodel.compress_fragment(good)] * 2,
                                          [len(good), len(good) - 1], device=cpu)
        res["limit_code"] = 0
    except SnappyError as e:
        res["limit_code"] = e.code
    res["negative"] = _error(lambda: mesh.decompress_fragments_sharded(
        [b"\x00a"], [-1], device=cpu))
    res["disagree"] = _error(lambda: mesh.compress_sharded(urls[: 1000 + rank], device=cpu))
    res["one_rank_invalid"] = _error(lambda: mesh.compress_sharded(
        urls[:1000], bs=0 if rank == 1 else 32768, device=cpu))

    # the local-data API: urls.10K's first 64 KiB as 4 KiB pages, padded to equal shards
    data, bs = urls[:65536], 4096
    nb = len(data) // bs + (-(len(data) // bs)) % WORLD
    pages = np.zeros((nb, bs), np.uint8)
    pages.reshape(-1)[: len(data)] = np.frombuffer(data, np.uint8)
    lens = np.zeros((nb,), np.int32)
    lens[: len(data) // bs] = bs
    per = nb // WORLD
    comp, clens, offs = multihost.compress_blocks_multihost(
        pages[rank * per : (rank + 1) * per], lens[rank * per : (rank + 1) * per], device=cpu)
    res.update(mh_comp=comp.numpy(), mh_clens=clens.numpy(), mh_offsets=offs.numpy())
    return res


def _rank_main(rank: int, store: str, out: str) -> None:
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=WORLD, rank=rank,
                            timeout=datetime.timedelta(seconds=TIMEOUT))
    try:
        res = _rank_cases(rank)
    finally:
        dist.destroy_process_group()
    np.savez(out, **{k: np.frombuffer(v, np.uint8) if isinstance(v, bytes) else np.asarray(v)
                     for k, v in res.items()})


@pytest.fixture(autouse=True, scope="module")
def _one_thread_a_rank():
    # every rank multihost.launch spawns inherits this environment: one
    # torch thread each, as in this process
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield


@pytest.fixture(scope="module")
def ref():
    with np.load(DATA / "torch_ref" / "sharded.npz") as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each rank's answers (a dict a rank) from one WORLD-rank gloo group."""
    tmp = tmp_path_factory.mktemp("ranks")
    multihost.launch([[__file__, str(r), str(tmp / "store"), str(tmp / f"rank{r}.npz")]
                      for r in range(WORLD)], LAUNCH_S)
    out = []
    for r in range(WORLD):
        with np.load(tmp / f"rank{r}.npz") as z:
            out.append({k: z[k] for k in z.files})
    return out


def _bytes(a: np.ndarray) -> bytes:
    return a.astype(np.uint8).tobytes()


# ------------------------------------------------------------ whole-data API


@pytest.mark.parametrize("n", [1, 2, WORLD])
def test_compress_sharded_equals_the_jax_stream_at_each_world_size(ranks, ref, n):
    # sharding must not change the bytes (tests/test_sharding.py
    # ::test_compress_sharded_matches_single): every rank of the 1-, 2- and
    # 3-rank groups returns the JAX mesh's stream of urls.10K
    fixture = (DATA / "torch_ref" / "urls.10K.jax.snappy").read_bytes()
    assert hashlib.sha256(fixture).digest() == _bytes(ref["urls_sha256"])
    for r in range(n):
        assert _bytes(ranks[r][f"urls@{n}"]) == fixture
    for r in range(n, WORLD):
        assert "not a rank" in str(ranks[r][f"outside@{n}"])


@pytest.mark.parametrize("case", ["two", "uneven", "dryrun3"])
def test_compress_sharded_equals_the_jax_mesh(ranks, ref, case):
    # 2 blocks over 3 ranks leave one rank with padding only; 5 blocks over 3
    # (tests/test_sharding.py::test_uneven_block_count) pad the last shard;
    # dryrun3 is __graft_entry__.dryrun_multichip(3)'s input at bs = 1024
    want = _bytes(ref[f"{case}_comp"])
    if case == "dryrun3":
        data = dryrun.dryrun_input(3)
        assert data == _bytes(ref["dryrun3_data"])             # drift check
    else:
        n = SHARDED_CASES[case]
        data = _urls()[:n]
        assert -(-n // 32768) in (2, 5)
    from csnappy_tpu.models import pymodel as jax_pymodel

    assert jax_pymodel.decompress(want) == data
    for r in range(WORLD):
        assert _bytes(ranks[r][case]) == want


def test_decompress_fragments_sharded_joins_to_the_input(ranks, urls10k):
    # tests/test_sharding.py::test_decompress_fragments_sharded: 22 fragments over 3 ranks
    for r in range(WORLD):
        assert _bytes(ranks[r]["fragments"]) == urls10k


def test_sharded_fragment_odd_out_cap(ranks, ref):
    # tests/test_advice_r2.py: one 4,608-byte fragment, two ranks of padding
    spec = importlib.util.spec_from_file_location(
        "make_torch_fixtures", ROOT / "tools" / "make_torch_fixtures.py")
    maker = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(maker)
    assert _bytes(ref["odd_out"]) == maker.sharded_odd_input()
    for r in range(WORLD):
        assert _bytes(ranks[r]["odd"]) == _bytes(ref["odd_out"])


def test_per_fragment_dst_limit_enforced_on_every_rank(ranks, ref):
    # tests/test_sharding.py::test_per_fragment_dst_limit_enforced: the second
    # fragment's limit is one byte short; every rank raises the JAX code
    assert int(ref["limit_code"]) == E_OUTPUT_OVERRUN
    assert [int(ranks[r]["limit_code"]) for r in range(WORLD)] == [E_OUTPUT_OVERRUN] * WORLD


def test_empty_inputs_on_every_rank(ranks):
    for r in range(WORLD):
        assert _bytes(ranks[r]["empty"]) == b"\x00"
        assert int(ranks[r]["no_fragments"]) == 0


@pytest.mark.parametrize("case, words", [
    ("negative", "out_lens must lie in [0, 2147483647]"),    # decode_fused.MAX_WIDTH
    ("disagree", "arguments differ"),
    ("one_rank_invalid", "ranks [1] were given invalid arguments"),
])
def test_bad_arguments_raise_on_every_rank(ranks, case, words):
    # a rank that raised alone would leave the others waiting in a collective;
    # rank 1 alone was given bs = 0 in the last case and names its own fault
    for r in range(WORLD):
        want = "bs must lie in [1, 32768]" if case == "one_rank_invalid" and r == 1 else words
        assert want in str(ranks[r][case]), (r, ranks[r][case])


# ------------------------------------------------------------ local-data API


def _check_multihost(parts, ref, data: bytes, bs: int = 4096) -> None:
    """tests/test_multihost.py's assertions: the same global offsets on every
    rank, the rows in rank order equal to the single-process encoder's."""
    for p in parts[1:]:
        np.testing.assert_array_equal(p["offsets"], parts[0]["offsets"])
    clens = np.concatenate([p["clens"] for p in parts])
    comp = np.concatenate([p["comp"] for p in parts])
    full = -(-len(data) // bs)
    assert comp.shape[1] == encode_fused.ocap(bs)
    np.testing.assert_array_equal(clens[:full], ref["enc4k_lens"])
    np.testing.assert_array_equal(parts[0]["offsets"], np.cumsum(clens) - clens)
    for i in range(full):
        assert comp[i, : clens[i]].tobytes() == _bytes(ref["enc4k_comp"][i, : clens[i]])
        assert not comp[i, clens[i]:].any()
        assert pymodel.decompress_noheader(comp[i, : clens[i]].tobytes(), bs) == \
            data[i * bs : (i + 1) * bs]


def test_compress_blocks_multihost_three_ranks(ranks, ref, urls10k):
    parts = [{k[3:]: ranks[r][k] for k in ("mh_comp", "mh_clens", "mh_offsets")}
             for r in range(WORLD)]
    _check_multihost(parts, ref, urls10k[:65536])


def test_two_process_worker_loopback(tmp_path, ref, urls10k):
    # tests/test_multihost.py::test_two_process_loopback, through init over TCP
    port = multihost.free_port()
    multihost.launch([["-m", "csnappy_tpu_torch.parallel.multihost", "--worker", "--rank", str(r),
                       "--nprocs", "2", "--port", str(port), "--out", str(tmp_path / f"part{r}.npz"),
                       "--nbytes", "65536", "--device", "cpu", "--backend", "gloo"]
                      for r in range(2)], LAUNCH_S)
    parts = []
    for r in range(2):
        with np.load(tmp_path / f"part{r}.npz") as z:
            parts.append({k: z[k] for k in z.files})
    assert int(parts[0]["nb"]) == 16 and int(parts[0]["per"]) == 8
    _check_multihost(parts, ref, urls10k[:65536])


def test_dryrun_two_ranks_on_the_cpu(capsys):
    # python -m csnappy_tpu_torch.parallel.dryrun --nprocs 2 --device cpu, its
    # launch in this process: two gloo ranks, 2 * multihost.TIMEOUT_S seconds at most
    assert dryrun.main(["--nprocs", "2", "--device", "cpu"]) == 0
    assert "dryrun: 2 ranks (cpu) ok" in capsys.readouterr().out


def test_launch_kills_the_ranks_at_its_time_limit():
    with pytest.raises(RuntimeError, match="was killed"):
        multihost.launch([["-c", "import time; time.sleep(60)"]], 0.5)


# ------------------------------------------------------------ one rank, in process


@pytest.fixture
def one_rank(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", world_size=1,
                            rank=0, timeout=datetime.timedelta(seconds=TIMEOUT))
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_one_rank_in_process(one_rank, urls10k):
    fixture = (DATA / "torch_ref" / "urls.10K.jax.snappy").read_bytes()
    assert mesh.compress_sharded(urls10k, device="cpu") == fixture
    assert mesh.default_mesh() is dist.group.WORLD
    assert multihost.global_mesh() is dist.group.WORLD
    assert dist.get_world_size(mesh.default_mesh(n=1)) == 1
    with pytest.raises(ValueError):
        mesh.default_mesh(n=2)


@pytest.mark.parametrize("n", [1, 2, WORLD])
def test_limits_past_131072_decode_as_the_oracle(ranks, n):
    # no width ceiling: limits past 131,072 decode as the JAX answers (the
    # w64k rows, within their 65,536 bytes) and the oracle (the w256k rows)
    # at 1, 2 and 3 ranks, every rank of the group holding every fragment
    frags, limits = _wide_case()
    with np.load(DATA / "torch_ref" / "wide.npz") as z:
        jax = [z["w64k_out"][i, : z["w64k_prod"][i]].tobytes() for i in WIDE_JAX_ROWS]
        assert z["w64k_status"][list(WIDE_JAX_ROWS)].tolist() == [0] * len(WIDE_JAX_ROWS)
    oracle = [pymodel.decompress_noheader(f, x) for f, x in zip(frags, limits)]
    assert oracle[: len(jax)] == jax and max(limits) > 131072
    for r in range(n):
        assert _bytes(ranks[r][f"wide@{n}"]) == b"".join(oracle), (n, r)


def test_device_none_without_a_card_raises(one_rank, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.compress_sharded(b"abc")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.decompress_fragments_sharded([b"\x00a"], [1])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.compress_blocks_multihost(np.zeros((1, 1024), np.uint8), np.zeros(1, np.int32))


def test_no_group_raises():
    assert not dist.is_initialized()
    for fn in (mesh.default_mesh, multihost.global_mesh,
               lambda: mesh.compress_sharded(b"abc", device="cpu"),
               lambda: mesh.decompress_fragments_sharded([], [], device="cpu")):
        with pytest.raises(RuntimeError, match="multihost.init"):
            fn()


def test_init_refuses_nccl_without_a_card(monkeypatch):
    with pytest.raises(ValueError, match="NCCL runs on the card"):
        multihost.init("localhost:1", 1, 0, backend="nccl", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.init("localhost:1", 1, 0)
    assert not dist.is_initialized()


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), sys.argv[2], sys.argv[3])
