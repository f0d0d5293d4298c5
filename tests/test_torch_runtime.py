"""The port's host runtime, build, configuration and interop, on the CPU.

* ``runtime/native``: the boundary scan's return codes and the compactor;
* ``ops/_build``: libraries named by a hash of source and command;
* ``config`` and ``interop``: the JAX package's state carried across;
* import isolation: the port never loads ``jax`` or ``csnappy_tpu``;
* conformance: the independent from-spec decoder (``csrc/spec_decoder.c``)
  reproduces every stream the port's encoder makes.
"""
import ast
import ctypes
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from csnappy_tpu.config import CodecConfig as JaxConfig
from csnappy_tpu_torch import api, errors, interop
from csnappy_tpu_torch.config import CodecConfig, resolve_device
from csnappy_tpu_torch.models import pymodel, wire
from csnappy_tpu_torch.ops import _build, encode_fused
from csnappy_tpu_torch.runtime import native

# the suite runs in parallel worker processes: one intra-op thread each keeps
# the torch ops here from contending with every other worker
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]


# ------------------------------------------------------------------ native


def test_scan_segmentable_stream(urls10k):
    comp = pymodel.compress(urls10k[:100000])
    body = comp[wire.varint_decode(comp)[1]:]
    rc, offs, produced = native.scan_segments(body, 100000)
    assert (rc, produced, len(offs)) == (native.SCAN_SEGMENTABLE, 100000, 4)
    assert offs[0] == 0 and (np.diff(offs) > 0).all()


@pytest.mark.parametrize("stream, cap, want", [
    (b"\x00a" * 3, 2, errors.E_OUTPUT_OVERRUN),
    (b"\x00a\x01\x00", 100, errors.E_DATA_MALFORMED),        # offset 0
    (b"\xf0", 100, errors.E_DATA_MALFORMED),                  # truncated literal length
    (b"\x00a\x05\x02", 3, errors.E_DATA_MALFORMED),           # bad offset and no space: data first
])
def test_scan_errors_are_exact(stream, cap, want):
    assert native.scan_segments(stream, cap)[0] == want


def test_scan_classifies_crossing_and_far():
    lit = bytes(range(256)) * 160                             # 40960 bytes
    s = bytearray()
    wire.emit_literal(s, lit)
    assert native.scan_segments(bytes(s), 1 << 20)[0] == native.SCAN_CROSSING
    s += bytes([wire.TAG_COPY_2 | (7 << 2)]) + (40000).to_bytes(2, "little")
    assert native.scan_segments(bytes(s), 1 << 20)[0] == native.SCAN_FAR_OFFSET


def test_compact_concatenates_rows():
    padded = np.arange(24, dtype=np.uint8).reshape(3, 8)
    assert native.compact(padded, np.array([2, 0, 3])) == bytes([0, 1, 16, 17, 18])
    with pytest.raises(ValueError):
        native.compact(padded, np.array([9, 0, 0]))


def test_compact_of_encoder_rows(urls10k):
    comp, lens = encode_fused.encode_blocks(
        np.frombuffer(urls10k[:8192], np.uint8).reshape(2, 4096).copy(), [4096, 4096],
        device="cpu")
    out = encode_fused._compact(comp, lens)
    assert out == b"".join(comp[i, : int(lens[i])].numpy().tobytes() for i in range(2))


# ------------------------------------------------------------------- build


def test_build_targets_carry_the_source_hash():
    names = set(_build.SOURCES)
    assert set(_build.CUDA_NAMES) <= names
    for name in names:
        t = _build.target(name)
        assert t.parent == _build.BUILD and t.name.startswith(f"lib{name}_")
        assert _build.SOURCES[name].exists()
    cmd = _build._command("decode_blocks", pathlib.Path("x.so"))
    assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd


def test_build_target_follows_local_headers(tmp_path, monkeypatch):
    # a source's library name carries the hash of every local header it
    # includes, through headers, so an edited header is never served stale
    (tmp_path / "sub").mkdir()
    src, top, inner = tmp_path / "k.cu", tmp_path / "top.cuh", tmp_path / "sub" / "inner.cuh"
    src.write_text('#include <cstdint>\n#include "top.cuh"\n')
    top.write_text('#pragma once\n#include "sub/inner.cuh"\n')
    inner.write_text("// v1\n")
    monkeypatch.setitem(_build.SOURCES, "k", src)
    assert _build.local_headers(src) == [top.resolve(), inner.resolve()]
    first = _build.target("k")
    inner.write_text("// v2\n")
    second = _build.target("k")
    top.write_text('#pragma once\n#include "sub/inner.cuh"\n// edited\n')
    assert len({first, second, _build.target("k")}) == 3
    assert [h.name for h in _build.local_headers(_build.SOURCES["probe4"])] == ["kernel_lib.cuh"]
    assert _build.local_headers(_build.SOURCES["decode_blocks"]) == []


def test_build_dir_is_ignored_by_git():
    out = subprocess.run(
        ["git", "check-ignore", "-q", str(_build.target("csnappy_host"))],
        cwd=ROOT, capture_output=True)
    if out.returncode == 128:
        pytest.skip("not a git checkout")
    assert out.returncode == 0


# ------------------------------------------------------- config and interop


def test_config_validation():
    assert CodecConfig().backend == "torch" and CodecConfig().device is None
    for bad in (dict(block_size=1000), dict(page_size=512), dict(hash_bits=9),
                dict(backend="jax")):
        with pytest.raises(ValueError):
            CodecConfig(**bad)
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_config_from_jax():
    cfg = interop.config_from_jax(dataclasses.asdict(JaxConfig(block_size=4096, hash_bits=12)))
    assert (cfg.block_size, cfg.hash_bits, cfg.backend) == (4096, 12, "torch")
    assert interop.config_from_jax(dataclasses.asdict(JaxConfig(backend="py"))).backend == "py"
    # the port has a native backend now: it carries across as itself
    native_cfg = interop.config_from_jax(dataclasses.asdict(JaxConfig(backend="native")))
    assert native_cfg.backend == "native"
    with pytest.raises(ValueError):
        interop.config_from_jax(dict(dataclasses.asdict(JaxConfig()), backend="tpu"))


def test_blocks_from_jax_layout():
    # the JAX decoder's input layout: one byte per int32, (rows, 128) tiles
    rng = np.random.default_rng(4)
    arr = rng.integers(0, 256, (3, 1024), dtype=np.uint8)
    tiles = arr.astype(np.int32).reshape(3, 1024 // 128, 128)
    got = interop.blocks_from_jax(tiles)
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), arr)
    with pytest.raises(ValueError):
        interop.blocks_from_jax(tiles.reshape(3, 1024))
    with pytest.raises(ValueError):
        interop.blocks_from_jax(tiles + 256)


def test_meta_from_jax():
    meta = np.zeros((2, 8), np.int32)
    meta[:, 0], meta[:, 1] = [7, 0], [0, -5]
    prod, status = interop.meta_from_jax(meta)
    assert prod.tolist() == [7, 0] and status.tolist() == [0, -5]
    with pytest.raises(ValueError):
        interop.meta_from_jax(meta[:, :4])


# --------------------------------------------------------------- isolation


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "import csnappy_tpu_torch, csnappy_tpu_torch.api, csnappy_tpu_torch.interop\n"
        "from csnappy_tpu_torch.ops import decode_fused, decode_jnp, decode_stream, decode_ws,"
        " encode_fused, kernel_lib, primitives\n"
        "from csnappy_tpu_torch.runtime import container, native\n"
        "from csnappy_tpu_torch import cli\n"
        "from csnappy_tpu_torch.parallel import dryrun, mesh, multihost\n"
        "from csnappy_tpu_torch.tools import benchtable, corpus, movebench, phaseprof, probe,"
        " records, timing, zramsim\n"
        "import bench_torch\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'csnappy_tpu'))\n"
        "assert not bad, bad\n"
        "assert 'triton' not in sys.modules\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"                   # one torch thread, as in this process
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, check=True, timeout=120)


def _top_level_imports(path: pathlib.Path) -> set[str]:
    mods = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            mods |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.add(node.module.split(".")[0])
    return mods


def test_chip_smoke_imports_nothing_of_jax():
    mods = _top_level_imports(ROOT / "chip_smoke.py")
    assert "csnappy_tpu_torch" in mods
    assert not mods & {"jax", "jaxlib", "csnappy_tpu"}, mods


@pytest.mark.parametrize("path", sorted((ROOT / "csnappy_tpu_torch").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_module_imports_nothing_of_jax(path):
    # every module, imported at run time or not, and whatever imports it
    assert not _top_level_imports(path) & {"jax", "jaxlib", "csnappy_tpu"}, path


def _defined_twice(source: str) -> list[str]:
    """Functions and classes that a module body, or a class body, of
    ``source`` defines twice: the second definition replaces the first, so
    pytest never collects the first."""
    dups = []

    def scan(body, where):
        seen = set()
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                if node.name in seen:
                    dups.append(where + node.name)
                seen.add(node.name)
                if isinstance(node, ast.ClassDef):
                    scan(node.body, f"{where}{node.name}.")

    scan(ast.parse(source).body, "")
    return dups


@pytest.mark.parametrize("path", sorted((ROOT / "tests").glob("test_torch_*.py")),
                         ids=lambda p: p.name)
def test_port_test_module_defines_each_name_once(path):
    assert _defined_twice(path.read_text()) == [], path.name


def test_defined_twice_finds_a_shadowed_test():
    source = ("def test_a():\n    pass\n\n\ndef test_b():\n    pass\n\n\n"
              "def test_a():\n    pass\n\n\nclass TestC:\n    def test_d(self):\n"
              "        pass\n\n    def test_d(self):\n        pass\n")
    assert _defined_twice(source) == ["test_a", "TestC.test_d"]


# ------------------------------------------------------------- conformance


@pytest.fixture(scope="module")
def spec(tmp_path_factory):
    # built privately so no other test module's build of the same file races it
    so = tmp_path_factory.mktemp("spec") / "libspec_decoder.so"
    subprocess.run([os.environ.get("CC", "cc"), "-O2", "-std=c99", "-fPIC", "-shared", "-o",
                    str(so), str(ROOT / "csrc" / "spec_decoder.c")], check=True)
    lib = ctypes.CDLL(str(so))
    lib.spec_snappy_decode.restype = ctypes.c_long
    lib.spec_snappy_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p, ctypes.c_size_t
    ]
    lib.spec_snappy_decode_elements.restype = ctypes.c_long
    lib.spec_snappy_decode_elements.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p, ctypes.c_size_t
    ]
    return lib


def test_port_stream_decodes_independently(spec, urls10k):
    comp = api.compress(urls10k, device="cpu")
    out = ctypes.create_string_buffer(len(urls10k) + 1)
    got = spec.spec_snappy_decode(comp, len(comp), out, len(urls10k) + 1)
    assert got == len(urls10k) and out.raw[:got] == urls10k


def test_fuzz_port_fragments_vs_spec_decoder(spec):
    rng = np.random.default_rng(11)
    cases = []
    for n in (1, 2, 63, 64, 100, 4096, 32768):
        cases.append(rng.integers(0, 256, n, dtype=np.uint8).tobytes())
        cases.append((b"abcdef" * (n // 6 + 1))[:n])
        cases.append(bytes(n))
        cases.append((rng.integers(0, 4, n, dtype=np.uint8) * 65).tobytes())
    for data in cases:
        frag = api.compress_fragment(data, device="cpu")
        out = ctypes.create_string_buffer(len(data) + 1)
        got = spec.spec_snappy_decode_elements(frag, len(frag), out, len(data) + 1)
        assert got == len(data) and out.raw[:got] == data, len(data)
