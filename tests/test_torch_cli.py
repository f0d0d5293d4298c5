"""The port's CLI (``csnappy_tpu_torch/cli.py``), mirroring ``tests/test_cli.py``.

The torch backend runs on ``--device cpu`` (the kernels' plain versions);
``py`` and ``native`` are host code.  Outputs are compared with the JAX
package's CLI where it runs without a Pallas call (``py`` and ``native``).
"""
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from csnappy_tpu import cli as jax_cli
from csnappy_tpu_torch import cli

# the suite runs in parallel worker processes: one intra-op thread each keeps
# the torch ops here from contending with every other worker
torch.set_num_threads(1)

DATA = pathlib.Path(__file__).parent / "data"
ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = ["--device", "cpu"]


def test_file_roundtrip(tmp_path, urls10k):
    src = DATA / "urls.10K"
    comp = tmp_path / "u.snappy"
    back = tmp_path / "u.out"
    assert cli.main(["file", "-c", "-b", "torch", *CPU, str(src), str(comp)]) == 0
    assert cli.main(["file", "-d", "-b", "torch", *CPU, str(comp), str(back)]) == 0
    assert back.read_bytes() == urls10k
    # the torch backend's stream is the JAX encoder's
    assert comp.read_bytes() == (DATA / "torch_ref" / "urls.10K.jax.snappy").read_bytes()


def test_file_decompress_golden(tmp_path, urls10k):
    out = tmp_path / "g.out"
    assert cli.main(["file", "-d", *CPU, str(DATA / "urls.10K.snappy"), str(out)]) == 0
    assert out.read_bytes() == urls10k


def test_file_baddata_fails(tmp_path):
    assert cli.main(["file", "-d", *CPU, str(DATA / "baddata3.snappy"), str(tmp_path / "x")]) == 1


def test_selftests():
    assert cli.main(["file", "-S", "c", "-b", "py"]) == 0
    assert cli.main(["file", "-S", "d", "-b", "py"]) == 0


def test_selftests_torch_backend():
    assert cli.main(["file", "-S", "c", *CPU]) == 0
    assert cli.main(["file", "-S", "d", *CPU]) == 0


def test_selftests_native_backend():
    assert cli.main(["file", "-S", "c", "-b", "native"]) == 0
    assert cli.main(["file", "-S", "d", "-b", "native"]) == 0


def test_block_roundtrip(tmp_path, urls10k):
    src = tmp_path / "in.bin"
    src.write_bytes(urls10k[:100000])
    cont = tmp_path / "c.blk"
    back = tmp_path / "out.bin"
    assert cli.main(["block", "-c", "-m", "snappy", *CPU, str(src), str(cont)]) == 0
    assert cli.main(["block", "-d", "-m", "snappy", *CPU, str(cont), str(back)]) == 0
    assert back.read_bytes() == src.read_bytes()


def test_block_zlib(tmp_path, urls10k):
    src = tmp_path / "in.bin"
    src.write_bytes(urls10k[:50000])
    cont = tmp_path / "c.blk"
    back = tmp_path / "out.bin"
    assert cli.main(["block", "-c", "-m", "zlib", str(src), str(cont)]) == 0
    assert cli.main(["block", "-d", "-m", "zlib", str(cont), str(back)]) == 0
    assert back.read_bytes() == src.read_bytes()
    jax_cont = tmp_path / "j.blk"
    assert jax_cli.main(["block", "-c", "-m", "zlib", str(src), str(jax_cont)]) == 0
    assert cont.read_bytes() == jax_cont.read_bytes()


@pytest.mark.parametrize("backend", ["py", "native"])
def test_file_output_equals_jax_cli(tmp_path, backend):
    src = DATA / "urls.10K"
    ours, theirs = tmp_path / "p.snappy", tmp_path / "j.snappy"
    assert cli.main(["file", "-c", "-b", backend, str(src), str(ours)]) == 0
    assert jax_cli.main(["file", "-c", "-b", backend, str(src), str(theirs)]) == 0
    assert ours.read_bytes() == theirs.read_bytes()


def test_exit_codes_and_messages_equal_jax(tmp_path, capsys):
    missing = str(tmp_path / "missing")
    for argv in (["file", "-d", "-b", "py", missing, "-"],
                 ["file", "-d", "-b", "py", str(DATA / "baddata3.snappy"), str(tmp_path / "x")],
                 ["block", "-d", str(DATA / "baddata3.snappy"), str(tmp_path / "y")]):
        want = jax_cli.main(argv)
        want_err = capsys.readouterr().err
        got = cli.main(argv + (CPU if argv[0] == "block" else []))
        got_err = capsys.readouterr().err
        assert got == want == 1 and got_err == want_err, argv
    assert cli.main([]) == 2


def test_stdin_stdout_pipe(urls10k):
    """mkfifo-style pipe test of the reference Makefile (Makefile:21-26),
    via subprocess pipes."""
    data = urls10k[:40000]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"                   # one torch thread in each process, as here
    p1 = subprocess.run(
        [sys.executable, "-m", "csnappy_tpu_torch.cli", "file", "-c", "-b", "py"],
        input=data, capture_output=True, env=env, cwd=str(ROOT))
    assert p1.returncode == 0, p1.stderr
    p2 = subprocess.run(
        [sys.executable, "-m", "csnappy_tpu_torch.cli", "file", "-d", *CPU],
        input=p1.stdout, capture_output=True, env=env, cwd=str(ROOT))
    assert p2.returncode == 0, p2.stderr
    assert p2.stdout == data
