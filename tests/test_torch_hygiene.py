"""The memory hygiene harness (``csnappy_tpu_torch/tools/hygiene.py``) on the CPU.

Its case generator is deterministic by seed and covers every family and
kernel; every decoder case's plain answer equals the oracle
(``models/pymodel``) row by row; every encoder case's plain stream decodes
back to its row and is zero past its length; the summary and exit logic on
canned results; the allocator refuses to load without a card.  The harness
itself runs on the card (``tests/test_torch_cuda.py -k hygiene``,
``chip_smoke.py`` phase 15).  Small widths: the whole file takes seconds.
"""
import random

import pytest
import torch

from csnappy_tpu_torch.errors import SnappyError
from csnappy_tpu_torch.models import pymodel
from csnappy_tpu_torch.tools import hygiene

# the suite runs in parallel worker processes: one intra-op thread each keeps
# the torch ops here from contending with every other worker
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def small():
    return hygiene.cases(3, small=True)


def _oracle(stream: bytes, limit: int):
    try:
        out = pymodel.decompress_noheader(stream, limit)
    except SnappyError as e:
        return b"", e.code
    return out, 0


def test_cases_are_deterministic_by_seed(small):
    again = hygiene.cases(3, small=True)
    assert {f: [(c.kernel, c.name, c.rows) for c in v] for f, v in small.items()} == \
        {f: [(c.kernel, c.name, c.rows) for c in v] for f, v in again.items()}
    other = hygiene.cases(4, ("decode",), small=True)["decode"]
    assert [c.rows for c in other] != [c.rows for c in small["decode"]]


def test_cases_cover_every_family_and_kernel(small):
    assert tuple(small) == hygiene.FAMILIES and all(small.values())
    assert {c.kernel for v in small.values() for c in v} == set(hygiene.KERNELS)
    # every decoder case and the look-back scan run behind the occupier too
    assert all(c.protocol for f in ("decode", "stream", "scan") for c in small[f])
    assert all(c.protocol for c in small["movebench"] if c.kernel == "movebench.scan_kernel")
    # the main path's wide batch comes first, after an encoder call, from host bytes
    first = small["decode"][0]
    assert first.name == "main_path_batch after encode_blocks (from host bytes)"
    assert first.kernel == "decode_wide"
    assert [len(r[0]) for r in first.rows] == [357264, 17382, 127497]


@pytest.mark.parametrize("kind", hygiene.STREAM_KINDS)
def test_every_stream_kind_decodes_to_its_length(kind):
    rng = random.Random(kind)
    for n in (1, 1000, 32768, 70001):
        s = hygiene.valid_stream(rng, kind, n)
        out, code = _oracle(s, n)
        assert (code, len(out)) == (0, n), (kind, n)


@pytest.mark.parametrize("event", [e for e in hygiene.EVENTS if e])
def test_every_event_is_an_error(event):
    rng = random.Random(event)
    for kind in ("urls", "synthetic", "run"):
        s = hygiene.event_stream(rng, kind, 70000, event)
        assert _oracle(s, 70000)[1] == -5, (event, kind)


def test_decoder_plain_answers_equal_the_oracle(small):
    codes = set()
    for fam in ("decode", "stream"):
        for case in small[fam]:
            got = case.plain()
            for i, (stream, limit) in enumerate(case.rows):
                want, code = _oracle(stream, limit)
                codes.add(code)
                if fam == "decode":
                    out, prod, status = got[0][i], int(got[1][i]), int(got[2][i])
                    assert not out[len(want):].any(), case.name      # zero past produced
                    out = out[: len(want)]
                else:
                    out, prod, status = got[0], int(got[1][0]), int(got[2][0])
                assert (prod, status) == (len(want), code), (case.name, i)
                assert out.numpy().tobytes() == want, (case.name, i)
    assert codes == {0, -3, -5}


def test_encoder_plain_streams_decode_back(small):
    for case in small["encode"]:
        comp, lens = case.plain()
        for i, (row, n) in enumerate(case.rows):
            ln = int(lens[i])
            assert pymodel.decompress_noheader(comp[i, :ln].numpy().tobytes(), n) == row
            assert not comp[i, ln:].any(), case.name


def test_each_case_launches_on_the_card(small, monkeypatch):
    # run(dev) copies the inputs to dev and returns the launch, which calls
    # its wrapper with device=None, the card: without one every kernel's
    # launch raises rather than take a plain version
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    seen = set()
    for group in small.values():
        for case in group:
            if case.kernel not in seen:
                with pytest.raises(RuntimeError, match="no CUDA device"):
                    case.run(torch.device("cpu"))()
                seen.add(case.kernel)
    assert seen == set(hygiene.KERNELS)


def test_an_empty_body_stages(small):
    # torch.frombuffer refuses an empty buffer; seed 224's segments case
    # #152 (an empty stream at limit 0, no padding) once stopped a pass there
    assert hygiene._bytes_on(b"", torch.device("cpu")).shape == (0,)
    case = next(c for c in small["decode"] if c.name == "an empty body from a card tensor")
    assert callable(case.run(torch.device("cpu")))
    out, prod, status = case.plain()
    assert out.shape == (1, 0) and int(prod[0]) == 0 and int(status[0]) == 0


def test_summary_and_exit_logic():
    case = hygiene.Case("decode_wide", "c", None, None, True)
    good, bad = hygiene.Tally(), hygiene.Tally()
    for poison in hygiene.POISONS:
        good.add(case, True, 0, False, poison)
        good.add(case, True, 0, True, poison)
    bad.add(case, False, 0, True, 0xA5)
    lines = [good.line("decode_wide", False)]
    assert lines[0]["poisons"] == ["0x5a", "0xa5"] and lines[0]["occupied"] == 2
    summ, rc = hygiene.summary(lines)
    assert rc == 0 and summ["ok"] and summ["hygiene_summary"]["decoder_calls"] == 4
    assert hygiene.summary(lines + [bad.line("decode_stream", True)])[1] == 1
    assert bad.line("decode_stream", True)["first_bad"] == ["c (poison 0xa5, occupied)"]
    guarded = hygiene.Tally()
    guarded.add(case, True, 3, False, 0x5A, sizes=[1000])
    assert hygiene.summary([guarded.line("encode_kernel", False)])[1] == 1
    assert guarded.first_bad == ["c (poison 0x5a, guards of blocks of [1000] B)"]
    a, b = torch.zeros(3, dtype=torch.uint8), torch.zeros(3, dtype=torch.int32)
    assert hygiene.same([a], [a.clone()]) and not hygiene.same([a], [b])
    assert not hygiene.same([a], [a, a])


def test_allocator_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        hygiene.install_allocator()
    with pytest.raises(SystemExit, match="unknown families"):
        hygiene.main(["--families", "decode,nope"])
