"""Error taxonomy of the codec (own copy of ``csnappy_tpu/errors.py``).

Mirrors the error-code contract of the reference C API (csnappy.h:124-129):
every failure mode the reference can report is reportable here, with the same
numeric values so drivers can be swapped 1:1.  On device, kernels carry a
per-stream int32 status; the host reduces it to these codes (SURVEY.md §5
"failure detection").
"""
from __future__ import annotations

E_OK = 0
E_HEADER_BAD = -1          # varint preamble unparseable (>5 bytes / shift overflow)
E_OUTPUT_INSUF = -2        # header-declared length exceeds caller's dst buffer
E_OUTPUT_OVERRUN = -3      # stream tried to produce more bytes than dst has
E_INPUT_NOT_CONSUMED = -4  # decode finished before consuming the whole input
E_DATA_MALFORMED = -5      # bad tag/offset/truncated stream

_MESSAGES = {
    E_OK: "ok",
    E_HEADER_BAD: "bad varint length header",
    E_OUTPUT_INSUF: "output buffer smaller than header-declared length",
    E_OUTPUT_OVERRUN: "stream writes past end of output buffer",
    E_INPUT_NOT_CONSUMED: "decode ended before end of input",
    E_DATA_MALFORMED: "malformed compressed data",
}


class SnappyError(Exception):
    """Codec failure carrying one of the CSNAPPY-compatible error codes."""

    def __init__(self, code: int, detail: str = ""):
        self.code = code
        msg = _MESSAGES.get(code, f"error {code}")
        super().__init__(f"{msg}{': ' + detail if detail else ''} (code {code})")


def raise_for_code(code: int, detail: str = "") -> None:
    if code != E_OK:
        raise SnappyError(code, detail)
