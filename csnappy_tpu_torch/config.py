"""Codec configuration of the PyTorch port — the JAX package's knob surface.

  * ``block_size``   — whole-stream fragment size (csnappy_compress.c:636).
  * ``page_size``    — block-container page size (zram parity): validated for
    parity with the JAX package; the container (``runtime/container.py``)
    takes ``page_size`` as an argument, as the JAX one does, and nothing
    reads this field.
  * ``hash_bits``    — accepted and validated for parity, ignored: the fused
    encoder's sort-based matcher is exact and has no table.
  * ``backend``      — ``torch`` (the kernels) | ``py`` (the oracle) |
    ``native`` (the host C++ codec, ``runtime/native.py``).
  * ``device``       — where the ``torch`` backend runs; ``None`` means
    ``cuda``, and with no card that raises.  Tests pass ``"cpu"``, which
    runs each kernel's plain PyTorch version.
  * ``debug_checks`` — cross-check every ``torch`` result against the oracle.
    Env default: CSNAPPY_TPU_DEBUG=1.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field

import torch


BACKENDS = ("torch", "py", "native")


@dataclass(frozen=True)
class CodecConfig:
    block_size: int = 32768        # fragment size; <= 32768, multiple of 1024
    page_size: int = 4096          # container page size: validated for parity; the
                                   # container takes page_size as an argument
    hash_bits: int = 16            # 10..16, ignored by the exact sort matcher
    backend: str = "torch"         # torch | py | native
    device: str | None = None      # None = "cuda"
    debug_checks: bool = field(
        default_factory=lambda: bool(os.environ.get("CSNAPPY_TPU_DEBUG"))
    )

    def __post_init__(self):
        if not 1024 <= self.block_size <= 32768 or self.block_size % 1024:
            raise ValueError("block_size must be in [1024, 32768], multiple of 1024")
        if not 1024 <= self.page_size or self.page_size % 1024:
            raise ValueError("page_size must be a multiple of 1024 >= 1024")
        if not 10 <= self.hash_bits <= 16:
            raise ValueError("hash_bits must be in [10, 16]")
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}")


DEFAULT = CodecConfig()


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; raise when there is none (no silent CPU path)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run the plain versions")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def refuse_card_tensors(dev: torch.device, *xs) -> None:
    """The plain versions run only on CPU tensors: a tensor already on the
    card with ``device="cpu"`` raises instead of being copied to the host."""
    if dev.type == "cpu" and any(isinstance(x, torch.Tensor) and x.is_cuda for x in xs):
        raise ValueError("a CUDA tensor was passed with device='cpu'; "
                         "the kernels run on the card, the plain versions on CPU tensors")
