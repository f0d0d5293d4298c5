"""Carry the JAX package's state across to the port.

The codec has no weights: what crosses is its configuration and its block
layout.  The JAX kernels hold one byte per int32 in ``(rows, 128)`` tiles
and report per-block results in an ``int32[B, 8]`` meta array; the port
keeps uint8 at every boundary.  Everything here takes plain numpy arrays or
dicts, so this module imports nothing of the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from .config import CodecConfig

_BACKENDS = {"jax": "torch", "py": "py", "native": "native"}


def config_from_jax(d: dict) -> CodecConfig:
    """``CodecConfig`` from ``dataclasses.asdict`` of the JAX package's config.

    Backend ``jax`` maps to ``torch``; ``py`` and ``native`` stay; any other
    raises.  ``mesh_axis`` is dropped until the port has scale-out.
    """
    backend = d.get("backend", "jax")
    if backend not in _BACKENDS:
        raise ValueError(f"backend {backend!r} has no counterpart in the port")
    return CodecConfig(
        block_size=d.get("block_size", 32768),
        page_size=d.get("page_size", 4096),
        hash_bits=d.get("hash_bits", 16),
        backend=_BACKENDS[backend],
        debug_checks=d.get("debug_checks", False),
    )


def blocks_from_jax(a) -> torch.Tensor:
    """``int32[B, R, 128]`` one-byte-per-int32 tiles -> ``uint8[B, R*128]``."""
    a = np.asarray(a)
    if a.ndim != 3 or a.shape[2] != 128:
        raise ValueError(f"expected [B, R, 128], got {a.shape}")
    if a.size and (a.min() < 0 or a.max() > 255):
        raise ValueError("tile values must be bytes")
    return torch.from_numpy(a.reshape(a.shape[0], -1).astype(np.uint8))


def meta_from_jax(meta) -> tuple[torch.Tensor, torch.Tensor]:
    """``int32[B, 8]`` kernel meta -> (produced int32[B], status int32[B])."""
    m = np.asarray(meta)
    if m.ndim != 2 or m.shape[1] != 8:
        raise ValueError(f"expected [B, 8], got {m.shape}")
    return (torch.from_numpy(m[:, 0].astype(np.int32)),
            torch.from_numpy(m[:, 1].astype(np.int32)))
