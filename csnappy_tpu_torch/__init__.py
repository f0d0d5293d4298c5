"""csnappy_tpu_torch — the Snappy codec of ``csnappy_tpu``, ported to PyTorch
and hand-written CUDA kernels for NVIDIA Hopper (H100).

The batched 32 KiB block codec (fused encode and decode kernels), the
whole-stream decoders, the public API over them, the paged block container
(zram's 4 KiB pages), the CLI, the ``native`` host codec and the tools.  The
JAX package ``csnappy_tpu`` is the reference each part is held against; this
package imports nothing from it and never imports JAX.  Entry points run on the card unless the caller passes ``device="cpu"``,
which runs each kernel's plain PyTorch version.
"""
from .errors import (
    E_DATA_MALFORMED,
    E_HEADER_BAD,
    E_INPUT_NOT_CONSUMED,
    E_OK,
    E_OUTPUT_INSUF,
    E_OUTPUT_OVERRUN,
    SnappyError,
)
from .models import wire

__version__ = "0.1.0"
CSNAPPY_COMPAT_VERSION = 5  # API-parity version (csnappy.h:11)

__all__ = [
    "wire",
    "SnappyError",
    "E_OK",
    "E_HEADER_BAD",
    "E_OUTPUT_INSUF",
    "E_OUTPUT_OVERRUN",
    "E_INPUT_NOT_CONSUMED",
    "E_DATA_MALFORMED",
]
