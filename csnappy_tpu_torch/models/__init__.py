"""Wire format and the oracle (own copies of ``csnappy_tpu.models``)."""
from . import pymodel, wire

__all__ = ["wire", "pymodel"]
