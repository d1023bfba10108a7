from .ops import CountSketchCSR, countsketch_apply, countsketch_csr
from .ref import countsketch_ref

__all__ = ["CountSketchCSR", "countsketch_apply", "countsketch_csr", "countsketch_ref"]
