from .ops import (
    CooPlan,
    CountSketchCSR,
    countsketch_apply,
    countsketch_coo_apply,
    countsketch_coo_plan,
    countsketch_csr,
)
from .ref import countsketch_coo_ref, countsketch_fold_ref, countsketch_ref

__all__ = [
    "CooPlan",
    "CountSketchCSR",
    "countsketch_apply",
    "countsketch_coo_apply",
    "countsketch_coo_plan",
    "countsketch_coo_ref",
    "countsketch_csr",
    "countsketch_fold_ref",
    "countsketch_ref",
]
