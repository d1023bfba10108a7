from .ops import hadamard_transform, srht_apply
from .ref import fwht, hadamard_matrix, hadamard_ref, srht_ref

__all__ = [
    "fwht",
    "hadamard_matrix",
    "hadamard_ref",
    "hadamard_transform",
    "srht_apply",
    "srht_ref",
]
