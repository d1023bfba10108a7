from .ops import SRHTPlan, gather_list, hadamard_transform, sign_mask, srht_apply, srht_plan
from .ref import fwht, hadamard_matrix, hadamard_ref, srht_ref

__all__ = [
    "SRHTPlan",
    "fwht",
    "gather_list",
    "hadamard_matrix",
    "hadamard_ref",
    "hadamard_transform",
    "sign_mask",
    "srht_apply",
    "srht_plan",
    "srht_ref",
]
