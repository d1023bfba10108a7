"""Plain PyTorch versions for the TSQR package — same contracts, no kernel."""
from __future__ import annotations

import torch

from ..countsketch.ref import acc_dtype, countsketch_ref
from ..sketch_matmul.ref import fused_gaussian_ref, sketch_matmul_ref

__all__ = [
    "panel_gram_ref",
    "countsketch_gram_ref",
    "matmul_gram_ref",
    "gaussian_gram_ref",
    "tsqr_ref",
]


def panel_gram_ref(B: torch.Tensor) -> torch.Tensor:
    """G = BᵀB in the accumulation dtype (kernel B2's oracle)."""
    Bf = B.to(acc_dtype(B.dtype))
    return Bf.T @ Bf


def countsketch_gram_ref(A, buckets, signs, d):
    """(B = SA, G = BᵀB) in the accumulation dtype (kernel B3's oracle)."""
    B = countsketch_ref(A, buckets, signs, d)
    return B, panel_gram_ref(B)


def matmul_gram_ref(S, A):
    """(B = SA, G = BᵀB) in the accumulation dtype (kernel B7's oracle)."""
    B = sketch_matmul_ref(S, A)
    return B, panel_gram_ref(B)


def gaussian_gram_ref(A, key, d, scale=None):
    """(B = scale·G·A, G = BᵀB) in the accumulation dtype (kernel B5's
    oracle)."""
    B = fused_gaussian_ref(A, key, d, scale)
    return B, panel_gram_ref(B)


def tsqr_ref(B: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Householder QR with the package's diag(R) ≥ 0 sign convention."""
    Q, R = torch.linalg.qr(B, mode="reduced")
    sgn = torch.where(torch.diagonal(R) < 0, -1.0, 1.0).to(R.dtype)
    return Q * sgn[None, :], R * sgn[:, None]
