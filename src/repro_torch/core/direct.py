"""Deterministic direct least-squares solvers (ground truth for tests).

Port of ``repro/core/direct.py``; all three are library linear algebra
(LAPACK on the CPU, cuSOLVER/cuBLAS on the card), as in the reference.
"""
from __future__ import annotations

import torch

from .backend import as_tensor

__all__ = ["qr_solve", "svd_solve", "normal_equations"]


def _inputs(A, b, device):
    A = as_tensor(A, device)
    return A, as_tensor(b, A.device, A.dtype)


def qr_solve(A, b, *, device=None) -> torch.Tensor:
    """x = R⁻¹ Qᵀ b via reduced Householder QR of A."""
    A, b = _inputs(A, b, device)
    Q, R = torch.linalg.qr(A, mode="reduced")
    return torch.linalg.solve_triangular(R, (Q.T @ b)[:, None], upper=True)[:, 0]


def svd_solve(A, b, rcond: float | None = None, *, device=None) -> torch.Tensor:
    """Minimum-norm LS solution via SVD (most robust, most expensive).

    Singular values at or below ``rcond·σ_max`` are dropped; ``None`` means
    ε·max(m, n), the reference's (``jnp.linalg.lstsq``) default."""
    A, b = _inputs(A, b, device)
    U, S, Vh = torch.linalg.svd(A, full_matrices=False)
    if rcond is None:
        rcond = torch.finfo(A.dtype).eps * max(A.shape)
    keep = S > rcond * S[0]
    inv = torch.where(keep, 1.0 / torch.where(keep, S, 1.0), 0.0)
    return Vh.T @ (inv * (U.T @ b))


def normal_equations(A, b, *, device=None) -> torch.Tensor:
    """Cholesky on AᵀA — fast, squares the condition number (for comparison)."""
    A, b = _inputs(A, b, device)
    L = torch.linalg.cholesky(A.T @ A)
    return torch.cholesky_solve((A.T @ b)[:, None], L)[:, 0]
