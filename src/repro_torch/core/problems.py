"""Ill-conditioned least-squares problem generator (paper §5.1, after [1]).

Port of ``repro/core/problems.py``:

  A = U₁ Σ Vᵀ with Haar U₁ ∈ R^{m×n}, Haar V ∈ R^{n×n},
  Σ log-equispaced in [1, 1/κ];  x = w/‖w‖;  r ⟂ range(A), ‖r‖ = β;
  b = A x + r.   Then x is exactly argmin‖Ax−b‖ with residual norm β.

``method='haar'`` draws U₁ via QR of a Gaussian; ``method='fast'`` uses the
scaled Gaussian itself (κ up to a Marchenko–Pastur factor, x_true the
minimizer only up to O(β)).  The draws come from one ``torch.Generator`` on
the chosen device, in the order G₁, V, w, g; they differ from the
reference's ``jax.random`` draws, so a test that needs both packages on one
problem carries the reference's arrays across with
``repro_torch.convert.problem_from_reference``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .backend import as_generator, resolve_device

__all__ = ["generate", "Problem"]


class Problem(NamedTuple):
    A: torch.Tensor
    b: torch.Tensor
    x_true: torch.Tensor
    r_true: torch.Tensor
    cond: float
    beta: float


def generate(
    key,
    m: int,
    n: int,
    *,
    cond: float = 1e10,
    beta: float = 1e-10,
    dtype: torch.dtype = torch.float64,
    method: str = "haar",
    device=None,
) -> Problem:
    if not m > n:
        raise ValueError(f"overdetermined problems need m > n, got {m}x{n}")
    if method not in ("haar", "fast"):
        raise ValueError(f"unknown method {method!r}")
    dev = resolve_device(device)
    gen = as_generator(key, dev)

    def randn(*shape):
        return torch.randn(shape, generator=gen, dtype=dtype, device=dev)

    G1 = randn(m, n)
    if method == "haar":
        U1 = torch.linalg.qr(G1, mode="reduced").Q
    else:
        U1 = G1 / math.sqrt(m)  # ≈ orthonormal columns
    del G1
    V = torch.linalg.qr(randn(n, n), mode="reduced").Q
    sigma = torch.logspace(0.0, -math.log10(cond), n, dtype=dtype, device=dev)
    A = (U1 * sigma) @ V.T

    w = randn(n)
    x = w / torch.linalg.vector_norm(w)

    # r = β · (component of a Gaussian orthogonal to range(A)); for 'haar'
    # range(A) = range(U1) exactly, so x is the exact minimizer.
    g = randn(m)
    v = g - U1 @ (U1.T @ g) if method == "haar" else g
    r = beta * v / torch.linalg.vector_norm(v)
    b = A @ x + r
    return Problem(A=A, b=b, x_true=x, r_true=r, cond=cond, beta=beta)
