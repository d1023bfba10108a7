"""Tall-skinny QR: tree-Householder panels, CholeskyQR finisher, panel Gram.

Port of ``repro/kernels/tsqr/ops.py``.  Two TSQR modes, both returning
B = QR with Q (s, n) orthonormal and R (n, n) upper triangular with a
non-negative diagonal:

- ``mode="tree"`` — Householder QR of each row panel (batched), then the
  per-panel R factors merge pairwise up a binary tree; Q = B·R⁻¹ plus one
  CholeskyQR correction round.
- ``mode="cholqr"`` — shifted CholeskyQR3 (Fukaya et al. 2020) from one
  Gram G = BᵀB computed by kernel B2 (:func:`panel_gram`).

:func:`panel_gram` wraps kernel B2 (``csrc/gram.cuh``), which replaces
``repro/kernels/tsqr/kernel.py:51`` (``panel_gram_kernel``, launched at
``tsqr/ops.py:67``): a CUDA tensor launches the kernel or raises, a CPU
tensor runs the plain version of ``ref.py``.  In f64 the kernel runs on the
FP64 tensor cores and in f32 on the TF32 tensor cores in split TF32 (each
value cut exactly into three TF32 parts, six TF32 products a product,
``csrc/tf32_mma.cuh``), each with its sum over s
split into slabs by :func:`repro_torch.kernels.common.gram_split`.
"""
from __future__ import annotations

import torch

from ...core.backend import as_tensor
from .. import _build
from ..common import gram_split, pad_to, scratch_for, sm_count
from ..countsketch.ref import acc_dtype
from .ref import panel_gram_ref

__all__ = ["MAX_FUSED_COLS", "panel_gram", "cholqr_finish", "tsqr"]

# Widest A the fused CountSketch-Gram route (kernel B3) takes; wider A goes
# through the unfused apply and a library Gram, as in the reference.  The
# reference's 512 is a VMEM budget.  Here shared memory sets no limit: B1
# keeps no per-block state and B2's block tiles are 64x64 whatever n is.  The
# cap is instead the widest width ``chip_smoke.py`` holds kernels B2 and B3
# against their plain versions on the card, so the fused route never runs
# at a width that was not checked there.
MAX_FUSED_COLS = 2048


def panel_gram(B: torch.Tensor) -> torch.Tensor:
    """G = BᵀB for B (s, n) in the accumulation dtype (f32 for half B)."""
    if not isinstance(B, torch.Tensor) or B.ndim != 2:
        raise ValueError("panel_gram takes a 2-D torch.Tensor")
    if B.device.type == "cpu":
        return panel_gram_ref(B)
    if B.device.type != "cuda":
        raise ValueError(f"panel_gram runs on CUDA or CPU, got {B.device}")
    code = _build.dtype_code(B.dtype)
    B = B.contiguous()
    s, n = B.shape
    G = torch.empty((n, n), dtype=acc_dtype(B.dtype), device=B.device)
    split = gram_split(B.dtype, s, n, sm_count(B.device))
    scratch = scratch_for([split], B.device)
    lib = _build.load()
    with torch.cuda.device(B.device):
        err = lib.repro_panel_gram(
            code, B.data_ptr(), G.data_ptr(), _build.ptr(scratch), s, n, split.slab,
            split.parts, _build.stream_ptr(B.device),
        )
    _build.check(err, "panel_gram")
    _build.count_launch(panel_gram)
    return G


panel_gram.launches = 0


def _positive_diag(Q, R):
    """Flip row signs of R (and matching column signs of Q) so diag(R) ≥ 0."""
    sgn = torch.where(torch.diagonal(R) < 0, -1.0, 1.0).to(R.dtype)
    return Q * sgn[None, :], R * sgn[:, None]


def _right_solve(R, X):
    """X·R⁻¹ for upper-triangular R."""
    return torch.linalg.solve_triangular(R, X, upper=True, left=False)


def cholqr_finish(
    B: torch.Tensor, G: torch.Tensor, *, rounds: int = 2
) -> tuple[torch.Tensor, torch.Tensor]:
    """Shifted CholeskyQR with ``rounds`` correction passes: B = QR from a
    precomputed Gram G = BᵀB.

    The shift σ = 11(sn + n(n+1))·ε·tr(G)/n keeps the first Cholesky
    positive definite when κ(G) exceeds 1/ε; each correction round
    re-orthogonalizes Q ← Q·chol(QᵀQ)⁻¹ and absorbs the factor into R.
    """
    s, n = B.shape
    dtype = B.dtype
    eps = torch.finfo(dtype).eps
    eye = torch.eye(n, dtype=dtype, device=B.device)
    shift = 11.0 * (s * n + n * (n + 1)) * eps * torch.trace(G) / n
    R = torch.linalg.cholesky(G + shift * eye).mT
    Q = _right_solve(R, B)
    for _ in range(rounds):
        R2 = torch.linalg.cholesky(Q.T @ Q).mT
        Q = _right_solve(R2, Q)
        R = R2 @ R
    return _positive_diag(Q, R)


def _tree_r(B_p: torch.Tensor, block_rows: int) -> torch.Tensor:
    """R of B via per-panel Householder QR + binary-tree pairwise merges."""
    s_p, n = B_p.shape
    Rs = torch.linalg.qr(B_p.reshape(s_p // block_rows, block_rows, n)).R
    while Rs.shape[0] > 1:
        p = Rs.shape[0]
        odd = None
        if p % 2:  # odd level: carry the last R up unmerged
            odd, Rs = Rs[-1:], Rs[:-1]
        pairs = Rs.reshape(p // 2, 2 * Rs.shape[1], n)
        Rs = torch.linalg.qr(pairs).R
        if odd is not None:
            pad = Rs.new_zeros((1, Rs.shape[1] - odd.shape[1], n))
            Rs = torch.cat([Rs, torch.cat([odd, pad], dim=1)])
    return Rs[0][:n]


def tsqr(
    B,
    *,
    mode: str = "tree",
    block_rows: int = 512,
    device=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Tall-skinny QR of B (s ≥ n): returns (Q, R), diag(R) ≥ 0.

    ``mode="tree"`` is the stability-first default; ``mode="cholqr"`` runs
    kernel B2 and shifted CholeskyQR3 (stable to κ ≈ 1e10 in f64).
    """
    B = as_tensor(B, device)
    s, n = B.shape
    if s < n:
        raise ValueError(f"tsqr needs a tall matrix, got shape {(s, n)}")
    if mode == "cholqr":
        G = panel_gram(B)
        # half-precision B factors in the f32 accumulation dtype of the Gram
        return cholqr_finish(B.to(G.dtype), G)
    if mode != "tree":
        raise ValueError(f"unknown tsqr mode {mode!r}; have ('tree', 'cholqr')")

    br = max(min(block_rows, s), n)
    R = _tree_r(pad_to(B, (br, 1)), br)
    _, R = _positive_diag(B.new_empty((0, n)), R)
    # Q = B·R⁻¹ + ONE CholeskyQR correction (κ(B·R⁻¹) ≈ 1, so it is safe).
    Q = _right_solve(R, B)
    R2 = torch.linalg.cholesky(Q.T @ Q).mT
    Q = _right_solve(R2, Q)
    return _positive_diag(Q, R2 @ R)
