"""Linear operators — the input protocol of every solver.

Port of ``repro/core/linop.py`` for dense inputs.  The solvers touch A only
through products: ``matvec``/``rmatvec`` (vectors), ``matmat``/``rmatmat``
(blocks) and ``materialize`` (dense A, when possible).

- :class:`LinearOperator` — the protocol.
- :class:`DenseOperator` — wraps a dense ``torch.Tensor``.
- ``SparseOperator``, ``TikhonovAugmented`` and ``CustomOperator`` arrive
  with the sparse and matrix-free slice (ROADMAP A8); :func:`as_operator`
  raises ``NotImplementedError`` for those inputs.

``estimate_2norm`` is the shared power-iteration σ_max estimator; its start
vector is drawn from a ``torch.Generator``.
"""
from __future__ import annotations

import dataclasses

import torch

from .backend import as_generator, as_tensor

__all__ = [
    "LinearOperator",
    "DenseOperator",
    "as_operator",
    "ensure_dense",
    "estimate_2norm",
]


class LinearOperator:
    """Protocol base: a linear map R^n → R^m known only through products.

    Subclasses define ``shape``/``dtype``/``device``/``matvec``/``rmatvec``;
    the blocked ``matmat``/``rmatmat`` default to one vector product per
    column.
    """

    @property
    def shape(self) -> tuple[int, int]:
        raise NotImplementedError

    @property
    def dtype(self) -> torch.dtype:
        raise NotImplementedError

    @property
    def device(self) -> torch.device:
        raise NotImplementedError

    @property
    def ndim(self) -> int:
        return 2

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def rmatvec(self, u: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def matmat(self, X: torch.Tensor) -> torch.Tensor:
        return torch.stack([self.matvec(x) for x in X.T], dim=1)

    def rmatmat(self, U: torch.Tensor) -> torch.Tensor:
        return torch.stack([self.rmatvec(u) for u in U.T], dim=1)

    def __matmul__(self, other):
        if other.ndim == 1:
            return self.matvec(other)
        if other.ndim == 2:
            return self.matmat(other)
        raise ValueError(f"operand must be 1- or 2-D, got ndim={other.ndim}")

    @property
    def materializable(self) -> bool:
        return False

    def materialize(self) -> torch.Tensor:
        raise TypeError(
            f"{type(self).__name__} cannot be materialized to a dense array; "
            "use a matrix-free solver (lstsq picks one automatically)"
        )


@dataclasses.dataclass(frozen=True)
class DenseOperator(LinearOperator):
    """A dense ``torch.Tensor`` seen through the operator protocol."""

    A: torch.Tensor

    @property
    def shape(self):
        return tuple(self.A.shape)

    @property
    def dtype(self):
        return self.A.dtype

    @property
    def device(self):
        return self.A.device

    def matvec(self, x):
        return self.A @ x

    def rmatvec(self, u):
        return self.A.T @ u

    def matmat(self, X):
        return self.A @ X

    def rmatmat(self, U):
        return self.A.T @ U

    @property
    def materializable(self):
        return True

    def materialize(self):
        return self.A


def as_operator(A, *, device=None) -> LinearOperator:
    """Coerce a dense matrix (tensor or numpy array) or a
    :class:`LinearOperator` to the protocol.  Idempotent on operators;
    dense data moves to ``device`` (``None`` → ``cuda``)."""
    if isinstance(A, LinearOperator):
        return A
    if isinstance(A, torch.Tensor) and A.layout != torch.strided:
        raise NotImplementedError(
            "sparse inputs (SparseOperator) arrive with ROADMAP A8"
        )
    if hasattr(A, "matvec") and hasattr(A, "rmatvec") and hasattr(A, "shape"):
        raise NotImplementedError(
            "matrix-free operators (CustomOperator) arrive with ROADMAP A8"
        )
    A = as_tensor(A, device)
    if A.ndim != 2:
        raise ValueError(f"need a 2-D matrix, got shape {tuple(A.shape)}")
    return DenseOperator(A)


def ensure_dense(A, *, who: str = "this solver", device=None) -> torch.Tensor:
    """The dense matrix behind ``A``, or raise for a non-materializable one."""
    op = as_operator(A, device=device)
    if isinstance(op, DenseOperator):
        return op.A
    if not op.materializable:
        raise TypeError(
            f"{who} needs a materializable matrix, got {type(op).__name__}"
        )
    return op.materialize()


def estimate_2norm(A, key, iters: int = 25, *, device=None) -> torch.Tensor:
    """σ_max(A) by power iteration on AᵀA — the one shared 2-norm estimator.

    ``key`` is a ``torch.Generator`` on A's device (or an int seed); the
    start vector is drawn from it.
    """
    A = as_operator(A, device=device)
    gen = as_generator(key, A.device)
    v = torch.randn(A.shape[1], generator=gen, dtype=A.dtype, device=A.device)
    v = v / torch.linalg.vector_norm(v)
    tiny = torch.finfo(A.dtype).tiny
    for _ in range(iters):
        w = A.rmatvec(A.matvec(v))
        v = w / torch.clamp(torch.linalg.vector_norm(w), min=tiny)
    return torch.linalg.vector_norm(A.matvec(v))
