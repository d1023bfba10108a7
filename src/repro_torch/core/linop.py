"""Linear operators — the input protocol of every solver.

Port of ``repro/core/linop.py``.  The solvers touch A only through
products: ``matvec``/``rmatvec`` (vectors), ``matmat``/``rmatmat``
(blocks) and ``materialize`` (dense A, when possible).

- :class:`LinearOperator` — the protocol.
- :class:`DenseOperator` — wraps a dense ``torch.Tensor``.
- :class:`SparseOperator` — a sparse A (the counterpart of the
  reference's BCOO): a torch sparse tensor in the COO, CSR or CSC layout,
  or the entries of a BCOO (``repro_torch.convert.sparse_from_reference``).
  It keeps the entries in the caller's order, duplicates included, for the
  bucket sketches' coordinate scatter, and a CSR of A and a CSR of Aᵀ,
  built once, so ``matvec`` and ``rmatvec`` are both row-parallel
  products.  Each product is a gather of the operand, the entries'
  products and a segment sum over the CSR's rows: a fixed order, so two
  calls give the same bits.  cuSPARSE's SpMV does not: on an H100 its
  product with Aᵀ's CSR (rows of ~10⁴ entries) changed bits from call to
  call (``chip_smoke.py`` phase 12).
- :class:`TikhonovAugmented` — the ridge operator [A; √λ·Iₙ] behind
  ``lstsq(..., reg=λ)``.
- :class:`CustomOperator` — any (matvec, rmatvec) pair, including
  SciPy-style duck-typed operators.

``matmat``/``rmatmat`` default to ``torch.vmap`` of the vector products
(the reference's ``jax.vmap``), so a closure ``A @ v`` becomes one matrix
product over the block.  A callable that ``torch.vmap`` cannot batch (one
that leaves tensor code: ``.item()``, numpy, a Python branch on a value)
makes ``matmat``/``rmatmat`` raise ``torch.vmap``'s error; give such an
operator its own blocked products by subclassing :class:`LinearOperator`.

``estimate_2norm`` is the shared power-iteration σ_max estimator; its start
vector is drawn from a ``torch.Generator``.
"""
from __future__ import annotations

import dataclasses
import functools
import warnings
from typing import Callable, NamedTuple

import numpy as np
import torch

from .backend import as_generator, as_tensor, resolve_device

__all__ = [
    "LinearOperator",
    "DenseOperator",
    "SparseOperator",
    "TikhonovAugmented",
    "CustomOperator",
    "CSR",
    "input_kind",
    "as_operator",
    "ensure_dense",
    "estimate_2norm",
]

_SPARSE_LAYOUTS = (torch.sparse_coo, torch.sparse_csr, torch.sparse_csc)
# Mean entries a row above which a CSR product reduces its (nnz,) products
# rather than an (nnz, 1) view of them (CSR.mm).
_LONG_ROWS = 64


class LinearOperator:
    """Protocol base: a linear map R^n → R^m known only through products.

    Subclasses define ``shape``/``dtype``/``device``/``matvec``/``rmatvec``;
    the blocked ``matmat``/``rmatmat`` default to ``torch.vmap`` of the
    vector products over the block's columns.
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
        return torch.vmap(self.matvec, in_dims=1, out_dims=1)(X)

    def rmatmat(self, U: torch.Tensor) -> torch.Tensor:
        return torch.vmap(self.rmatvec, in_dims=1, out_dims=1)(U)

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


class CSR(NamedTuple):
    """A sparse matrix in compressed rows, coordinates unique and sorted."""

    crow: torch.Tensor  # (rows + 1,) int64 — row i owns entries [crow[i], crow[i+1])
    col: torch.Tensor  # (nnz,) int64
    val: torch.Tensor  # (nnz,)
    shape: tuple[int, int]

    @classmethod
    def of(cls, major, minor, vals, n_major: int, n_minor: int) -> "CSR":
        """The (n_major, n_minor) CSR of the entries (major, minor, vals),
        repeated coordinates summed.  A stable sort keeps the order of
        equal coordinates and each run of them is one segment sum, so the
        CSR is the same on every call."""
        key = major * n_minor + minor
        key, perm = torch.sort(key, stable=True)
        uniq, counts = torch.unique_consecutive(key, return_counts=True)
        vals = vals[perm]
        if uniq.numel() != key.numel():
            vals = torch.segment_reduce(vals, "sum", lengths=counts)
        rows = torch.div(uniq, n_minor, rounding_mode="floor")
        crow = torch.zeros(n_major + 1, dtype=torch.int64, device=vals.device)
        torch.cumsum(torch.bincount(rows, minlength=n_major), 0, out=crow[1:])
        return cls(crow=crow, col=uniq - rows * n_minor, val=vals, shape=(n_major, n_minor))

    def mm(self, X: torch.Tensor) -> torch.Tensor:
        """This matrix times X (a vector, or a block column by column): each
        row's products with the gathered entries of X, summed in the row's
        order by one segment reduction.  Its (nnz,) form is the faster one
        for long rows and its (nnz, 1) form for short ones (on an H100,
        ``chip_smoke.py`` phase 12: 0.22 against 2.62 ms for 1000 rows of
        ~10⁴ entries, 1.45 against 0.20 ms for 2^20 rows of 10).  Each form
        sums in a fixed order, not the same one, and the choice follows the
        CSR's shape alone, so two calls give the same bits."""
        if X.ndim == 2:
            return torch.stack([self.mm(X[:, j]) for j in range(X.shape[1])], dim=1)
        p = self.val * X[self.col]
        if p.numel() > _LONG_ROWS * self.shape[0]:
            return torch.segment_reduce(p, "sum", offsets=self.crow)
        return torch.segment_reduce(p[:, None], "sum", offsets=self.crow, axis=0)[:, 0]

    def to_dense(self) -> torch.Tensor:
        rows = torch.repeat_interleave(
            torch.arange(self.shape[0], device=self.val.device), self.crow.diff()
        )
        out = torch.zeros(self.shape, dtype=self.val.dtype, device=self.val.device)
        out[rows, self.col] = self.val
        return out

    def to_torch(self) -> torch.Tensor:
        """As a torch sparse CSR tensor, for a library product."""
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", "Sparse CSR tensor support is in beta")
            return torch.sparse_csr_tensor(
                self.crow, self.col, self.val, self.shape, check_invariants=False
            )


@dataclasses.dataclass(frozen=True)
class SparseOperator(LinearOperator):
    """A sparse A given by its entries (r, c, v): O(nnz) products.

    ``rows``, ``cols`` (int64) and ``vals`` hold the entries in the
    caller's order, repeated coordinates included (they add up); the
    bucket sketches scatter straight from them (``core/sketch.py``), so A
    is never densified there.  ``csr`` and ``csr_t`` are the :class:`CSR`
    of A and of Aᵀ, built once by :meth:`from_entries`: ``matvec`` and
    ``matmat`` multiply with the first, ``rmatvec`` and ``rmatmat`` with
    the second, each a row-parallel product in a fixed order.
    """

    rows: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor
    op_shape: tuple[int, int]
    csr: CSR = dataclasses.field(repr=False)
    csr_t: CSR = dataclasses.field(repr=False)

    @classmethod
    def from_entries(cls, rows, cols, vals, shape, *, device=None) -> "SparseOperator":
        """The operator of the entries (rows[e], cols[e], vals[e]) of an
        (m, n) matrix, on ``device`` (``None`` → ``cuda``)."""
        dev = resolve_device(device)
        m, n = (int(s) for s in shape)
        rows = as_tensor(rows, dev, torch.int64).reshape(-1)
        cols = as_tensor(cols, dev, torch.int64).reshape(-1)
        vals = as_tensor(vals, dev).reshape(-1)
        if not (rows.shape == cols.shape == vals.shape):
            raise ValueError(
                f"rows, cols and vals must have one length, got {rows.numel()}, "
                f"{cols.numel()} and {vals.numel()}"
            )
        if not vals.is_floating_point():
            raise TypeError(f"sparse values must be floating point, got {vals.dtype}")
        if rows.numel() and not (
            0 <= int(rows.min()) and int(rows.max()) < m
            and 0 <= int(cols.min()) and int(cols.max()) < n
        ):
            raise ValueError(f"entry coordinates must lie in [0, {m}) x [0, {n})")
        return cls(
            rows=rows, cols=cols, vals=vals, op_shape=(m, n),
            csr=CSR.of(rows, cols, vals, m, n), csr_t=CSR.of(cols, rows, vals, n, m),
        )

    @classmethod
    def from_tensor(cls, M: torch.Tensor, *, device=None) -> "SparseOperator":
        """The operator of a 2-D torch sparse tensor (COO, CSR or CSC), its
        entries taken in its storage order."""
        if M.layout not in _SPARSE_LAYOUTS:
            raise ValueError(f"sparse layouts {_SPARSE_LAYOUTS} are supported, got {M.layout}")
        if M.ndim != 2 or M.dense_dim() != 0:
            raise ValueError(
                f"need a 2-D sparse matrix with scalar entries, got shape {tuple(M.shape)} "
                f"with {M.dense_dim()} dense dims"
            )
        M = M.to(resolve_device(device))
        if M.layout == torch.sparse_coo:
            rows, cols = M._indices()
            vals = M._values()
        elif M.layout == torch.sparse_csr:
            crow, cols, vals = M.crow_indices(), M.col_indices(), M.values()
            rows = torch.repeat_interleave(
                torch.arange(M.shape[0], device=M.device), crow.diff()
            )
        else:
            ccol, rows, vals = M.ccol_indices(), M.row_indices(), M.values()
            cols = torch.repeat_interleave(
                torch.arange(M.shape[1], device=M.device), ccol.diff()
            )
        return cls.from_entries(rows, cols, vals, M.shape, device=M.device)

    @property
    def shape(self):
        return self.op_shape

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def device(self):
        return self.vals.device

    @property
    def nse(self) -> int:
        """Stored entries, repeated coordinates counted each time."""
        return int(self.vals.numel())

    def matvec(self, x):
        return self.csr.mm(x)

    def rmatvec(self, u):
        return self.csr_t.mm(u)

    def matmat(self, X):
        return self.csr.mm(X)

    def rmatmat(self, U):
        return self.csr_t.mm(U)

    @property
    def materializable(self):
        return True

    def materialize(self):
        return self.csr.to_dense()


@dataclasses.dataclass(frozen=True)
class TikhonovAugmented(LinearOperator):
    """The ridge operator [A; √λ·Iₙ] of shape (m + n, n).

    min‖Ax − b‖² + λ‖x‖² = min‖[A; √λI] x − [b; 0]‖², so every
    least-squares solver handles Tikhonov regularization through this
    operator.  ``reg`` (λ ≥ 0) is a 0-d tensor in A's dtype on A's
    device, and so is √λ (:attr:`sqrt_reg`): the products multiply by it
    on the device and never round it through the host.
    """

    op: LinearOperator
    reg: torch.Tensor

    @classmethod
    def wrap(cls, A, reg, *, device=None) -> "TikhonovAugmented":
        op = as_operator(A, device=device)
        return cls(op=op, reg=torch.as_tensor(reg, dtype=op.dtype, device=op.device))

    @property
    def shape(self):
        m, n = self.op.shape
        return (m + n, n)

    @property
    def dtype(self):
        return self.op.dtype

    @property
    def device(self):
        return self.op.device

    @functools.cached_property
    def sqrt_reg(self) -> torch.Tensor:
        return torch.sqrt(self.reg)

    def matvec(self, x):
        return torch.cat([self.op.matvec(x), self.sqrt_reg * x])

    def rmatvec(self, u):
        m = self.op.shape[0]
        return self.op.rmatvec(u[:m]) + self.sqrt_reg * u[m:]

    def matmat(self, X):
        return torch.cat([self.op.matmat(X), self.sqrt_reg * X], dim=0)

    def rmatmat(self, U):
        m = self.op.shape[0]
        return self.op.rmatmat(U[:m]) + self.sqrt_reg * U[m:]

    def augment_rhs(self, b: torch.Tensor) -> torch.Tensor:
        """[b; 0ₙ] — the right-hand side (or block) of the augmented system."""
        n = self.op.shape[1]
        return torch.cat([b, b.new_zeros((n,) + tuple(b.shape[1:]))])

    @property
    def materializable(self):
        return self.op.materializable

    def materialize(self):
        n = self.op.shape[1]
        eye = torch.eye(n, dtype=self.dtype, device=self.device)
        return torch.cat([self.op.materialize(), self.sqrt_reg * eye], dim=0)


@dataclasses.dataclass(frozen=True)
class CustomOperator(LinearOperator):
    """Adapter for an arbitrary (matvec, rmatvec) pair.

    ``op_device`` is where the products take and return tensors (``None``
    → ``cuda``).  ``materialize_fn`` is optional; without it the operator
    is not materializable and ``lstsq`` routes it to the matrix-free
    solvers.  ``matmat``/``rmatmat`` batch the callables with
    ``torch.vmap`` (see the module docstring for callables it cannot
    batch).
    """

    matvec_fn: Callable
    rmatvec_fn: Callable
    op_shape: tuple[int, int]
    op_dtype: torch.dtype
    op_device: torch.device | str | None = None
    materialize_fn: Callable | None = None

    @property
    def shape(self):
        return tuple(self.op_shape)

    @property
    def dtype(self):
        return self.op_dtype

    @property
    def device(self):
        return resolve_device(self.op_device)

    def matvec(self, x):
        return self.matvec_fn(x)

    def rmatvec(self, u):
        return self.rmatvec_fn(u)

    @property
    def materializable(self):
        return self.materialize_fn is not None

    def materialize(self):
        if self.materialize_fn is None:
            return super().materialize()
        return self.materialize_fn()


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, dtype=np.dtype(dtype))).dtype


def input_kind(A) -> str:
    """``"dense"``, ``"sparse"`` or ``"operator"``: the form
    :func:`as_operator` gives ``A``, read without converting it."""
    if isinstance(A, DenseOperator):
        return "dense"
    if isinstance(A, SparseOperator):
        return "sparse"
    if isinstance(A, LinearOperator):
        return "operator"
    if isinstance(A, torch.Tensor) and A.layout != torch.strided:
        return "sparse"
    if hasattr(A, "matvec") and hasattr(A, "rmatvec") and hasattr(A, "shape"):
        return "operator"
    return "dense"


def as_operator(A, *, device=None) -> LinearOperator:
    """Coerce a dense matrix (tensor or numpy array), a torch sparse tensor
    (COO, CSR or CSC), a duck-typed operator (``matvec``, ``rmatvec``,
    ``shape`` and ``dtype``) or a :class:`LinearOperator` to the protocol.
    Idempotent on operators; data moves to ``device`` (``None`` →
    ``cuda``); a duck-typed operator keeps its own ``device`` when it has
    one."""
    if isinstance(A, LinearOperator):
        return A
    kind = input_kind(A)
    if kind == "sparse":
        return SparseOperator.from_tensor(A, device=device)
    if kind == "operator":
        dtype = getattr(A, "dtype", None)
        if dtype is None:
            raise TypeError(f"duck-typed operator {A!r} must expose .dtype")
        return CustomOperator(
            matvec_fn=A.matvec,
            rmatvec_fn=A.rmatvec,
            op_shape=tuple(A.shape),
            op_dtype=_torch_dtype(dtype),
            op_device=getattr(A, "device", None) or resolve_device(device),
            materialize_fn=getattr(A, "materialize", None),
        )
    A = as_tensor(A, device)
    if A.ndim != 2:
        raise ValueError(f"need a 2-D matrix, got shape {tuple(A.shape)}")
    return DenseOperator(A)


def ensure_dense(A, *, who: str = "this solver", device=None) -> torch.Tensor:
    """The dense matrix behind ``A``, or raise for a non-materializable one
    with a pointer to the matrix-free paths."""
    op = as_operator(A, device=device)
    if isinstance(op, DenseOperator):
        return op.A
    if not op.materializable:
        raise TypeError(
            f"{who} needs a materializable matrix, got {type(op).__name__}; "
            "use lstsq(method='iterative'/'fossils'/'saa'/'lsqr') for "
            "matrix-free inputs"
        )
    return op.materialize()


def estimate_2norm(A, key, iters: int = 25, *, device=None) -> torch.Tensor:
    """σ_max(A) by power iteration on AᵀA — the one shared 2-norm estimator.

    Accepts anything :func:`as_operator` does; only products with A are
    used.  ``key`` is a ``torch.Generator`` on A's device (or an int
    seed); the start vector is drawn from it.
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
