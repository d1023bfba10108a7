"""Sketching operators (paper §2), CountSketch slice.

Port of ``repro/core/sketch.py``.  ``sample(kind, key, d, m)`` draws an
operator from a ``torch.Generator``; ``op.apply(A, backend=...)`` applies
it to an (m,) vector or (m, n) matrix along axis 0, and ``op.apply_op(A)``
sketches a ``repro_torch.core.linop`` operator.  CountSketch
(Clarkson–Woodruff, the paper's choice) is the one kind of this slice; the
other five kinds arrive with ROADMAP A5 and ``sample`` raises for them.

Backends (see ``repro_torch.core.backend``): ``"auto"`` routes the apply
through kernel B1's wrapper (``countsketch_apply``: the hand kernel for a
CUDA tensor, the plain version for a CPU tensor); ``"reference"`` runs the
plain ``index_add_`` version.  Both realize the same S.

Row streaming: ``apply_rows(tile, row_offset)`` is the restriction of S to a
contiguous row tile of A, and ``restrict_cols(idx)`` the sub-operator
S[:, idx] — the primitives the streaming and session slices build on.
"""
from __future__ import annotations

import dataclasses

import torch

from ..kernels.countsketch import countsketch_apply, countsketch_csr, countsketch_ref
from . import backend as backend_lib
from . import linop

__all__ = ["sample", "CountSketch", "SKETCH_KINDS"]


class _OperatorApply:
    """Operator-aware sketching: B = S·A for A given as a linop operator.

    Dense operators take the backend-dispatched ``apply``; the sparse,
    Tikhonov and matrix-free dispatch of the reference arrives with
    ROADMAP A8.
    """

    def apply_op(self, A, *, backend: str = "auto"):
        A = linop.as_operator(A, device=self.device)
        if isinstance(A, linop.DenseOperator):
            return self.apply(A.A, backend=backend)
        raise NotImplementedError(
            f"sketching a {type(A).__name__} arrives with ROADMAP A8"
        )


@dataclasses.dataclass(frozen=True)
class CountSketch(_OperatorApply):
    """Clarkson–Woodruff: one ±1 per column of S, at a random bucket.

    SA[k] = sum_{i : h(i)=k} s(i) · A[i] — an isometry in expectation with
    no scaling.  The bucket → rows CSR that kernel B1 walks is built once
    per dtype and cached on the operator (:meth:`csr`).
    """

    buckets: torch.Tensor  # (m,) int32 in [0, d)
    signs: torch.Tensor  # (m,) ±1
    d: int
    m: int
    _csr: dict = dataclasses.field(
        default_factory=dict, compare=False, repr=False
    )

    @classmethod
    def sample(cls, key, d, m, dtype=torch.float64, *, device=None):
        dev = backend_lib.resolve_device(device)
        gen = backend_lib.as_generator(key, dev)
        buckets = torch.randint(
            0, d, (m,), generator=gen, dtype=torch.int32, device=dev
        )
        signs = torch.randint(
            0, 2, (m,), generator=gen, dtype=torch.int8, device=dev
        ).to(dtype) * 2 - 1
        return cls(buckets=buckets, signs=signs, d=int(d), m=int(m))

    @property
    def device(self) -> torch.device:
        return self.buckets.device

    def csr(self, dtype: torch.dtype):
        """The cached bucket → rows CSR with signs in ``dtype``."""
        if dtype not in self._csr:
            self._csr[dtype] = countsketch_csr(
                self.buckets, self.signs, self.d, dtype
            )
        return self._csr[dtype]

    def apply(self, A, *, backend: str = "auto"):
        A = backend_lib.as_tensor(A, self.device)
        if backend_lib.uses_kernels(backend):
            csr = self.csr(A.dtype) if A.device.type == "cuda" else None
            return countsketch_apply(A, self.buckets, self.signs, self.d, csr=csr)
        return countsketch_ref(A, self.buckets, self.signs, self.d)

    def apply_rows(self, tile, row_offset: int, *, backend: str = "auto"):
        t = tile.shape[0]
        return self.restrict_cols(
            slice(row_offset, row_offset + t)
        ).apply(tile, backend=backend)

    def restrict_cols(self, idx):
        buckets, signs = self.buckets[idx], self.signs[idx]
        return CountSketch(
            buckets=buckets, signs=signs, d=self.d, m=buckets.shape[0]
        )

    def as_dense(self):
        S = torch.zeros((self.d, self.m), dtype=self.signs.dtype, device=self.device)
        S[self.buckets.to(torch.int64), torch.arange(self.m, device=self.device)] = self.signs
        return S


SKETCH_KINDS: dict[str, type] = {
    "countsketch": CountSketch,
    "clarkson_woodruff": CountSketch,  # alias — the paper's final choice
}

_LATER_KINDS = ("gaussian", "uniform_dense", "srht", "sparse_sign", "uniform_sparse")


def sample(kind: str, key, d: int, m: int, dtype=torch.float64, *, device=None, **kw):
    """Draw a sketching operator ``S : R^m -> R^d`` of the given kind."""
    if kind in _LATER_KINDS:
        raise NotImplementedError(
            f"sketch kind {kind!r} arrives with ROADMAP A5; this slice has "
            f"{sorted(SKETCH_KINDS)}"
        )
    try:
        cls = SKETCH_KINDS[kind]
    except KeyError:
        raise ValueError(
            f"unknown sketch kind {kind!r}; have {sorted(SKETCH_KINDS)}"
        ) from None
    return cls.sample(key, d, m, dtype=dtype, device=device, **kw)
