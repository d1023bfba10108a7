"""Sketching operators (paper §2): CountSketch, Gaussian, uniform-dense.

Port of ``repro/core/sketch.py``.  ``sample(kind, key, d, m)`` draws an
operator from a ``torch.Generator`` (or an int seed); ``op.apply(A,
backend=...)`` applies it to an (m,) vector or (m, n) matrix along axis 0,
and ``op.apply_op(A)`` sketches a ``repro_torch.core.linop`` operator.
CountSketch (Clarkson–Woodruff, the paper's choice), the Gaussian sketch
and the uniform-dense sketch are ported; SRHT and the two sparse kinds
arrive with the next slice (ROADMAP A5) and ``sample`` raises for them.

Backends (see ``repro_torch.core.backend``): ``"auto"`` routes the apply
through the kind's kernel wrapper — ``countsketch_apply`` (B1),
``fused_gaussian_sketch`` (B4) or ``sketch_matmul`` (B6) — which launches
the hand kernel for a CUDA tensor and runs the plain version for a CPU
tensor; ``"reference"`` runs plain tensor code.  Both realize the same S:
the Gaussian S is drawn from the kernels' counter-based threefry +
Box–Muller stream, so kernel B4 regenerates it from the key alone.

Row streaming: ``apply_rows(tile, row_offset)`` is the restriction of S to a
contiguous row tile of A, and ``restrict_cols(idx)`` the sub-operator
S[:, idx] — the primitives the streaming and session slices build on.
"""
from __future__ import annotations

import dataclasses

import torch

from ..kernels.common import key_to_u32
from ..kernels.countsketch import countsketch_apply, countsketch_csr, countsketch_ref
from ..kernels.sketch_matmul import (
    default_scale,
    fused_gaussian_sketch,
    gaussian_cols_ref,
    sketch_matmul,
)
from . import backend as backend_lib
from . import linop

__all__ = ["sample", "CountSketch", "GaussianSketch", "UniformDenseSketch", "SKETCH_KINDS"]


def _as_2d(A):
    """Canonicalize (m,) -> (m, 1); returns (A2d, was_vector)."""
    return (A[:, None], True) if A.ndim == 1 else (A, False)


def _maybe_squeeze(B, was_vector):
    return B[:, 0] if was_vector else B


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


@dataclasses.dataclass(frozen=True)
class GaussianSketch(_OperatorApply):
    """S with iid N(0, 1/d) entries.

    S is drawn from the counter-based threefry2x32 + Box–Muller stream of
    ``repro_torch.kernels.sketch_matmul`` (element (i, j) ← counter pair
    (i, j) under the key words ``key = (k0, k1)``), scaled by 1/√d in f32
    and then cast, so kernel B4 regenerates the SAME matrix inside the
    kernel from the key alone.  The kernel route never reads ``S``.

    ``sample(..., materialize=False)`` stores no S (``S=None``): every
    column block is regenerated on demand from the key, bitwise equal to
    slicing the stored matrix.  ``SketchedFactor.build`` draws that way on
    a CUDA device (``precond._operator_for``): at d = 4000, m = 2^16 the
    stored S would be 2.1 GB that kernel B4 never reads, and the result
    depends only on the key.
    """

    S: torch.Tensor | None
    key: tuple  # (k0, k1): the threefry key words, ints in [0, 2^32)
    d: int
    m: int
    dev: torch.device = dataclasses.field(compare=False, repr=False, default=None)

    @classmethod
    def sample(cls, key, d, m, dtype=torch.float64, materialize=True, *, device=None):
        dev = backend_lib.resolve_device(device)
        if isinstance(key, torch.Generator):
            key = backend_lib.as_generator(key, dev)
        words = key_to_u32(key)
        cols = torch.arange(m, dtype=torch.int64, device=dev)
        S = cls._gen_cols(words, d, cols, dtype) if materialize else None
        return cls(S=S, key=words, d=int(d), m=int(m), dev=dev)

    @staticmethod
    def _gen_cols(key, d, cols, dtype):
        """Columns S[:, cols] from the kernel's counter stream (exact): the
        f32 Gaussians times the f32 scale, then cast to ``dtype``."""
        G = gaussian_cols_ref(key[0], key[1], d, cols, torch.float32)
        return G.mul_(default_scale(d)).to(dtype)

    @property
    def device(self) -> torch.device:
        return self.S.device if self.S is not None else self.dev

    def _cols(self, cols, dtype):
        if self.S is not None:
            return self.S[:, cols]
        return self._gen_cols(self.key, self.d, cols, dtype)

    def apply(self, A, *, backend: str = "auto"):
        A = backend_lib.as_tensor(A, self.device)
        if backend_lib.uses_kernels(backend):
            return fused_gaussian_sketch(A, self.key, self.d)
        A2, vec = _as_2d(A)
        return _maybe_squeeze(self.as_dense().to(A2.dtype) @ A2, vec)

    def apply_rows(self, tile, row_offset: int, *, backend: str = "auto"):
        del backend  # one (d, t) × (t, n) block product either way
        tile2, _ = _as_2d(backend_lib.as_tensor(tile, self.device))
        t = tile2.shape[0]
        cols = torch.arange(row_offset, row_offset + t, device=self.device)
        return self._cols(cols, tile2.dtype).to(tile2.dtype) @ tile2

    def restrict_cols(self, idx):
        """S[:, idx] as a stored ``UniformDenseSketch``: in the stored S's
        dtype, or f64 when S is regenerated (as the reference)."""
        cols = torch.arange(self.m, device=self.device)[idx]
        S = self._cols(cols, torch.float64)
        return UniformDenseSketch(S=S, d=self.d, m=S.shape[1])

    def as_dense(self):
        if self.S is not None:
            return self.S
        cols = torch.arange(self.m, device=self.device)
        return self._gen_cols(self.key, self.d, cols, torch.float64)


@dataclasses.dataclass(frozen=True)
class UniformDenseSketch(_OperatorApply):
    """S with iid U(-√(3/d), √(3/d)) entries (unit row variance / d).

    The kernel route (B6, ``sketch_matmul``) rounds S to A's dtype before
    the product, so a bf16 A under ``precision="mixed"`` meets a bf16 S.
    That is what the reference's fused route does (``tsqr/fused.py:265``);
    its unfused route keeps S in f64 (``core/sketch.py:346``).  The port
    takes the fused route's rounding on both routes.
    """

    S: torch.Tensor
    d: int
    m: int

    @classmethod
    def sample(cls, key, d, m, dtype=torch.float64, *, device=None):
        dev = backend_lib.resolve_device(device)
        gen = backend_lib.as_generator(key, dev)
        lim = (3.0 / d) ** 0.5
        S = torch.empty((d, m), dtype=dtype, device=dev).uniform_(-lim, lim, generator=gen)
        return cls(S=S, d=int(d), m=int(m))

    @property
    def device(self) -> torch.device:
        return self.S.device

    def apply(self, A, *, backend: str = "auto"):
        A = backend_lib.as_tensor(A, self.device)
        if backend_lib.uses_kernels(backend):
            return sketch_matmul(self.S, A)
        A2, vec = _as_2d(A)
        return _maybe_squeeze(self.S.to(A2.dtype) @ A2, vec)

    def apply_rows(self, tile, row_offset: int, *, backend: str = "auto"):
        del backend
        tile2, _ = _as_2d(backend_lib.as_tensor(tile, self.device))
        St = self.S[:, row_offset : row_offset + tile2.shape[0]]
        return St.to(tile2.dtype) @ tile2

    def restrict_cols(self, idx):
        S = self.S[:, idx]
        return UniformDenseSketch(S=S, d=self.d, m=S.shape[1])

    def as_dense(self):
        return self.S


SKETCH_KINDS: dict[str, type] = {
    "gaussian": GaussianSketch,
    "uniform_dense": UniformDenseSketch,
    "countsketch": CountSketch,
    "clarkson_woodruff": CountSketch,  # alias — the paper's final choice
}

_LATER_KINDS = ("srht", "sparse_sign", "uniform_sparse")


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
