"""The sketched QR factor — the one reusable object behind every solver.

Port of ``repro/core/precond.py``.  Draw a subspace embedding S (s×m,
s ≪ m), sketch B = SA, and take the reduced QR factor B = QR.  R is then
both a right preconditioner (A R⁻¹ is a near-isometry w.h.p.) and the
coordinate change back to x-space (x = R⁻¹ z).

``SketchedFactor.build`` accepts, as ``sketch=``, either a kind name (the
operator is drawn from the generator) or an already-drawn operator.  The
second form is the carry-across hook: a test draws S with the reference
package, converts it with ``repro_torch.convert`` (one converter per
kind) and runs both packages on the same S.

``extend`` grows the sketch by appended rows for the certified tier's
escalation.  A ``TikhonovAugmented`` A ([A; √λI], ``reg=``) is sketched
through ``AugmentedSketch`` (blockdiag(S, I): S over the data rows, the
identity rows exact); ``sketch=`` then names the kind of S or gives S
itself (over the data rows) or the whole ``AugmentedSketch``.  Sparse and
matrix-free A are sketched through ``apply_op`` in operator form, and
``whiten_mv``/``whiten_rmv`` take a block through ``matmat``/``rmatmat``.
``build_streaming`` arrives with ROADMAP A9.

Spans (``repro_torch.obs.trace``): ``factor.build`` (``sketch``, ``rows``,
``fused``) around each build, with ``sketch.apply`` and ``factor.qr``
inside on the unfused route; ``factor.extend`` with its ``factor.qr``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..obs import trace as obs_trace
from . import backend as backend_lib
from . import linop
from . import sketch as sketch_lib

__all__ = ["SketchedFactor", "default_sketch_size", "distortion"]


def _lowp_operator(A, use_kernels: bool):
    """bf16-rounded copy of a dense (or Tikhonov-augmented dense) operator
    for the mixed sketch.

    Through the kernel wrappers the bf16 tensor is fed as it is (they
    accumulate in f32 and return f32 for half inputs); on the reference
    backend the data is rounded to bf16 then upcast to f32.  λ is rounded
    with the data, as the reference rounds it.  Sparse and matrix-free
    operators raise.
    """

    def cast(arr):
        low = arr.to(torch.bfloat16)
        return low if use_kernels else low.to(torch.float32)

    if isinstance(A, linop.DenseOperator):
        return linop.DenseOperator(A=cast(A.A))
    if isinstance(A, linop.TikhonovAugmented) and isinstance(A.op, linop.DenseOperator):
        return linop.TikhonovAugmented.wrap(cast(A.op.A), A.reg, device=A.device)
    raise ValueError(
        "precision='mixed' needs a dense data matrix (or Tikhonov-augmented "
        f"dense); got {type(A).__name__}"
    )


def _sketch_apply(op, A, *, backend: str, precision: str):
    """B = S·A honouring ``precision`` — the unfused sketch-apply stage.

    Mixed precision rounds the data to bf16 before the apply and returns B
    in A's working dtype.
    """
    A = linop.as_operator(A, device=op.device)
    if precision == "mixed":
        low = _lowp_operator(A, backend_lib.uses_kernels(backend))
        return op.apply_op(low, backend=backend).to(A.dtype)
    return op.apply_op(A, backend=backend)


def default_sketch_size(n: int, m: int) -> int:
    """Paper regime: m ≫ s > n; s = 4n clamped to s ≤ m."""
    s = int(min(max(4 * n, n + 16), max(m // 2, n + 1)))
    return max(min(s, m), 1)


def distortion(sketch_size: int, n: int) -> float:
    """A-priori embedding distortion estimate ε ≈ √(n/s), clipped below 1."""
    return min((n / float(sketch_size)) ** 0.5, 0.99)


def _solve_upper(R, Z):
    """R⁻¹ Z for a vector or a block Z."""
    if Z.ndim == 1:
        return torch.linalg.solve_triangular(R, Z[:, None], upper=True)[:, 0]
    return torch.linalg.solve_triangular(R, Z, upper=True)


def _kind_name(sketch) -> str:
    """A span's name for ``sketch=``: the kind, or the operator's class."""
    return sketch if isinstance(sketch, str) else type(sketch).__name__


def _operator_for(op, A, sketch_size, key):
    """The sketch operator: drawn from ``key`` for a kind name, or the
    already-drawn operator passed as ``sketch=`` (checked against A).

    A Gaussian sketch on a CUDA device is drawn with ``materialize=False``:
    kernel B4 regenerates S inside the kernel from the key alone, so a
    stored S (2.1 GB in f64 at d = 4000, m = 2^16) would never be read.
    The result is the same S either way."""
    m, n = A.shape
    device = A.device
    if isinstance(op, str):
        s = sketch_size if sketch_size is not None else default_sketch_size(n, m)
        kw = {}
        if op == "gaussian" and device.type == "cuda":
            kw["materialize"] = False  # kernel B4 regenerates S from the key
        return sketch_lib.sample(op, key, s, m, dtype=A.dtype, device=device, **kw)
    if sketch_size is not None and sketch_size != op.d:
        raise ValueError(f"sketch_size={sketch_size} but the operator has d = {op.d}")
    if op.m != m:
        raise ValueError(f"sketch operator has m = {op.m}, A has {m} rows")
    if op.device != device:
        raise ValueError(f"sketch operator is on {op.device}, A on {device}")
    return op


class SketchedFactor(NamedTuple):
    """QR factor of a sketch SA: preconditioner, whitener and warm-starter.

    ``Q`` is (s, n) with orthonormal columns, ``R`` is (n, n) upper
    triangular with B = SA = QR.
    """

    Q: torch.Tensor
    R: torch.Tensor

    @classmethod
    def from_sketch(cls, B: torch.Tensor) -> "SketchedFactor":
        """Factor an already-assembled sketch B = SA (Householder QR)."""
        Q, R = torch.linalg.qr(B, mode="reduced")
        return cls(Q=Q, R=R)

    @classmethod
    def build(
        cls,
        A,
        key,
        *,
        sketch="clarkson_woodruff",
        sketch_size: int | None = None,
        backend: str = "auto",
        precision: str = "full",
        fused: bool | None = None,
        device=None,
    ):
        """Draw S (or take the operator given as ``sketch``), sketch A and
        factor: returns ``(factor, op)``.

        ``precision="mixed"`` sketches a bf16-rounded copy of dense A;
        ``fused`` routes the build through ``sketch_qr`` (kernel B3, B5, B7,
        or B8 then B2, on the card; ``None`` → ``REPRO_FUSED_QR``).
        """
        factor, op, _ = cls.build_full(
            A, key, sketch=sketch, sketch_size=sketch_size, backend=backend,
            precision=precision, fused=fused, device=device,
        )
        return factor, op

    @classmethod
    def build_full(
        cls,
        A,
        key,
        *,
        sketch="clarkson_woodruff",
        sketch_size: int | None = None,
        backend: str = "auto",
        precision: str = "full",
        fused: bool | None = None,
        device=None,
    ):
        """:meth:`build` that also returns the assembled sketch B."""
        backend_lib.check_precision(precision)
        backend_lib.check_backend(backend)
        A = linop.as_operator(A, device=device)
        if isinstance(A, linop.TikhonovAugmented):
            # blockdiag(S, I): sketch the data rows, keep the (maximally
            # coherent) regularization rows exact — see AugmentedSketch
            if isinstance(sketch, sketch_lib.AugmentedSketch):
                op = _operator_for(sketch, A, None, key)
            else:
                inner = _operator_for(sketch, A.op, sketch_size, key)
                op = sketch_lib.AugmentedSketch(inner=inner, tail=A.shape[1])
            rows = op.inner.d
        else:
            op = _operator_for(sketch, A, sketch_size, key)
            rows = op.d
        kind = _kind_name(sketch)
        if backend_lib.resolve_fused(fused):
            from ..kernels.tsqr import sketch_qr  # kernels import core

            with obs_trace.span("factor.build", sketch=kind, rows=rows, fused=True):
                Q, R, B = sketch_qr(op, A, backend=backend, precision=precision)
                obs_trace.maybe_block(R)
            return cls(Q=Q, R=R), op, B
        with obs_trace.span("factor.build", sketch=kind, rows=rows, fused=False):
            with obs_trace.span("sketch.apply", kind=kind, precision=precision):
                B = _sketch_apply(op, A, backend=backend, precision=precision)
                obs_trace.maybe_block(B)
            with obs_trace.span("factor.qr", shape=tuple(B.shape)):
                factor = cls.from_sketch(B)
                obs_trace.maybe_block(factor.R)
        return factor, op, B

    def extend(self, A, op, key, extra: int, *, B=None, backend: str = "auto"):
        """Grow the sketch by ``extra`` appended rows and re-QR: returns
        ``(factor, op_new, B_new)``.

        ``op.extend_rows(key, extra)`` stacks a fresh block drawn from
        ``key`` under the first d rows, and only that block is applied to
        A (on the card, through the kind's kernel).  ``B`` is the stored
        sketch this factor was built from (``build_full``); ``B_new``'s top
        block is then ``B`` times its weight, bitwise.  Without ``B`` it is
        rebuilt as Q·R, exact to rounding.
        """
        A = linop.as_operator(A, device=self.R.device)
        with obs_trace.span("factor.extend", extra=extra):
            op_new = op.extend_rows(key, extra)
            if B is None:
                B = self.Q @ self.R
            B_new = op_new.extend_sketch(B, A, backend=backend)
            with obs_trace.span("factor.qr", shape=tuple(B_new.shape)):
                factor = SketchedFactor.from_sketch(B_new)
                obs_trace.maybe_block(factor.R)
        return factor, op_new, B_new

    @property
    def n(self) -> int:
        return self.R.shape[-1]

    @property
    def sketch_size(self) -> int:
        return self.Q.shape[-2]

    def precondition(self, z: torch.Tensor) -> torch.Tensor:
        """x = R⁻¹ z — z-space (whitened) back to x-space."""
        return _solve_upper(self.R, z)

    def rt_solve(self, v: torch.Tensor) -> torch.Tensor:
        """R⁻ᵀ v (forward substitution on the lower-triangular Rᵀ)."""
        Rt = self.R.mT
        if v.ndim == 1:
            return torch.linalg.solve_triangular(Rt, v[:, None], upper=False)[:, 0]
        return torch.linalg.solve_triangular(Rt, v, upper=False)

    def whiten_mv(self, A, z: torch.Tensor) -> torch.Tensor:
        """Y z = A (R⁻¹ z) — operator-form matvec of the whitened system
        (a block z through ``matmat``)."""
        return linop.as_operator(A, device=z.device) @ self.precondition(z)

    def whiten_rmv(self, A, u: torch.Tensor) -> torch.Tensor:
        """Yᵀ u = R⁻ᵀ (Aᵀ u) — operator-form rmatvec of the whitened system
        (a block u through ``rmatmat``)."""
        A = linop.as_operator(A, device=u.device)
        return self.rt_solve(A.rmatvec(u) if u.ndim == 1 else A.rmatmat(u))

    def materialize_whitened(self, A) -> torch.Tensor:
        """Y = A R⁻¹ explicitly (one triangular solve from the right)."""
        A = linop.ensure_dense(A, device=self.R.device)
        return torch.linalg.solve_triangular(self.R, A, upper=True, left=False)

    def warm_start(self, c: torch.Tensor) -> torch.Tensor:
        """z₀ = Qᵀ c with c = Sb — the sketch-and-solve solution in z-space."""
        return self.Q.T @ c

    def sketch_and_solve(self, c: torch.Tensor) -> torch.Tensor:
        """x̂ = R⁻¹ Qᵀ c — the plain sketch-and-solve estimate in x-space."""
        return self.precondition(self.warm_start(c))

    def normal_solve(self, g: torch.Tensor) -> torch.Tensor:
        """(RᵀR)⁻¹ g — the sketched-normal-equations solve."""
        return self.precondition(self.rt_solve(g))
