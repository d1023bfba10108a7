"""``sketch_qr`` — the fused sketch→QR pipeline entry point.

Port of ``repro/kernels/tsqr/fused.py`` for the CountSketch, Gaussian and
uniform-dense families.  One call produces the sketched factor (Q, R) and
the sketch B = SA:

- ``backend="auto"``, dense A with at most :data:`MAX_FUSED_COLS` columns
  → the family's fused wrapper returns (B, G = BᵀB): kernel B3
  (:func:`countsketch_gram`), B5 (:func:`gaussian_gram`) or B7
  (:func:`matmul_gram`), and the shifted-CholeskyQR3 finisher turns G
  into R;
- otherwise (``backend="reference"``, or a wider A) → the unfused sketch
  apply, a library Gram ``BᵀB``, and the same finisher.

Both honour ``precision="mixed"`` (the apply and the Gram run on a
bf16-rounded copy of A with f32 accumulation; Q, R and B come back in A's
dtype).  On the fused route the uniform-dense S is rounded to A's dtype
(bf16 under ``mixed``), as the reference's ``fused.py:265`` does; the
port's unfused kernel route rounds it the same way (see
``repro_torch.core.sketch.UniformDenseSketch``).  SRHT raises until its
slice (ROADMAP A5, kernel B8).

The three fused kernels share one design.  The TPU kernels keep each B
panel in VMEM and fold it into G on the panel's last grid step, carrying
G across a sequential grid.  On Hopper blocks run in parallel, so a single
launch cannot fold every panel into one G without atomics or a G per
block.  Each C entry therefore runs two hand kernels back to back on one
stream: the sketch kernel (B1, B4 or B6) writes B once, then the panel
Gram (B2) reads it once.  B is bitwise that sketch kernel's output and G is
exactly symmetric.  The extra read of B is d·n elements against A's m·n.
"""
from __future__ import annotations

import torch

from .. import _build
from ..countsketch.ops import _prepare
from ..countsketch.ref import acc_dtype
from ..sketch_matmul.ops import _check_key, _check_S
from ..sketch_matmul.ops import _prepare as _prepare_dense
from ..sketch_matmul.ref import default_scale
from .ops import MAX_FUSED_COLS, cholqr_finish
from .ref import countsketch_gram_ref, gaussian_gram_ref, matmul_gram_ref

__all__ = ["sketch_qr", "countsketch_gram", "matmul_gram", "gaussian_gram"]


def countsketch_gram(A, buckets, signs, d, *, csr=None):
    """Fused CountSketch apply + Gram: (B = SA, G = BᵀB), through kernel B3
    on CUDA.  A is (m, n); B and G are in the accumulation dtype."""
    prepared = _prepare("countsketch_gram", A, buckets, signs, d, csr, (2,))
    if prepared is None:
        return countsketch_gram_ref(A, buckets, signs, d)
    code, A, csr = prepared
    n = A.shape[1]
    acc = acc_dtype(A.dtype)
    B = torch.empty((d, n), dtype=acc, device=A.device)
    G = torch.empty((n, n), dtype=acc, device=A.device)
    lib = _build.load()
    with torch.cuda.device(A.device):
        err = lib.repro_countsketch_gram(
            code, A.data_ptr(), csr.rows.data_ptr(), csr.signs.data_ptr(),
            csr.offsets.data_ptr(), B.data_ptr(), G.data_ptr(), d, n,
            _build.stream_ptr(A.device),
        )
    _build.check(err, "countsketch_gram")
    countsketch_gram.launches += 1
    return B, G


countsketch_gram.launches = 0


def _outputs(A, d):
    acc = acc_dtype(A.dtype)
    n = A.shape[1]
    return (
        torch.empty((d, n), dtype=acc, device=A.device),
        torch.empty((n, n), dtype=acc, device=A.device),
    )


def matmul_gram(S, A):
    """Fused dense-sketch apply + Gram: (B = SA, G = BᵀB), through kernel
    B7 (``csrc/matmul_gram.cu``: B6 then B2) on CUDA.  A is (m, n); S is
    rounded to A's dtype; B and G are in the accumulation dtype."""
    prepared = _prepare_dense("matmul_gram", A, (2,))
    _check_S(S, A)
    if prepared is None:
        return matmul_gram_ref(S, A)
    code, A = prepared
    S = S.to(A.dtype).contiguous()
    d, (m, n) = S.shape[0], A.shape
    B, G = _outputs(A, d)
    lib = _build.load()
    with torch.cuda.device(A.device):
        err = lib.repro_matmul_gram(
            code, S.data_ptr(), A.data_ptr(), B.data_ptr(), G.data_ptr(), d, m, n,
            _build.stream_ptr(A.device),
        )
    _build.check(err, "matmul_gram")
    matmul_gram.launches += 1
    return B, G


matmul_gram.launches = 0


def gaussian_gram(A, key, d, *, scale=None):
    """Fused in-kernel Gaussian apply + Gram: (B = scale·G·A, G = BᵀB),
    through kernel B5 (``csrc/gaussian_gram.cu``: B4 then B2) on CUDA —
    S never exists in device memory.  ``key = (k0, k1)``; ``scale=None``
    means 1/√d."""
    prepared = _prepare_dense("gaussian_gram", A, (2,))
    k0, k1 = _check_key(key, d)
    if prepared is None:
        return gaussian_gram_ref(A, (k0, k1), d, scale)
    code, A = prepared
    m, n = A.shape
    B, G = _outputs(A, d)
    lib = _build.load()
    with torch.cuda.device(A.device):
        err = lib.repro_gaussian_gram(
            code, k0, k1, default_scale(d, scale), A.data_ptr(), B.data_ptr(),
            G.data_ptr(), d, m, n, _build.stream_ptr(A.device),
        )
    _build.check(err, "gaussian_gram")
    gaussian_gram.launches += 1
    return B, G


gaussian_gram.launches = 0


def _lowp(A_arr: torch.Tensor, use_kernels: bool) -> torch.Tensor:
    """The mixed-precision data cast: round to bf16; on the reference
    backend upcast to f32 so accumulation runs ≥ f32 there too."""
    A_lp = A_arr.to(torch.bfloat16)
    return A_lp if use_kernels else A_lp.to(torch.float32)


def sketch_qr(
    op,
    A,
    *,
    backend: str = "auto",
    precision: str = "full",
    rounds: int = 2,
    device=None,
):
    """Fused sketch→QR: ``(Q, R, B)`` with B = S·A = Q·R, diag(R) ≥ 0.

    ``op`` is a ``repro_torch.core.sketch`` CountSketch, GaussianSketch or
    UniformDenseSketch; ``A`` a dense matrix or ``repro_torch.core.linop``
    operator.
    """
    from ...core import backend as backend_lib
    from ...core import linop
    from ...core import sketch as sketch_lib
    from ...core.precond import _sketch_apply

    backend_lib.check_precision(precision)
    use_kernels = backend_lib.uses_kernels(backend)
    families = (
        sketch_lib.CountSketch, sketch_lib.GaussianSketch, sketch_lib.UniformDenseSketch,
    )
    if not isinstance(op, families):
        raise NotImplementedError(
            f"sketch_qr for {type(op).__name__} arrives with its sketch "
            "family (ROADMAP A5: SRHT and the sparse kinds are the next slice)"
        )
    A_op = linop.as_operator(A, device=device)
    working = A_op.dtype
    fusable = (
        use_kernels
        and isinstance(A_op, linop.DenseOperator)
        and A_op.shape[1] <= MAX_FUSED_COLS
    )
    if fusable:
        A_arr = _lowp(A_op.A, True) if precision == "mixed" else A_op.A
        if isinstance(op, sketch_lib.CountSketch):
            B, G = countsketch_gram(
                A_arr, op.buckets, op.signs, op.d, csr=op.csr(A_arr.dtype)
            )
        elif isinstance(op, sketch_lib.GaussianSketch):
            B, G = gaussian_gram(A_arr, op.key, op.d)
        else:
            B, G = matmul_gram(op.S, A_arr)
        B = B.to(working)
        G = G.to(working)
    else:
        B = _sketch_apply(op, A_op, backend=backend, precision=precision)
        B = B.to(working)
        G = B.T @ B
    Q, R = cholqr_finish(B, G, rounds=rounds)
    return Q, R, B
