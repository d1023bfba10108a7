"""``sketch_qr`` — the fused sketch→QR pipeline entry point.

Port of ``repro/kernels/tsqr/fused.py`` for every sketch kind.  One call
produces the sketched factor (Q, R) and the sketch B = SA:

- ``backend="auto"``, dense A with at most :data:`MAX_FUSED_COLS` columns,
  and a CountSketch, Gaussian, uniform-dense or SRHT operator → the
  family's fused wrapper returns (B, G = BᵀB): kernel B3
  (:func:`countsketch_gram`), B5 (:func:`gaussian_gram`) or B7
  (:func:`matmul_gram`); for the SRHT, as in the reference, B8
  (``srht_apply``) then B2 (``panel_gram``).  The shifted-CholeskyQR3
  finisher turns G into R;
- otherwise (``backend="reference"``, a wider A, or the sparse-sign,
  uniform-sparse and stacked operators, which the reference does not fuse
  either) → the unfused sketch apply, a library Gram ``BᵀB``, and the same
  finisher.

Both honour ``precision="mixed"`` (the apply and the Gram run on a
bf16-rounded copy of A with f32 accumulation; Q, R and B come back in A's
dtype).  On the fused route the uniform-dense S is rounded to A's dtype
(bf16 under ``mixed``), as the reference's ``fused.py:265`` does; the
port's unfused kernel route rounds it the same way (see
``repro_torch.core.sketch.UniformDenseSketch``).  Under ``mixed`` the SRHT
half gives an f32 B where the reference's kernel gives bf16 (ROADMAP C).

The three fused kernels share one design.  The TPU kernels keep each B
panel in VMEM and fold it into G on the panel's last grid step, carrying
G across a sequential grid.  On Hopper blocks run in parallel, so a single
launch cannot fold every panel into one G without atomics or a G per
block.  Each C entry therefore runs two hand kernels back to back on one
stream: the sketch kernel (B1, B4 or B6) writes B once, then the panel
Gram (B2) reads it once.  B is bitwise that sketch kernel's output and G is
exactly symmetric.  The extra read of B is d·n elements against A's m·n.
In f64, B6, B4 and B2 run on the FP64 tensor cores with the split plans
of ``kernels/common.py`` (B4 generating S in the engine's ring, once per
thread-block cluster); when a plan splits a sum, the C entry also launches
the kernel that adds the partials, so each fused wrapper stays one C call.
"""
from __future__ import annotations

import torch

from .. import _build
from ..common import gaussian_split, gram_split, scratch_for, sketch_split, sm_count
from ..countsketch.ops import _prepare
from ..countsketch.ref import acc_dtype
from ..sketch_matmul.ops import _check_key, _check_S
from ..sketch_matmul.ops import _prepare as _prepare_dense
from ..sketch_matmul.ref import default_scale
from ..srht.ops import srht_apply
from .ops import MAX_FUSED_COLS, cholqr_finish, panel_gram
from .ref import countsketch_gram_ref, gaussian_gram_ref, matmul_gram_ref

__all__ = ["sketch_qr", "countsketch_gram", "matmul_gram", "gaussian_gram"]


def countsketch_gram(A, buckets, signs, d, *, csr=None):
    """Fused CountSketch apply + Gram: (B = SA, G = BᵀB), through kernel B3
    on CUDA.  A is (m, n); B and G are in the accumulation dtype."""
    prepared = _prepare("countsketch_gram", A, buckets, signs, d, csr, (2,))
    if prepared is None:
        return countsketch_gram_ref(A, buckets, signs, d)
    code, A, csr = prepared
    B, G = _outputs(A, d)
    n = A.shape[1]
    split = gram_split(B.dtype, d, n, sm_count(A.device))
    scratch = scratch_for([split], A.device)
    lib = _build.load()
    with torch.cuda.device(A.device):
        err = lib.repro_countsketch_gram(
            code, A.data_ptr(), csr.rows.data_ptr(), csr.signs.data_ptr(),
            csr.offsets.data_ptr(), B.data_ptr(), G.data_ptr(), _build.ptr(scratch), d, n,
            split.slab, split.parts, _build.stream_ptr(A.device),
        )
    _build.check(err, "countsketch_gram")
    _build.count_launch(countsketch_gram)
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
    sms = sm_count(A.device)
    split_b, split_g = sketch_split(A.dtype, d, m, n, sms), gram_split(B.dtype, d, n, sms)
    scratch = scratch_for([split_b, split_g], A.device)
    lib = _build.load()
    with torch.cuda.device(A.device):
        err = lib.repro_matmul_gram(
            code, S.data_ptr(), A.data_ptr(), B.data_ptr(), G.data_ptr(), _build.ptr(scratch),
            d, m, n, split_b.slab, split_b.parts, split_g.slab, split_g.parts,
            _build.stream_ptr(A.device),
        )
    _build.check(err, "matmul_gram")
    _build.count_launch(matmul_gram)
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
    sms = sm_count(A.device)
    split_b, split_g = gaussian_split(A.dtype, d, m, n, sms), gram_split(B.dtype, d, n, sms)
    scratch = scratch_for([split_b, split_g], A.device)
    lib = _build.load()
    with torch.cuda.device(A.device):
        err = lib.repro_gaussian_gram(
            code, k0, k1, default_scale(d, scale), A.data_ptr(), B.data_ptr(),
            G.data_ptr(), _build.ptr(scratch), d, m, n, split_b.slab, split_b.parts,
            split_g.slab, split_g.parts, _build.stream_ptr(A.device),
        )
    _build.check(err, "gaussian_gram")
    _build.count_launch(gaussian_gram)
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

    ``op`` is any ``repro_torch.core.sketch`` operator; ``A`` a dense
    matrix or ``repro_torch.core.linop`` operator.
    """
    from ...core import backend as backend_lib
    from ...core import linop
    from ...core import sketch as sketch_lib
    from ...core.precond import _sketch_apply

    backend_lib.check_precision(precision)
    use_kernels = backend_lib.uses_kernels(backend)
    A_op = linop.as_operator(A, device=device)
    working = A_op.dtype
    fusable = (
        use_kernels
        and isinstance(A_op, linop.DenseOperator)
        and A_op.shape[1] <= MAX_FUSED_COLS
        and isinstance(
            op,
            (
                sketch_lib.CountSketch,
                sketch_lib.GaussianSketch,
                sketch_lib.UniformDenseSketch,
                sketch_lib.SRHTSketch,
            ),
        )
    )
    if fusable:
        A_arr = _lowp(A_op.A, True) if precision == "mixed" else A_op.A
        if isinstance(op, sketch_lib.CountSketch):
            B, G = countsketch_gram(
                A_arr, op.buckets, op.signs, op.d, csr=op.csr(A_arr.dtype)
            )
        elif isinstance(op, sketch_lib.GaussianSketch):
            B, G = gaussian_gram(A_arr, op.key, op.d)
        elif isinstance(op, sketch_lib.UniformDenseSketch):
            B, G = matmul_gram(op.S, A_arr)
        else:  # SRHT: the transform through B8, then B2's Gram
            B = srht_apply(A_arr, op.signs, op.rows, op.d, plan=op.plan())
            G = panel_gram(B)
        B = B.to(working)
        G = G.to(working)
    else:
        B = _sketch_apply(op, A_op, backend=backend, precision=precision)
        B = B.to(working)
        G = B.T @ B
    Q, R = cholqr_finish(B, G, rounds=rounds)
    return Q, R, B
