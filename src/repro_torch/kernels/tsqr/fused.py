"""``sketch_qr`` — the fused sketch→QR pipeline entry point.

Port of ``repro/kernels/tsqr/fused.py`` for the CountSketch family.  One
call produces the sketched factor (Q, R) and the sketch B = SA:

- ``backend="auto"``, dense A with at most :data:`MAX_FUSED_COLS` columns
  → :func:`countsketch_gram` returns (B, G = BᵀB) from kernel B3, and the
  shifted-CholeskyQR3 finisher turns G into R;
- otherwise (``backend="reference"``, or a wider A) → the unfused sketch
  apply, a library Gram ``BᵀB``, and the same finisher.

Both honour ``precision="mixed"`` (the apply and the Gram run on a
bf16-rounded copy of A with f32 accumulation; Q, R and B come back in A's
dtype).  The other sketch families raise until their slice (ROADMAP A5).

:func:`countsketch_gram` wraps kernel B3 (``csrc/countsketch_gram.cu``),
which replaces ``repro/kernels/tsqr/kernel.py:68``
(``countsketch_gram_kernel``, launched through ``tsqr/fused.py:56``).  Its
design: kernel B1 writes B once, then kernel B2 reads it once — two hand
kernels in one C call, no atomics, B bitwise the plain CountSketch.  The
extra read of B is d·n elements against A's m·n.
"""
from __future__ import annotations

import torch

from .. import _build
from ..countsketch.ops import _prepare
from ..countsketch.ref import acc_dtype
from .ops import MAX_FUSED_COLS, cholqr_finish
from .ref import countsketch_gram_ref

__all__ = ["sketch_qr", "countsketch_gram"]


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

    ``op`` is a ``repro_torch.core.sketch.CountSketch``; ``A`` a dense
    matrix or ``repro_torch.core.linop`` operator.
    """
    from ...core import backend as backend_lib
    from ...core import linop
    from ...core import sketch as sketch_lib
    from ...core.precond import _sketch_apply

    backend_lib.check_precision(precision)
    use_kernels = backend_lib.uses_kernels(backend)
    if not isinstance(op, sketch_lib.CountSketch):
        raise NotImplementedError(
            f"sketch_qr for {type(op).__name__} arrives with its sketch "
            "family (ROADMAP A5)"
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
        B, G = countsketch_gram(
            A_arr, op.buckets, op.signs, op.d, csr=op.csr(A_arr.dtype)
        )
        B = B.to(working)
        G = G.to(working)
    else:
        B = _sketch_apply(op, A_op, backend=backend, precision=precision)
        B = B.to(working)
        G = B.T @ B
    Q, R = cholqr_finish(B, G, rounds=rounds)
    return Q, R, B
