"""Wrapper of kernel B1, the CountSketch apply (``csrc/countsketch.cuh``).

Replaces ``repro/kernels/countsketch/kernel.py:27`` (``countsketch_kernel``,
launched at ``countsketch/ops.py:59``).  The TPU version is a blocked
one-hot matmul, because the TPU has no scatter and no atomics.  On Hopper
the apply is bound by reading A once, so the port sums each bucket's rows
directly: :func:`countsketch_csr` sorts the entries by bucket once (a
stable argsort plus offsets — index set-up, cached on the operator by
``repro_torch.core.sketch``), and the kernel gives one thread to each
(bucket, column) output.  It is deterministic and bitwise equal to the
plain version run on the CPU.

The same kernel applies the three bucket sketches: ``buckets`` and the
weights ``signs`` are (m,) — one entry per row, the CountSketch (±1) and
the uniform-sparse sketch (uniform weights) — or (k, m), the sparse-sign
sketch's k ±1 entries per row (its 1/√k is the caller's).  The reference
has no Pallas kernel for the two sparse kinds (``core/sketch.py:524``,
``:596``); the port reuses B1 for them rather than ``index_add_``, whose
atomics on CUDA sum in an order that changes from run to run.

Contract (as the reference's): A is (m, n) or (m,); the result is (d, n)
or (d,); f64 and f32 inputs keep their dtype, bf16 and f16 inputs give f32;
the weights are rounded to A's dtype.  A CUDA tensor launches the kernel or
raises; a CPU tensor runs the plain version of ``ref.py``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import _build
from .ref import acc_dtype, countsketch_ref

__all__ = ["countsketch_apply", "countsketch_csr", "CountSketchCSR"]


class CountSketchCSR(NamedTuple):
    """Entries grouped by bucket; within a bucket in (block, row) order."""

    rows: torch.Tensor  # (nnz,) int32 — each entry's row of A, sorted by bucket (stable)
    signs: torch.Tensor  # (nnz,) the entries' weights in that order, in A's dtype
    offsets: torch.Tensor  # (d + 1,) int64 — bucket k owns entries [off[k], off[k+1])


def countsketch_csr(
    buckets: torch.Tensor, signs: torch.Tensor, d: int, dtype: torch.dtype
) -> CountSketchCSR:
    """Bucket → entries CSR of a bucket sketch, on the buckets' device.

    ``buckets`` and ``signs`` are (m,) or (k, m); entry (j, i) is row i's
    j-th, and nnz = k·m.
    """
    m = buckets.shape[-1]
    if m >= 2**31:
        raise ValueError(f"the CSR stores int32 row ids; m = {m} is too large")
    flat = buckets.reshape(-1).to(torch.int64)
    order = torch.sort(flat, stable=True).indices
    counts = torch.bincount(flat, minlength=d)
    offsets = torch.zeros(d + 1, dtype=torch.int64, device=buckets.device)
    torch.cumsum(counts, 0, out=offsets[1:])
    return CountSketchCSR(
        rows=(order % m).to(torch.int32),
        signs=signs.reshape(-1)[order].to(dtype).contiguous(),
        offsets=offsets,
    )


def _check_csr(csr: CountSketchCSR, A: torch.Tensor, nnz: int, d: int) -> None:
    if csr.rows.shape != (nnz,) or csr.signs.shape != (nnz,):
        raise ValueError(f"CSR holds {csr.rows.shape[0]} entries, the sketch {nnz}")
    if csr.offsets.shape != (d + 1,):
        raise ValueError(f"CSR has {csr.offsets.shape[0] - 1} buckets, d = {d}")
    for name, t in csr._asdict().items():
        if t.device != A.device or not t.is_contiguous():
            raise ValueError(f"CSR {name} must be contiguous on {A.device}")
    if csr.rows.dtype != torch.int32 or csr.offsets.dtype != torch.int64:
        raise TypeError("CSR rows must be int32 and offsets int64")
    if csr.signs.dtype != A.dtype:
        raise TypeError(f"CSR signs are {csr.signs.dtype}, A is {A.dtype}")


def _prepare(name, A, buckets, signs, d, csr, ndims):
    """The input checks shared by the wrappers of kernels B1 and B3.

    Returns None for a CPU ``A`` (the wrapper runs its plain version).  For
    a CUDA ``A`` it returns the kernel's dtype code, A as a contiguous
    (m, n) matrix, and the checked CSR (built here when not given).
    """
    if not isinstance(A, torch.Tensor):
        raise TypeError(f"A must be a torch.Tensor, got {type(A).__name__}")
    if A.ndim not in ndims:
        raise ValueError(
            f"{name}: A must have {' or '.join(map(str, ndims))} dims, "
            f"got shape {tuple(A.shape)}"
        )
    if (
        buckets.ndim not in (1, 2)
        or buckets.shape[-1] != A.shape[0]
        or signs.shape != buckets.shape
    ):
        raise ValueError(
            f"buckets/signs must both be ({A.shape[0]},) or (k, {A.shape[0]}), "
            f"got {tuple(buckets.shape)} and {tuple(signs.shape)}"
        )
    if buckets.device != A.device or signs.device != A.device:
        raise ValueError(
            f"buckets ({buckets.device}) and signs ({signs.device}) must be "
            f"on A's device {A.device}"
        )
    if A.device.type == "cpu":
        return None
    if A.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or CPU, got {A.device}")
    code = _build.dtype_code(A.dtype)
    A2 = (A[:, None] if A.ndim == 1 else A).contiguous()
    if csr is None:
        csr = countsketch_csr(buckets, signs, d, A.dtype)
    _check_csr(csr, A2, buckets.numel(), d)
    return code, A2, csr


def countsketch_apply(
    A: torch.Tensor,
    buckets: torch.Tensor,
    signs: torch.Tensor,
    d: int,
    *,
    csr: CountSketchCSR | None = None,
) -> torch.Tensor:
    """SA for the bucket sketch (buckets, signs), through kernel B1 on CUDA.

    ``buckets``/``signs`` are (m,) or (k, m) (see the module docstring);
    ``csr`` is the operator's cached :func:`countsketch_csr` for A's dtype
    and device; it is built here when not given.
    """
    prepared = _prepare("countsketch_apply", A, buckets, signs, d, csr, (1, 2))
    if prepared is None:
        return countsketch_ref(A, buckets, signs, d)
    code, A2, csr = prepared
    n = A2.shape[1]
    out = torch.empty((d, n), dtype=acc_dtype(A.dtype), device=A.device)
    lib = _build.load()
    with torch.cuda.device(A.device):
        err = lib.repro_countsketch_apply(
            code, A2.data_ptr(), csr.rows.data_ptr(), csr.signs.data_ptr(),
            csr.offsets.data_ptr(), out.data_ptr(), d, n,
            _build.stream_ptr(A.device),
        )
    _build.check(err, "countsketch_apply")
    countsketch_apply.launches += 1
    return out[:, 0] if A.ndim == 1 else out


countsketch_apply.launches = 0
