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

``out=`` is the fold mode of the streaming accumulator
(``repro_torch.streaming.accumulate``): SA is added into the given (d, n)
state, each (bucket, column) sum starting from the state's value and going
on in row order (``countsketch_fold_ref`` on the CPU: the state's
``index_add_``).  A tile-by-tile fold is then bitwise the apply over all
rows, for any tiling.  On CUDA ``index_add_`` is atomic and never used.

:func:`countsketch_coo_apply` is the coordinate scatter of the bucket
sketches, their apply to a sparse A given by its entries (r, c, v)
(``csrc/countsketch.cuh``, ``coo_scatter_kernel``).  It replaces no TPU
kernel: the reference scatters with a jnp ``.at[].add``
(``repro/core/sketch.py:506–518``, ``:577–590``, ``:641–650``), whose
counterpart on CUDA, ``index_add_``, sums with atomics in an order that
changes from run to run.  Here each entry's k products go to the cells
(h_j(r), c); :func:`countsketch_coo_plan` sorts them by cell (a stable
sort of the int64 keys h·n + c in the reference's j-major, entry-order
ravel, plus d·n + 1 segment offsets: index set-up, a library call as the
CSR's build is), and the kernel gives one thread to each cell, which sums
its segment in that order, gathering v and w through the sort's
permutation.  Every cell is written once, empty ones as 0; the result is
bitwise the plain version run on the CPU.  f64 and f32 only: half inputs
never reach it (``precision="mixed"`` raises for a sparse A).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import _build
from .ref import acc_dtype, coo_keys, countsketch_coo_ref, countsketch_fold_ref, countsketch_ref

__all__ = [
    "countsketch_apply",
    "countsketch_csr",
    "CountSketchCSR",
    "countsketch_coo_apply",
    "countsketch_coo_plan",
    "CooPlan",
]


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
    # The stable sort of the bucket ids in their own (int32) dtype: the
    # order of an int64 sort, in half the key memory (a 2.6e8-entry gradient
    # of the compressed all-reduce sorts on four ranks of one card at once).
    flat = buckets.reshape(-1)
    order = torch.sort(flat, stable=True).indices
    counts = torch.bincount(flat, minlength=d)
    offsets = torch.zeros(d + 1, dtype=torch.int64, device=buckets.device)
    torch.cumsum(counts, 0, out=offsets[1:])
    return CountSketchCSR(
        rows=(order if buckets.ndim == 1 else order % m).to(torch.int32),
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


def _check_out(out, A, d: int) -> None:
    """The fold mode's state: (d, n) — (d,) for a vector A — contiguous, in
    A's accumulation dtype, on A's device."""
    shape = (d,) if A.ndim == 1 else (d, A.shape[1])
    if not isinstance(out, torch.Tensor) or tuple(out.shape) != shape:
        raise ValueError(f"out must be a {shape} tensor, got {getattr(out, 'shape', out)}")
    if out.dtype != acc_dtype(A.dtype) or out.device != A.device or not out.is_contiguous():
        raise ValueError(
            f"out must be contiguous {acc_dtype(A.dtype)} on {A.device}, got "
            f"{out.dtype} on {out.device}"
        )


def countsketch_apply(
    A: torch.Tensor,
    buckets: torch.Tensor,
    signs: torch.Tensor,
    d: int,
    *,
    csr: CountSketchCSR | None = None,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """SA for the bucket sketch (buckets, signs), through kernel B1 on CUDA.

    ``buckets``/``signs`` are (m,) or (k, m) (see the module docstring);
    ``csr`` is the operator's cached :func:`countsketch_csr` for A's dtype
    and device; it is built here when not given.  With ``out`` (the fold
    mode) SA is added into that state in place, and ``out`` is returned.
    """
    prepared = _prepare("countsketch_apply", A, buckets, signs, d, csr, (1, 2))
    if out is not None:
        _check_out(out, A, d)
    if prepared is None:
        if out is None:
            return countsketch_ref(A, buckets, signs, d)
        return countsketch_fold_ref(out.view(d, -1), A, buckets, signs).view(out.shape)
    code, A2, csr = prepared
    n = A2.shape[1]
    if out is None:
        dest, entry = torch.empty((d, n), dtype=acc_dtype(A.dtype), device=A.device), "repro_countsketch_apply"
    else:
        dest, entry = out, "repro_countsketch_fold"
    lib = _build.load()
    with torch.cuda.device(A.device):
        err = getattr(lib, entry)(
            code, A2.data_ptr(), csr.rows.data_ptr(), csr.signs.data_ptr(),
            csr.offsets.data_ptr(), dest.data_ptr(), d, n,
            _build.stream_ptr(A.device),
        )
    _build.check(err, "countsketch_apply")
    _build.count_launch(countsketch_apply)
    if out is not None:
        return out
    return dest[:, 0] if A.ndim == 1 else dest


countsketch_apply.launches = 0


class CooPlan(NamedTuple):
    """The coordinate scatter's products grouped by output cell."""

    perm: torch.Tensor  # (k·nnz,) int64 — product ids (j·nnz + e), sorted by cell (stable)
    offsets: torch.Tensor  # (d·n + 1,) int64 — cell q owns perm[off[q]:off[q+1]]


def countsketch_coo_plan(rows, cols, n: int, buckets, d: int) -> CooPlan:
    """Sort the k·nnz products of the entries (rows, cols) by their cell
    h_j(r)·n + c, keeping the j-major, entry-order ravel within a cell."""
    keys = coo_keys(rows, cols, n, buckets)
    perm = torch.sort(keys, stable=True).indices
    offsets = torch.zeros(d * n + 1, dtype=torch.int64, device=keys.device)
    torch.cumsum(torch.bincount(keys, minlength=d * n), 0, out=offsets[1:])
    return CooPlan(perm=perm, offsets=offsets)


def countsketch_coo_apply(
    rows: torch.Tensor,
    cols: torch.Tensor,
    vals: torch.Tensor,
    shape,
    buckets: torch.Tensor,
    weights: torch.Tensor,
    d: int,
    *,
    plan: CooPlan | None = None,
) -> torch.Tensor:
    """SA for the bucket sketch (buckets, weights), each (m,) or (k, m), and
    the sparse A of ``shape`` (m, n) — or (m,), with ``cols`` all 0 —
    given by its entries (rows, cols, vals), through the coordinate scatter
    kernel on CUDA.  The result is (d, n) (or (d,)) in the values' dtype.
    ``plan`` is :func:`countsketch_coo_plan` of these entries; it is built
    here when not given."""
    shape = tuple(int(s) for s in shape)
    if len(shape) not in (1, 2):
        raise ValueError(f"countsketch_coo_apply: shape must be (m,) or (m, n), got {shape}")
    m = shape[0]
    nnz = vals.shape[0] if vals.ndim == 1 else -1
    if vals.ndim != 1 or rows.shape != (nnz,) or cols.shape != (nnz,):
        raise ValueError(
            f"rows, cols and vals must be 1-D of one length, got {tuple(rows.shape)}, "
            f"{tuple(cols.shape)} and {tuple(vals.shape)}"
        )
    if rows.dtype != torch.int64 or cols.dtype != torch.int64:
        raise TypeError(f"rows and cols must be int64, got {rows.dtype} and {cols.dtype}")
    if buckets.ndim not in (1, 2) or buckets.shape[-1] != m or weights.shape != buckets.shape:
        raise ValueError(
            f"buckets/weights must both be ({m},) or (k, {m}), "
            f"got {tuple(buckets.shape)} and {tuple(weights.shape)}"
        )
    for name, t in (("rows", rows), ("cols", cols), ("buckets", buckets), ("weights", weights)):
        if t.device != vals.device:
            raise ValueError(f"{name} ({t.device}) must be on the values' device {vals.device}")
    if vals.device.type == "cpu":
        return countsketch_coo_ref(rows, cols, vals, shape, buckets, weights, d)
    if vals.device.type != "cuda":
        raise ValueError(f"countsketch_coo_apply runs on CUDA or CPU, got {vals.device}")
    return _coo_launch(rows, cols, vals, shape, buckets, weights, d, plan)


def _coo_launch(rows, cols, vals, shape, buckets, weights, d, plan):
    """The CUDA branch of :func:`countsketch_coo_apply` (arguments checked)."""
    if vals.dtype not in (torch.float64, torch.float32):
        raise TypeError(f"the coordinate scatter takes f64 or f32 values, got {vals.dtype}")
    m, nnz = shape[0], vals.shape[0]
    n = shape[1] if len(shape) == 2 else 1
    k = buckets.numel() // m if m else 1
    # the kernel gathers w[j, rows[i]] and the plan's keys index d·n cells:
    # out-of-range ids would read and write outside the buffers
    for name, t, hi in (("rows", rows, m), ("cols", cols, n), ("buckets", buckets, d)):
        if t.numel() and not bool((t.min() >= 0) & (t.max() < hi)):
            raise ValueError(f"countsketch_coo_apply: {name} must lie in [0, {hi})")
    if plan is None:
        plan = countsketch_coo_plan(rows, cols, n, buckets, d)
    if plan.perm.shape != (k * nnz,) or plan.offsets.shape != (d * n + 1,):
        raise ValueError("plan does not match these entries and this sketch")
    for name, t in plan._asdict().items():
        if t.dtype != torch.int64 or t.device != vals.device or not t.is_contiguous():
            raise ValueError(f"plan {name} must be contiguous int64 on {vals.device}")
    w = weights.reshape(-1, m).to(vals.dtype).contiguous()
    rows, vals = rows.contiguous(), vals.contiguous()
    out = torch.empty(d * n, dtype=vals.dtype, device=vals.device)
    lib = _build.load()
    with torch.cuda.device(vals.device):
        err = lib.repro_coo_scatter(
            _build.dtype_code(vals.dtype), plan.perm.data_ptr(), rows.data_ptr(),
            vals.data_ptr(), w.data_ptr(), plan.offsets.data_ptr(), out.data_ptr(),
            d * n, nnz, m, _build.stream_ptr(vals.device),
        )
    _build.check(err, "countsketch_coo_apply")
    _build.count_launch(countsketch_coo_apply)
    return out.view(d, n) if len(shape) == 2 else out


countsketch_coo_apply.launches = 0
