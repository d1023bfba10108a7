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
(h_j(r), c), and :func:`countsketch_coo_plan` groups them by bucket, each
bucket's in the reference's j-major, entry-order ravel.  For entries in
row order it sorts nothing over the entries: it is B1's bucket CSR of the
sketch (cached on the operator) and a row pointer over the entries (cached
on the ``SparseOperator``).  For entries in any other order it is a stable
sort of the k·nnz products by their int32 bucket id.  The kernel gives one
warp to each bucket, which adds the bucket's products in that order into
its output row in shared memory and writes the row once, empty cells as 0;
the result is bitwise the plain version run on the CPU.  f64 and f32 only:
half inputs never reach it (``precision="mixed"`` raises for a sparse A).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import _build
from .ref import acc_dtype, countsketch_coo_ref, countsketch_fold_ref, countsketch_ref

__all__ = [
    "countsketch_apply",
    "countsketch_csr",
    "CountSketchCSR",
    "countsketch_coo_apply",
    "countsketch_coo_plan",
    "coo_rowptr",
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
    """The coordinate scatter's products grouped by bucket: bucket b's are
    those of ``items[offsets[b]:offsets[b + 1]]``, in the reference's
    j-major, entry-order ravel (product p = j·nnz + e).

    By row (``rowptr`` given; entries in row order): ``items`` and
    ``weights`` are B1's bucket CSR of the sketch, each bucket's (j, r) in
    (j, r) order with its weight w_j(r), and row r's entries are
    ``[rowptr[r], rowptr[r + 1])``.  By product (``rowptr`` None):
    ``items`` are the product ids p, sorted by bucket (stable)."""

    offsets: torch.Tensor  # (d + 1,) int64
    items: torch.Tensor  # by row: (k·m,) int32 rows; by product: (k·nnz,) int64 ids
    weights: torch.Tensor | None  # by row: (k·m,) in the values' dtype
    rowptr: torch.Tensor | None  # by row: (m + 1,) int64


def coo_rowptr(rows: torch.Tensor, m: int) -> torch.Tensor | None:
    """The (m + 1,) int64 row pointer of entries in row order (``rows``
    nondecreasing), or None where a row id decreases somewhere."""
    return _rowptr(rows, m) if _facts({"ordered": _ordered(rows)})["ordered"] else None


def _rowptr(rows: torch.Tensor, m: int) -> torch.Tensor:
    # a binary search a row over the sorted ids: no atomics on the hot bins
    # that a bincount of sorted ids would hit
    return torch.searchsorted(rows, torch.arange(m + 1, dtype=rows.dtype, device=rows.device))


def _ordered(rows: torch.Tensor) -> torch.Tensor | None:
    """On the device: whether ``rows`` is nondecreasing (None: trivially)."""
    return (rows[1:] >= rows[:-1]).all() if rows.numel() > 1 else None


def _in_range(t: torch.Tensor, hi: int) -> torch.Tensor | None:
    """On the device: whether every id of ``t`` lies in [0, hi) (None: empty)."""
    if not t.numel():
        return None
    lo, top = torch.aminmax(t)
    return (lo >= 0) & (top < hi)


def _facts(facts: dict) -> dict:
    """The device booleans of ``facts`` read back at once (None: True)."""
    known = [k for k, v in facts.items() if v is not None]
    read = dict(zip(known, torch.stack([facts[k] for k in known]).tolist())) if known else {}
    return {k: bool(read.get(k, True)) for k in facts}


def countsketch_coo_plan(rows, buckets, weights, d: int, dtype: torch.dtype, *,
                         csr: CountSketchCSR | None = None, rowptr=None) -> CooPlan:
    """Group the k·nnz products of the entries with row ids ``rows`` by
    bucket, for the bucket sketch (buckets, weights), each (m,) or (k, m),
    and values of ``dtype``.

    Entries in row order take the plan by row: ``csr`` (the operator's
    :func:`countsketch_csr` in ``dtype``) and ``rowptr``
    (:func:`coo_rowptr`), each built here when not given; no sort over the
    entries.  Any other order takes the plan by product: a stable sort of
    the products' int32 bucket ids.  Without ``rowptr`` the order is worked
    out here, and the rows and buckets are checked to lie in range
    (ValueError), in one read from the device."""
    m = buckets.shape[-1]
    if rowptr is None:
        facts = _facts({"ordered": _ordered(rows), "rows": _in_range(rows, m),
                        "buckets": _in_range(buckets, d)})
        _raise_unless(facts, m, 0, d)
        rowptr = _rowptr(rows, m) if facts["ordered"] else None
    return _plan(rows, buckets, weights, d, dtype, csr, rowptr)


def _plan(rows, buckets, weights, d, dtype, csr, rowptr) -> CooPlan:
    """The plan by row where ``rowptr`` is given, else by product; the
    caller has checked the rows and buckets to lie in range."""
    if rowptr is not None:
        if csr is None:
            csr = countsketch_csr(buckets, weights, d, dtype)
        return CooPlan(offsets=csr.offsets, items=csr.rows, weights=csr.signs, rowptr=rowptr)
    m = buckets.shape[-1]
    ids = buckets.reshape(-1, m)[:, rows].reshape(-1)
    offsets = torch.zeros(d + 1, dtype=torch.int64, device=ids.device)
    torch.cumsum(torch.bincount(ids, minlength=d), 0, out=offsets[1:])
    return CooPlan(offsets=offsets, items=torch.sort(ids, stable=True).indices, weights=None, rowptr=None)


def _raise_unless(facts: dict, m: int, n: int, d: int) -> None:
    for name, hi in (("rows", m), ("cols", n), ("buckets", d)):
        if not facts.get(name, True):
            raise ValueError(f"countsketch_coo_apply: {name} must lie in [0, {hi})")
    if not facts.get("rowptr", True):
        raise ValueError("plan rowptr does not cover the entries")


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
    ``plan`` is :func:`countsketch_coo_plan` of these entries and this
    sketch in the values' dtype; it is built here when not given."""
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


def _check_plan(plan: CooPlan, vals, k: int, m: int, d: int) -> None:
    """The plan's form, shapes, dtypes and device."""
    nnz = vals.shape[0]
    by_row = plan.rowptr is not None
    want = (
        [("offsets", (d + 1,), torch.int64), ("items", (k * m,), torch.int32),
         ("weights", (k * m,), vals.dtype), ("rowptr", (m + 1,), torch.int64)]
        if by_row else [("offsets", (d + 1,), torch.int64), ("items", (k * nnz,), torch.int64)]
    )
    if not by_row and plan.weights is not None:
        raise ValueError("a plan by product carries no weights")
    for name, shape, dtype in want:
        t = getattr(plan, name)
        if t is None or tuple(t.shape) != shape:
            raise ValueError(f"plan {name} does not match these entries and this sketch")
        if t.dtype != dtype or t.device != vals.device or not t.is_contiguous():
            raise ValueError(f"plan {name} must be contiguous {dtype} on {vals.device}")


def _coo_launch(rows, cols, vals, shape, buckets, weights, d, plan):
    """The CUDA branch of :func:`countsketch_coo_apply` (arguments checked).

    The kernel reads the ids it is handed without bounds: the rows (where
    it reads them), columns and buckets are checked to lie in range, and a
    given plan's row pointer to cover the entries, on the device, and read
    back once before the launch (ValueError), so that out-of-range ids
    never read or write outside the buffers."""
    if vals.dtype not in (torch.float64, torch.float32):
        raise TypeError(f"the coordinate scatter takes f64 or f32 values, got {vals.dtype}")
    m, nnz = shape[0], vals.shape[0]
    n = shape[1] if len(shape) == 2 else 1
    k = buckets.numel() // m if m else 1
    facts = {"cols": _in_range(cols, n), "buckets": _in_range(buckets, d)}
    if plan is None:
        facts.update(rows=_in_range(rows, m), ordered=_ordered(rows))
    else:
        _check_plan(plan, vals, k, m, d)
        if plan.rowptr is None:  # the kernel reads the rows
            facts["rows"] = _in_range(rows, m)
        else:
            facts["rowptr"] = (plan.rowptr[0] == 0) & (plan.rowptr[-1] == nnz)
    facts = _facts(facts)
    _raise_unless(facts, m, n, d)
    if plan is None:
        plan = _plan(rows, buckets, weights, d, vals.dtype, None, _rowptr(rows, m) if facts["ordered"] else None)
    by_row = plan.rowptr is not None
    w = None if by_row else weights.reshape(-1, m).to(vals.dtype).contiguous()
    rows, cols, vals = rows.contiguous(), cols.contiguous(), vals.contiguous()
    out = torch.empty(d * n, dtype=vals.dtype, device=vals.device)
    lib = _build.load()
    with torch.cuda.device(vals.device):
        err = lib.repro_coo_scatter(
            _build.dtype_code(vals.dtype), plan.offsets.data_ptr(), plan.items.data_ptr(),
            _build.ptr(plan.weights), _build.ptr(plan.rowptr), rows.data_ptr(), cols.data_ptr(),
            vals.data_ptr(), _build.ptr(w), out.data_ptr(), d, n, nnz, m,
            _build.stream_ptr(vals.device),
        )
    _build.check(err, "countsketch_coo_apply")
    _build.count_launch(countsketch_coo_apply)
    return out.view(d, n) if len(shape) == 2 else out


countsketch_coo_apply.launches = 0
