"""Plain PyTorch version of the CountSketch apply (kernel B1's oracle).

A sequential ``index_add_`` of w ⊙ A into d buckets.  ``buckets`` and the
weights ``signs`` are (m,) — one entry per row: the CountSketch (±1) and
the uniform-sparse sketch (uniform weights) — or (k, m): k entries per row,
the sparse-sign sketch, added block by block (k = 0 first).  On the CPU the
adds run in that order and in ascending row order within a block, which is
the order the CUDA kernel sums each bucket's entries in, and each product
is rounded on its own in both, so the two agree bitwise in f64 and f32.  On
a CUDA tensor ``index_add_`` uses atomics and its order varies from run to
run.

``countsketch_coo_ref`` is the plain version of the coordinate scatter,
the bucket sketches' apply to a sparse A given by its entries (r, c, v):
each entry adds w_j(r)·v to the cell (h_j(r), c), for j = 0..k−1.  It is
one ``index_add_`` on the flattened (d·n) output, with the k·nnz products
in the reference's j-major, entry-order ravel (``repro/core/sketch.py``,
``_apply_bcoo``); on the CPU the adds run in that order.
"""
from __future__ import annotations

import torch

__all__ = ["countsketch_ref", "countsketch_coo_ref", "coo_keys", "acc_dtype"]


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """Accumulation dtype: half inputs sum (and are returned) in f32."""
    return torch.float32 if dtype in (torch.bfloat16, torch.float16) else dtype


def countsketch_ref(
    A: torch.Tensor, buckets: torch.Tensor, signs: torch.Tensor, d: int
) -> torch.Tensor:
    """SA for the bucket sketch (buckets, signs), each (m,) or (k, m); A is
    (m, n) or (m,).  The weights are rounded to A's dtype first, as the
    kernel's CSR holds them (exact for ±1)."""
    acc = acc_dtype(A.dtype)
    vec = A.ndim == 1
    A2 = (A[:, None] if vec else A).to(acc)
    out = torch.zeros((d, A2.shape[1]), dtype=acc, device=A.device)
    for h, s in zip(buckets.reshape(-1, A2.shape[0]), signs.reshape(-1, A2.shape[0])):
        out.index_add_(0, h, s.to(A.dtype).to(acc)[:, None] * A2)
    return out[:, 0] if vec else out


def coo_keys(rows, cols, n: int, buckets) -> torch.Tensor:
    """The (k·nnz,) int64 cell keys h_j(r)·n + c of the entries, j-major:
    entry e's j-th product is element j·nnz + e."""
    m = buckets.shape[-1]
    h = buckets.reshape(-1, m)[:, rows].to(torch.int64)
    return (h * n + cols).reshape(-1)


def countsketch_coo_ref(rows, cols, vals, shape, buckets, weights, d: int) -> torch.Tensor:
    """SA for the bucket sketch (buckets, weights), each (m,) or (k, m), and
    the sparse A of ``shape`` (m, n) — or (m,), a sparse vector, with
    ``cols`` all 0 — given by its entries (rows, cols, vals).  The result
    is (d, n) (or (d,)) in the values' dtype; the weights are rounded to
    it first, as the reference's ``astype(M.dtype)``."""
    m = shape[0]
    n = shape[1] if len(shape) == 2 else 1
    w = weights.reshape(-1, m)[:, rows].to(vals.dtype)
    out = torch.zeros(d * n, dtype=vals.dtype, device=vals.device)
    out.index_add_(0, coo_keys(rows, cols, n, buckets), (w * vals).reshape(-1))
    return out.view(d, n) if len(shape) == 2 else out
