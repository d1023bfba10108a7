"""Plain PyTorch version of the CountSketch apply (kernel B1's oracle).

A sequential ``index_add_`` of s ⊙ A into d buckets.  On the CPU the adds
run in ascending row order, which is the order the CUDA kernel sums in, so
the two agree bitwise in f64 and f32.  On a CUDA tensor ``index_add_``
uses atomics and its order varies from run to run.
"""
from __future__ import annotations

import torch

__all__ = ["countsketch_ref", "acc_dtype"]


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """Accumulation dtype: half inputs sum (and are returned) in f32."""
    return torch.float32 if dtype in (torch.bfloat16, torch.float16) else dtype


def countsketch_ref(
    A: torch.Tensor, buckets: torch.Tensor, signs: torch.Tensor, d: int
) -> torch.Tensor:
    """SA for the CountSketch (buckets, signs); A is (m, n) or (m,)."""
    acc = acc_dtype(A.dtype)
    vec = A.ndim == 1
    A2 = A[:, None] if vec else A
    contrib = signs.to(acc)[:, None] * A2.to(acc)
    out = torch.zeros((d, A2.shape[1]), dtype=acc, device=A.device)
    out.index_add_(0, buckets, contrib)
    return out[:, 0] if vec else out
