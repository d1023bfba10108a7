"""Plain PyTorch versions of the Walsh–Hadamard transform and the SRHT
(kernel B8's oracle).

:func:`fwht` is the stage loop of ``repro/core/sketch.py:fwht``: stages
h = m/2, m/4, …, 1 (the highest bit of the row index first), each mapping
the pair (a, b) = (x[i], x[i + h]) to (a + b, a − b).  The CUDA kernel runs
the same stages in the same order, so the two agree bitwise, on the card
and on the CPU.  The stages update one copy of x in place: a temporary of
half its size per stage, instead of the reference's new array per stage.
"""
from __future__ import annotations

import torch

from ..common import sqrt_tensor
from ..countsketch.ref import acc_dtype

__all__ = ["fwht", "hadamard_ref", "srht_ref", "hadamard_matrix"]


def _fwht_(y: torch.Tensor) -> torch.Tensor:
    """The stage loop, in place on a contiguous ``y`` that the caller owns."""
    m = y.shape[0]
    if m & (m - 1):
        raise ValueError(f"FWHT length must be a power of two, got {m}")
    flat = y.view(m, -1)
    h = m // 2
    while h >= 1:
        v = flat.view(m // (2 * h), 2, h, flat.shape[1])
        a, b = v[:, 0], v[:, 1]
        t = a - b
        a.add_(b)
        b.copy_(t)
        h //= 2
    return y


def fwht(x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Unnormalized fast Walsh–Hadamard transform along ``axis`` (length a
    power of two).  O(m log m) adds; returns a new tensor."""
    y = x.movedim(axis, 0).clone(memory_format=torch.contiguous_format)
    return _fwht_(y).movedim(0, axis)


def hadamard_ref(x: torch.Tensor) -> torch.Tensor:
    """H x along axis 0 in the accumulation dtype (f32 for half x)."""
    acc = acc_dtype(x.dtype)
    return _fwht_(x.to(acc, copy=True, memory_format=torch.contiguous_format))


def srht_ref(
    A: torch.Tensor, signs: torch.Tensor, rows: torch.Tensor, d: int
) -> torch.Tensor:
    """(1/√d)·P·H·D·A for A (m, n) or (m,), ``signs`` (m_pad,), ``rows``
    (d,) indices into m_pad; the result is in the accumulation dtype."""
    acc = acc_dtype(A.dtype)
    vec = A.ndim == 1
    A2 = (A[:, None] if vec else A).to(acc)
    m, m_pad = A2.shape[0], signs.shape[0]
    if m_pad != m:
        A2 = torch.cat([A2, A2.new_zeros((m_pad - m, A2.shape[1]))])
    HDx = _fwht_(signs.to(acc)[:, None] * A2)
    out = HDx[rows.to(torch.int64)] / sqrt_tensor(d, acc, A.device)
    return out[:, 0] if vec else out


def hadamard_matrix(k: int, dtype=torch.float64, device="cpu") -> torch.Tensor:
    """Sylvester H_k (k a power of two) from the parity of popcount(i & j);
    for tests only."""
    i = torch.arange(k, device=device)
    bits = i[:, None] & i[None, :]
    parity = torch.zeros_like(bits)
    while bool(bits.any()):
        parity ^= bits & 1
        bits >>= 1
    return (1 - 2 * parity).to(dtype)
