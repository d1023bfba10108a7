"""Shared utilities for the port's kernel wrappers.

Port of ``repro/kernels/common.py``: ``cdiv`` and ``pad_to``.  The
reference's ``threefry2x32`` and ``bits_to_gaussian`` arrive with the
Gaussian sketch slice (ROADMAP A5).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["cdiv", "pad_to"]


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def pad_to(x: torch.Tensor, multiples: tuple[int, ...], value=0) -> torch.Tensor:
    """Pad each axis of ``x`` at its end up to the next multiple (0 = keep)."""
    pads = []
    for dim, mult in zip(x.shape, multiples):
        target = cdiv(dim, mult) * mult if mult else dim
        pads.append(target - dim)
    if not any(pads):
        return x
    # F.pad lists (before, after) pairs from the LAST axis backwards.
    flat = []
    for p in reversed(pads):
        flat += [0, p]
    return F.pad(x, flat, value=value)
