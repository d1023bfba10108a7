"""Shared utilities for the port's kernel wrappers.

Port of ``repro/kernels/common.py``: ``cdiv``, ``pad_to``, the counter-based
``threefry2x32`` behind the Gaussian sketch, ``bits_to_gaussian`` and
``key_to_u32``.

PyTorch has no uint32 ``+``, ``<<`` or ``>>`` on CPU tensors, so the plain
threefry works on int64 tensors holding values in [0, 2^32) and masks
every sum and shift with ``& 0xFFFFFFFF``.  It gives the reference's bits
exactly.  ``bits_to_gaussian`` repeats the reference's f32 arithmetic in
the same order; its log, cos and sqrt round differently from XLA's, so the
Gaussians agree with the reference's to a few f32 ulps, not bitwise (the
bound is stated in ``tests/test_torch_sketch_matmul.py``).  The CUDA
kernels use the same arithmetic in ``csrc/threefry.cuh``.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["cdiv", "pad_to", "threefry2x32", "bits_to_gaussian", "key_to_u32"]

_MASK = 0xFFFFFFFF
_ROTS_A = (13, 15, 26, 6)
_ROTS_B = (17, 29, 16, 24)
# The reference multiplies u2 by the Python float 2π, which JAX rounds to
# f32 once: the same constant here.
_TWO_PI_F32 = float(np.float32(2.0 * math.pi))


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


def key_to_u32(key) -> tuple[int, int]:
    """The two 32-bit key words ``(k0, k1)`` of a Gaussian sketch.

    ``key`` is a ``torch.Generator`` (two draws in [0, 2^32) on its
    device), an int seed (the same draws from a CPU generator with that
    seed, so the words do not depend on the data's device), or the
    reference's key data as numpy (``np.asarray(jax.random.key_data(k))``,
    shape (2,)).
    """
    if isinstance(key, (int, np.integer)):
        key = torch.Generator().manual_seed(int(key))
    if isinstance(key, torch.Generator):
        words = torch.randint(
            0, 2**32, (2,), generator=key, dtype=torch.int64, device=key.device
        )
        k0, k1 = words.tolist()
        return int(k0), int(k1)
    arr = np.asarray(key)
    if arr.shape != (2,) or arr.dtype.kind not in "iu":
        raise ValueError(f"key data must be two integer words, got {arr.dtype} {arr.shape}")
    k0, k1 = (int(v) for v in arr)
    if not (0 <= k0 <= _MASK and 0 <= k1 <= _MASK):
        raise ValueError(f"key words must lie in [0, 2^32), got {(k0, k1)}")
    return k0, k1


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0: int, k1: int, x0: torch.Tensor, x1: torch.Tensor):
    """Threefry-2x32, 20 rounds: the reference's key schedule and rotations.

    ``k0``, ``k1`` are ints in [0, 2^32); ``x0``, ``x1`` int64 tensors of
    one shape holding values in [0, 2^32).  Returns two new int64 tensors.
    """
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for g in range(1, 6):
        for r in _ROTS_A if g % 2 == 1 else _ROTS_B:
            x0.add_(x1).bitwise_and_(_MASK)
            x1 = _rotl(x1, r).bitwise_xor_(x0)
        x0.add_(ks[g % 3]).bitwise_and_(_MASK)
        x1.add_(ks[(g + 1) % 3] + g).bitwise_and_(_MASK)
    return x0, x1


def bits_to_gaussian(b0: torch.Tensor, b1: torch.Tensor) -> torch.Tensor:
    """Box–Muller on two 32-bit streams (int64 tensors) → one N(0, 1)
    stream in f32, in the reference's order of operations."""
    u1 = (b0 >> 8).to(torch.float32) * 2.0**-24 + 2.0**-25
    u2 = (b1 >> 8).to(torch.float32) * 2.0**-24
    r = torch.sqrt(-2.0 * torch.log(u1))
    theta = _TWO_PI_F32 * u2
    return r * torch.cos(theta)
