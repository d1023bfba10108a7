"""Plain PyTorch versions of the dense-sketch kernels (B4's and B6's oracles).

Port of ``repro/kernels/sketch_matmul/ref.py``.  The Gaussian S is the
kernel's own stream: element (i, j) comes from ``threefry2x32(k0, k1, i,
j)`` and Box–Muller in f32, so any tiling and any column subset give the
same values.  The generators work in column chunks of at most
``_CHUNK_ELEMS`` elements, so the int64 temporaries of the threefry never
hold all d·m counters at once (one such temporary is 2.1 GB at d = 4000,
m = 2^16).

``fused_gaussian_ref`` scales S in f32 and then casts it to A's dtype, as
the TPU kernel does (``sketch_matmul/kernel.py:65–68``) and as the
reference's ``GaussianSketch._gen_cols`` does.  The reference's own
``fused_gaussian_ref`` (``ref.py:54–62``) casts first and scales in A's
dtype, so in f64 it is ~3e-7 away from its kernel; this version follows
the kernel.

Half-precision A gives an f32 result; f64 and f32 keep their dtype.  S is
rounded to A's dtype before the product, as the kernels do.
"""
from __future__ import annotations

import numpy as np
import torch

from ..common import bits_to_gaussian, threefry2x32
from ..countsketch.ref import acc_dtype

__all__ = [
    "sketch_matmul_ref",
    "gaussian_cols_ref",
    "gaussian_matrix_ref",
    "fused_gaussian_ref",
    "default_scale",
]

_CHUNK_ELEMS = 2**24


def default_scale(d: int, scale: float | None = None) -> float:
    """The f32 scale of a Gaussian sketch: 1/√d unless given."""
    return float(np.float32(1.0 / float(d) ** 0.5 if scale is None else scale))


def sketch_matmul_ref(S: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """S (d, m) · A (m, n) or A (m,), with S rounded to A's dtype."""
    acc = acc_dtype(A.dtype)
    vec = A.ndim == 1
    A2 = A[:, None] if vec else A
    out = S.to(A.dtype).to(acc) @ A2.to(acc)
    return out[:, 0] if vec else out


def gaussian_cols_ref(
    k0: int, k1: int, d: int, cols: torch.Tensor, dtype=torch.float32, *, row0: int = 0
):
    """Columns S[row0 : row0 + d, cols] of the unscaled Gaussian stream, in
    ``dtype``.

    ``cols`` is a 1-D integer tensor of column counters in [0, 2^32); the
    result lies on its device.
    """
    cols = cols.to(torch.int64)
    (t,) = cols.shape
    out = torch.empty((d, t), dtype=dtype, device=cols.device)
    chunk = max(1, _CHUNK_ELEMS // max(d, 1))
    rows = torch.arange(row0, row0 + d, dtype=torch.int64, device=cols.device)[:, None]
    for c0 in range(0, t, chunk):
        c = cols[c0 : c0 + chunk]
        x0 = rows.expand(d, c.shape[0])
        x1 = c[None, :].expand(d, c.shape[0])
        b0, b1 = threefry2x32(k0, k1, x0, x1)
        out[:, c0 : c0 + c.shape[0]] = bits_to_gaussian(b0, b1)
    return out


def gaussian_matrix_ref(k0, k1, d, m, dtype=torch.float32, *, col_offset=0, device=None):
    """The (d, m) unscaled Gaussian S from counter column ``col_offset`` on:
    bitwise ``gaussian_matrix_ref(k0, k1, d, col_offset + m)[:, col_offset:]``."""
    cols = torch.arange(col_offset, col_offset + m, dtype=torch.int64, device=device)
    return gaussian_cols_ref(k0, k1, d, cols, dtype)


def fused_gaussian_ref(A: torch.Tensor, key, d: int, scale=None) -> torch.Tensor:
    """scale·G·A with G the (d, m) Gaussian stream of ``key = (k0, k1)``;
    ``scale=None`` means 1/√d.  G·scale is formed in f32, then cast."""
    k0, k1 = key
    S = gaussian_matrix_ref(k0, k1, d, A.shape[0], device=A.device)
    S.mul_(default_scale(d, scale))
    return sketch_matmul_ref(S, A)
