"""Wrappers of kernels B6 (dense S·A) and B4 (in-kernel Gaussian S·A).

Replaces ``repro/kernels/sketch_matmul/kernel.py:27`` (``matmul_kernel``,
launched at ``sketch_matmul/ops.py:51``) and ``kernel.py:40``
(``fused_gaussian_kernel``, launched at ``ops.py:116``).  Both CUDA
kernels are one tiled product in ``csrc/dense_sketch.cuh``, templated on
where the S tile comes from: read from memory (B6) or generated in shared
memory from the threefry counter (i, j) and Box–Muller (B4, so S never
reaches device memory).  Each block owns one output tile and sums over m in
one fixed order, with no atomics: the result is deterministic.

Contract (as the reference's): A is (m, n) or (m,); the result is (d, n)
or (d,); f64 and f32 keep their dtype, half inputs give f32.  S is rounded
to A's dtype before the product (``sketch_matmul`` casts it when the
dtypes differ), as the reference's fused route does.  A CUDA tensor
launches the kernel or raises; a CPU tensor runs the plain version of
``ref.py``.  ``wrapper.launches`` counts kernel launches only.
"""
from __future__ import annotations

import torch

from .. import _build
from ..countsketch.ref import acc_dtype
from .ref import default_scale, fused_gaussian_ref, sketch_matmul_ref

__all__ = ["sketch_matmul", "fused_gaussian_sketch", "threefry_bits"]

_U32 = 2**32


def _prepare(name, A, ndims):
    """Input checks shared by the dense-sketch wrappers (B4–B7).

    Returns None for a CPU ``A`` (the wrapper runs its plain version); for a
    CUDA ``A`` the kernel's dtype code and A as a contiguous (m, n) matrix.
    """
    if not isinstance(A, torch.Tensor):
        raise TypeError(f"A must be a torch.Tensor, got {type(A).__name__}")
    if A.ndim not in ndims:
        raise ValueError(
            f"{name}: A must have {' or '.join(map(str, ndims))} dims, "
            f"got shape {tuple(A.shape)}"
        )
    if A.shape[0] >= _U32:
        raise ValueError(f"{name}: the counters are 32-bit; m = {A.shape[0]} is too large")
    if A.device.type == "cpu":
        return None
    if A.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or CPU, got {A.device}")
    code = _build.dtype_code(A.dtype)
    return code, (A[:, None] if A.ndim == 1 else A).contiguous()


def _check_S(S, A):
    if not isinstance(S, torch.Tensor) or S.ndim != 2:
        raise ValueError("S must be a 2-D torch.Tensor")
    if S.shape[1] != A.shape[0]:
        raise ValueError(f"S is {tuple(S.shape)} but A has {A.shape[0]} rows")
    if S.device != A.device:
        raise ValueError(f"S is on {S.device}, A on {A.device}")


def _check_key(key, d):
    k0, k1 = key
    if not (0 <= k0 < _U32 and 0 <= k1 < _U32):
        raise ValueError(f"key words must lie in [0, 2^32), got {key}")
    if d >= _U32:
        raise ValueError(f"the counters are 32-bit; d = {d} is too large")
    return int(k0), int(k1)


def sketch_matmul(S: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """S (d, m) · A, through kernel B6 on CUDA."""
    prepared = _prepare("sketch_matmul", A, (1, 2))
    _check_S(S, A)
    if prepared is None:
        return sketch_matmul_ref(S, A)
    code, A2 = prepared
    S = S.to(A.dtype).contiguous()
    d, (m, n) = S.shape[0], A2.shape
    out = torch.empty((d, n), dtype=acc_dtype(A.dtype), device=A.device)
    lib = _build.load()
    with torch.cuda.device(A.device):
        err = lib.repro_sketch_matmul(
            code, S.data_ptr(), A2.data_ptr(), out.data_ptr(), d, m, n,
            _build.stream_ptr(A.device),
        )
    _build.check(err, "sketch_matmul")
    sketch_matmul.launches += 1
    return out[:, 0] if A.ndim == 1 else out


sketch_matmul.launches = 0


def fused_gaussian_sketch(A: torch.Tensor, key, d: int, *, scale=None) -> torch.Tensor:
    """scale·G·A with G ~ N(0, 1)^{d×m} from ``key = (k0, k1)``, generated
    inside kernel B4 on CUDA; ``scale=None`` means 1/√d.  G·scale is formed
    in f32 and cast to A's dtype."""
    prepared = _prepare("fused_gaussian_sketch", A, (1, 2))
    k0, k1 = _check_key(key, d)
    if prepared is None:
        return fused_gaussian_ref(A, (k0, k1), d, scale)
    code, A2 = prepared
    m, n = A2.shape
    out = torch.empty((d, n), dtype=acc_dtype(A.dtype), device=A.device)
    lib = _build.load()
    with torch.cuda.device(A.device):
        err = lib.repro_fused_gaussian(
            code, k0, k1, default_scale(d, scale), A2.data_ptr(), out.data_ptr(),
            d, m, n, _build.stream_ptr(A.device),
        )
    _build.check(err, "fused_gaussian_sketch")
    fused_gaussian_sketch.launches += 1
    return out[:, 0] if A.ndim == 1 else out


fused_gaussian_sketch.launches = 0


def threefry_bits(key, row0: int, col0: int, rows: int, cols: int, device) -> tuple:
    """Raw threefry bits (b0, b1) of counters (row0 + i, col0 + j) as int64
    (rows, cols) tensors, from the device function kernels B4 and B5 call.

    A check, not a kernel of any path: it lets a run hold the card's bits
    bitwise against :func:`repro_torch.kernels.common.threefry2x32`.
    """
    k0, k1 = _check_key(key, row0 + rows)
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"threefry_bits reads the CUDA device function; got {device}")
    out = torch.empty((2, rows, cols), dtype=torch.int32, device=device)
    lib = _build.load()
    with torch.cuda.device(device):
        err = lib.repro_threefry_bits(
            k0, k1, row0, col0, rows, cols, out[0].data_ptr(), out[1].data_ptr(),
            _build.stream_ptr(device),
        )
    _build.check(err, "threefry_bits")
    bits = out.to(torch.int64) & 0xFFFFFFFF
    return bits[0], bits[1]
