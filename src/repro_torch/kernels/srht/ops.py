"""Wrappers of kernel B8, the Walsh–Hadamard transform and the SRHT apply
(``csrc/hadamard.cuh``, ``csrc/srht.cu``).

Replaces ``repro/kernels/srht/kernel.py:25`` (``block_hadamard_kernel``)
and ``:32`` (``cross_hadamard_kernel``), launched at ``srht/ops.py:58`` and
``:82``.  The TPU turns the transform into two dense ±1 matmuls because
strided butterflies fit badly in VMEM; on Hopper the transform is bound by
memory traffic, so the kernel keeps the radix-2 butterflies and runs them in
shared memory and registers, in passes of at most 10 bits (two at
m = 2^20).  It runs the stages in the plain version's order, so it is
bitwise equal to :func:`~repro_torch.kernels.srht.ref.fwht`.  The first
pass applies the signs D and reads rows ≥ m as zeros, so no padded or
signed copy of A is made; the row sample P and the division by √d run in a
small gather kernel after the last pass.

Contract (as the reference's): axis 0; an (m,) or (m, n) input; for
:func:`srht_apply`, ``signs`` of length m_pad (the next power of two ≥ m)
and ``rows`` = d indices into [0, m_pad).  f64 and f32 inputs keep their
dtype; half inputs give f32 (the port's common contract; the reference's
kernel returns bf16 for bf16 input).  A CUDA tensor launches the kernel or
raises; a CPU tensor runs the plain version of ``ref.py``.
``wrapper.launches`` counts kernel launches only.
"""
from __future__ import annotations

import math

import torch

from .. import _build
from ..countsketch.ref import acc_dtype
from .ref import hadamard_ref, srht_ref

__all__ = ["hadamard_transform", "srht_apply"]


def _prepare(name, x):
    """Input checks shared by the B8 wrappers: None for a CPU ``x`` (the
    wrapper runs its plain version), else the dtype code and x as a
    contiguous (m, n) matrix."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(x).__name__}")
    if x.ndim not in (1, 2):
        raise ValueError(f"{name}: input must have 1 or 2 dims, got shape {tuple(x.shape)}")
    if x.device.type == "cpu":
        return None
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or CPU, got {x.device}")
    code = _build.dtype_code(x.dtype)
    return code, (x[:, None] if x.ndim == 1 else x).contiguous()


def hadamard_transform(x: torch.Tensor) -> torch.Tensor:
    """H x along axis 0 (m a power of two), through kernel B8 on CUDA."""
    prepared = _prepare("hadamard_transform", x)
    m = x.shape[0]
    if m < 1 or m & (m - 1):
        raise ValueError(f"hadamard_transform: m must be a power of two, got {m}")
    if prepared is None:
        return hadamard_ref(x)
    code, x2 = prepared
    n = x2.shape[1]
    out = torch.empty((m, n), dtype=acc_dtype(x.dtype), device=x.device)
    lib = _build.load()
    with torch.cuda.device(x.device):
        err = lib.repro_hadamard(
            code, x2.data_ptr(), out.data_ptr(), m, n, _build.stream_ptr(x.device)
        )
    _build.check(err, "hadamard_transform")
    hadamard_transform.launches += 1
    return out[:, 0] if x.ndim == 1 else out


hadamard_transform.launches = 0


def srht_apply(
    A: torch.Tensor, signs: torch.Tensor, rows: torch.Tensor, d: int
) -> torch.Tensor:
    """SRHT sketch (1/√d)·P·H·D·A, through kernel B8 on CUDA.

    ``signs`` (m_pad,) is D; ``rows`` (d,) are the sampled rows of H·D·A.
    On CUDA the transform runs in an (m_pad, n) scratch buffer in the
    accumulation dtype, freed on return.  A row index outside [0, m_pad)
    raises on the CPU; on the card, where checking it would cost a host
    round trip per call, the kernel writes NaN into that output row
    instead of reading out of bounds (the operators draw and convert only
    in-range rows).
    """
    prepared = _prepare("srht_apply", A)
    m, m_pad = A.shape[0], signs.shape[0]
    if signs.ndim != 1 or m_pad < max(m, 1) or m_pad & (m_pad - 1):
        raise ValueError(
            f"signs must have a power-of-two length >= m = {m}, got {tuple(signs.shape)}"
        )
    if rows.shape != (d,):
        raise ValueError(f"rows must be ({d},), got {tuple(rows.shape)}")
    if signs.device != A.device or rows.device != A.device:
        raise ValueError(
            f"signs ({signs.device}) and rows ({rows.device}) must be on A's device {A.device}"
        )
    if prepared is None:
        if d and not bool(((rows >= 0) & (rows < m_pad)).all()):
            raise ValueError(f"rows must lie in [0, {m_pad})")
        return srht_ref(A, signs, rows, d)
    code, A2 = prepared
    n = A2.shape[1]
    acc = acc_dtype(A.dtype)
    signs = signs.to(acc).contiguous()
    rows = rows.to(torch.int64).contiguous()
    buf = torch.empty((m_pad, n), dtype=acc, device=A.device)
    out = torch.empty((d, n), dtype=acc, device=A.device)
    lib = _build.load()
    with torch.cuda.device(A.device):
        err = lib.repro_srht_apply(
            code, A2.data_ptr(), signs.data_ptr(), rows.data_ptr(), buf.data_ptr(),
            out.data_ptr(), m, m_pad, n, d, math.sqrt(d), _build.stream_ptr(A.device),
        )
    _build.check(err, "srht_apply")
    srht_apply.launches += 1
    return out[:, 0] if A.ndim == 1 else out


srht_apply.launches = 0
