"""Wrappers of kernel B8, the Walsh–Hadamard transform and the SRHT apply
(``csrc/hadamard.cuh``, ``csrc/srht.cu``).

Replaces ``repro/kernels/srht/kernel.py:25`` (``block_hadamard_kernel``)
and ``:32`` (``cross_hadamard_kernel``), launched at ``srht/ops.py:58`` and
``:82``.  The TPU turns the transform into two dense ±1 matmuls because
strided butterflies fit badly in VMEM; on Hopper the transform is bound by
memory traffic, so the kernel keeps the radix-2 butterflies and runs them in
shared memory and registers, in passes of at most 10 bits (two at
m = 2^20).  It runs the stages in the plain version's order, so it is
bitwise equal to :func:`~repro_torch.kernels.srht.ref.fwht`.

The SRHT runs every pass of one column panel of w columns
(``common.hadamard_panel``: 8 in f64, A read in 64-byte row segments)
before the next panel, each pass one launch, through one (m_pad, w) panel
buffer (67 MB at m_pad = 2^20); the first pass reads A once, applies D as
sign bits (:func:`sign_mask`) and reads rows ≥ m as zeros, and the last
pass writes only the d sampled rows, divided by √d, through a gather list
(:func:`gather_list`).  No (m_pad, n) buffer is made.  :class:`SRHTPlan`
holds both, built on the device with no host round trip; ``SRHTSketch``
caches it.  The transform runs all columns as one panel.

Contract (as the reference's): axis 0; an (m,) or (m, n) input; for
:func:`srht_apply`, ``signs`` of length m_pad (the next power of two ≥ m),
±1 (the card reads their sign bits), and ``rows`` = d indices into
[0, m_pad).  f64 and f32 inputs keep their dtype; half inputs give f32 (the
port's common contract; the reference's kernel returns bf16 for bf16
input).  A CUDA tensor launches the kernel or raises; a CPU tensor runs the
plain version of ``ref.py``.  ``wrapper.launches`` counts kernel launches
only.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import _build
from ..common import cdiv, hadamard_panel, hadamard_passes
from ..countsketch.ref import acc_dtype
from .ref import hadamard_ref, srht_ref

__all__ = ["SRHTPlan", "gather_list", "hadamard_transform", "sign_mask", "srht_apply", "srht_plan"]


class SRHTPlan(NamedTuple):
    """What B8's SRHT launch reads besides A: D and P, in the kernel's order."""

    mask: torch.Tensor  # int32 (cdiv(m_pad, 32),): D's sign bits, first pass's order
    rows: torch.Tensor  # int64 (d,): the rows, stably sorted; out of range → m_pad
    index: torch.Tensor  # int64 (d,): the output row of each sorted entry
    offsets: torch.Tensor  # int64 (groups + 2,): entries of each last-pass group, then the out-of-range ones


def sign_mask(signs: torch.Tensor) -> torch.Tensor:
    """D's sign bits as int32 words, in the order B8's first pass reads them.

    The first pass's item for group g (the low ``lo`` bits of the row) gives
    thread y the local rows k = (j << Q2) | y, j < 2^Q1, row = (k << lo) | g.
    Bit (g << G) | (y << Q1) | j holds that row's sign, so a thread's signs
    are one aligned run of 2^Q1 ≤ 32 bits of one word.  Bit set = negative
    (``torch.signbit``).
    """
    m_pad = signs.shape[0]
    g = hadamard_passes(m_pad)[0]
    lo = m_pad.bit_length() - 1 - g
    q1, q2 = (g + 1) // 2, g // 2
    # row = (j << (q2 + lo)) | (y << lo) | g: a (j, y, g) array, read as (g, y, j)
    bits = torch.signbit(signs).view(1 << q1, 1 << q2, 1 << lo).permute(2, 1, 0).reshape(-1)
    bits = torch.cat([bits.to(torch.uint8), bits.new_zeros(-m_pad % 32, dtype=torch.uint8)])
    weights = torch.tensor([1 << s for s in range(8)], dtype=torch.uint8, device=signs.device)
    octets = (bits.view(-1, 8) * weights).sum(1, dtype=torch.uint8)
    return octets.view(torch.int32)  # little-endian: bit i of a word is bit i % 8 of octet i // 8


def gather_list(rows: torch.Tensor, m_pad: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """B8's row → outputs list of P: ``(sorted_rows, index, offsets)``.

    A stable sort of ``rows`` (duplicates keep their output order), the
    output row of each entry, and the offsets of the entries of each group
    of 2^G contiguous rows of the last pass.  A row outside [0, m_pad) sorts
    as m_pad into one last bucket, past every group: its output row is NaN.
    """
    g_last = hadamard_passes(m_pad)[-1]
    groups = m_pad >> g_last
    r = rows.to(torch.int64)
    key = torch.where((r >= 0) & (r < m_pad), r, m_pad)
    order = torch.sort(key, stable=True).indices
    counts = torch.bincount(key >> g_last, minlength=groups + 1)
    offsets = torch.zeros(groups + 2, dtype=torch.int64, device=rows.device)
    torch.cumsum(counts, 0, out=offsets[1:])
    return key[order].contiguous(), order.contiguous(), offsets


def srht_plan(signs: torch.Tensor, rows: torch.Tensor) -> SRHTPlan:
    """The sign mask and gather list of (signs, rows), on their device."""
    return SRHTPlan(sign_mask(signs), *gather_list(rows, signs.shape[0]))


def _check_plan(plan, m_pad: int, d: int, device) -> None:
    if not isinstance(plan, SRHTPlan):
        raise TypeError(f"plan must be an SRHTPlan, got {type(plan).__name__}")
    groups = m_pad >> hadamard_passes(m_pad)[-1]
    shapes = {"mask": (cdiv(m_pad, 32), torch.int32), "rows": (d, torch.int64),
              "index": (d, torch.int64), "offsets": (groups + 2, torch.int64)}
    for name, (size, dtype) in shapes.items():
        t = getattr(plan, name)
        if t.shape != (size,) or t.dtype != dtype:
            raise ValueError(f"plan.{name} must be {dtype} ({size},), got {t.dtype} {tuple(t.shape)}")
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"plan.{name} must be contiguous on {device}")


def _panel_buffer(m_pad: int, w: int, acc: torch.dtype, device):
    """The (m_pad, w) panel buffer, or None where one pass needs none."""
    if len(hadamard_passes(m_pad)) == 1:
        return None
    return torch.empty((m_pad, w), dtype=acc, device=device)


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
    """H x along axis 0 (m a power of two), through kernel B8 on CUDA.

    All n columns form one panel whose intermediate is the output itself:
    it is as large as x anyway, so no scratch is needed."""
    prepared = _prepare("hadamard_transform", x)
    m = x.shape[0]
    if m < 1 or m & (m - 1):
        raise ValueError(f"hadamard_transform: m must be a power of two, got {m}")
    if prepared is None:
        return hadamard_ref(x)
    code, x2 = prepared
    n = x2.shape[1]
    acc = acc_dtype(x.dtype)
    out = torch.empty((m, n), dtype=acc, device=x.device)
    if n == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(x.device):
        err = lib.repro_hadamard(
            code, x2.data_ptr(), out.data_ptr(), m, n, _build.stream_ptr(x.device)
        )
    _build.check(err, "hadamard_transform")
    _build.count_launch(hadamard_transform)
    return out[:, 0] if x.ndim == 1 else out


hadamard_transform.launches = 0


def srht_apply(
    A: torch.Tensor,
    signs: torch.Tensor,
    rows: torch.Tensor,
    d: int,
    *,
    plan: SRHTPlan | None = None,
) -> torch.Tensor:
    """SRHT sketch (1/√d)·P·H·D·A, through kernel B8 on CUDA.

    ``signs`` (m_pad,) is D (±1); ``rows`` (d,) are the sampled rows of
    H·D·A.  ``plan`` is :func:`srht_plan` of (signs, rows), built here when
    not given (``SRHTSketch`` caches it).  On CUDA the scratch is one
    (m_pad, w) panel buffer in the accumulation dtype, freed on return.  A row index outside [0, m_pad) raises on the CPU; on the
    card, where checking it would cost a host round trip per call, the
    kernel writes NaN into that output row instead of reading out of bounds
    (the operators draw and convert only in-range rows).
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
    if plan is not None:
        _check_plan(plan, m_pad, d, A.device)
    if prepared is None:
        if d and not bool(((rows >= 0) & (rows < m_pad)).all()):
            raise ValueError(f"rows must lie in [0, {m_pad})")
        return srht_ref(A, signs, rows, d)
    code, A2 = prepared
    n = A2.shape[1]
    acc = acc_dtype(A.dtype)
    out = torch.empty((d, n), dtype=acc, device=A.device)
    if n == 0 or d == 0:
        return out[:, 0] if A.ndim == 1 else out
    if plan is None:
        plan = srht_plan(signs, rows)
    w = min(hadamard_panel(A.element_size()), n)
    buf = _panel_buffer(m_pad, w, acc, A.device)
    lib = _build.load()
    with torch.cuda.device(A.device):
        err = lib.repro_srht_apply(
            code, A2.data_ptr(), plan.mask.data_ptr(), plan.rows.data_ptr(),
            plan.index.data_ptr(), plan.offsets.data_ptr(), _build.ptr(buf),
            out.data_ptr(), m, m_pad, n, d, w, math.sqrt(d),
            _build.stream_ptr(A.device),
        )
    _build.check(err, "srht_apply")
    _build.count_launch(srht_apply)
    return out[:, 0] if A.ndim == 1 else out


srht_apply.launches = 0
