"""Shared utilities for the port's kernel wrappers.

Port of ``repro/kernels/common.py``: ``cdiv``, ``pad_to``, the counter-based
``threefry2x32`` behind the Gaussian sketch, ``bits_to_gaussian`` and
``key_to_u32``; plus ``sqrt_tensor``, the divisor of the SRHT and
sparse-sign scales, and the plan of the f64 tensor-core engine
(``csrc/dense_mma.cuh``) behind kernels B6, B4 and B2: :func:`split_plan`,
:func:`sketch_split`, :func:`gen_cluster`, :func:`gaussian_split` and
:func:`gram_split`; and the schedule of kernel B8 (``csrc/hadamard.cuh``):
:func:`hadamard_passes` and :func:`hadamard_panel`.

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

import functools
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "cdiv", "pad_to", "sqrt_tensor", "threefry2x32", "bits_to_gaussian", "key_to_u32",
    "MMA_STEP", "SKETCH_MMA_TILE", "GRAM_MMA_TILE", "GAUSS_MMA_ROWS", "GEN_CLUSTER_MAX", "Split", "split_plan",
    "sketch_split", "gen_cluster", "gen_grid", "gaussian_split", "gram_split", "sm_count",
    "scratch_for", "HAD_MAX_BITS", "HAD_SEGMENT_BYTES", "hadamard_passes", "hadamard_panel",
]

_MASK = 0xFFFFFFFF
_ROTS_A = (13, 15, 26, 6)
_ROTS_B = (17, 29, 16, 24)
# The reference multiplies u2 by the Python float 2π, which JAX rounds to
# f32 once: the same constant here.
_TWO_PI_F32 = float(np.float32(2.0 * math.pi))


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


# The f64 tensor-core engine of csrc/dense_mma.cuh, as its C sources set it
# (the tests hold these equal to kMmaStep, kSketchMmaTile, kGramMmaTile,
# kGaussMmaRows and kGenClusterMax): rows of the reduction in one ring
# stage, the square block tiles of B6 and of B2, the rows of B4's block
# tile (its columns are SKETCH_MMA_TILE), and the most blocks of B4's
# thread-block cluster.
MMA_STEP = 16
SKETCH_MMA_TILE = 128
GRAM_MMA_TILE = 64
GAUSS_MMA_ROWS = 96
GEN_CLUSTER_MAX = 8
# Bounds of the plan: at most MAX_PARTS slabs; each block pays about
# PART_OVERHEAD stages of set-up (the ring's fill, the partial's store);
# one more slab must gain at least PART_GAIN of the modelled time, since
# its partial tiles are written and read once more.
MAX_PARTS = 16
PART_OVERHEAD = 4
PART_GAIN = 1 / 8


class Split(NamedTuple):
    """The split of one engine product's reduction, as its C entry takes it."""

    slab: int  # rows of the reduction in each slab (a multiple of MMA_STEP)
    parts: int  # slabs; the last one may be shorter
    scratch: int  # f64 elements of partial tiles the call needs (0 when parts == 1)


def split_plan(length: int, tiles: int, sms: int, step: int = MMA_STEP) -> tuple[int, int]:
    """``(slab, parts)``: cut a reduction of ``length`` rows into ``parts``
    slabs of ``slab`` rows, the last one shorter, for ``tiles`` output tiles
    on ``sms`` SMs.

    Every slab but the last is a whole number of ``step``-row stages, and
    none is empty.  The modelled time of ``parts`` slabs is the blocks of
    the busiest SM, ``cdiv(tiles·parts, sms)``, times each block's stages
    plus PART_OVERHEAD.  Going up from one slab, the plan moves to more
    slabs (at most MAX_PARTS) only where they cut the modelled time of the
    best plan so far by PART_GAIN.  It is a function of its arguments
    alone, so a shape always gets the same split and the same rounding.
    """
    if length < 0 or tiles < 1 or sms < 1 or step < 1:
        raise ValueError(f"split_plan({length}, {tiles}, {sms}, {step})")
    steps = max(cdiv(length, step), 1)
    best = None
    for p in range(1, min(MAX_PARTS, steps) + 1):
        per = cdiv(steps, p)
        parts = cdiv(steps, per)  # no empty slab
        cost = cdiv(tiles * parts, sms) * (per + PART_OVERHEAD)
        if best is None or cost < (1 - PART_GAIN) * best[0]:
            best = (cost, per * step, parts)
    return best[1], best[2]


_NO_SPLIT = Split(MMA_STEP, 1, 0)


def _split(length: int, tiles: int, tile: int, sms: int) -> Split:
    slab, parts = split_plan(length, tiles, sms)
    return Split(slab, parts, parts * tiles * tile * tile if parts > 1 else 0)


def sketch_split(dtype: torch.dtype, d: int, m: int, n: int, sms: int) -> Split:
    """The split of B6's sum over m (the engine runs f64 with n ≥ 2)."""
    if dtype != torch.float64 or d < 1 or n < 2:
        return _NO_SPLIT
    tiles = cdiv(d, SKETCH_MMA_TILE) * cdiv(n, SKETCH_MMA_TILE)
    return _split(m, tiles, SKETCH_MMA_TILE, sms)


def gen_cluster(n: int) -> int:
    """Blocks C of B4's thread-block cluster for n output columns.

    The blocks that share a row tile of S (its n-tiles) split the
    generation of S between them; they form the fewest clusters of at most
    GEN_CLUSTER_MAX blocks, as even as possible, so that the grid is padded
    by fewer than one block a cluster (``csrc/dense_mma.cuh:gen_cluster``).
    """
    tiles = max(cdiv(n, SKETCH_MMA_TILE), 1)
    return cdiv(tiles, cdiv(tiles, GEN_CLUSTER_MAX))


def gen_grid(n: int) -> tuple[int, int]:
    """``(C, gx)``: B4's cluster size and its grid's width along n, the
    n-tiles rounded up to whole clusters."""
    c = gen_cluster(n)
    return c, cdiv(max(cdiv(n, SKETCH_MMA_TILE), 1), c) * c


def gaussian_split(dtype: torch.dtype, d: int, m: int, n: int, sms: int) -> Split:
    """The split of B4's sum over m (the engine runs f64 with n ≥ 2).

    The plan counts the padded grid's blocks, on the SMs that whole
    clusters can fill; the partials are those of the real tiles only.
    """
    if dtype != torch.float64 or d < 1 or n < 2:
        return _NO_SPLIT
    c, gx = gen_grid(n)
    rows = cdiv(d, GAUSS_MMA_ROWS)
    slab, parts = split_plan(m, rows * gx, max(sms // c, 1) * c)
    tiles = rows * cdiv(n, SKETCH_MMA_TILE)
    return Split(slab, parts, parts * tiles * GAUSS_MMA_ROWS * SKETCH_MMA_TILE if parts > 1 else 0)


def gram_split(dtype: torch.dtype, s: int, n: int, sms: int) -> Split:
    """The split of B2's sum over s for B (s, n) in ``dtype`` (the engine
    runs f64; its upper tiles only)."""
    if dtype != torch.float64 or n < 1:
        return _NO_SPLIT
    t = cdiv(n, GRAM_MMA_TILE)
    return _split(s, t * (t + 1) // 2, GRAM_MMA_TILE, sms)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """The SMs of a CUDA device."""
    return _sm_count(torch.device(device).index or 0)


def scratch_for(splits, device) -> torch.Tensor | None:
    """One f64 buffer for the partial tiles of ``splits`` (calls on one
    stream, one after the other, share it), or None when none is needed."""
    elems = max(s.scratch for s in splits)
    return torch.empty(elems, dtype=torch.float64, device=device) if elems else None


# Kernel B8 (csrc/hadamard.cuh; the tests hold HAD_MAX_BITS equal to
# kHadMaxBits): the most bits of one pass, and the width in bytes of the row
# segments in which the SRHT's first pass reads A.  Those segments lie 2^10
# rows apart, and on the H100 HBM serves them at a rate counted in segments,
# not bytes (PERF.md, PR 16): at m_pad = 2^20 in f64, panels of 2, 4, 8 and
# 16 columns took 30.2, 19.7, 15.0 and 14.1 ms.  64-byte segments are where
# the gain flattens.
HAD_MAX_BITS = 10
HAD_SEGMENT_BYTES = 64


def hadamard_passes(m_pad: int) -> tuple[int, ...]:
    """The bits of each pass of B8's transform of length ``m_pad`` (a power
    of two), highest bits first: p = log2(m_pad) split into the fewest passes
    of at most HAD_MAX_BITS bits, as evenly as they go, the earlier passes
    taking the extra bit (``csrc/hadamard.cuh:plan_hadamard``)."""
    if m_pad < 1 or m_pad & (m_pad - 1):
        raise ValueError(f"hadamard_passes: m_pad must be a power of two, got {m_pad}")
    left = m_pad.bit_length() - 1
    passes = max(cdiv(left, HAD_MAX_BITS), 1)
    bits = []
    for i in range(passes):
        bits.append(cdiv(left, passes - i))
        left -= bits[-1]
    return tuple(bits)


def hadamard_panel(in_bytes: int) -> int:
    """Columns w of the SRHT's panel in B8 for input elements of
    ``in_bytes``: the fewest whose row segment of A is HAD_SEGMENT_BYTES
    long (8 in f64, 16 in f32, 32 in half), whatever m_pad.  The wrapper
    caps it at n, so the (m_pad, w) panel buffer takes at most
    HAD_SEGMENT_BYTES · acc / in_bytes bytes a row (64 in f64 and f32, 128
    for half input: 67 MB and 134 MB at m_pad = 2^20), and never more than
    an (m_pad, n) buffer."""
    if in_bytes < 1 or HAD_SEGMENT_BYTES % in_bytes:
        raise ValueError(f"hadamard_panel: no panel for {in_bytes}-byte elements")
    return HAD_SEGMENT_BYTES // in_bytes


def sqrt_tensor(k: int, dtype: torch.dtype, device) -> torch.Tensor:
    """√k in ``dtype`` as a 0-d tensor on ``device``, to divide by.

    ``math.sqrt(k)`` rounded to f32 is the correctly rounded f32 square root
    (53 ≥ 2·24 + 2 bits, so the double rounding is innocuous): the value of
    the reference's ``jnp.sqrt(jnp.asarray(k, dtype))``.  A 0-d tensor on
    the data's device keeps the quotient a true division; PyTorch turns a
    division by a host scalar into a product with its reciprocal on CUDA.
    """
    return torch.tensor(math.sqrt(k), dtype=dtype, device=device)


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
