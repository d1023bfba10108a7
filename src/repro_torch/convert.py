"""Carry the reference package's state across to the port.

The JAX package has no weights: its "parameters" are the drawn sketch
operator and the problem arrays.  These helpers take them as numpy arrays
(``np.asarray`` of the JAX arrays) and return the port's objects on
``device`` (``None`` → ``cuda``), so a test can run both packages on the
same S and the same problem.  Pass the converted operator as ``sketch=`` to
``SketchedFactor.build``, ``saa_sas`` or ``lstsq``.  ``sparse_from_reference`` takes a BCOO's
entries to the port's ``SparseOperator``.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.backend import as_tensor, resolve_device
from .core.linop import SparseOperator
from .core.problems import Problem
from .core.sketch import (
    CountSketch,
    GaussianSketch,
    SparseSignSketch,
    SRHTSketch,
    UniformDenseSketch,
    UniformSparseSketch,
    _next_pow2,
)
from .kernels.common import key_to_u32

__all__ = [
    "countsketch_from_reference",
    "gaussian_from_reference",
    "uniform_dense_from_reference",
    "srht_from_reference",
    "sparse_sign_from_reference",
    "uniform_sparse_from_reference",
    "problem_from_reference",
    "sparse_from_reference",
]


def _buckets(buckets, weights, d: int, ndim: int, dev):
    """Checked bucket and weight arrays of a bucket sketch, as tensors."""
    buckets, weights = np.asarray(buckets), np.asarray(weights)
    if buckets.shape != weights.shape or buckets.ndim != ndim:
        raise ValueError(f"buckets and weights must be matching {ndim}-D arrays")
    if buckets.size and (buckets.min() < 0 or buckets.max() >= d):
        raise ValueError(f"buckets must lie in [0, {d})")
    return as_tensor(buckets, dev, torch.int32), as_tensor(weights, dev)


def countsketch_from_reference(buckets, signs, d: int, *, device=None) -> CountSketch:
    """The port's ``CountSketch`` for a reference operator's ``buckets``
    (int, in [0, d)) and ``signs`` (±1, in the data dtype)."""
    buckets, signs = _buckets(buckets, signs, d, 1, resolve_device(device))
    return CountSketch(buckets=buckets, signs=signs, d=int(d), m=int(buckets.shape[0]))


def sparse_sign_from_reference(buckets, signs, d: int, k: int, *, device=None) -> SparseSignSketch:
    """The port's ``SparseSignSketch`` for a reference operator's (k, m)
    ``buckets`` and ``signs``."""
    buckets, signs = _buckets(buckets, signs, d, 2, resolve_device(device))
    if buckets.shape[0] != k:
        raise ValueError(f"buckets hold {buckets.shape[0]} entries per row, k = {k}")
    return SparseSignSketch(
        buckets=buckets, signs=signs, d=int(d), m=int(buckets.shape[1]), k=int(k)
    )


def uniform_sparse_from_reference(buckets, values, d: int, *, device=None) -> UniformSparseSketch:
    """The port's ``UniformSparseSketch`` for a reference operator's
    ``buckets`` and ``values``."""
    buckets, values = _buckets(buckets, values, d, 1, resolve_device(device))
    return UniformSparseSketch(buckets=buckets, values=values, d=int(d), m=int(buckets.shape[0]))


def srht_from_reference(signs, rows, d: int, m: int, *, device=None) -> SRHTSketch:
    """The port's ``SRHTSketch`` for a reference operator's ``signs``
    (m_pad,) and ``rows`` (d,) into [0, m_pad)."""
    dev = resolve_device(device)
    signs, rows = np.asarray(signs), np.asarray(rows)
    m_pad = _next_pow2(m)
    if signs.shape != (m_pad,):
        raise ValueError(f"signs must be ({m_pad},) for m = {m}, got {signs.shape}")
    if rows.shape != (d,) or (rows.size and (rows.min() < 0 or rows.max() >= m_pad)):
        raise ValueError(f"rows must be ({d},) indices into [0, {m_pad})")
    return SRHTSketch(
        signs=as_tensor(signs, dev), rows=as_tensor(rows, dev, torch.int64),
        d=int(d), m=int(m), m_pad=m_pad,
    )


def gaussian_from_reference(key_data, d: int, m: int, S=None, *, device=None) -> GaussianSketch:
    """The port's ``GaussianSketch`` for a reference operator: ``key_data``
    is ``np.asarray(jax.random.key_data(op.key))`` (two uint32 words) and
    ``S`` its stored matrix, or None for an unmaterialized operator."""
    dev = resolve_device(device)
    if S is not None:
        S = as_tensor(S, dev)
        if S.shape != (d, m):
            raise ValueError(f"S is {S.shape}, expected {(d, m)}")
    return GaussianSketch(S=S, key=key_to_u32(key_data), d=int(d), m=int(m), dev=dev)


def uniform_dense_from_reference(S, *, device=None) -> UniformDenseSketch:
    """The port's ``UniformDenseSketch`` holding a reference operator's S."""
    S = as_tensor(S, resolve_device(device))
    if S.ndim != 2:
        raise ValueError(f"S must be 2-D, got shape {tuple(S.shape)}")
    return UniformDenseSketch(S=S, d=int(S.shape[0]), m=int(S.shape[1]))


def problem_from_reference(A, b, x_true, r_true, cond, beta, *, device=None) -> Problem:
    """The port's ``Problem`` holding a reference problem's arrays."""
    dev = resolve_device(device)
    return Problem(
        A=as_tensor(A, dev),
        b=as_tensor(b, dev),
        x_true=as_tensor(x_true, dev),
        r_true=as_tensor(r_true, dev),
        cond=float(cond),
        beta=float(beta),
    )


def sparse_from_reference(indices, data, shape, *, device=None) -> SparseOperator:
    """The port's ``SparseOperator`` for a 2-D BCOO's ``indices`` ((nse, 2)
    row and column ids) and ``data`` ((nse,)), in their order and with
    their repeated coordinates: the bucket sketches then scatter the
    entries in the order the reference's ``.at[].add`` does."""
    indices, data = np.asarray(indices), np.asarray(data)
    if indices.ndim != 2 or indices.shape[1] != 2 or data.shape != (indices.shape[0],):
        raise ValueError(
            f"need (nse, 2) indices and (nse,) data, got {indices.shape} and {data.shape}"
        )
    return SparseOperator.from_entries(
        indices[:, 0], indices[:, 1], data, shape, device=device
    )
