"""Carry the reference package's state across to the port.

The JAX package has no weights: its "parameters" are the drawn sketch
operator and the problem arrays.  These helpers take them as numpy arrays
(``np.asarray`` of the JAX arrays) and return the port's objects on
``device`` (``None`` → ``cuda``), so a test can run both packages on the
same S and the same problem.  Pass the converted operator as ``sketch=`` to
``SketchedFactor.build``, ``saa_sas`` or ``lstsq``.  ``sparse_from_reference`` takes a BCOO's
entries to the port's ``SparseOperator``; ``source_from_reference`` a row
source of ``repro.streaming`` to the port's, with the same tiling.

The LM stack's state crosses too: ``params_from_reference`` takes a
``repro.models`` parameter tree (the same nested dicts and lists, so the
copy renames nothing), ``train_state_from_reference`` a ``repro.train``
``TrainState`` and ``batch_from_reference`` a batch of tokens, labels or
frame embeddings, so both packages compute on the same numbers.
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
from .streaming.sources import ArraySource, MemmapSource, ShardedSource

__all__ = [
    "countsketch_from_reference",
    "gaussian_from_reference",
    "uniform_dense_from_reference",
    "srht_from_reference",
    "sparse_sign_from_reference",
    "uniform_sparse_from_reference",
    "problem_from_reference",
    "sparse_from_reference",
    "source_from_reference",
    "params_from_reference",
    "train_state_from_reference",
    "batch_from_reference",
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


def source_from_reference(source, *, device=None):
    """The port's row source for a reference ``ArraySource`` (its array as a
    tensor on ``device``, with the same tile boundaries, an uneven
    ``boundaries=`` tiling included), ``MemmapSource`` (the same file and
    tiling) or ``ShardedSource`` (each shard converted), so both packages
    stream the same tiles."""
    name = type(source).__name__
    if name == "ArraySource":
        A = as_tensor(np.asarray(source.A), resolve_device(device))
        offsets = [int(o) for o in source._offsets]
        m, rows = A.shape[0], int(source.tile_rows)
        if offsets == list(range(0, m, rows)) + [m]:
            return ArraySource(A, tile_rows=rows)
        return ArraySource(A, boundaries=offsets)
    if name == "MemmapSource":
        return MemmapSource(source.path, tile_rows=int(source.tile_rows))
    if name == "ShardedSource":
        return ShardedSource([source_from_reference(s, device=device) for s in source.shards])
    raise TypeError(
        f"no converter for a reference {name}: convert its array (ArraySource) "
        "or its file (MemmapSource)"
    )


def _tensor(x, dtype, dev) -> torch.Tensor:
    """A reference array (numpy, bf16 through ``ml_dtypes`` included) as a
    tensor of ``dtype`` on ``dev``; bf16 goes through f32, exactly."""
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)
    return as_tensor(arr, dev).to(dtype)


def _tree_from_reference(shapes, tree, dev, dtype=None):
    """``tree``'s leaves as tensors, checked against ``shapes`` (a tree of
    ``(shape, dtype)``; ``dtype=`` overrides the leaves' dtype)."""
    from .models.common import is_shape, tree_get, tree_paths, tree_rebuild

    leaves = {}
    for path in tree_paths(shapes, is_leaf=is_shape):
        shape, want = tree_get(shapes, path)
        arr = np.asarray(tree_get(tree, path))
        if tuple(arr.shape) != tuple(shape):
            raise ValueError(f"{path}: shape {arr.shape}, the model wants {shape}")
        leaves[path] = _tensor(arr, dtype or want, dev)
    return tree_rebuild(shapes, leaves, is_shape)


def params_from_reference(cfg, params, *, device=None):
    """The port's parameter tree for a ``repro.models`` tree of ``cfg``
    (leaves as numpy arrays), in ``cfg.dtype`` on ``device``."""
    from .models.transformer import params_shapes

    return _tree_from_reference(params_shapes(cfg), params, resolve_device(device))


def train_state_from_reference(cfg, state, *, device=None):
    """The port's ``TrainState`` for a ``repro.train`` ``TrainState`` of
    ``cfg``: the step as a host int32 scalar, the parameters in
    ``cfg.dtype``, the f32 master and the moments in
    ``cfg.opt_moments_dtype`` on ``device``."""
    from .models.common import DTYPES
    from .models.transformer import params_shapes
    from .train.step import TrainState

    dev = resolve_device(device)
    shapes = params_shapes(cfg)
    moments = DTYPES[cfg.opt_moments_dtype]
    opt = {
        "master": _tree_from_reference(shapes, state.opt["master"], dev, torch.float32),
        "m": _tree_from_reference(shapes, state.opt["m"], dev, moments),
        "v": _tree_from_reference(shapes, state.opt["v"], dev, moments),
    }
    step = torch.tensor(int(np.asarray(state.step)), dtype=torch.int32)
    return TrainState(step=step, params=_tree_from_reference(shapes, state.params, dev), opt=opt)


def batch_from_reference(batch, *, device=None) -> dict:
    """A reference batch (``tokens``/``labels`` as int32, ``embeds`` as f32)
    as tensors on ``device``."""
    dev = resolve_device(device)
    out = {}
    for k, v in batch.items():
        arr = np.asarray(v)
        out[k] = _tensor(arr, torch.int32 if arr.dtype.kind in "iu" else torch.float32, dev)
    return out
