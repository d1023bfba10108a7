"""Carry the reference package's state across to the port.

The JAX package has no weights: its "parameters" are the drawn sketch
operator and the problem arrays.  These helpers take them as numpy arrays
(``np.asarray`` of the JAX arrays) and return the port's objects on
``device`` (``None`` → ``cuda``), so a test can run both packages on the
same S and the same problem.  Pass the converted operator as ``sketch=`` to
``SketchedFactor.build``, ``saa_sas`` or ``lstsq``.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.backend import as_tensor, resolve_device
from .core.problems import Problem
from .core.sketch import CountSketch

__all__ = ["countsketch_from_reference", "problem_from_reference"]


def countsketch_from_reference(buckets, signs, d: int, *, device=None) -> CountSketch:
    """The port's ``CountSketch`` for a reference operator's ``buckets``
    (int, in [0, d)) and ``signs`` (±1, in the data dtype)."""
    dev = resolve_device(device)
    buckets = np.asarray(buckets)
    signs = np.asarray(signs)
    if buckets.shape != signs.shape or buckets.ndim != 1:
        raise ValueError("buckets and signs must be matching 1-D arrays")
    if buckets.size and (buckets.min() < 0 or buckets.max() >= d):
        raise ValueError(f"buckets must lie in [0, {d})")
    return CountSketch(
        buckets=as_tensor(buckets, dev, torch.int32),
        signs=as_tensor(signs, dev),
        d=int(d),
        m=int(buckets.shape[0]),
    )


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
