"""Distributed sketch-and-solve: a row-sharded A over ``torch.distributed``.

Port of ``repro/core/distributed.py``.  The tall matrix A (m × n, m ≫ n)
is split into contiguous row blocks, one a rank, in rank order (as
``P(axes, None)`` places rows).  Every scatter-kind sketch (CountSketch,
sparse-sign, uniform-sparse) is a linear row map with per-row parameters,
so each rank sketches its rows into the *global* s-bucket space and one
all-reduce assembles SA = Σᵢ S A_i exactly; the communication is one
s × (n + 1) all-reduce, independent of m.  The small QR runs replicated;
LSQR then runs with row-sharded m-space vectors, its Aᵀu products and
m-space inner products all-reduced (``lsqr(udot=...)``).

The reference's mapping, and the port's:

- ``(mesh, axes)`` → ``group=`` (a ``ProcessGroup``), or ``mesh=`` (a
  ``DeviceMesh``) + ``axes=`` through ``repro_torch.sharding.group_for``;
  with neither, the default group; with no initialized group it raises;
- ``A``, ``b`` as sharded global arrays → each rank passes its own row
  block ``A_i``, ``b_i`` (:func:`shard_rows` cuts them);
- ``key`` → a ``torch.Generator`` (or an int seed);
- ``lax.psum`` → ``repro_torch.sharding.psum``.

The draw: the reference samples one operator at global size from ``key``
(every device computes the same draw from the same key).  Here every rank
samples ``cls.sample(key, s, m)`` and the group's first rank broadcasts its
parameter arrays over the others', so "one draw" holds by construction
whatever the ranks' devices and generator states.  Each rank then slices
its rows along the kind's row axis (``restrict_cols``: axis 1 of the
sparse-sign sketch's (k, m) arrays, axis 0 otherwise) and calls the kind's
backend-dispatched ``apply``: kernel B1 on a CUDA block.  ``sketch=`` also takes an already-drawn global
operator (the ``convert.*_from_reference`` objects, as ``saa_sas`` and
``lstsq`` do); every rank must then pass the same one.

The factor is replicated: every rank runs the QR of the same all-reduced
sketch.  LSQR's stop test reads only all-reduced quantities and values
computed from them (``lsqr``), so every rank takes the same branch at
every iteration; a rank that diverged would leave the others waiting in
their next all-reduce until the group's timeout, which raises.
"""
from __future__ import annotations

import torch

from .. import sharding
from . import backend as backend_lib
from . import linop
from . import sketch as sketch_lib
from .lsqr import _dot, lsqr
from .precond import SketchedFactor, default_sketch_size
from .result import SolveResult

__all__ = ["sketched_lstsq", "DistributedLSQResult", "shard_rows"]

# The reference's name for the result type, kept for its callers.
DistributedLSQResult = SolveResult

# Scatter kinds: their per-row parameter arrays (field names) and the axis
# along which those arrays index rows of A — the axis that shards with A.
_ROW_PARAM_FIELDS = {
    sketch_lib.CountSketch: (("buckets", "signs"), 0),
    sketch_lib.UniformSparseSketch: (("buckets", "values"), 0),
    sketch_lib.SparseSignSketch: (("buckets", "signs"), 1),
}


def shard_rows(A, b, *, group=None, mesh=None, axes=("data",)):
    """This rank's contiguous row block (views) of a global (A, b): ranks
    in order, block sizes differing by at most one row."""
    group = sharding.resolve_group(group, mesh, axes, who="shard_rows")
    world = torch.distributed.get_world_size(group)
    rank = torch.distributed.get_rank(group)
    return A.tensor_split(world)[rank], b.tensor_split(world)[rank]


def _check_kind(sketch):
    """The operator class of ``sketch`` (a kind name or an operator), or
    the reference's ``ValueError``s."""
    cls = type(sketch) if not isinstance(sketch, str) else sketch_lib.SKETCH_KINDS.get(sketch)
    if cls is None:
        raise ValueError(
            f"unknown sketch kind {sketch!r}; have {sorted(sketch_lib.SKETCH_KINDS)}"
        )
    if cls not in _ROW_PARAM_FIELDS:
        name = sketch if isinstance(sketch, str) else cls.__name__
        raise ValueError(
            f"sketch {name!r} has no per-row parameters to shard; the "
            "distributed driver supports the scatter kinds "
            "(clarkson_woodruff/countsketch, sparse_sign, uniform_sparse)"
        )
    return cls


def _global_operator(sketch, cls, key, s, m, dtype, device, group):
    """The one global draw: every rank samples at global size from ``key``
    and the group's first rank's per-row parameter arrays are broadcast
    over the others' (a no-op where the ranks' generators agreed).  An
    operator passed as ``sketch=`` is used as given."""
    if not isinstance(sketch, str):
        if s != sketch.d:
            raise ValueError(f"sketch_size={s} but the operator has d = {sketch.d}")
        if sketch.m != m:
            raise ValueError(f"sketch operator has m = {sketch.m}, the shards {m} rows")
        if sketch.device != device:
            raise ValueError(f"sketch operator is on {sketch.device}, A on {device}")
        return sketch
    op = cls.sample(key, s, m, dtype=dtype, device=device)
    for f in _ROW_PARAM_FIELDS[cls][0]:
        sharding.broadcast_first(getattr(op, f), group)
    return op


def _local_sketch(A_i, b_i, op, row0: int, group, *, backend: str = "auto"):
    """(SA, Sb) assembled from this rank's rows [row0, row0 + m_i): the
    rank's restriction of ``op`` applied to ``A_i`` and ``b_i`` (kernel B1
    twice on a CUDA block), then one all-reduce of [SA | Sb], (s, n + 1)."""
    sub = op.restrict_cols(slice(row0, row0 + A_i.shape[0]))
    SA = sub.apply(A_i, backend=backend)
    Sb = sub.apply(b_i, backend=backend)
    SAb = sharding.psum(torch.cat([SA, Sb[:, None]], dim=1), group)
    return SAb[:, :-1], SAb[:, -1]


def sketched_lstsq(
    A,
    b,
    key,
    *,
    group=None,
    mesh=None,
    axes=("data",),
    sketch="clarkson_woodruff",
    sketch_size: int | None = None,
    atol: float = 0.0,
    btol: float = 0.0,
    steptol: float | None = None,
    iter_lim: int = 100,
    backend: str = "auto",
    device=None,
) -> SolveResult:
    """Distributed SAA-SAS over this rank's row block ``A`` (m_i × n) and
    ``b`` (m_i,); every rank of the group calls it, and every rank returns
    the same result.

    One all-reduce of the s × (n + 1) sketch, then per LSQR iteration one
    of the n-vector Aᵀu and one of a scalar.  ``sketch`` is a scatter kind
    (``clarkson_woodruff``/``countsketch``, ``sparse_sign``,
    ``uniform_sparse``) or such an operator over the global m rows; the
    dense kinds and the SRHT have no row-local parameters and raise.
    ``backend`` selects the local apply (``repro_torch.core.backend``).
    A sparse or otherwise materializable A is densified; a matrix-free
    operator is rejected.  ``device=None`` means ``"cuda"``.
    """
    A = linop.ensure_dense(A, who="the distributed row-sharded driver", device=device)
    b = backend_lib.as_tensor(b, A.device, A.dtype)
    backend_lib.check_backend(backend)
    cls = _check_kind(sketch)
    group = sharding.resolve_group(group, mesh, axes, who="sketched_lstsq")
    m, row0 = sharding.row_offset(A.shape[0], group, A.device)
    n = A.shape[1]
    if sketch_size is not None:
        s = sketch_size
    else:
        s = sketch.d if not isinstance(sketch, str) else default_sketch_size(n, m)
    if steptol is None:
        steptol = 32 * float(torch.finfo(A.dtype).eps)
    op = _global_operator(sketch, cls, key, s, m, A.dtype, A.device, group)

    # --- sketch locally into the global bucket space, one all-reduce -------
    SA, Sb = _local_sketch(A, b, op, row0, group, backend=backend)

    # --- replicated small factorization ------------------------------------
    factor = SketchedFactor.from_sketch(SA)
    z0 = factor.warm_start(Sb)

    # --- distributed LSQR on Y = A R⁻¹ (operator form) ---------------------
    # mv touches only local rows; rmv sums the ranks' contributions (R is
    # replicated and the triangular solve is linear, so solving per rank
    # then summing equals solving the summed gradient).
    def mv(z):
        return factor.whiten_mv(A, z)

    def rmv(u):
        return sharding.psum(factor.whiten_rmv(A, u), group)

    def udot(u, w):
        return sharding.psum(_dot(u, w), group)

    res = lsqr(
        mv, rmv, b, x0=z0, n=n, atol=atol, btol=btol,
        steptol=steptol, iter_lim=iter_lim, udot=udot,
    )
    return SolveResult(
        x=factor.precondition(res.x), istop=res.istop, itn=res.itn,
        rnorm=res.rnorm, arnorm=res.arnorm,
        used_fallback=torch.tensor(False, device=A.device),
    )
