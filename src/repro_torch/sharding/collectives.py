"""Block placement and the autograd collectives of the mesh train step.

Each rank holds one block of every tensor: along each dimension whose spec
names mesh axes, the slice at this rank's flattened coordinate over them
(``PartitionSpec.axes``; the first axis major), as ``NamedSharding`` places
a ``jax.Array``'s shards.

- :func:`block_slices` / :func:`block_shape` / :func:`shard_block` — this
  rank's block of a full tensor;
- :func:`unshard` — the full tensor from every rank's block;
- :func:`gather` / :func:`reduce_scatter` — along one dimension over one
  mesh axis;
- :func:`gather_param` — the FSDP gather of a weight (``torch.autograd``:
  the gather forward, the sum over the data axes and this rank's block
  backward), :func:`copy_to` (identity forward, the sum over an axis
  backward: a tensor entering a tensor-parallel region), :func:`reduce_from`
  (the sum over an axis forward, identity backward: a row-parallel
  product's partial sums leaving it) and :func:`pmean` (the mean over axes
  both ways).

Every collective is an ``all_reduce`` or a ``broadcast`` (the collectives
PyTorch documents gloo as running on CUDA tensors).  A gather is one
``broadcast`` a rank of the group, each of its block's bytes (``uint8``),
into a full buffer: exact, and half the traffic of an ``all_reduce`` of a
zero-filled buffer.  A reduce-scatter is an ``all_reduce`` of the full
tensor (in f32 when more than two ranks add, ``_sum_dtype``), of which
each rank keeps its block.

``BYTES`` counts the bytes each kind hands to ``all_reduce`` and
``broadcast`` on this rank (``"gather"``, ``"reduce_scatter"``,
``"model_sum"``, ``"mean"``, ``"norm"``, and ``"attn_combine"``: a decode
step's combine of the ranks' attentions over a cache split by position);
``CALLS`` the same calls by kind, collective, mesh axes and group size
(the count and the bytes of each, which ``launch.collective_stats`` turns
into ring traffic); ``reset_bytes()`` zeroes both.
"""
from __future__ import annotations

import itertools

import torch
import torch.distributed as dist

from . import Mesh, PartitionSpec

__all__ = [
    "BYTES",
    "CALLS",
    "reset_bytes",
    "dp_axes",
    "block_slices",
    "block_shape",
    "shard_block",
    "unshard",
    "gather",
    "reduce_scatter",
    "psum_over",
    "gather_param",
    "copy_to",
    "reduce_from",
    "pmean",
]

BYTES = {"gather": 0, "reduce_scatter": 0, "model_sum": 0, "mean": 0, "norm": 0, "attn_combine": 0}
# kind -> {(collective, mesh axes, group size): [calls, bytes]}; collective
# is "all_reduce" or "broadcast"
CALLS: dict = {k: {} for k in BYTES}


def reset_bytes():
    for k in BYTES:
        BYTES[k] = 0
        CALLS[k] = {}


def _count(kind: str, collective: str, mesh: Mesh, axes: tuple, nbytes: int):
    """One call of ``kind``: ``nbytes`` handed to ``collective`` over the
    group of ``mesh``'s ``axes``."""
    BYTES[kind] += nbytes
    rec = CALLS[kind].setdefault((collective, axes, mesh.axis_size(axes)), [0, 0])
    rec[0] += 1
    rec[1] += nbytes


def dp_axes(mesh: Mesh) -> tuple:
    """The data-parallel axes of ``mesh`` (``pod`` and ``data`` where present)."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _spec_axes(spec, ndim: int) -> list[tuple]:
    spec = PartitionSpec(*spec) if not isinstance(spec, PartitionSpec) else spec
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than the tensor's {ndim} dims")
    return [spec.axes(i) for i in range(ndim)]


def block_slices(shape, spec, mesh: Mesh, axes=None) -> tuple:
    """This rank's block of a tensor of ``shape``: one slice a dimension
    (only the dimensions split over ``axes``, default every axis, are cut)."""
    out = []
    for n, ax in zip(shape, _spec_axes(spec, len(shape))):
        if ax and (axes is None or set(ax) <= set(axes)):
            parts = mesh.axis_size(ax)
            if n % parts:
                raise ValueError(f"dimension {n} does not split over {ax} ({parts} ranks)")
            size = n // parts
            i = mesh.axis_index(ax)
            out.append(slice(i * size, (i + 1) * size))
        else:
            out.append(slice(None))
    return tuple(out)


def block_shape(shape, spec, mesh: Mesh) -> tuple:
    """The shape of a rank's block of a tensor of ``shape`` (the same on
    every rank; ``mesh`` may be abstract)."""
    out = []
    for n, ax in zip(shape, _spec_axes(spec, len(shape))):
        parts = mesh.axis_size(ax) if ax else 1
        if n % parts:
            raise ValueError(f"dimension {n} does not split over {ax} ({parts} ranks)")
        out.append(n // parts)
    return tuple(out)


def shard_block(t: torch.Tensor, spec, mesh: Mesh) -> torch.Tensor:
    """This rank's block of the full tensor ``t``, a contiguous copy."""
    return t[block_slices(t.shape, spec, mesh)].clone(memory_format=torch.contiguous_format)


def _gathered(t: torch.Tensor, spec, mesh: Mesh, axes) -> tuple[list, tuple]:
    """(the shape ``t`` grows to when its dimensions split over ``axes`` are
    gathered, the mesh axes those dimensions use)."""
    shape, used = list(t.shape), []
    for i, ax in enumerate(_spec_axes(spec, t.ndim)):
        if not ax:
            continue
        inside = [a for a in ax if a in axes]
        if inside and len(inside) != len(ax):
            raise ValueError(f"dimension {i} is split over {ax}: gather it over all of them or none")
        if inside:
            shape[i] *= mesh.axis_size(ax)
            used += [a for a in ax if a not in used]
    return shape, tuple(used)


def _peers(mesh: Mesh, axes) -> list[Mesh]:
    """This rank's group over ``axes``, each member as a mesh record at its
    own rank (for its block), in the order of its coordinates."""
    names, sizes = mesh.axis_names, tuple(mesh.shape.values())
    out = []
    for sub in itertools.product(*(range(mesh.shape[a]) for a in axes)):
        coords = dict(mesh.coords, **dict(zip(axes, sub)))
        rank = 0
        for a in names:
            rank = rank * mesh.shape[a] + coords[a]
        out.append(Mesh(sizes, names, rank=rank))
    return out


def unshard(t: torch.Tensor, spec, mesh: Mesh, axes=None, *, kind: str = "gather") -> torch.Tensor:
    """The tensor of which ``t`` is this rank's block, gathered along the
    dimensions split over ``axes`` (default: every axis; then the full
    tensor), exactly: each rank of the group over the axes those dimensions
    use broadcasts its block's bytes in turn."""
    axes = tuple(mesh.axis_names) if axes is None else tuple(axes)
    shape, used = _gathered(t, spec, mesh, axes)
    if not used or mesh.axis_size(used) == 1:
        return t
    buf = torch.empty(shape, dtype=t.dtype, device=t.device)
    group, used = mesh.group(used), tuple(a for a in mesh.axis_names if a in used)
    for peer in _peers(mesh, used):
        block = t.contiguous() if peer.rank == mesh.rank else torch.empty(t.shape, dtype=t.dtype, device=t.device)
        raw = block.view(-1).view(torch.uint8)
        _count(kind, "broadcast", mesh, used, raw.numel())
        dist.broadcast(raw, src=peer.rank, group=group)
        buf[block_slices(shape, spec, peer, axes=used)] = block
    return buf


def _one_dim_spec(ndim: int, dim: int, axis: str) -> PartitionSpec:
    dim %= ndim
    return PartitionSpec(*(axis if i == dim else None for i in range(ndim)))


def gather(t: torch.Tensor, dim: int, axis: str, mesh: Mesh) -> torch.Tensor:
    """The blocks of ``t`` over mesh axis ``axis`` concatenated along ``dim``."""
    return unshard(t, _one_dim_spec(t.ndim, dim, axis), mesh, (axis,))


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def psum_over(t: torch.Tensor, axes, mesh: Mesh, *, kind: str, dtype=None, op: str = "sum") -> torch.Tensor:
    """Σ (``op="max"``: the max) of ``t`` over the ranks along ``axes`` (a
    copy, reduced in ``dtype``, default ``t``'s; returned in that dtype)."""
    axes = tuple(a for a in mesh.axis_names if a in ((axes,) if isinstance(axes, str) else axes))
    out = t.to(dtype or t.dtype, copy=True, memory_format=torch.contiguous_format)
    if axes and mesh.axis_size(axes) > 1:
        _count(kind, "all_reduce", mesh, axes, out.numel() * out.element_size())
        dist.all_reduce(out, op=_OPS[op], group=mesh.group(axes))
    return out


def _sum_dtype(dtype, ranks: int):
    """The dtype a sum over ``ranks`` runs in: f32 at least, but a sum of
    two is rounded once to f32 and once to ``dtype`` in either, so pairs
    sum in ``dtype`` (half the bytes, the same bits)."""
    return dtype if ranks <= 2 else torch.promote_types(dtype, torch.float32)


def reduce_scatter(t: torch.Tensor, dim: int, axis: str, mesh: Mesh) -> torch.Tensor:
    """Σ over ``axis`` of ``t`` (in f32 at least, ``_sum_dtype``), this
    rank's block of it along ``dim``, in ``t``'s dtype."""
    total = psum_over(t, (axis,), mesh, kind="reduce_scatter", dtype=_sum_dtype(t.dtype, mesh.axis_size(axis)))
    return total[block_slices(total.shape, _one_dim_spec(t.ndim, dim, axis), mesh)].to(t.dtype)


class _GatherParam(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, spec, mesh, gather_axes, sum_axes):
        ctx.spec, ctx.mesh, ctx.sum_axes = spec, mesh, sum_axes
        _, ctx.used = _gathered(w, spec, mesh, gather_axes)
        out = unshard(w, spec, mesh, gather_axes)
        return out.view_as(out) if out is w else out

    @staticmethod
    def backward(ctx, g):
        dtype = g.dtype
        ranks = ctx.mesh.axis_size(ctx.sum_axes)
        g = psum_over(g, ctx.sum_axes, ctx.mesh, kind="reduce_scatter", dtype=_sum_dtype(dtype, ranks))
        if ctx.used:
            g = g[block_slices(g.shape, ctx.spec, ctx.mesh, axes=ctx.used)]
        return g.to(dtype), None, None, None, None


def gather_param(w: torch.Tensor, spec, mesh: Mesh, *, whole: bool = False) -> torch.Tensor:
    """A weight block ready for use by this rank (ZeRO-3's gather).

    Forward: the dimensions split over the data axes gathered (``whole``:
    the dimensions split over every axis, the full weight).  Backward: the
    gradient summed over the data axes (each data rank saw its own rows),
    then this rank's block of it.  A weight replicated over the data axes
    passes unchanged forward and is still summed backward.  A ``model``
    block gathered ``whole`` is one every model rank uses entirely, so its
    gradient is complete on each and is only cut, never summed, over
    ``model``."""
    dp = dp_axes(mesh)
    gather_axes = tuple(mesh.axis_names) if whole else dp
    return _GatherParam.apply(w, spec, mesh, gather_axes, dp)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh):
        ctx.axis, ctx.mesh = axis, mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return psum_over(g, ctx.axis, ctx.mesh, kind="model_sum"), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh):
        return psum_over(x, axis, mesh, kind="model_sum")

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Pmean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        ctx.axes, ctx.mesh = axes, mesh
        ctx.n = mesh.axis_size(axes)
        return psum_over(x, axes, mesh, kind="mean") / ctx.n

    @staticmethod
    def backward(ctx, g):
        return psum_over(g, ctx.axes, ctx.mesh, kind="mean") / ctx.n, None, None


def copy_to(x: torch.Tensor, mesh: Mesh | None, axis: str = "model") -> torch.Tensor:
    """Megatron's *f*: ``x`` (the same on every rank along ``axis``) entering
    a region where each rank computes its own part; identity forward, the
    sum over ``axis`` backward, so ``x``'s gradient is whole on every rank.
    With no mesh (``None``), or one rank along ``axis``, ``x`` itself."""
    if mesh is None or axis not in mesh.axis_names or mesh.axis_size(axis) == 1:
        return x
    return _CopyTo.apply(x, axis, mesh)


def reduce_from(x: torch.Tensor, mesh: Mesh | None, axis: str = "model") -> torch.Tensor:
    """Megatron's *g*: the sum over ``axis`` of each rank's partial result
    forward; identity backward (the gradient is already the same on every
    rank).  With no mesh (``None``), or one rank along ``axis``, ``x``
    itself."""
    if mesh is None or axis not in mesh.axis_names or mesh.axis_size(axis) == 1:
        return x
    return _ReduceFrom.apply(x, axis, mesh)


def pmean(x: torch.Tensor, mesh: Mesh, axes) -> torch.Tensor:
    """``lax.pmean``: the mean over ``axes`` forward, and of the incoming
    gradients backward."""
    axes = tuple(a for a in mesh.axis_names if a in ((axes,) if isinstance(axes, str) else axes))
    if not axes or mesh.axis_size(axes) == 1:
        return x
    return _Pmean.apply(x, axes, mesh)
