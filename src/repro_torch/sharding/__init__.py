"""Collective plumbing of the port's distributed solve and all-reduce.

The counterpart of ``repro/sharding/__init__.py:shard_map_compat``, the one
helper the reference's distributed solve needs.  JAX wraps a per-shard
function in ``shard_map`` over named mesh axes and sums with ``lax.psum``;
torch code is already SPMD (one process per rank), so what the port needs
is the group to sum over and the sum itself:

- :func:`resolve_group` — the process group of a call: a ``ProcessGroup``
  as given, or :func:`group_for` a ``DeviceMesh`` and axis names, or the
  default group; with none initialized it raises (nothing runs quietly as
  a world of one);
- :func:`group_for` — the group over one or more named dimensions of a
  ``torch.distributed.device_mesh.DeviceMesh`` (``P(axes)`` placement);
- :func:`psum` — ``lax.psum``: an ``all_reduce(SUM)`` on a copy;
- :func:`broadcast_first` — every rank gets the group's first rank's tensor;
- :func:`row_offset` — the global row count and this rank's first row,
  from one ``all_reduce`` of a (world,) vector of row counts.

Only ``all_reduce`` and ``broadcast`` are used: they are the collectives
PyTorch documents gloo as running on CUDA tensors (``all_gather`` is not
among them), so the same code runs over NCCL, over gloo on CUDA tensors
(several ranks on one card) and over gloo on the CPU.  A failed collective
raises; nothing falls back to another backend.

The reference's logical-axis rules (``DEFAULT_RULES``, ``OPT_RULES``,
``logical_to_spec``, ``tree_pspecs``, ``constrain``) belong to the model
stack (ROADMAP A14) and are not here.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["resolve_group", "group_for", "psum", "broadcast_first", "row_offset"]


def group_for(mesh, axes=("data",)):
    """The process group over the named dimension(s) ``axes`` of ``mesh``.

    ``mesh`` is a ``DeviceMesh`` (one or several axes: the ranks that differ
    only along them, as ``P(axes)`` shards rows), a ``ProcessGroup`` (or
    ``None``, the default group), returned as is.
    """
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh):
        return mesh
    if isinstance(axes, str):
        axes = (axes,)
    axes = tuple(axes)
    missing = [a for a in axes if a not in (mesh.mesh_dim_names or ())]
    if missing:
        raise ValueError(f"mesh has axes {mesh.mesh_dim_names}, not {missing}")
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    return mesh[axes]._flatten().get_group()


def resolve_group(group=None, mesh=None, axes=("data",), *, who: str = "this call"):
    """The process group ``who`` sums over: ``group``, else ``group_for(mesh,
    axes)``, else the default group.  Raises when no group is initialized."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            f"{who} needs an initialized torch.distributed process group "
            "(torch.distributed.init_process_group); it does not run as a "
            "world of one without one"
        )
    if group is not None and mesh is not None:
        raise ValueError("pass group= or mesh=, not both")
    if mesh is not None:
        return group_for(mesh, axes)
    return group if group is not None else dist.group.WORLD


def psum(t: torch.Tensor, group=None) -> torch.Tensor:
    """Σ over the group's ranks of ``t`` (``lax.psum``): an ``all_reduce``
    of a contiguous copy, which is returned; ``t`` is untouched.  Every
    rank receives the same bits."""
    out = t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def broadcast_first(t: torch.Tensor, group=None) -> torch.Tensor:
    """``t`` overwritten in place by the group's first rank's ``t`` (same
    shape and dtype on every rank); returned."""
    src = dist.get_global_rank(group, 0) if group not in (None, dist.group.WORLD) else 0
    dist.broadcast(t, src=src, group=group)
    return t


def row_offset(rows: int, group=None, device=None) -> tuple[int, int]:
    """(m, row0): the rows of all ranks and this rank's first global row,
    the ranks' blocks taken in rank order.  One ``all_reduce`` of a (world,)
    int64 vector on ``device`` (the data's: NCCL takes CUDA tensors only)."""
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    counts = torch.zeros(world, dtype=torch.int64, device=device)
    counts[rank] = int(rows)
    dist.all_reduce(counts, op=dist.ReduceOp.SUM, group=group)
    counts = counts.tolist()
    return sum(counts), sum(counts[:rank])
