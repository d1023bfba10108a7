"""Sharding: the reference's logical-axis rules, the port's mesh record and
the collective plumbing of the distributed solve and the mesh train step.

The counterpart of ``repro/sharding/__init__.py``.

*The rules* (``DEFAULT_RULES``, ``OPT_RULES``, ``logical_to_spec``,
``tree_pspecs``, ``named_sharding``) are the reference's, copied verbatim:
parameters and activations carry logical axis names, a rules table maps
them to mesh axes, a mapping whose mesh-axis product does not divide the
dimension is dropped, and an expert weight whose expert count does not
divide the ``model`` axis is sharded over its expert FFN dim instead.  A
spec is a :class:`PartitionSpec`: one entry a dimension, ``None``, a mesh
axis name or a tuple of them.

*The mesh* (:class:`Mesh`) is the port's own record of a named grid of
ranks: its shape, and, when built over an initialized world
(``launch.mesh.make_mesh``), this rank's coordinates and one process group
for every set of axes (the ranks that differ only along them).  A mesh
with no world (``Mesh(shape, axes)``) serves ``logical_to_spec`` alone.
``use_mesh(mesh)`` is the counterpart of ``with mesh:`` and
``current_mesh()`` of the reference's thread-resources lookup: under it the
model functions take each rank's blocks and its own rows of the batch.
``constrain`` is the identity: each rank already holds its own block, so
there is no layout to annotate.

*The plumbing* of the distributed solve:

- :func:`resolve_group` — the process group of a call: a ``ProcessGroup``
  as given, or :func:`group_for` a mesh and axis names, or the default
  group; with none initialized it raises (nothing runs quietly as a world
  of one);
- :func:`group_for` — the group over one or more named axes of a
  :class:`Mesh` or a ``torch.distributed.device_mesh.DeviceMesh``;
- :func:`psum` — ``lax.psum``: an ``all_reduce(SUM)`` on a copy;
- :func:`broadcast_first` — every rank gets the group's first rank's tensor;
- :func:`row_offset` — the global row count and this rank's first row,
  from one ``all_reduce`` of a (world,) vector of row counts.

Block placement and the autograd collectives of the mesh step are in
``sharding.collectives``.  Only ``all_reduce`` and ``broadcast`` are used:
they are the collectives PyTorch documents gloo as running on CUDA tensors
(``all_gather`` is not among them), so the same code runs over NCCL, over
gloo on CUDA tensors (several ranks on one card) and over gloo on the CPU.
A failed collective raises; nothing falls back to another backend.
"""
from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import torch
import torch.distributed as dist

__all__ = [
    "DEFAULT_RULES",
    "OPT_RULES",
    "PartitionSpec",
    "Mesh",
    "NamedSharding",
    "logical_to_spec",
    "named_sharding",
    "tree_pspecs",
    "constrain",
    "use_mesh",
    "current_mesh",
    "current_rules",
    "resolve_group",
    "group_for",
    "psum",
    "broadcast_first",
    "row_offset",
]

# logical axis -> physical mesh axis (or tuple of axes), None = replicated
DEFAULT_RULES: dict[str, object] = {
    # activations
    "batch": ("pod", "data"),
    "seq": None,
    "act_embed": None,
    "act_heads": "model",
    "act_ff": "model",
    "act_experts": "model",
    "cap": ("pod", "data"),
    "cache_seq": "model",  # decode KV caches: sequence-sharded over TP
    # weights
    "embed": "data",  # FSDP dim of every weight
    "vocab": "model",
    "heads": "model",
    "kv_heads": None,  # GQA kv count < model axis -> replicate
    "mlp": "model",
    "experts": "model",
    "expert_mlp": None,
    "rnn": "model",
    "inner": "model",  # ssm d_inner
    "layers": None,
    "head_dim": None,
    "state": None,
    "conv": None,
    "lora": None,
    "patches": None,
    None: None,
}


# Optimizer-state rules: ZeRO-1 — master/m/v additionally sharded over the
# pod axis via the weights' embed dim (on single-pod meshes 'pod' is absent
# and this degenerates to DEFAULT_RULES).
OPT_RULES = dict(DEFAULT_RULES)
OPT_RULES["embed"] = ("pod", "data")


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``: one entry a dimension — ``None``
    (replicated), a mesh axis name, or a tuple of names (the dimension
    split over their product, the first axis major)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"

    def axes(self, i: int) -> tuple:
        """The mesh axes dimension ``i`` is split over (``()`` past the end)."""
        e = self[i] if i < len(self) else None
        return () if e is None else (e,) if isinstance(e, str) else tuple(e)


class Mesh:
    """A named grid of ranks (row-major: rank r sits at the coordinates of r
    in ``shape``, as ``jax.make_mesh`` lays out devices in order).

    ``Mesh(shape, axes)`` is abstract: names and sizes, for
    ``logical_to_spec``.  ``launch.mesh.make_mesh`` builds one over the
    initialized world with ``groups``: this rank's coordinates and a
    process group for every set of axes."""

    def __init__(self, shape, axis_names, *, rank=None, groups=None):
        shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
        if len(shape) != len(axis_names) or len(set(axis_names)) != len(axis_names):
            raise ValueError(f"mesh shape {shape} and axes {axis_names} do not match")
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, shape))  # name -> size, as JAX's Mesh.shape
        self.rank = rank
        self.coords = None if rank is None else dict(zip(axis_names, _unravel(rank, shape)))
        self._groups = groups

    def __repr__(self):
        return f"Mesh({self.shape})"

    def axis_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in _as_axes(axes))

    def axis_index(self, axes) -> int:
        """This rank's flattened coordinate over ``axes`` (the first major)."""
        if self.coords is None:
            raise ValueError("an abstract mesh has no rank")
        idx = 0
        for a in _as_axes(axes):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def group(self, axes):
        """The process group over ``axes``: the ranks that differ only along
        them (of this rank alone where they hold one)."""
        if self._groups is None:
            raise ValueError("an abstract mesh has no process groups (launch.mesh.make_mesh builds them)")
        axes = _as_axes(axes)
        missing = [a for a in axes if a not in self.shape]
        if missing:
            raise ValueError(f"mesh has axes {self.axis_names}, not {missing}")
        return self._groups[tuple(a for a in self.axis_names if a in axes)]


def _as_axes(axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _unravel(r: int, shape) -> tuple:
    out = []
    for s in reversed(shape):
        out.append(r % s)
        r //= s
    return tuple(reversed(out))


class NamedSharding(NamedTuple):
    """``jax.sharding.NamedSharding``: a spec on a mesh."""

    mesh: Mesh
    spec: PartitionSpec


def logical_to_spec(axes: tuple, mesh, rules=None, shape=None) -> PartitionSpec:
    """Map a tuple of logical axis names to a PartitionSpec on ``mesh``.

    If ``shape`` is given, any mapping whose mesh-axis product does not
    divide the dimension is dropped (replicated) — e.g. batch=1 long-context
    decode, or vocab sizes not divisible by the model axis.
    """
    rules = rules or DEFAULT_RULES
    mesh_axes = set(mesh.axis_names)
    sizes = dict(mesh.shape)
    out = []
    for i, ax in enumerate(axes):
        phys = rules.get(ax, None)
        if phys is None:
            out.append(None)
            continue
        if not isinstance(phys, tuple):
            phys = (phys,)
        present = tuple(a for a in phys if a in mesh_axes)
        if shape is not None and present:
            prod = 1
            for a in present:
                prod *= sizes[a]
            if prod == 0 or shape[i] % prod:
                present = ()
        if not present:
            out.append(None)
        elif len(present) == 1:
            out.append(present[0])
        else:
            out.append(present)

    # Expert-weight fallback: when the expert count does not divide the
    # model axis (e.g. mixtral's 8 experts on 16-way TP), shard the expert
    # FFN dim over 'model' instead — otherwise MoE weights (and their
    # optimizer state) end up replicated across the whole TP axis.
    if shape is not None and "experts" in axes and "model" in mesh_axes:
        e_dim = axes.index("experts")
        if out[e_dim] != "model" and "expert_mlp" in axes:
            f_dim = axes.index("expert_mlp")
            if out[f_dim] is None and shape[f_dim] % sizes["model"] == 0:
                out[f_dim] = "model"
    return PartitionSpec(*out)


def named_sharding(axes: tuple, mesh, rules=None) -> NamedSharding:
    return NamedSharding(mesh, logical_to_spec(axes, mesh, rules))


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and not isinstance(x, PartitionSpec) and all(
        isinstance(a, (str, type(None))) for a in x)


def tree_pspecs(axes_tree, mesh, rules=None, shapes_tree=None):
    """Map a tree of logical-axis tuples to PartitionSpecs.

    ``shapes_tree``: optional matching tree of ``(shape, dtype)`` leaves (or
    tensors) for divisibility-aware mapping.
    """
    from ..models.common import tree_map

    if shapes_tree is None:
        return tree_map(lambda axes: logical_to_spec(axes, mesh, rules), axes_tree, is_leaf=_is_axes)
    return tree_map(lambda axes, sh: logical_to_spec(axes, mesh, rules, shape=_shape_of(sh)),
                    axes_tree, shapes_tree, is_leaf=_is_axes)


def _shape_of(x) -> tuple:
    return tuple(x.shape) if hasattr(x, "shape") else tuple(x[0])


# process-wide, not a thread's: on the card the autograd engine runs the
# backward pass, and the recomputation of a checkpointed period, on a thread
# of its own, which must see the step's mesh
_MESHES: list = []


@contextlib.contextmanager
def use_mesh(mesh, rules=None):
    """``with mesh:``: within it ``current_mesh()`` is ``mesh`` (and
    ``current_rules()`` the rules its specs come from), for every thread of
    the process."""
    _MESHES.append((mesh, rules))
    try:
        yield mesh
    finally:
        _MESHES.pop()


def current_mesh():
    """The mesh of the innermost ``use_mesh``, or ``None``."""
    return _MESHES[-1][0] if _MESHES else None


def current_rules():
    """The rules of the innermost ``use_mesh`` (``None``: the defaults)."""
    return _MESHES[-1][1] if _MESHES else None


def constrain(x: torch.Tensor, axes: tuple, mesh=None, rules=None) -> torch.Tensor:
    """``with_sharding_constraint`` by logical axes: the identity.  Under a
    mesh every rank already holds its own block of each tensor (the model
    functions place and gather explicitly), so there is no layout left to
    annotate."""
    return x


def group_for(mesh, axes=("data",)):
    """The process group over the named dimension(s) ``axes`` of ``mesh``.

    ``mesh`` is a :class:`Mesh` or a ``DeviceMesh`` (one or several axes:
    the ranks that differ only along them, as ``P(axes)`` shards rows), a
    ``ProcessGroup`` (or ``None``, the default group), returned as is.
    """
    from torch.distributed.device_mesh import DeviceMesh

    if isinstance(mesh, Mesh):
        return mesh.group(axes)
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
