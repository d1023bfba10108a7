"""Meshes of ranks, and the card's constants.

Port of ``repro/launch/mesh.py``.  The reference lays a mesh over JAX
devices; the port's mesh is a grid over the ranks of the initialized
``torch.distributed`` world (one process a rank), recorded by
``sharding.Mesh``: the shape, the axis names, this rank's coordinates and
one process group for every set of axes.  The port keeps its own record
rather than a ``DeviceMesh``: a ``DeviceMesh`` is bound to one device type
and flattens several axes only through a private call, while the mesh step
needs groups over any set of axes for ranks that may share one card
(gloo) or hold one each (NCCL).  ``sharding.group_for`` takes either.

Defined as functions (not module constants) so importing never touches the
process group.  Production shapes are the reference's: 16×16 ranks a pod,
2 pods for the multi-pod layout.
"""
from __future__ import annotations

import itertools
import math

import torch.distributed as dist

from ..sharding import Mesh

__all__ = ["make_production_mesh", "make_mesh", "HW"]


# NVIDIA H100 SXM5 80GB constants (NVIDIA's data sheet) for the roofline
# model; the rates hold at the card's full 700 W power limit.
HW = {
    "peak_flops_bf16": 989e12,  # dense bf16 tensor-core ops/s, H100 SXM5 80GB at 700 W
    "hbm_bw": 3.35e12,  # bytes/s of HBM3, H100 SXM5 80GB at 700 W
    "nvlink_bw": 450e9,  # bytes/s a direction a card (NVLink 4, 18 links), H100 SXM5 80GB at 700 W
    "hbm_bytes": 80e9,  # capacity a card, H100 SXM5 80GB
}


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_mesh(shape, axes) -> Mesh:
    """A mesh of ``shape`` named ``axes`` over the initialized world (rank r
    at r's row-major coordinates).  Every rank calls it, in the same order
    as its other collectives: it creates one group a set of axes and a
    slice (``torch.distributed.new_group``, a collective).  Raises when no
    world is initialized or its size is not the mesh's."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    n = math.prod(shape)
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(f"make_mesh{shape} needs an initialized torch.distributed process group")
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != n:
        raise RuntimeError(f"need {n} ranks for mesh {shape}, the world has {world}")
    record = Mesh(shape, axes)
    groups = {}
    for k in range(1, len(axes) + 1):
        for sub in itertools.combinations(axes, k):
            rest = [a for a in axes if a not in sub]
            for fixed in itertools.product(*(range(record.shape[a]) for a in rest)):
                members = sorted(
                    r for r in range(n)
                    if all(Mesh(shape, axes, rank=r).coords[a] == c for a, c in zip(rest, fixed)))
                group = dist.group.WORLD if len(members) == n else dist.new_group(members)
                if rank in members:
                    groups[sub] = group
    return Mesh(shape, axes, rank=rank, groups=groups)
