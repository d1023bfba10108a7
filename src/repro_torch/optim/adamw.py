"""AdamW with f32 master weights and moments, decoupled weight decay,
global-norm clipping and a linear-warmup cosine schedule.

Port of ``repro/optim/adamw.py``: the same update, leaf by leaf in f32.
The state is the reference's ``{"master", "m", "v"}`` of trees shaped like
the parameters.  ``adamw_update`` writes the new state into the given one
(the reference's functional update with the state donated) and returns it,
so a step holds one state and one leaf's temporaries.  The reference's
``chunked_update_numel`` (a ``lax.map`` chunking, off by default) has no
counterpart.

The learning rate is a host float (f64 arithmetic); the bias corrections
1 − β^t are f32, as the reference computes them; the clipping scale stays on
the gradients' device, so an update never waits for the device.

On a mesh (``specs=``, ``mesh=``: each rank holds blocks of the gradients
and of the state) the update is the same, block by block; only the global
norm needs the other ranks: each leaf's squared norm is summed over the
axes its spec splits it on, so a replicated leaf counts once.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..models.common import tree_leaves, tree_map

__all__ = ["AdamWConfig", "lr_at", "adamw_init", "global_norm", "adamw_update", "cast_params"]


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


def lr_at(cfg: AdamWConfig, step) -> float:
    """Linear warmup to ``cfg.lr``, then cosine decay to ``min_lr_ratio``."""
    step = float(step)
    warm = min(step / max(cfg.warmup_steps, 1), 1.0)
    prog = min(max((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0), 1.0)
    cos = 0.5 * (1 + math.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def adamw_init(params, moments_dtype=torch.float32) -> dict:
    """(master f32 copy, m, v), each on its parameter's device; the master
    is a copy even when the parameters are f32."""
    return {
        "master": tree_map(lambda p: p.detach().to(torch.float32, copy=True), params),
        "m": tree_map(lambda p: torch.zeros(p.shape, dtype=moments_dtype, device=p.device), params),
        "v": tree_map(lambda p: torch.zeros(p.shape, dtype=moments_dtype, device=p.device), params),
    }


def global_norm(tree, specs=None, mesh=None) -> torch.Tensor:
    """√Σ g² over the tree's leaves in flatten order, in f32.

    With ``specs`` (a matching tree of ``PartitionSpec``s) and ``mesh``, the
    leaves are this rank's blocks: the squared norms of the leaves split
    over the same axes are added, then summed over those axes (one
    ``all_reduce`` a set of axes, in mesh order); a leaf replicated on an
    axis is counted once, not once a rank."""
    if mesh is None:
        total = None
        for g in tree_leaves(tree):
            sq = g.float().square().sum()
            total = sq if total is None else total + sq
        return total.sqrt()
    from ..sharding import PartitionSpec
    from ..sharding.collectives import psum_over

    by_axes = {}
    for g, spec in zip(tree_leaves(tree), tree_leaves(specs, is_leaf=lambda s: isinstance(s, PartitionSpec))):
        axes = tuple(a for a in mesh.axis_names if any(a in spec.axes(i) for i in range(g.ndim)))
        sq = g.float().square().sum()
        by_axes[axes] = sq if axes not in by_axes else by_axes[axes] + sq
    total = None
    for axes in sorted(by_axes, key=lambda ax: [mesh.axis_names.index(a) for a in ax]):
        part = psum_over(by_axes[axes], axes, mesh, kind="norm")
        total = part if total is None else total + part
    return total.sqrt()


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads, opt_state, step, *, specs=None, mesh=None):
    """One AdamW update at ``step`` (the count of updates before it).

    Writes the new master, m and v into ``opt_state`` and returns
    ``(opt_state, {"grad_norm", "lr"})``; ``grad_norm`` is a 0-d tensor on
    the gradients' device.  ``specs``/``mesh``: the gradients and the state
    are this rank's blocks (``global_norm``).
    """
    step = int(step)
    gnorm = global_norm(grads, specs, mesh)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = lr_at(cfg, step)
    t = np.float32(step + 1)
    bc1 = float(np.float32(1) - np.float32(cfg.b1) ** t)
    bc2 = float(np.float32(1) - np.float32(cfg.b2) ** t)
    for g, master, m, v in zip(*(tree_leaves(x) for x in (grads, opt_state["master"], opt_state["m"],
                                                             opt_state["v"]))):
        # the reference's arithmetic, step by step, in place where a buffer
        # is free: at most four leaf-sized temporaries live at once
        g = g.float() * scale
        m32 = m if m.dtype == torch.float32 else m.float()
        m32.mul_(cfg.b1).add_(g * (1 - cfg.b1))  # b1·m + (1 − b1)·g
        v32 = v if v.dtype == torch.float32 else v.float()
        v32.mul_(cfg.b2).add_((g * (1 - cfg.b2)).mul_(g))  # b2·v + (1 − b2)·g·g
        del g
        update = m32 / bc1
        update.div_((v32 / bc2).sqrt_().add_(cfg.eps))  # (m/bc1) / (√(v/bc2) + eps)
        master.sub_(update.add_(cfg.weight_decay * master).mul_(lr))  # master − lr·(update + wd·master)
        if m32 is not m:
            m.copy_(m32)
            v.copy_(v32)
    return opt_state, {"grad_norm": gnorm, "lr": lr}


def cast_params(opt_state, dtype):
    return tree_map(lambda p: p.to(dtype), opt_state["master"])
