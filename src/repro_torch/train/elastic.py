"""Elastic scaling: restoring onto another mesh, and the micro-batch count
that keeps the global batch.

Port of ``repro/train/elastic.py``.  Checkpoints hold unsharded host arrays
(``train/checkpoint.py``; a sharded state is assembled leaf by leaf as it is
saved), so a restart restores onto whatever mesh the surviving ranks form:
``restore_elastic`` gives each rank its blocks under the new mesh's
``state_pspecs`` (any factorization whose axis sizes divide the weight
dims; a mapping that does not divide is replicated, as the rules say).  The
data stream is stateless-indexable (``data.batch_at(step)``), so it resumes
bit for bit; when the data-parallel world changes, the global batch is
held by scaling the micro-batch count inversely (``rebalance_microbatch``).
"""
from __future__ import annotations

from ..configs.base import ModelConfig
from ..models.common import tree_map
from ..sharding import NamedSharding, PartitionSpec
from . import checkpoint as ckpt_lib
from .step import state_pspecs, state_shapes

__all__ = ["restore_elastic", "rebalance_microbatch"]


def restore_elastic(ckpt_dir: str, cfg: ModelConfig, mesh, step: int | None = None, rules=None, *, device=None):
    """Restore a ``TrainState`` checkpoint onto ``mesh`` (a ``sharding.Mesh``
    over the current world): each rank gets its blocks, on ``device``
    (``None``: the card).  Returns ``(state, step)``."""
    shardings = tree_map(lambda s: NamedSharding(mesh, s), state_pspecs(cfg, mesh, rules),
                         is_leaf=lambda x: isinstance(x, PartitionSpec))
    return ckpt_lib.restore(ckpt_dir, state_shapes(cfg), step=step, shardings=shardings, device=device)


def rebalance_microbatch(global_batch: int, old_dp: int, new_dp: int, old_micro: int) -> int:
    """Keep the global batch fixed when the DP world size changes.

    per-device batch = global/(dp·micro); hold global fixed by scaling the
    microbatch count inversely with dp.
    """
    total_micro_tokens = global_batch // old_dp // old_micro
    new_micro = max(1, global_batch // new_dp // max(total_micro_tokens, 1))
    while global_batch % (new_dp * new_micro):
        new_micro += 1
    return new_micro
