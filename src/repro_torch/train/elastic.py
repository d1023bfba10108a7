"""Elastic scaling: the micro-batch count that keeps the global batch.

Port of ``rebalance_microbatch`` from ``repro/train/elastic.py``.  A
restart reads the latest checkpoint (``train/checkpoint.py``) and the data
stream is stateless-indexable (``data.batch_at(step)``), so it resumes bit
for bit; when the data-parallel world changes, the global batch is held by
scaling the micro-batch count inversely.  Restoring onto another mesh
(``restore_elastic``, ``restore(shardings=)``) belongs to the second half of
the ML stack (ROADMAP A14b).
"""
from __future__ import annotations

__all__ = ["rebalance_microbatch"]


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
