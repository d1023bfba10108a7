"""repro_torch.cluster — fault-tolerant out-of-core solving across a worker pool.

Port of ``repro.cluster``.  Four layers (each module's docstring has the
full contract):

- ``shard``       row-range partitioning, ownership, reassignment
- ``checkpoint``  mid-pass accumulator save/restore (bitwise resume)
- ``faults``      deterministic kill/delay/duplicate injection
- ``coordinator`` the worker pool + recovery driver (``ClusterEngine``)

Entry points: build a :class:`ClusterSpec` and hand it to
``repro_torch.lstsq(A, b, gen, cluster=spec)``,
``stream_lstsq(source, b, gen, cluster=spec)`` or
``StreamingSolver(source, gen, cluster=spec)``.
"""
from .checkpoint import (
    CheckpointMismatch,
    latest_watermark,
    op_digest,
    pass_namespace,
    restore_accumulator,
    save_accumulator,
)
from .coordinator import ClusterEngine, ClusterFailure, ClusterSpec
from .faults import (
    DelayWorker,
    DuplicateMerge,
    FaultPlan,
    KillWorker,
    WorkerKilled,
)
from .shard import (
    OwnershipMap,
    RowRange,
    RowRangeSource,
    partition_rows,
    split_range,
)

__all__ = [
    "ClusterSpec",
    "ClusterEngine",
    "ClusterFailure",
    "RowRange",
    "OwnershipMap",
    "RowRangeSource",
    "partition_rows",
    "split_range",
    "op_digest",
    "pass_namespace",
    "save_accumulator",
    "restore_accumulator",
    "latest_watermark",
    "CheckpointMismatch",
    "FaultPlan",
    "KillWorker",
    "DelayWorker",
    "DuplicateMerge",
    "WorkerKilled",
]
