"""repro_torch.train — the port of ``repro.train``: the atomic checkpoint
store (sharded saves and restores onto a mesh), the train and serve steps
(one process, data-parallel over a ``torch.distributed`` group with the
CountSketch-compressed all-reduce, and FSDP × TP over a mesh of ranks),
the training loop, greedy generation and elastic restore."""
from . import checkpoint, elastic, loop, serve, step
from .checkpoint import AsyncCheckpointer, latest_step, restore, save
from .elastic import rebalance_microbatch, restore_elastic
from .loop import train_loop
from .serve import generate
from .step import (
    TrainState,
    batch_pspec,
    init_sharded_state,
    init_train_state,
    jit_train_step,
    make_decode_step,
    make_dp_train_step,
    make_prefill_step,
    make_train_step,
    shard_state,
    state_pspecs,
    state_shapes,
)

__all__ = [
    "checkpoint", "elastic", "loop", "serve", "step",
    "AsyncCheckpointer", "latest_step", "restore", "save",
    "rebalance_microbatch", "restore_elastic", "train_loop", "generate",
    "TrainState", "batch_pspec", "init_sharded_state", "init_train_state", "jit_train_step", "make_decode_step",
    "make_dp_train_step", "make_prefill_step", "make_train_step", "shard_state", "state_pspecs",
    "state_shapes",
]
