"""repro_torch.train — the port of ``repro.train``: the atomic checkpoint
store, the train and serve steps (one process, and data-parallel over a
``torch.distributed`` group with the CountSketch-compressed all-reduce),
the training loop, greedy generation and the elastic micro-batch rule."""
from . import checkpoint, elastic, loop, serve, step
from .checkpoint import AsyncCheckpointer, latest_step, restore, save
from .elastic import rebalance_microbatch
from .loop import train_loop
from .serve import generate
from .step import (
    TrainState,
    init_train_state,
    make_decode_step,
    make_dp_train_step,
    make_prefill_step,
    make_train_step,
    state_shapes,
)

__all__ = [
    "checkpoint", "elastic", "loop", "serve", "step",
    "AsyncCheckpointer", "latest_step", "restore", "save",
    "rebalance_microbatch", "train_loop", "generate",
    "TrainState", "init_train_state", "make_decode_step", "make_dp_train_step",
    "make_prefill_step", "make_train_step", "state_shapes",
]
