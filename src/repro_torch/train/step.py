"""Train and serve step factories.

Port of ``repro/train/step.py``:

``make_train_step`` — one process: value and gradient of ``loss_fn`` by
autograd, micro-batch accumulation in ``cfg.grad_accum_dtype``, the f32
AdamW update, and the parameters cast from the f32 master after it.

``make_dp_train_step`` — pure data parallelism over a ``torch.distributed``
group: every rank holds the whole state and passes its own rows of the
batch; the loss is averaged over the group, and the gradients are the
group's mean (``compression=None``) or go through the CountSketch-compressed
all-reduce (``optim.sketched_psum_grads``, kernel B1 sketching each large
gradient on the card) with an error-feedback tree.  The reference's
``shard_map`` over a mesh becomes the group (``group=``, else the
default group); with no group initialized it raises.

``make_prefill_step`` / ``make_decode_step`` — serving entry points.

A step updates the state it is given in place (the reference's state is
donated to its jitted step) and returns it as the new state with the step
counter advanced; the counter is a host int32 scalar.  The 2-D FSDP/TP
placement (``state_pspecs``, ``batch_pspec``, ``jit_train_step``) belongs to
the second half of the ML stack (ROADMAP A14b).

On the card, the factories turn off TF32 and reduced-precision bf16
reductions in matrix products (``torch.backends.cuda.matmul``, a
process-wide setting), so f32 products run in f32 and bf16 products
accumulate in f32, as the reference's do.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.distributed as dist

from .. import sharding
from ..configs.base import ModelConfig
from ..models import transformer as tfm
from ..models.common import DTYPES, is_shape, tree_get, tree_map, tree_paths, tree_rebuild
from ..optim import AdamWConfig, CompressionConfig, adamw_init, adamw_update, sketched_psum_grads

__all__ = [
    "TrainState",
    "init_train_state",
    "state_shapes",
    "set_matmul_precision",
    "make_train_step",
    "make_dp_train_step",
    "make_prefill_step",
    "make_decode_step",
]


class TrainState(NamedTuple):
    step: torch.Tensor  # 0-d int32 on the host: the updates taken so far
    params: Any
    opt: Any


def set_matmul_precision():
    """Full-precision accumulation in the card's matrix products: no TF32 for
    f32, no reduced-precision reductions for bf16 (process-wide)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def init_train_state(cfg: ModelConfig, key, *, device=None) -> TrainState:
    """Step 0: parameters drawn from ``key`` (a generator or an int seed)
    and held as the ``nn.Parameter``s of a ``Transformer``, an f32 master,
    zero moments."""
    params = tfm.Transformer(cfg, key=key, device=device).params()
    opt = adamw_init(params, moments_dtype=DTYPES[cfg.opt_moments_dtype])
    return TrainState(step=torch.zeros((), dtype=torch.int32), params=params, opt=opt)


def state_shapes(cfg: ModelConfig) -> TrainState:
    """The state's ``(shape, dtype)`` leaves (restore targets), with nothing
    allocated."""
    shapes = tfm.params_shapes(cfg)
    moments = DTYPES[cfg.opt_moments_dtype]

    def recast(dtype):
        return tree_map(lambda s: (s[0], dtype), shapes, is_leaf=is_shape)

    return TrainState(step=((), torch.int32), params=shapes,
                      opt={"master": recast(torch.float32), "m": recast(moments), "v": recast(moments)})


def _loss_and_grads(cfg: ModelConfig, params, batch):
    """(loss, gradient tree) of ``loss_fn`` at ``params``; the gradients are
    in each parameter's dtype."""
    paths = list(tree_paths(params))
    leaves = [tree_get(params, p).detach().requires_grad_() for p in paths]
    loss, _ = tfm.loss_fn(cfg, tree_rebuild(params, dict(zip(paths, leaves)), torch.is_tensor), batch)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree_rebuild(params, dict(zip(paths, grads)), torch.is_tensor)


def _microbatches(batch, n_micro: int):
    """(B, ...) -> n_micro batches of B/n_micro rows, in row order."""
    B = next(iter(batch.values())).shape[0]
    if B % n_micro:
        raise ValueError(f"a batch of {B} rows does not split into {n_micro} micro-batches")
    rows = B // n_micro
    return [{k: v[i * rows:(i + 1) * rows] for k, v in batch.items()} for i in range(n_micro)]


def _apply_update(opt_cfg: AdamWConfig, state: TrainState, grads, loss):
    """AdamW on ``state`` in place, the parameters cast from the new master."""
    new_opt, om = adamw_update(opt_cfg, grads, state.opt, state.step)
    with torch.no_grad():
        tree_map(lambda p, m: p.copy_(m), state.params, new_opt["master"])
    return TrainState(step=state.step + 1, params=state.params, opt=new_opt), {"loss": loss, **om}


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, *, n_micro: int = 1):
    """Returns ``train_step(state, batch) -> (state, metrics)``; metrics
    ``loss`` and ``grad_norm`` are 0-d tensors, ``lr`` a float."""
    set_matmul_precision()
    acc_dtype = DTYPES[cfg.grad_accum_dtype]

    def train_step(state: TrainState, batch):
        if n_micro == 1:
            loss, grads = _loss_and_grads(cfg, state.params, batch)
        else:
            grads = loss = None
            for mb in _microbatches(batch, n_micro):
                l, g = _loss_and_grads(cfg, state.params, mb)
                if grads is None:
                    grads, loss = tree_map(lambda b: b.to(acc_dtype), g), l
                else:
                    tree_map(lambda a, b: a.add_(b.to(a.dtype)), grads, g)
                    loss = loss + l
            tree_map(lambda g: g.div_(n_micro), grads)  # in place: the accumulator is the step's own
            loss = loss / n_micro
        return _apply_update(opt_cfg, state, grads, loss)

    return train_step


def make_dp_train_step(
    cfg: ModelConfig,
    opt_cfg: AdamWConfig,
    group=None,
    *,
    compression: CompressionConfig | None = None,
):
    """Data-parallel train step over a process group: every rank calls
    ``step(state, ef, batch) -> ((state, ef), metrics)`` with the whole
    (replicated) state, its error-feedback tree (``None`` without
    compression) and its own rows of the batch.

    ``group``: a ``ProcessGroup``, or ``None`` for the default group;
    raises when no group is initialized.  Gradients are combined with an all-reduce mean or, when
    ``compression`` is given, with the CountSketch-compressed all-reduce and
    error feedback (a fresh sketch a step: the step counter is its ``step``).
    """
    set_matmul_precision()
    group = sharding.resolve_group(group, who="make_dp_train_step")
    n = dist.get_world_size(group)

    def step(state: TrainState, ef, batch):
        loss, grads = _loss_and_grads(cfg, state.params, batch)
        loss = sharding.psum(loss, group) / n
        if compression is None:
            grads = tree_map(lambda g: sharding.psum(g, group) / n, grads)
            new_ef = ef
        else:
            grads, new_ef = sketched_psum_grads(compression, grads, ef, group, step=int(state.step))
        new_state, metrics = _apply_update(opt_cfg, state, grads, loss)
        return (new_state, new_ef), metrics

    return step


# ===========================================================================
# Serving steps
# ===========================================================================


def make_prefill_step(cfg: ModelConfig):
    set_matmul_precision()

    def prefill_step(params, batch):
        return tfm.prefill(cfg, params, batch)

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    set_matmul_precision()

    def decode_step(params, cache, tokens, step, embeds=None):
        return tfm.decode_step(cfg, params, cache, tokens, step, embeds=embeds)

    return decode_step
