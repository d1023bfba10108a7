"""Train and serve step factories.

Port of ``repro/train/step.py``:

``make_train_step`` — one process: value and gradient of ``loss_fn`` by
autograd, micro-batch accumulation in ``cfg.grad_accum_dtype``, the f32
AdamW update, and the parameters cast from the f32 master after it.

``jit_train_step`` — the reference's FSDP × TP step over a mesh of ranks
(``sharding.Mesh``, ``launch.mesh.make_mesh``): every rank calls it with
its blocks of the state (``state_pspecs``, ``shard_state``) and its rows of
the batch (``batch_pspec``).  Inside ``loss_fn`` each layer gathers its
weights over ``data`` as it runs and the tensor-parallel modules sum over
``model`` (``sharding.collectives``); the backward pass reduce-scatters
each weight's gradient to its block.  Micro-batches are accumulated in
``cfg.grad_accum_dtype``, the gradients are the mean over the data axes,
AdamW runs on the optimizer's blocks with the global norm summed over the
shards, and the loss is the mean over the data axes (the same on every
rank).  On a mesh with a ``pod`` axis the optimizer state is split further
than the parameters (ZeRO-1, ``OPT_RULES``): each gradient block is moved
to the optimizer's block before the update and each new parameter block
rebuilt from the optimizer's blocks after it
(``collectives.reshard``).

``make_dp_train_step`` — pure data parallelism over a ``torch.distributed``
group: every rank holds the whole state and passes its own rows of the
batch; the loss is averaged over the group, and the gradients are the
group's mean (``compression=None``) or go through the CountSketch-compressed
all-reduce (``optim.sketched_psum_grads``, kernel B1 sketching each large
gradient on the card) with an error-feedback tree.  The reference's
``shard_map`` over a mesh becomes the group (``group=``, or ``mesh=`` and
``axes=`` through ``sharding.group_for``, else the default group); with no
group initialized it raises.

``make_prefill_step`` / ``make_decode_step`` — serving entry points, on one
process or (``mesh=``) on each rank's blocks, rows and caches.

A step updates the state it is given in place (the reference's state is
donated to its jitted step) and returns it as the new state with the step
counter advanced; the counter is a host int32 scalar.

On the card, the factories turn off TF32 and reduced-precision bf16
reductions in matrix products (``torch.backends.cuda.matmul``, a
process-wide setting), so f32 products run in f32 and bf16 products
accumulate in f32, as the reference's do.
"""
from __future__ import annotations

import contextlib
from typing import Any, NamedTuple

import torch
import torch.distributed as dist

from .. import sharding
from ..configs.base import ModelConfig
from ..models import transformer as tfm
from ..models.common import DTYPES, is_shape, tree_get, tree_leaves, tree_map, tree_paths, tree_rebuild
from ..optim import AdamWConfig, CompressionConfig, adamw_init, adamw_update, sketched_psum_grads
from ..sharding import OPT_RULES, PartitionSpec, collectives, logical_to_spec, tree_pspecs

__all__ = [
    "TrainState",
    "init_train_state",
    "state_shapes",
    "state_pspecs",
    "batch_pspec",
    "shard_state",
    "init_sharded_state",
    "set_matmul_precision",
    "make_train_step",
    "jit_train_step",
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


def state_pspecs(cfg: ModelConfig, mesh, rules=None) -> TrainState:
    """The state's specs on ``mesh``: the parameters under ``rules`` (default
    ``DEFAULT_RULES``), the master and the moments under ``OPT_RULES``
    (ZeRO-1: the ``embed`` dimension split over ``("pod", "data")``, where
    the parameters split it over ``data``) unless ``rules`` is given.  On a
    mesh with no ``pod`` axis the two agree."""
    axes = tfm.params_axes(cfg)
    shapes = tfm.params_shapes(cfg)
    pspecs = tree_pspecs(axes, mesh, rules, shapes_tree=shapes)
    ospecs = tree_pspecs(axes, mesh, rules or OPT_RULES, shapes_tree=shapes)
    return TrainState(step=PartitionSpec(), params=pspecs, opt={"master": ospecs, "m": ospecs, "v": ospecs})


def batch_pspec(mesh, rules=None) -> PartitionSpec:
    return logical_to_spec(("batch", "seq"), mesh, rules)


def _is_spec(x) -> bool:
    return isinstance(x, PartitionSpec)


def shard_state(cfg: ModelConfig, state: TrainState, mesh, rules=None, *, device=None) -> TrainState:
    """This rank's blocks of ``state`` (``state_pspecs``), each a copy on
    ``device`` (default: the leaf's own), made leaf by leaf; the caller
    drops the full state.  ``state.opt=None`` makes the optimizer state
    from the parameters' blocks under the optimizer's specs (an f32 master
    copy and zero moments: the blocks of ``adamw_init`` of the whole), so no
    rank ever holds the whole state."""
    specs = state_pspecs(cfg, mesh, rules)

    def block(t, spec):
        return collectives.shard_block(t, spec, mesh).to(device or t.device)

    params = tree_map(block, state.params, specs.params)
    if state.opt is None:
        opt = adamw_init(tree_map(block, state.params, specs.opt["master"]),
                         moments_dtype=DTYPES[cfg.opt_moments_dtype])
    else:
        opt = {k: tree_map(block, state.opt[k], specs.opt[k]) for k in state.opt}
    return TrainState(step=state.step.clone(), params=params, opt=opt)


def init_sharded_state(cfg: ModelConfig, key, mesh, rules=None, *, device=None) -> TrainState:
    """This rank's blocks of ``init_train_state(cfg, key, device=device)``,
    bit for bit: each parameter is drawn whole on ``device``, as
    ``init_params`` draws it, and cut to its block at once (one whole leaf
    is held at a time); the master and the moments are made from its
    blocks under the optimizer's specs."""
    specs = state_pspecs(cfg, mesh, rules)

    def specs_of(tree):
        return dict(zip(tree_paths(tree, is_leaf=_is_spec), tree_leaves(tree, is_leaf=_is_spec)))

    p_of, o_of = specs_of(specs.params), specs_of(specs.opt["master"])

    def keep(path, t):
        block = collectives.shard_block(t, p_of[path], mesh)
        return block, block if o_of[path] == p_of[path] else collectives.shard_block(t, o_of[path], mesh)

    both = tfm.init_params(cfg, key, device=device, keep=keep)
    pair = lambda x: isinstance(x, tuple) and len(x) == 2 and torch.is_tensor(x[0])  # noqa: E731
    params = tree_map(lambda x: x[0], both, is_leaf=pair)
    opt = adamw_init(tree_map(lambda x: x[1], both, is_leaf=pair), moments_dtype=DTYPES[cfg.opt_moments_dtype])
    return TrainState(step=torch.zeros((), dtype=torch.int32), params=params, opt=opt)


def _loss_and_grads(cfg: ModelConfig, params, batch):
    """(loss, gradient tree, loss_fn's metrics) of ``loss_fn`` at
    ``params``; the gradients are in each parameter's dtype."""
    paths = list(tree_paths(params))
    leaves = [tree_get(params, p).detach().requires_grad_() for p in paths]
    loss, metrics = tfm.loss_fn(cfg, tree_rebuild(params, dict(zip(paths, leaves)), torch.is_tensor), batch)
    grads = torch.autograd.grad(loss, leaves)
    return (loss.detach(), tree_rebuild(params, dict(zip(paths, grads)), torch.is_tensor),
            {k: v.detach() for k, v in metrics.items()})


def _accumulated(cfg: ModelConfig, params, batch, n_micro: int):
    """(loss, gradients, metrics) over ``n_micro`` micro-batches: the means,
    the gradients accumulated in ``cfg.grad_accum_dtype`` (with one
    micro-batch, in the parameters' dtypes)."""
    if n_micro == 1:
        return _loss_and_grads(cfg, params, batch)
    acc_dtype = DTYPES[cfg.grad_accum_dtype]
    grads = loss = metrics = None
    for mb in _microbatches(batch, n_micro):
        l, g, m = _loss_and_grads(cfg, params, mb)
        if grads is None:
            grads, loss, metrics = tree_map(lambda b: b.to(acc_dtype), g), l, m
        else:
            tree_map(lambda a, b: a.add_(b.to(a.dtype)), grads, g)
            loss = loss + l
            metrics = {k: metrics[k] + m[k] for k in metrics}
    tree_map(lambda g: g.div_(n_micro), grads)  # in place: the accumulator is the step's own
    return loss / n_micro, grads, {k: v / n_micro for k, v in metrics.items()}


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

    def train_step(state: TrainState, batch):
        loss, grads, _ = _accumulated(cfg, state.params, batch, n_micro)
        return _apply_update(opt_cfg, state, grads, loss)

    return train_step


def jit_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, mesh, *, n_micro: int = 1, rules=None):
    """The FSDP × TP train step on ``mesh``: every rank calls ``step(state,
    batch) -> (state, metrics)`` with its blocks of the state
    (``shard_state``, ``init_sharded_state``) and its rows of the batch
    (``batch_pspec``; the rows of its coordinates over the data axes), and
    updates its blocks in place.

    A weight's gradient comes back from the backward pass summed over the
    data ranks and cut to this rank's parameter block; a weight replicated
    over ``model`` is whole on every model rank, its uses inside a
    tensor-parallel region summed over ``model`` once (``copy_to``).  Where
    the optimizer state is split otherwise than the parameters (ZeRO-1 over
    ``pod``: ``OPT_RULES`` split ``embed`` over ``("pod", "data")``, or a
    dimension the product does not divide, which the rules leave whole), the
    gradient block is moved to the optimizer's block before the update
    (kind ``zero_grad``) and the new parameter block rebuilt from the
    optimizer's blocks after it, in the parameters' dtype (kind
    ``zero_param``): both a gather over the data axes and a cut
    (``collectives.reshard``), since a block split pod-major over ``("pod",
    "data")`` need not lie inside a rank's ``data`` block.  The global norm
    counts each entry once, under the optimizer's specs.  A dimension split
    over a data axis and ``model`` at once (which no rule produces) raises.
    Metrics: ``loss``, ``ce`` (the means over the data axes and the
    micro-batches), ``aux`` (the MoE layers' aux losses, each the mean of
    the data shards'), ``grad_norm`` and ``lr``; the same on every rank."""
    set_matmul_precision()
    specs = state_pspecs(cfg, mesh, rules)
    p_specs = tree_leaves(specs.params, is_leaf=_is_spec)
    o_specs = tree_leaves(specs.opt["master"], is_leaf=_is_spec)
    dp = collectives.dp_axes(mesh)
    for spec in p_specs + o_specs:
        for i in range(len(spec)):
            if set(spec.axes(i)) & set(dp) and set(spec.axes(i)) - set(dp):
                raise NotImplementedError(f"a dimension split over {spec.axes(i)}: data and model axes at once")
    moved = [ps != os for ps, os in zip(p_specs, o_specs)]
    n_dp = mesh.axis_size(dp)

    def step(state: TrainState, batch):
        with sharding.use_mesh(mesh, rules):
            loss, grads, metrics = _accumulated(cfg, state.params, batch, n_micro)
            leaves = [collectives.reshard(g, ps, os, mesh, dp, kind="zero_grad") if z else g
                      for g, ps, os, z in zip(tree_leaves(grads), p_specs, o_specs, moved)]
            del grads
            for g in leaves:
                g.div_(n_dp)  # the sums over the data ranks, to means
            # the mean over data of the loss and the cross-entropy (the aux
            # loss is each MoE layer's mean over data already)
            both = collectives.psum_over(torch.stack([loss, metrics["ce"]]), dp, mesh, kind="mean") / n_dp
            grads = tree_rebuild(state.opt["master"], dict(zip(tree_paths(state.opt["master"]), leaves)),
                                 torch.is_tensor)
            new_opt, om = adamw_update(opt_cfg, grads, state.opt, state.step, specs=specs.opt["master"], mesh=mesh)
        with torch.no_grad():
            for p, m, ps, os, z in zip(tree_leaves(state.params), tree_leaves(new_opt["master"]), p_specs, o_specs,
                                       moved):
                p.copy_(collectives.reshard(m.to(p.dtype), os, ps, mesh, dp, kind="zero_param") if z else m)
        out = {"loss": both[0], "ce": both[1], "aux": metrics["aux"], **om}
        return TrainState(step=state.step + 1, params=state.params, opt=new_opt), out

    return step


def make_dp_train_step(
    cfg: ModelConfig,
    opt_cfg: AdamWConfig,
    group=None,
    *,
    mesh=None,
    axes=("data",),
    compression: CompressionConfig | None = None,
):
    """Data-parallel train step over a process group: every rank calls
    ``step(state, ef, batch) -> ((state, ef), metrics)`` with the whole
    (replicated) state, its error-feedback tree (``None`` without
    compression) and its own rows of the batch.

    ``group``: a ``ProcessGroup``; or ``mesh`` (a ``sharding.Mesh`` or a
    ``DeviceMesh``) and its ``axes``, through ``sharding.group_for``; else
    the default group.  Raises when no group is initialized.  Gradients are
    combined with an all-reduce mean or, when ``compression`` is given,
    with the CountSketch-compressed all-reduce and error feedback (a fresh
    sketch a step: the step counter is its ``step``).
    """
    set_matmul_precision()
    group = sharding.resolve_group(group, mesh=mesh, axes=axes, who="make_dp_train_step")
    n = dist.get_world_size(group)

    def step(state: TrainState, ef, batch):
        loss, grads, _ = _loss_and_grads(cfg, state.params, batch)
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


def _on_mesh(mesh):
    return sharding.use_mesh(mesh) if mesh is not None else contextlib.nullcontext()


def make_prefill_step(cfg: ModelConfig, mesh=None):
    """``prefill_step(params, batch, S_cache=None) -> (logits, cache)``; on
    ``mesh`` every rank passes its blocks and its rows of the batch and gets
    its rows of the logits and its blocks of the caches (``tfm.prefill``
    under ``sharding.use_mesh``)."""
    set_matmul_precision()

    def prefill_step(params, batch, S_cache=None):
        with _on_mesh(mesh):
            return tfm.prefill(cfg, params, batch, S_cache=S_cache)

    return prefill_step


def make_decode_step(cfg: ModelConfig, mesh=None):
    """``decode_step(params, cache, tokens, step, embeds=None, img=None) ->
    (logits, cache)``; on ``mesh`` each rank's blocks, rows and caches, as
    in ``make_prefill_step``."""
    set_matmul_precision()

    def decode_step(params, cache, tokens, step, embeds=None, img=None):
        with _on_mesh(mesh):
            return tfm.decode_step(cfg, params, cache, tokens, step, embeds=embeds, img=img)

    return decode_step
