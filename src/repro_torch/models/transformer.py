"""Unified decoder stack: a pattern of layers over stacked parameters.

Port of ``repro/models/transformer.py``.  A model = optional ``prefix``
layers + ``n_periods`` repetitions of a layer ``pattern`` (each pattern
layer's parameters stacked on a leading axis, which the layer loop indexes)
+ optional ``suffix`` layers.

The parameters are the reference's tree: the nested dict ``embed`` /
``prefix`` / ``pattern`` / ``suffix`` / ``final_ln`` / ``head`` with each
pattern layer's leaves stacked as ``(n_periods, …)``.  The functions below
take that tree; ``Transformer`` holds it as the ``nn.Parameter``s of an
``nn.Module`` (nested modules for dicts, ``ModuleList``s for lists) and
hands it back with ``params()``.  Keeping the tree keeps three things
aligned with the reference: the compressed all-reduce's per-tensor draws
(``optim.sketched_psum_grads`` numbers tensors in flatten order), the
checkpoint names (``train/checkpoint.py``, ``keystr`` paths) and the weight
converter (``convert.params_from_reference``, a rename-free copy).

Public entry points:
  model_specs / init_params / params_axes / params_shapes / Transformer
  forward          — full-sequence logits (train/eval)
  loss_fn          — forward + seq-chunked softmax-xent (the (B, S, V)
                     logits are never whole; each chunk's logits are
                     recomputed in the backward pass)
  prefill          — forward that also builds the serving cache
  decode_step      — one-token step writing into the cache
  init_cache / cache_axes

``cfg.remat`` maps to ``torch.utils.checkpoint`` per period: ``"none"``
saves every activation, ``"full"`` only each period's input, ``"dots"``
saves the outputs of the 2-D matrix products (``aten.mm``/``addmm``: the
weight products, the reference's ``checkpoint_dots_with_no_batch_dims``)
and recomputes the rest.  The serving paths run without autograd.

Every family of the reference runs: the mixers ``attn`` (GQA, sliding
window), ``mla``, ``cross_attn``, ``ssd`` and ``rglru``; a dense or MoE FFN
(``moe=True``: the MoE's aux loss reaches ``loss_fn``); the ``token``,
``frames`` and ``vision`` front ends (``vision`` takes precomputed image
embeddings as ``batch["image_embeds"]``, and ``decode_step(img=)``).

Under a mesh (``sharding.use_mesh``; the train step ``jit_train_step``)
``forward``, ``loss_fn`` and ``backbone`` take each rank's blocks and its
rows of the batch.  Each layer gathers its own weights over the data axes
as it runs (ZeRO-3: one layer's weights at a time, again in the backward
pass's recomputation under ``remat``), never over ``model``: every mixer
(GQA, MLA, cross-attention, SSD, RG-LRU) and the dense and MoE FFNs run
tensor-parallel over ``model`` (``attention``, ``ssm``, ``rglru``, ``mlp``,
``moe``).  The tables are vocab-parallel where the rules split ``vocab``
over ``model`` (``_tables``): each model rank holds V/tp rows of the
embedding table (and columns of the head), gathered over the data axes
only; the lookup takes the tokens in its range and zeroes the rest, one
sum over ``model`` (kind ``vocab_sum``); the head computes each rank's
columns of the logits, and the cross-entropy combines them in f32 over
``model`` (the max, Σ exp and the label's logit, kind ``vocab_ce``), its
chunks still recomputed in the backward pass.  ``forward``, ``prefill``
and ``decode_step`` return every column of the logits, the ranks' columns
gathered over ``model`` (kind ``vocab_gather``).  Where ``vocab`` does not
divide over ``model`` (the rules' divisibility drop) the tables are used
whole.  The final norm is gathered over the data axes.  With no mesh every
one of these steps is the identity and the functions are the one-process
port.

``prefill`` and ``decode_step`` take the same blocks and the rank's rows
of the prompts (or tokens) under a mesh, and the caches are each rank's
blocks under the rules (``init_cache``, ``cache_specs``): its rows over the
data axes; for the GQA and MLA caches its slice of the positions over
``model`` (``cache_seq``; a cache's length must divide over it); SSD's
``conv_x`` tail its ``inner`` columns and RG-LRU's ``h`` and ``conv`` its
``rnn`` channels; SSD's state and its B/C tails whole over ``model`` (each
rank updates its heads, the new heads gathered over ``model``).  Where the
rules replicate the batch (a batch that does not divide over the data
axes), every data rank serves all of it.
"""
from __future__ import annotations

import functools
from typing import Any, NamedTuple

import torch
import torch.nn as nn
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from .. import sharding
from ..configs.base import LayerSpec, ModelConfig
from ..core.backend import as_generator, resolve_device
from ..sharding import PartitionSpec, logical_to_spec
from ..sharding import collectives as col
from . import attention as attn
from . import mlp as mlp_mod
from . import moe as moe_mod
from . import rglru as rglru_mod
from . import ssm as ssm_mod
from .common import DTYPES, PSpec, axes_tree, init_tree, is_shape, mesh_specs, rms_norm, shape_tree, tree_map

__all__ = [
    "layer_specs", "model_specs", "init_params", "params_axes", "params_shapes",
    "apply_layer", "backbone", "forward", "loss_fn", "init_cache", "cache_axes", "cache_specs",
    "decode_step", "prefill", "Transformer",
]

# ===========================================================================
# Param specs
# ===========================================================================


_MIXER_SPECS = {
    "attn": attn.gqa_specs,
    "mla": attn.mla_specs,
    "cross_attn": attn.cross_specs,
    "ssd": ssm_mod.ssd_specs,
    "rglru": rglru_mod.rglru_specs,
}


def layer_specs(cfg: ModelConfig, spec: LayerSpec) -> dict:
    if spec.mixer not in _MIXER_SPECS:
        raise ValueError(f"unknown mixer {spec.mixer!r}")
    d = {"mixer": _MIXER_SPECS[spec.mixer](cfg)}
    if spec.ffn:
        d["ffn"] = moe_mod.moe_specs(cfg) if spec.moe else mlp_mod.mlp_specs(cfg)
    return d


def _stack_specs(specs, n: int):
    return tree_map(
        lambda s: PSpec((n,) + s.shape, ("layers",) + s.axes, s.init, s.dtype),
        specs,
        is_leaf=lambda x: isinstance(x, PSpec),
    )


def model_specs(cfg: ModelConfig) -> dict:
    D, V = cfg.d_model, cfg.vocab
    specs: dict[str, Any] = {}
    if cfg.frontend in ("token", "vision"):
        specs["embed"] = PSpec((V, D), ("vocab", "embed"), "embed")
    # 'frames' front end: inputs arrive as precomputed (B,S,D) embeddings
    specs["prefix"] = [layer_specs(cfg, s) for s in cfg.prefix]
    specs["pattern"] = [_stack_specs(layer_specs(cfg, s), cfg.n_periods) for s in cfg.pattern]
    specs["suffix"] = [layer_specs(cfg, s) for s in cfg.suffix]
    specs["final_ln"] = PSpec((D,), ("embed",), "zeros")
    if not cfg.tie_embeddings:
        specs["head"] = PSpec((D, V), ("embed", "vocab"))
    return specs


def init_params(cfg: ModelConfig, key, *, device=None, keep=None):
    """The parameter tree, drawn from ``key`` (a ``torch.Generator`` on
    ``device``, or an int seed) in ``cfg.dtype`` on ``device`` (``None``:
    the card).  ``keep(path, leaf)``: what to keep of each leaf as it is
    drawn (``models.common.init_tree``)."""
    dev = resolve_device(device)
    return init_tree(model_specs(cfg), as_generator(key, dev), DTYPES[cfg.dtype], dev, keep=keep)


def params_axes(cfg: ModelConfig):
    return axes_tree(model_specs(cfg))


def params_shapes(cfg: ModelConfig):
    return shape_tree(model_specs(cfg), DTYPES[cfg.dtype])


# ===========================================================================
# Layer application
# ===========================================================================


def _ffn(p, x, cfg: ModelConfig, spec: LayerSpec):
    """The layer's FFN: returns (x, aux); aux is 0 without an MoE FFN."""
    if spec.ffn and spec.moe:
        return moe_mod.moe_apply(p["ffn"], x, cfg, return_aux=True)
    return _serve_ffn(p, x, cfg, spec), torch.zeros((), dtype=torch.float32, device=x.device)


def _serve_ffn(p, x, cfg: ModelConfig, spec: LayerSpec):
    """The layer's FFN without the aux loss (serving)."""
    if spec.ffn and spec.moe:
        return moe_mod.moe_apply(p["ffn"], x, cfg)
    if spec.ffn:
        return mlp_mod.mlp_apply(p["ffn"], x, cfg)
    return x


def apply_layer(p, x, cfg: ModelConfig, spec: LayerSpec, img=None, pos_offset=0):
    """Returns (x, aux); aux is 0 without an MoE FFN."""
    mp = p["mixer"]
    if spec.mixer == "attn":
        x = attn.gqa_apply(mp, x, cfg, window=spec.window, pos_offset=pos_offset)
    elif spec.mixer == "mla":
        x = attn.mla_apply(mp, x, cfg, pos_offset=pos_offset)
    elif spec.mixer == "cross_attn":
        x = attn.cross_apply(mp, x, img, cfg)
    elif spec.mixer == "ssd":
        x = ssm_mod.ssd_apply(mp, x, cfg)
    elif spec.mixer == "rglru":
        x = rglru_mod.rglru_apply(mp, x, cfg)
    return _ffn(p, x, cfg, spec)


_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, cfg: ModelConfig):
    """``fn`` under ``cfg.remat``'s policy (when autograd records)."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    if cfg.remat == "dots":
        ctx = functools.partial(create_selective_checkpoint_contexts, _save_dots)
        return functools.partial(checkpoint, fn, use_reentrant=False, context_fn=ctx)
    if cfg.remat == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    raise ValueError(f"unknown remat policy {cfg.remat!r}")


def _period(tree, l: int):
    """Period ``l``'s parameters (or cache): every stacked leaf at ``l``."""
    return tree_map(lambda a: a[l], tree)


# ===========================================================================
# Forward (train / eval)
# ===========================================================================


class _Tables(NamedTuple):
    """The embedding table and the head as a call uses them: with no mesh the
    parameters; under a mesh where the rules split ``vocab`` over ``model``
    each rank's V/tp rows of the table and columns of the head (gathered
    over the data axes only), ``mesh`` the mesh and ``v0`` the rank's first
    vocabulary entry; else both gathered whole (``mesh`` None)."""

    embed: Any
    head: torch.Tensor
    mesh: Any
    v0: int


def _tables(cfg: ModelConfig, params) -> _Tables:
    """The call's ``_Tables`` (with tied embeddings the lookup and the head
    share one gathered table)."""
    mesh = sharding.current_mesh()
    if mesh is None:
        return _Tables(params.get("embed"), params["embed"].T if cfg.tie_embeddings else params["head"], None, 0)
    specs = mesh_specs(model_specs(cfg), mesh)
    key, vdim = ("embed", 0) if "embed" in params else ("head", 1)
    split = mesh.shape.get("model", 1) > 1 and specs[key].axes(vdim) == ("model",)
    gathered = {k: col.gather_param(params[k], specs[k], mesh, whole=not split) for k in ("embed", "head")
                if k in params}
    head = gathered["embed"].T if cfg.tie_embeddings else gathered["head"]
    if not split:
        return _Tables(gathered.get("embed"), head, None, 0)
    return _Tables(gathered.get("embed"), head, mesh, mesh.axis_index("model") * head.shape[1])


def _lookup(t: _Tables, tokens):
    """The embeddings of ``tokens``.  Vocab-parallel: each rank looks up the
    tokens in its range, zeroes the rest, and the ranks' rows are summed
    over ``model`` (exact: one rank adds a row, the others zeros; the
    gradient reaches only the rows a rank holds)."""
    ids = tokens.long()
    if t.mesh is None:
        return t.embed[ids]
    n = t.embed.shape[0]
    local = ids - t.v0
    inside = (local >= 0) & (local < n)
    rows = torch.where(inside[..., None], t.embed[local.clamp(0, n - 1)], 0)
    return col.reduce_from(rows, t.mesh, kind="vocab_sum")


def _logits(t: _Tables, x):
    """The f32 logits of ``x`` (..., D): vocab-parallel, each rank's columns
    gathered over ``model`` (``x`` enters through ``copy_to``)."""
    if t.mesh is None:
        return (x @ t.head).float()
    local = (col.copy_to(x, t.mesh) @ t.head).float()
    return col.gather_cut(local, -1, t.mesh, kind="vocab_gather")


def _embed_inputs(cfg: ModelConfig, t: _Tables, batch):
    """(the input embeddings (B, S, D), the image embeddings or None), in
    the model's dtype."""
    dtype = DTYPES[cfg.dtype]
    if cfg.frontend == "frames":
        x = batch["embeds"].to(dtype)
    else:
        x = _lookup(t, batch["tokens"]).to(dtype)
    img = batch.get("image_embeds")
    return x, None if img is None else img.to(dtype)


def backbone(cfg: ModelConfig, params, x, img=None):
    """Embeddings -> final hidden states.  Returns (x, total_aux)."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for spec, p in zip(cfg.prefix, params["prefix"]):
        x, aux = apply_layer(p, x, cfg, spec, img=img)
        aux_total = aux_total + aux

    def period_body(h, period_params):
        aux_acc = torch.zeros((), dtype=torch.float32, device=h.device)
        for i, spec in enumerate(cfg.pattern):
            h, aux = apply_layer(period_params[i], h, cfg, spec, img=img)
            aux_acc = aux_acc + aux
        return h, aux_acc

    body = _remat(period_body, cfg)
    for l in range(cfg.n_periods):
        x, aux = body(x, _period(params["pattern"], l))
        aux_total = aux_total + aux

    for spec, p in zip(cfg.suffix, params["suffix"]):
        x, aux = apply_layer(p, x, cfg, spec, img=img)
        aux_total = aux_total + aux
    return _final_norm(cfg, params, x), aux_total


def _final_norm(cfg: ModelConfig, params, x):
    """The final norm (under a mesh its weight gathered whole)."""
    final_ln = params["final_ln"]
    mesh = sharding.current_mesh()
    if mesh is not None:
        final_ln = col.gather_param(final_ln, mesh_specs(model_specs(cfg), mesh)["final_ln"], mesh, whole=True)
    return rms_norm(x, final_ln, cfg.norm_eps)


def forward(cfg: ModelConfig, params, batch):
    """Full logits, f32 (careful: (B,S,V) — use loss_fn for training).
    Under a mesh, the rank's rows of them, every column."""
    t = _tables(cfg, params)
    x, _ = backbone(cfg, params, *_embed_inputs(cfg, t, batch))
    return _logits(t, x)


def _chunk_ce(xs, ls, w):
    """Σ over a chunk of (logsumexp − the label's logit), f32."""
    logits = (xs @ w).float()  # (B, chunk, V)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, ls[..., None])[..., 0]
    return (lse - ll).sum()


def _chunk_ce_vocab(xs, ls, w, v0: int, mesh):
    """``_chunk_ce`` with the head's columns split over ``model``: each rank
    computes the logits of its V/tp columns and the three pieces combine in
    f32 over ``model``: the running max (an ``all_reduce`` MAX, held
    constant: the result does not depend on it), Σ exp and the label's
    logit, taken only on the rank that holds it (both sums
    ``reduce_from``: each rank's gradient is its own columns' part)."""
    logits = (xs @ w).float()  # (B, chunk, V/tp)
    n = logits.shape[-1]
    m = col.psum_over(logits.detach().amax(-1), "model", mesh, kind="vocab_ce", op="max")
    sumexp = col.reduce_from(torch.exp(logits - m[..., None]).sum(-1), mesh, kind="vocab_ce")
    local = ls - v0
    inside = (local >= 0) & (local < n)
    ll = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    ll = col.reduce_from(torch.where(inside, ll, 0.0), mesh, kind="vocab_ce")
    return (torch.log(sumexp) + m - ll).sum()


def loss_fn(cfg: ModelConfig, params, batch):
    """Seq-chunked softmax cross-entropy plus the MoE aux loss.  Returns
    (loss, metrics).  Under a mesh with ``vocab`` split over ``model``, the
    vocab-parallel cross-entropy (``_chunk_ce_vocab``)."""
    t = _tables(cfg, params)
    x, aux = backbone(cfg, params, *_embed_inputs(cfg, t, batch))
    labels = batch["labels"].long()
    B, S = labels.shape

    chunk = min(cfg.loss_chunk or S, S)
    while S % chunk:
        chunk -= 1
    fn, extra = (_chunk_ce, ()) if t.mesh is None else (_chunk_ce_vocab, (t.v0, t.mesh))
    if t.mesh is not None:
        x = col.copy_to(x, t.mesh)
    # the chunk's logits are recomputed in the backward pass, never kept
    ce = functools.partial(checkpoint, fn, use_reentrant=False) if torch.is_grad_enabled() else fn
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(S // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        total = total + ce(x[:, sl], labels[:, sl], t.head, *extra)
    loss = total / (B * S) + aux
    return loss, {"ce": total / (B * S), "aux": aux}


# ===========================================================================
# Serving: prefill + decode
# ===========================================================================


def _layer_cache(cfg: ModelConfig, spec: LayerSpec, B: int, S: int, dtype, device):
    if spec.mixer == "attn":
        return attn.gqa_init_cache(cfg, B, S, spec.window, dtype, device)
    if spec.mixer == "mla":
        return attn.mla_init_cache(cfg, B, S, dtype, device)
    if spec.mixer == "ssd":
        return ssm_mod.ssd_init_cache(cfg, B, dtype, device)
    if spec.mixer == "rglru":
        return rglru_mod.rglru_init_cache(cfg, B, dtype, device)
    if spec.mixer == "cross_attn":
        return {}  # the image embeddings act as the (static) cache
    raise ValueError(spec.mixer)


_CACHE_AXES = {
    "attn": attn.gqa_cache_axes,
    "mla": attn.mla_cache_axes,
    "ssd": ssm_mod.ssd_cache_axes,
    "rglru": rglru_mod.rglru_cache_axes,
    "cross_attn": dict,
}


def init_cache(cfg: ModelConfig, B: int, S: int, *, device=None):
    """Zero caches for ``B`` sequences of up to ``S`` positions; the pattern's
    stacked ``(n_periods, …)``.  The recurrent states are f32, the rest in
    the model's dtype.  Under a mesh, this rank's block of each
    (``cache_specs``)."""
    return _zero_caches(cfg, B, S, resolve_device(device), split_batch=True)


def cache_specs(cfg: ModelConfig, B: int, S: int, mesh, rules=None):
    """The caches' specs on ``mesh``: ``cache_axes`` through the rules with
    each cache's shape.  So the GQA and MLA caches hold a rank's slice of
    the positions (``cache_seq``), SSD's ``conv_x`` its ``inner`` columns,
    RG-LRU's ``h`` and ``conv`` its ``rnn`` channels, and SSD's state
    (``("batch", None, "head_dim", "state")``) and its B/C tails are whole
    over ``model``.  A cache whose positions the rules split but whose
    length does not divide over them raises: the decode reads a rank's
    positions from the rules alone."""
    shapes, axes = _cache_shapes(cfg, B, S), cache_axes(cfg)
    seq_axes = logical_to_spec(("cache_seq",), mesh, rules).axes(0)

    def spec(sh, ax, mixer):
        out = logical_to_spec(ax, mesh, rules, shape=sh[0])
        if "cache_seq" in ax and seq_axes and out.axes(ax.index("cache_seq")) != seq_axes:
            raise ValueError(f"a {mixer} cache of {sh[0][ax.index('cache_seq')]} positions does not split "
                             f"over {seq_axes} ({mesh.axis_size(seq_axes)} ranks): choose a length that does")
        return out

    def layer(shp, axs, mixer):
        return {k: spec(shp[k], axs[k], mixer) for k in shp}

    return {part: [layer(shp, axs, s.mixer) for shp, axs, s in zip(shapes[part], axes[part], specs)]
            for part, specs in (("prefix", cfg.prefix), ("pattern", cfg.pattern), ("suffix", cfg.suffix))}


def _cache_shapes(cfg: ModelConfig, B: int, S: int):
    """The caches' ``(shape, dtype)`` leaves, nothing allocated."""
    dtype = DTYPES[cfg.dtype]

    def layer(spec, lead=()):
        return {k: (lead + tuple(a.shape), a.dtype) for k, a in _layer_cache(cfg, spec, B, S, dtype, "meta").items()}

    return {
        "prefix": [layer(s) for s in cfg.prefix],
        "pattern": [layer(s, (cfg.n_periods,)) for s in cfg.pattern],
        "suffix": [layer(s) for s in cfg.suffix],
    }


def _zero_caches(cfg: ModelConfig, B: int, S: int, dev, *, split_batch: bool):
    """``init_cache``; under a mesh each rank's block, its rows only where
    ``split_batch`` (``prefill`` is handed the rank's rows already)."""
    shapes = _cache_shapes(cfg, B, S)
    mesh = sharding.current_mesh()
    if mesh is None:
        return tree_map(lambda sh: torch.zeros(sh[0], dtype=sh[1], device=dev), shapes, is_leaf=is_shape)
    specs = cache_specs(cfg, B, S, mesh, sharding.current_rules())

    def block(sh, spec, ax):
        if not split_batch:
            spec = PartitionSpec(*(None if a == "batch" else e for e, a in zip(spec, ax)))
        return torch.zeros(col.block_shape(sh[0], spec, mesh), dtype=sh[1], device=dev)

    return tree_map(block, shapes, specs, cache_axes(cfg), is_leaf=is_shape)


def cache_axes(cfg: ModelConfig):
    def stacked(spec):
        return {k: ("layers",) + v for k, v in _CACHE_AXES[spec.mixer]().items()}

    return {
        "prefix": [_CACHE_AXES[s.mixer]() for s in cfg.prefix],
        "pattern": [stacked(s) for s in cfg.pattern],
        "suffix": [_CACHE_AXES[s.mixer]() for s in cfg.suffix],
    }


def _decode_layer(p, x, c, step: int, cfg: ModelConfig, spec: LayerSpec, img=None):
    mp = p["mixer"]
    if spec.mixer == "attn":
        x, c = attn.gqa_decode(mp, x, c, step, cfg, window=spec.window)
    elif spec.mixer == "mla":
        x, c = attn.mla_decode(mp, x, c, step, cfg)
    elif spec.mixer == "ssd":
        x, c = ssm_mod.ssd_decode(mp, x, c, step, cfg)
    elif spec.mixer == "rglru":
        x, c = rglru_mod.rglru_decode(mp, x, c, step, cfg)
    elif spec.mixer == "cross_attn":
        x = attn.cross_decode(mp, x, img, cfg)
    return _serve_ffn(p, x, cfg, spec), c


@torch.no_grad()
def decode_step(cfg: ModelConfig, params, cache, tokens, step, embeds=None, img=None):
    """One decoding step.

    ``tokens`` (B,) (or ``embeds`` (B, D) for the frames front end);
    ``step`` = the absolute position being written (an int); ``img`` the
    (B, P, D) image embeddings a cross-attention layer attends to.  Writes
    into ``cache`` in place (the reference's functional update, donated) and
    returns ``(logits (B, V) f32, cache)``.  Under a mesh: the rank's blocks,
    its rows of ``tokens`` (and ``img``) and its blocks of the caches.
    """
    step = int(step)
    dtype = DTYPES[cfg.dtype]
    t = _tables(cfg, params)
    x = embeds.to(dtype) if cfg.frontend == "frames" else _lookup(t, tokens).to(dtype)
    img = None if img is None else img.to(dtype)
    for spec, p, c in zip(cfg.prefix, params["prefix"], cache["prefix"]):
        x, _ = _decode_layer(p, x, c, step, cfg, spec, img)
    for l in range(cfg.n_periods):
        period_params, period_cache = _period(params["pattern"], l), _period(cache["pattern"], l)
        for i, spec in enumerate(cfg.pattern):
            x, _ = _decode_layer(period_params[i], x, period_cache[i], step, cfg, spec, img)
    for spec, p, c in zip(cfg.suffix, params["suffix"], cache["suffix"]):
        x, _ = _decode_layer(p, x, c, step, cfg, spec, img)
    x = _final_norm(cfg, params, x)
    return _logits(t, x), cache


def _prefill_layer(p, x, c, cfg: ModelConfig, spec: LayerSpec, img=None):
    """Apply the layer over the whole prompt, writing its cache entry ``c``:
    a GQA layer's keys and values of the prompt's last ``L`` positions
    (position t at slot t % L), MLA's latent and k_rope of its first
    ``S_cache`` positions, the recurrent mixers' final state and tails.
    Under a mesh a rank writes its blocks of the caches only."""
    mp = p["mixer"]
    if spec.mixer == "attn":
        x = attn.gqa_prefill(mp, x, c, cfg, window=spec.window)
    elif spec.mixer == "mla":
        x = attn.mla_prefill(mp, x, c, cfg)
    elif spec.mixer == "ssd":
        x = ssm_mod.ssd_prefill(mp, x, c, cfg)
    elif spec.mixer == "rglru":
        x = rglru_mod.rglru_prefill(mp, x, c, cfg)
    elif spec.mixer == "cross_attn":
        x = attn.cross_apply(mp, x, img, cfg)
    return _serve_ffn(p, x, cfg, spec)


@torch.no_grad()
def prefill(cfg: ModelConfig, params, batch, S_cache: int | None = None):
    """Process the prompt; returns (last-token logits (B, V) f32, cache).
    Under a mesh: the rank's blocks and its rows of the batch; the cache is
    the rank's blocks for those rows (``init_cache``)."""
    t = _tables(cfg, params)
    x, img = _embed_inputs(cfg, t, batch)
    B, S, _ = x.shape
    cache = _zero_caches(cfg, B, S_cache or S, x.device, split_batch=False)
    for spec, p, c in zip(cfg.prefix, params["prefix"], cache["prefix"]):
        x = _prefill_layer(p, x, c, cfg, spec, img)
    for l in range(cfg.n_periods):
        period_params, period_cache = _period(params["pattern"], l), _period(cache["pattern"], l)
        for i, spec in enumerate(cfg.pattern):
            x = _prefill_layer(period_params[i], x, period_cache[i], cfg, spec, img)
    for spec, p, c in zip(cfg.suffix, params["suffix"], cache["suffix"]):
        x = _prefill_layer(p, x, c, cfg, spec, img)
    x = _final_norm(cfg, params, x)
    return _logits(t, x[:, -1]), cache


# ===========================================================================
# The parameter tree as an nn.Module
# ===========================================================================


class _Node(nn.Module):
    """One dict of the parameter tree: its tensors as parameters (sharing
    their storage), its dicts as ``_Node``s, its lists as ``ModuleList``s."""

    def __init__(self, tree: dict):
        super().__init__()
        self._order = list(tree)
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, _Node(v))
            elif isinstance(v, list):
                self.add_module(k, nn.ModuleList(_Node(x) for x in v))
            else:
                self.register_parameter(k, nn.Parameter(v, requires_grad=v.is_floating_point()))

    def tree(self) -> dict:
        out = {}
        for k in self._order:
            v = getattr(self, k)
            if isinstance(v, _Node):
                out[k] = v.tree()
            elif isinstance(v, nn.ModuleList):
                out[k] = [x.tree() for x in v]
            else:
                out[k] = v
        return out


class Transformer(nn.Module):
    """A model of ``cfg`` holding the reference's parameter tree as
    ``nn.Parameter``s (``params=``, or drawn by ``init_params(cfg, key,
    device=device)``).  ``params()`` is the tree the functions of this
    module take."""

    def __init__(self, cfg: ModelConfig, params=None, *, key=0, device=None):
        super().__init__()
        self.cfg = cfg
        self.root = _Node(init_params(cfg, key, device=device) if params is None else params)

    def params(self) -> dict:
        return self.root.tree()

    def forward(self, batch):
        return forward(self.cfg, self.params(), batch)

    def loss(self, batch):
        return loss_fn(self.cfg, self.params(), batch)
