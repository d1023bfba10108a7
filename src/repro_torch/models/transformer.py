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
rows of the batch.  Each layer gathers its own weights over ``data`` as it
runs (ZeRO-3: one layer's weights at a time, again in the backward pass's
recomputation under ``remat``).  GQA attention, the dense FFN and the MoE
run tensor-parallel over ``model``; MLA, SSD, RG-LRU and cross-attention
run on every model rank with their weights gathered whole (their state
stays sharded by the rules).  The embedding table and the head are
gathered whole before use, once a call (with tied embeddings the lookup
and the head share the table); the final norm over ``data``.
"""
from __future__ import annotations

import functools
from typing import Any

import torch
import torch.nn as nn
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from .. import sharding
from ..configs.base import LayerSpec, ModelConfig
from ..core.backend import as_generator, resolve_device
from ..sharding import collectives as col
from . import attention as attn
from . import mlp as mlp_mod
from . import moe as moe_mod
from . import rglru as rglru_mod
from . import ssm as ssm_mod
from .common import DTYPES, PSpec, axes_tree, gather_tree, init_tree, mesh_specs, rms_norm, shape_tree, tree_map

__all__ = [
    "layer_specs", "model_specs", "init_params", "params_axes", "params_shapes",
    "apply_layer", "backbone", "forward", "loss_fn", "init_cache", "cache_axes",
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
    if spec.ffn:
        x = mlp_mod.mlp_apply(p["ffn"], x, cfg)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


# the mixers that run whole on every model rank under a mesh
_REPLICATED_MIXERS = ("mla", "cross_attn", "ssd", "rglru")


def apply_layer(p, x, cfg: ModelConfig, spec: LayerSpec, img=None, pos_offset=0):
    """Returns (x, aux); aux is 0 without an MoE FFN."""
    mp = p["mixer"]
    mesh = sharding.current_mesh()
    if mesh is not None and spec.mixer in _REPLICATED_MIXERS:
        mp = gather_tree(mp, _MIXER_SPECS[spec.mixer](cfg), mesh)
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


def _embed_inputs(cfg: ModelConfig, params, batch):
    """(the input embeddings (B, S, D), the image embeddings or None), in
    the model's dtype."""
    dtype = DTYPES[cfg.dtype]
    if cfg.frontend == "frames":
        x = batch["embeds"].to(dtype)
    else:
        x = params["embed"][batch["tokens"].long()].to(dtype)
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
    final_ln = params["final_ln"]
    mesh = sharding.current_mesh()
    if mesh is not None:
        final_ln = col.gather_param(final_ln, mesh_specs(model_specs(cfg), mesh)["final_ln"], mesh, whole=True)
    return rms_norm(x, final_ln, cfg.norm_eps), aux_total


def _head_weight(cfg: ModelConfig, params):
    return params["embed"].T if cfg.tie_embeddings else params["head"]


def _whole_tables(cfg: ModelConfig, params):
    """Under a mesh: ``params`` with the embedding table and the head
    gathered whole (a vocab-parallel lookup and cross-entropy would keep
    them split; they are gathered once a call here, 0.5 GB in bf16 at
    llama3.2-1b)."""
    mesh = sharding.current_mesh()
    if mesh is None:
        return params
    specs = mesh_specs(model_specs(cfg), mesh)
    out = dict(params)
    for k in ("embed", "head"):
        if k in params:
            out[k] = col.gather_param(params[k], specs[k], mesh, whole=True)
    return out


def forward(cfg: ModelConfig, params, batch):
    """Full logits, f32 (careful: (B,S,V) — use loss_fn for training)."""
    params = _whole_tables(cfg, params)
    x, _ = backbone(cfg, params, *_embed_inputs(cfg, params, batch))
    return (x @ _head_weight(cfg, params)).float()


def _chunk_ce(xs, ls, w):
    """Σ over a chunk of (logsumexp − the label's logit), f32."""
    logits = (xs @ w).float()  # (B, chunk, V)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, ls[..., None])[..., 0]
    return (lse - ll).sum()


def loss_fn(cfg: ModelConfig, params, batch):
    """Seq-chunked softmax cross-entropy plus the MoE aux loss.  Returns
    (loss, metrics)."""
    params = _whole_tables(cfg, params)
    x, aux = backbone(cfg, params, *_embed_inputs(cfg, params, batch))
    w = _head_weight(cfg, params)
    labels = batch["labels"].long()
    B, S = labels.shape

    chunk = min(cfg.loss_chunk or S, S)
    while S % chunk:
        chunk -= 1
    # the chunk's logits are recomputed in the backward pass, never kept
    ce = functools.partial(checkpoint, _chunk_ce, use_reentrant=False) if torch.is_grad_enabled() else _chunk_ce
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(S // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        total = total + ce(x[:, sl], labels[:, sl], w)
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
    the model's dtype."""
    dtype, dev = DTYPES[cfg.dtype], resolve_device(device)

    def stacked(spec):
        one = _layer_cache(cfg, spec, B, S, dtype, "meta")
        return {k: torch.zeros((cfg.n_periods,) + tuple(a.shape), dtype=a.dtype, device=dev) for k, a in one.items()}

    return {
        "prefix": [_layer_cache(cfg, s, B, S, dtype, dev) for s in cfg.prefix],
        "pattern": [stacked(s) for s in cfg.pattern],
        "suffix": [_layer_cache(cfg, s, B, S, dtype, dev) for s in cfg.suffix],
    }


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
    return _ffn(p, x, cfg, spec)[0], c


@torch.no_grad()
def decode_step(cfg: ModelConfig, params, cache, tokens, step, embeds=None, img=None):
    """One decoding step.

    ``tokens`` (B,) (or ``embeds`` (B, D) for the frames front end);
    ``step`` = the absolute position being written (an int); ``img`` the
    (B, P, D) image embeddings a cross-attention layer attends to.  Writes
    into ``cache`` in place (the reference's functional update, donated) and
    returns ``(logits (B, V) f32, cache)``.
    """
    step = int(step)
    dtype = DTYPES[cfg.dtype]
    x = embeds.to(dtype) if cfg.frontend == "frames" else params["embed"][tokens.long()].to(dtype)
    img = None if img is None else img.to(dtype)
    for spec, p, c in zip(cfg.prefix, params["prefix"], cache["prefix"]):
        x, _ = _decode_layer(p, x, c, step, cfg, spec, img)
    for l in range(cfg.n_periods):
        period_params, period_cache = _period(params["pattern"], l), _period(cache["pattern"], l)
        for i, spec in enumerate(cfg.pattern):
            x, _ = _decode_layer(period_params[i], x, period_cache[i], step, cfg, spec, img)
    for spec, p, c in zip(cfg.suffix, params["suffix"], cache["suffix"]):
        x, _ = _decode_layer(p, x, c, step, cfg, spec, img)
    x = rms_norm(x, params["final_ln"], cfg.norm_eps)
    return (x @ _head_weight(cfg, params)).float(), cache


def _prefill_layer(p, x, c, cfg: ModelConfig, spec: LayerSpec, img=None):
    """Apply the layer over the whole prompt, writing its cache entry ``c``:
    a GQA layer's keys and values of the prompt's last ``L`` positions
    (position t at slot t % L), MLA's latent and k_rope of its first
    ``S_cache`` positions, the recurrent mixers' final state and tails."""
    B, S, D = x.shape
    mp = p["mixer"]
    positions = torch.arange(S, device=x.device)
    if spec.mixer == "attn":
        # the reference recomputes the cache projections beside the layer
        h = rms_norm(x, mp["ln"], cfg.norm_eps)
        _, k, v = attn._project_qkv(mp, h, cfg, positions)
        L = c["k"].shape[2]
        take = min(S, L)
        idx = torch.arange(S - take, S, device=x.device) % L
        c["k"][:, :, idx] = k[:, :, S - take:].to(c["k"].dtype)
        c["v"][:, :, idx] = v[:, :, S - take:].to(c["v"].dtype)
        x = attn.gqa_apply(mp, x, cfg, window=spec.window)
    elif spec.mixer == "mla":
        latent, k_rope = attn.mla_latent(mp, rms_norm(x, mp["ln"], cfg.norm_eps), cfg, positions)
        take = min(S, c["latent"].shape[1])
        c["latent"][:, :take] = latent[:, :take].to(c["latent"].dtype)
        c["k_rope"][:, :take] = k_rope[:, :take].to(c["k_rope"].dtype)
        x = attn.mla_apply(mp, x, cfg)
    elif spec.mixer == "ssd":
        x, (state, tails) = ssm_mod.ssd_apply(mp, x, cfg, return_state=True)
        c["state"].copy_(state)
        for n, t in tails.items():
            c[f"conv_{n}"].copy_(t)
    elif spec.mixer == "rglru":
        x, (state, tail) = rglru_mod.rglru_apply(mp, x, cfg, return_state=True)
        c["h"].copy_(state)
        c["conv"].copy_(tail)
    elif spec.mixer == "cross_attn":
        x = attn.cross_apply(mp, x, img, cfg)
    return _ffn(p, x, cfg, spec)[0]


@torch.no_grad()
def prefill(cfg: ModelConfig, params, batch, S_cache: int | None = None):
    """Process the prompt; returns (last-token logits (B, V) f32, cache)."""
    x, img = _embed_inputs(cfg, params, batch)
    B, S, _ = x.shape
    cache = init_cache(cfg, B, S_cache or S, device=x.device)
    for spec, p, c in zip(cfg.prefix, params["prefix"], cache["prefix"]):
        x = _prefill_layer(p, x, c, cfg, spec, img)
    for l in range(cfg.n_periods):
        period_params, period_cache = _period(params["pattern"], l), _period(cache["pattern"], l)
        for i, spec in enumerate(cfg.pattern):
            x = _prefill_layer(period_params[i], x, period_cache[i], cfg, spec, img)
    for spec, p, c in zip(cfg.suffix, params["suffix"], cache["suffix"]):
        x = _prefill_layer(p, x, c, cfg, spec, img)
    x = rms_norm(x, params["final_ln"], cfg.norm_eps)
    return (x[:, -1] @ _head_weight(cfg, params)).float(), cache


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
