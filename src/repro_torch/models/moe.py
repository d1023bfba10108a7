"""Mixture-of-Experts FFN: top-k routing with capacity-based dispatch.

Port of ``repro/models/moe.py``'s global-dispatch path (``_moe_gspmd``):
flatten the (token, choice) assignments, rank each within its expert in
the order of a stable sort, drop the ranks beyond the capacity, gather into
a dense (E, C, D) buffer for the batched expert products, and combine each
token's K outputs weighted by their gates.  Shared experts (DeepSeek-V2)
and top-k renormalization (Mixtral); the router in f32; the Switch-style
load-balance aux loss.

Three places where torch would silently differ from the reference:

- *top-k ties*: ``jax.lax.top_k`` puts the lower expert first among equal
  probabilities, ``torch.topk`` does not promise to; the choice here is a
  stable descending sort's first K;
- *the rank within an expert* decides which assignments a full expert
  drops, so it comes from a stable argsort, as in the reference;
- *the combine*: every token has exactly K assignments, so its outputs are
  gathered as (T, K, D) and added in choice order (the reference's
  ``segment_sum`` over ``token_of``), with no atomic scatter: two calls on
  the same input give the same bits on the card.

The expert-parallel path (``_moe_shard_map``, the reference's shard_map
body as SPMD code) runs under a mesh with a ``model`` axis
(``sharding.use_mesh``), where every rank holds its blocks and its own
rows: the weights gathered over ``data``, the rank's tokens routed
locally with the capacity taken from their count, the rank's E/tp experts
(expert mode) or its slice of every expert's FFN (FFN mode, when the
experts do not split over ``model``), one combine sum over ``model``, and
the aux loss averaged over the data axes.  ``moe_apply`` takes it under
``"auto"`` and ``"shard_map"`` as the reference does.  By the reference's
own definition two things differ from the global dispatch: the capacity
comes from the rank's tokens (so at 1.25 other assignments are dropped;
the two agree at a drop-free capacity), and the aux loss is the mean of
each shard's, not the whole batch's.

No Pallas kernel runs here in the reference; the products are
``torch.bmm`` and matmuls.
"""
from __future__ import annotations

import torch

from .. import sharding
from ..configs.base import ModelConfig, MoEConfig
from ..sharding import collectives as col
from .common import PSpec, activation, mesh_specs, rms_norm
from .mlp import GATED

__all__ = ["moe_specs", "moe_apply"]


def moe_specs(cfg: ModelConfig) -> dict:
    D = cfg.d_model
    m: MoEConfig = cfg.moe
    E, F = m.n_experts, m.d_expert
    specs = {
        "ln": PSpec((D,), ("embed",), "zeros"),
        "router": PSpec((D, E), ("embed", None), dtype=torch.float32),
        "w_in": PSpec((E, D, F), ("experts", "embed", "expert_mlp")),
        "w_out": PSpec((E, F, D), ("experts", "expert_mlp", "embed")),
    }
    if cfg.act in GATED:
        specs["w_gate"] = PSpec((E, D, F), ("experts", "embed", "expert_mlp"))
    if m.n_shared:
        Fs = m.n_shared * m.d_expert
        specs["shared_in"] = PSpec((D, Fs), ("embed", "mlp"))
        specs["shared_out"] = PSpec((Fs, D), ("mlp", "embed"))
        if cfg.act in GATED:
            specs["shared_gate"] = PSpec((D, Fs), ("embed", "mlp"))
    return specs


def _capacity(T: int, m: MoEConfig) -> int:
    c = int(m.capacity_factor * T * m.top_k / m.n_experts)
    return max(8, -(-c // 8) * 8)  # multiple of 8 for tiling


def _route(p_router, h, m: MoEConfig):
    """(probs (T, E), gate values (T, K), expert ids (T, K)); among equal
    probabilities the lower expert comes first (``lax.top_k``'s order)."""
    probs = torch.softmax(h.float() @ p_router, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = vals[..., : m.top_k], idx[..., : m.top_k]
    if m.norm_topk:
        gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gate_vals, gate_idx


def _expert_counts(flat_e, E: int):
    """The assignments each of the ``E`` experts receives, (E,) int64:
    ``torch.bincount(flat_e, minlength=E)``'s integers with a shape fixed by
    ``E`` (a scatter-add of ones), so the dispatch also runs on meta and
    fake tensors (the dry run), where an output shape read from the data
    cannot be."""
    return torch.zeros(E, dtype=torch.int64, device=flat_e.device).scatter_add_(
        0, flat_e.long(), torch.ones_like(flat_e, dtype=torch.int64))


def _rank_in_expert(flat_e, E: int):
    """Stable rank of each assignment within its target expert."""
    A = flat_e.shape[0]
    order = torch.argsort(flat_e, stable=True)
    counts = _expert_counts(flat_e, E)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.empty_like(order)
    rank[order] = torch.arange(A, device=flat_e.device) - starts[flat_e[order]]
    return rank


def _expert_ffn(xe, p, cfg: ModelConfig):
    """xe (E, C, D) -> (E, C, D) through each expert's FFN."""
    up = torch.bmm(xe, p["w_in"])
    act = activation(cfg.act, up, torch.bmm(xe, p["w_gate"])) if cfg.act in GATED else activation(cfg.act, up)
    return torch.bmm(act, p["w_out"])


def _shared_ffn(h, p, cfg: ModelConfig):
    s_up = h @ p["shared_in"]
    s_act = activation(cfg.act, s_up, h @ p["shared_gate"]) if cfg.act in GATED else activation(cfg.act, s_up)
    return s_act @ p["shared_out"]


def _aux_loss(probs, flat_e, m: MoEConfig):
    frac = _expert_counts(flat_e, m.n_experts).float() / flat_e.shape[0]
    return m.aux_weight * m.n_experts * torch.sum(frac * probs.mean(0))


def _moe_gspmd(p, x, cfg: ModelConfig, return_aux: bool):
    """One global sort-based dispatch (the reference's name kept: under XLA it
    is the GSPMD-partitioned path)."""
    m: MoEConfig = cfg.moe
    D = x.shape[-1]
    h = rms_norm(x, p["ln"], cfg.norm_eps).reshape(-1, D)
    T = h.shape[0]
    E, K = m.n_experts, m.top_k
    C = _capacity(T, m)

    probs, gate_vals, gate_idx = _route(p["router"], h, m)

    A = T * K
    flat_e = gate_idx.reshape(A)
    token_of = torch.arange(A, device=x.device) // K
    rank = _rank_in_expert(flat_e, E)
    keep = rank < C
    dest = torch.where(keep, flat_e * C + rank, E * C)  # the dropped share slot E·C

    # each kept assignment owns its slot; only the dropped ones meet at E·C,
    # which is cut off, so the write order does not matter
    slot_src = torch.full((E * C + 1,), T, dtype=torch.long, device=x.device)
    slot_src[dest] = token_of
    h_pad = torch.cat([h, h.new_zeros(1, D)])
    xe = h_pad[slot_src[:-1]].reshape(E, C, D)

    ye = _expert_ffn(xe, p, cfg)

    ye_flat = torch.cat([ye.reshape(E * C, D), ye.new_zeros(1, D)])
    y_assign = (ye_flat[dest] * (gate_vals.reshape(A, 1).to(ye.dtype) * keep[:, None])).reshape(T, K, D)
    y = y_assign[:, 0]
    for k in range(1, K):  # the token's choices in order, as segment_sum adds them
        y = y + y_assign[:, k]

    if m.n_shared:
        y = y + _shared_ffn(h, p, cfg)

    out = x + y.reshape(x.shape).to(x.dtype)
    if not return_aux:
        return out
    return out, _aux_loss(probs, flat_e, m)


# ===========================================================================
# shard_map expert-parallel path
# ===========================================================================


def _moe_shard_map(p, x, cfg: ModelConfig, mesh, return_aux: bool):
    """The reference's ``_moe_shard_map`` body on this rank: ``p`` its
    blocks (the rules' layout), ``x`` its rows (B_loc, S, D)."""
    m: MoEConfig = cfg.moe
    E, K, D = m.n_experts, m.top_k, cfg.d_model
    tp = mesh.shape["model"]
    expert_mode = E % tp == 0 and E >= tp
    E_loc = E // tp if expert_mode else E
    specs = mesh_specs(moe_specs(cfg), mesh)
    split = 0 if expert_mode else 2  # the experts dim, else the expert FFN dim
    experts = [k for k in ("w_in", "w_gate", "w_out") if k in p]
    for k in experts:
        want = 1 if split == 2 and k == "w_out" else split
        if tp > 1 and specs[k].axes(want) != ("model",):
            raise ValueError(f"moe {k}: the rules place it as {specs[k]}, the expert-parallel path splits "
                             f"dim {want} over 'model'")

    # ---- FSDP-gather the weights over the data axes ------------------------
    ln = col.gather_param(p["ln"], specs["ln"], mesh, whole=True)
    router = col.gather_param(p["router"], specs["router"], mesh, whole=True)
    w = {k: col.gather_param(p[k], specs[k], mesh) for k in experts}

    h = rms_norm(x, ln, cfg.norm_eps).reshape(-1, D)
    T = h.shape[0]
    C = _capacity(T, m)
    probs, gate_vals, gate_idx = _route(router, h, m)
    A = T * K
    flat_e = gate_idx.reshape(A)
    token_of = torch.arange(A, device=x.device) // K
    rank = _rank_in_expert(flat_e, E)
    keep = rank < C
    if expert_mode:  # only the assignments to this rank's experts
        e0 = mesh.axis_index("model") * E_loc
        use = (flat_e >= e0) & (flat_e < e0 + E_loc) & keep
        dest = torch.where(use, (flat_e - e0) * C + rank, E_loc * C)
    else:
        use = keep
        dest = torch.where(keep, flat_e * C + rank, E_loc * C)

    # the rank's part of the expert outputs: the tokens and gates enter the
    # region through copy_to, so their gradients are summed over 'model'
    slot_src = torch.full((E_loc * C + 1,), T, dtype=torch.long, device=x.device)
    slot_src[dest] = token_of
    h_tp = col.copy_to(h, mesh)
    xe = torch.cat([h_tp, h_tp.new_zeros(1, D)])[slot_src[:-1]].reshape(E_loc, C, D)
    ye = _expert_ffn(xe, w, cfg)
    ye_flat = torch.cat([ye.reshape(E_loc * C, D), ye.new_zeros(1, D)])
    gates = col.copy_to(gate_vals, mesh)
    y_assign = (ye_flat[dest] * (gates.reshape(A, 1).to(ye.dtype) * use[:, None])).reshape(T, K, D)
    y = y_assign[:, 0]
    for k in range(1, K):  # the token's choices in order
        y = y + y_assign[:, k]

    shared = None
    if m.n_shared:
        names = [k for k in ("shared_in", "shared_gate", "shared_out") if k in p]
        if all(specs[k].axes(1 if k != "shared_out" else 0) == ("model",) for k in names):
            # the shared FFN dim is model-sharded: its contribution is partial too
            y = y + _shared_ffn(h_tp, {k: col.gather_param(p[k], specs[k], mesh) for k in names}, cfg)
        else:  # not split over 'model': whole on every rank, added after the sum
            shared = _shared_ffn(h, {k: col.gather_param(p[k], specs[k], mesh, whole=True) for k in names}, cfg)

    y = col.reduce_from(y, mesh)  # one combine sum over the model axis
    if shared is not None:
        y = y + shared
    out = x + y.reshape(x.shape).to(x.dtype)
    if not return_aux:
        return out
    return out, col.pmean(_aux_loss(probs, flat_e, m), mesh, col.dp_axes(mesh))


def _ffn_shardable(cfg, tp_size):
    m = cfg.moe
    ok_expert = m.n_experts % tp_size == 0 and m.n_experts >= tp_size
    ok_ffn = m.d_expert % tp_size == 0
    return ok_expert or ok_ffn


def moe_apply(p, x, cfg: ModelConfig, return_aux: bool = False):
    """x (B, S, D) or (T, D).  Returns y (+ the aux loss if requested).

    Under a mesh with a ``model`` axis (``sharding.use_mesh``), ``"auto"``
    and ``"shard_map"`` take the expert-parallel path on this rank's blocks
    and rows (a decode step's (T, D) tokens as T rows of one); ``"shard_map"``
    without one raises, as the reference does.  The global dispatch over a
    mesh's ranks (the reference's GSPMD partitioning of ``"gspmd"``) has no
    port and raises."""
    impl = cfg.moe_impl
    mesh = sharding.current_mesh()
    if impl in ("auto", "shard_map") and x.ndim == 3:
        if mesh is not None and "model" in mesh.axis_names and _ffn_shardable(cfg, mesh.shape["model"]):
            return _moe_shard_map(p, x, cfg, mesh, return_aux)
        if impl == "shard_map":
            raise RuntimeError("moe_impl='shard_map' requires a mesh with a 'model' axis")
    if impl in ("auto", "shard_map") and x.ndim == 2 and mesh is not None:
        out = moe_apply(p, x[:, None], cfg, return_aux)
        return (out[0][:, 0], out[1]) if return_aux else out[:, 0]
    if mesh is not None:
        raise NotImplementedError(
            f"moe_impl={impl!r} on {mesh}: the global dispatch over the ranks' rows has no port; the "
            "expert-parallel path needs a 'model' axis over which the experts or their FFN dim split")
    return _moe_gspmd(p, x, cfg, return_aux)
