"""Attention mixers: blockwise flash attention (GQA / MQA / sliding window)
with qk-norm, and its decode path over a KV cache.

Port of ``repro/models/attention.py``.  The train/prefill path is the
reference's online-softmax blockwise attention, in torch ops: O(qb·kvb)
live scores instead of O(S²), the same block sizes (``_pick_block``), the
same masks and the same sliding-window block selection, so peak memory stays
bounded at long prompts.  Scores and the probability-weighted sums are
computed in f32 from the inputs' values (the reference's
``preferred_element_type=f32``).  One departure in the loop, not in the
result: a causal kv block that lies wholly above the diagonal of a q block
is skipped, since it adds exactly zero (its probabilities are exp(-1e30 - m)
= 0 and its correction exp(m - m) = 1).

Cross-attention (``cross_*``: text queries over image patch embeddings,
scaled by tanh(gate)) and DeepSeek-V2's multi-head latent attention
(``mla_*``: a latent KV cache and the weight-absorbed decode) are the
reference's too.

Under a mesh (``sharding.use_mesh``) ``gqa_apply`` takes each rank's
blocks and its rows and runs tensor-parallel over ``model`` (the
reference's ``act_heads`` constraints): each model rank projects its own
slice of the query heads (``wq`` column-parallel), the KV heads those
query heads use (head h uses KV head h // (H/KV); ``kv_heads`` is
replicated by the rules), attends, and multiplies by its rows of ``wo``
(row-parallel), followed by one sum over ``model``.  The weights arrive
through the FSDP gather over ``data``.  Where the heads do not split over
``model`` every model rank computes the whole block on its rows, with the
weights gathered whole.

Serving under a mesh, each rank holds its rows of every GQA and MLA cache
and, where the rules split ``cache_seq`` (over ``model`` by default), only
its slice of the positions (of a window's ring, its slice of the ``L``
slots).  A prompt's keys and values (``gqa_prefill``), and MLA's latent,
are projected only at the positions this rank holds, with the whole
``wk``/``wv`` (which the rules replicate over ``model``).  A decode step
(``gqa_decode``, ``mla_decode``) computes every query head (``wq``
gathered whole), writes the new token on the rank that holds its slot,
attends over the rank's positions and combines the ranks' partial
attentions in f32 (``_combine``: the running max by an ``all_reduce`` MAX,
then the sums of exponentials and the weighted values by ``all_reduce``
SUMs, counted as ``collectives.BYTES["attn_combine"]``).  GQA's output
then goes through the rank's rows of ``wo`` and one sum over ``model``, as
in ``gqa_apply``; MLA's weights are whole (``transformer`` gathers them).
With no mesh the combine is the identity and the body is the one-process
decode.

No Pallas kernel runs here in the reference, so none is owed; the products
are ``torch.einsum``.
"""
from __future__ import annotations

import math

import torch

from .. import sharding
from ..configs.base import MLAConfig, ModelConfig
from ..sharding import collectives as col
from .common import PSpec, apply_rope, gather_tree, make_rope, mesh_specs, rms_norm

NEG_INF = -1e30

__all__ = [
    "flash_attention",
    "decode_attention",
    "gqa_specs",
    "gqa_apply",
    "gqa_prefill",
    "gqa_init_cache",
    "gqa_cache_axes",
    "gqa_decode",
    "cross_specs",
    "cross_apply",
    "cross_decode",
    "mla_specs",
    "mla_latent",
    "mla_apply",
    "mla_init_cache",
    "mla_cache_axes",
    "mla_decode",
]


def _pick_block(size: int, want: int) -> int:
    b = min(want, size)
    while size % b:
        b -= 1
    return max(b, 1)


def flash_attention(
    q: torch.Tensor,  # (B, Hq, Sq, dk)
    k: torch.Tensor,  # (B, Hkv, Skv, dk)
    v: torch.Tensor,  # (B, Hkv, Skv, dv)
    *,
    causal: bool = True,
    window: int | None = None,
    q_offset: int = 0,
    q_block: int = 512,
    kv_block: int = 1024,
) -> torch.Tensor:
    """Blockwise online-softmax attention.  Returns (B, Hq, Sq, dv) in v's
    dtype."""
    B, Hq, Sq, dk = q.shape
    _, Hkv, Skv, _ = k.shape
    dv = v.shape[-1]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(dk)

    qb = _pick_block(Sq, q_block)
    kvb = _pick_block(Skv, kv_block)
    nq, nkv = Sq // qb, Skv // kvb
    n_win = min(nkv, -(-(window + qb) // kvb) + 1) if window is not None else nkv

    qg = q.reshape(B, Hkv, G, Sq, dk)
    kv_pos_base = torch.arange(kvb, device=q.device)
    q_pos_base = torch.arange(qb, device=q.device)
    outs = []
    for qi in range(nq):
        q_i = qg[:, :, :, qi * qb:(qi + 1) * qb].float()
        q_start = qi * qb + q_offset  # absolute position of q row 0
        if window is not None:
            first_needed = max(q_start - window + 1, 0) // kvb
            start_blk = min(first_needed, nkv - n_win)
        else:
            start_blk = 0
        q_pos = q_start + q_pos_base  # (qb,)
        m = torch.full((B, Hkv, G, qb), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, Hkv, G, qb), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, Hkv, G, qb, dv), dtype=torch.float32, device=q.device)
        for j in range(n_win):
            blk = start_blk + j
            if causal and blk * kvb > q_start + qb - 1:
                break  # wholly above the diagonal: adds exactly zero
            k_j = k[:, :, blk * kvb:(blk + 1) * kvb].float()
            v_j = v[:, :, blk * kvb:(blk + 1) * kvb]
            s = torch.einsum("bhgqd,bhkd->bhgqk", q_i, k_j) * scale
            kv_pos = blk * kvb + kv_pos_base  # (kvb,)
            mask = torch.ones((qb, kvb), dtype=torch.bool, device=q.device)
            if causal:
                mask &= kv_pos[None, :] <= q_pos[:, None]
            if window is not None:
                mask &= kv_pos[None, :] > q_pos[:, None] - window
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bhkd->bhgqd", p.to(v.dtype).float(), v_j.float()
            )
            m = m_new
        outs.append(acc / torch.where(l == 0, 1.0, l)[..., None])
    out = torch.cat(outs, dim=3)  # (B, Hkv, G, Sq, dv)
    return out.reshape(B, Hq, Sq, dv).to(v.dtype)


def _seq_split():
    """(the mesh, the mesh axes a cache's positions split over under the
    current mesh and rules, this rank's index over them, their size); with
    no mesh, or where the rules keep ``cache_seq`` whole, ``(mesh, (), 0,
    1)``."""
    mesh = sharding.current_mesh()
    if mesh is None:
        return None, (), 0, 1
    axes = sharding.logical_to_spec(("cache_seq",), mesh, sharding.current_rules()).axes(0)
    if not axes or mesh.axis_size(axes) == 1:
        return mesh, (), 0, 1
    return mesh, axes, mesh.axis_index(axes), mesh.axis_size(axes)


def _combine(out, s, over, mesh):
    """The attention over every rank's positions from each rank's own:
    ``out`` (..., d) this rank's softmax-weighted values over its positions,
    ``s`` (..., n) its masked scores.  In f32, with m_r and l_r the rank's
    max and sum of exponentials: m = max_r m_r, c_r = l_r·exp(m_r − m) and
    the result Σ_r out_r·c_r / Σ_r c_r, in ``out``'s dtype.  A rank with no
    valid position has m_r = −1e30 and adds 0.  With nothing to combine
    (``over`` empty: one rank holds every position) ``out`` itself."""
    if not over:
        return out
    m_r = s.amax(-1)
    l_r = torch.exp(s - m_r[..., None]).sum(-1)
    m = col.psum_over(m_r, over, mesh, kind="attn_combine", op="max")
    c = l_r * torch.exp(m_r - m)
    w = c / col.psum_over(c, over, mesh, kind="attn_combine")
    return col.psum_over(out.float() * w[..., None], over, mesh, kind="attn_combine").to(out.dtype)


def decode_attention(q, k_cache, v_cache, valid_mask, *, over=()):
    """One-token attention.  q (B,Hq,dk); caches (B,Hkv,S,d*); mask (B,S).

    ``over``: the mesh axes the caches' positions are split over (this rank
    holds its slice of them, ``valid_mask`` its slice of the mask); the
    ranks' attentions are combined over them (``_combine``)."""
    B, Hq, dk = q.shape
    Hkv = k_cache.shape[1]
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, dk).float()
    s = torch.einsum("bhgd,bhsd->bhgs", qg, k_cache.float()) / math.sqrt(dk)
    s = torch.where(valid_mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgs,bhsd->bhgd", p.to(v_cache.dtype).float(), v_cache.float())
    out = _combine(out, s, over, sharding.current_mesh())
    return out.reshape(B, Hq, v_cache.shape[-1]).to(v_cache.dtype)


# ===========================================================================
# GQA self-attention block
# ===========================================================================


def gqa_specs(cfg: ModelConfig) -> dict:
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    specs = {
        "ln": PSpec((D,), ("embed",), "zeros"),
        "wq": PSpec((D, H * hd), ("embed", "heads")),
        "wk": PSpec((D, KV * hd), ("embed", "kv_heads")),
        "wv": PSpec((D, KV * hd), ("embed", "kv_heads")),
        "wo": PSpec((H * hd, D), ("heads", "embed")),
    }
    if cfg.qk_norm:
        specs["q_norm"] = PSpec((hd,), ("head_dim",), "zeros")
        specs["k_norm"] = PSpec((hd,), ("head_dim",), "zeros")
    return specs


def _project_qkv(p, h, cfg: ModelConfig, positions, *, heads=None, mesh=None):
    """The roped queries, keys and values of the normed input ``h``:
    (B, Hl, S, hd), (B, n_kv, S, hd) and (B, n_kv, S, hd).

    ``heads`` = (h0, Hl): only query heads h0 … h0 + Hl − 1 (``p["wq"]`` holds
    their columns) and, repeated so head i of them reads its own, the KV
    heads they use (head h uses KV head h // (H/KV)); default every head.
    The weights used whole here (``wk``, ``wv``, the qk norms) enter through
    ``collectives.copy_to`` over ``mesh``'s ``model`` axis, so their
    gradients are summed over ``model`` exactly once (with no mesh, as
    themselves)."""
    B, S, D = h.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h0, Hl = heads or (0, H)
    G = H // KV
    if Hl % G == 0:  # whole groups: KV heads h0/G … (h0 + Hl)/G − 1, in order
        cols, n_kv, expand = slice(h0 // G * hd, (h0 + Hl) // G * hd), Hl // G, None
    else:  # a group split between ranks: the KV head of each query head
        kv_of = [(h0 + i) // G for i in range(Hl)]
        cols, n_kv = slice(kv_of[0] * hd, (kv_of[-1] + 1) * hd), kv_of[-1] - kv_of[0] + 1
        expand = [j - kv_of[0] for j in kv_of]
    q = (h @ p["wq"]).reshape(B, S, Hl, hd).transpose(1, 2)
    k = (h @ col.copy_to(p["wk"], mesh)[:, cols]).reshape(B, S, n_kv, hd).transpose(1, 2)
    v = (h @ col.copy_to(p["wv"], mesh)[:, cols]).reshape(B, S, n_kv, hd).transpose(1, 2)
    if expand is not None:
        k, v = k[:, expand], v[:, expand]
    if cfg.qk_norm:
        q = rms_norm(q, col.copy_to(p["q_norm"], mesh), cfg.norm_eps)
        k = rms_norm(k, col.copy_to(p["k_norm"], mesh), cfg.norm_eps)
    cos, sin = make_rope(positions, hd, cfg.rope_theta)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _gqa_weights(p, cfg: ModelConfig, *, whole_q: bool = False):
    """The weights this rank uses, the mesh its tensor-parallel sums run
    over (``None`` where every rank computes every head) and its query heads
    (h0, Hl).  With no mesh, ``p`` and every head.  Under a mesh whose
    ``model`` axis splits the heads, ``wq`` and ``wo`` are this rank's
    columns and rows (gathered over ``data``; ``whole_q``: ``wq`` gathered
    whole, for a decode step that attends with every head), the rest
    gathered whole; where it does not split them, every weight gathered
    whole."""
    H = cfg.n_heads
    mesh = sharding.current_mesh()
    if mesh is None:
        return p, None, (0, H)
    specs = mesh_specs(gqa_specs(cfg), mesh)
    tp = mesh.shape.get("model", 1)
    if tp == 1 or H % tp or specs["wq"].axes(1) != ("model",) or specs["wo"].axes(0) != ("model",):
        return gather_tree(p, gqa_specs(cfg), mesh), None, (0, H)
    own = ("wo",) if whole_q else ("wq", "wo")
    w = {k: col.gather_param(t, specs[k], mesh, whole=k not in own) for k, t in p.items()}
    return w, mesh, (mesh.axis_index("model") * (H // tp), H // tp)


def gqa_apply(p, x, cfg: ModelConfig, *, window=None, pos_offset=0):
    """Full-sequence self-attention block (pre-norm, residual).  Under a
    mesh, ``p`` is this rank's blocks and ``x`` its rows; over ``model`` each
    rank attends with its own query heads and multiplies by its rows of
    ``wo``, followed by one sum over ``model`` (``ln`` acts before that
    region, so its gradient is whole on every rank already)."""
    return _gqa_attend(*_gqa_weights(p, cfg), x, cfg, window, pos_offset)


def _gqa_attend(p, mesh, heads, x, cfg: ModelConfig, window, pos_offset):
    """``gqa_apply`` on the weights, mesh and heads of ``_gqa_weights``."""
    B, S, D = x.shape
    h = col.copy_to(rms_norm(x, p["ln"], cfg.norm_eps), mesh)
    positions = pos_offset + torch.arange(S, device=x.device)
    q, k, v = _project_qkv(p, h, cfg, positions, heads=heads, mesh=mesh)
    o = flash_attention(
        q, k, v,
        causal=True, window=window, q_offset=0,
        q_block=cfg.attn_q_block, kv_block=cfg.attn_kv_block,
    )
    o = o.transpose(1, 2).reshape(B, S, heads[1] * cfg.head_dim)
    return x + col.reduce_from(o @ p["wo"], mesh)


def _project_kv(p, h, cfg: ModelConfig, positions):
    """Every KV head's roped (qk-normed) keys and its values at the rows of
    ``h`` (B, n, D) standing at ``positions``: (B, KV, n, hd) each, as
    ``_project_qkv`` computes them."""
    B, n, _ = h.shape
    KV, hd = cfg.n_kv_heads, cfg.head_dim
    k = (h @ p["wk"]).reshape(B, n, KV, hd).transpose(1, 2)
    v = (h @ p["wv"]).reshape(B, n, KV, hd).transpose(1, 2)
    if cfg.qk_norm:
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    cos, sin = make_rope(positions, hd, cfg.rope_theta)
    return apply_rope(k, cos, sin), v


def _prompt_slots(S: int, L: int, a: int, n: int):
    """The prompt positions of a GQA cache of ``L`` slots (position t at
    slot t % L, the last min(S, L) positions kept) that fall in slots
    a … a + n − 1: (t0, t1, first slot − a) for each run of consecutive
    positions (at most two: the ring wraps once)."""
    lo, hi = S - min(S, L), S
    out = []
    for k in (lo // L, lo // L + 1):
        t0, t1 = max(lo, k * L + a), min(hi, k * L + a + n)
        if t0 < t1:
            out.append((t0, t1, t0 - k * L - a))
    return out


def gqa_prefill(p, x, cache, cfg: ModelConfig, *, window=None):
    """``gqa_apply`` over a prompt (B, S, D), writing into ``cache`` in place
    the keys and values of its last ``L`` positions (position t at slot
    t % L) that this rank's slots hold: the reference recomputes the cache
    projections beside the layer.  Under a mesh the weights are gathered
    once for both."""
    B, S, D = x.shape
    w, mesh, heads = _gqa_weights(p, cfg)
    _, _, i, parts = _seq_split()
    n = cache["k"].shape[2]
    h = rms_norm(x, w["ln"], cfg.norm_eps)
    for t0, t1, slot in _prompt_slots(S, n * parts, i * n, n):
        k, v = _project_kv(w, h[:, t0:t1], cfg, torch.arange(t0, t1, device=x.device))
        cache["k"][:, :, slot:slot + t1 - t0] = k.to(cache["k"].dtype)
        cache["v"][:, :, slot:slot + t1 - t0] = v.to(cache["v"].dtype)
    return _gqa_attend(w, mesh, heads, x, cfg, window, 0)


def gqa_init_cache(cfg: ModelConfig, B: int, S: int, window, dtype, device=None):
    L = min(S, window) if window else S
    KV, hd = cfg.n_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((B, KV, L, hd), dtype=dtype, device=device),
        "v": torch.zeros((B, KV, L, hd), dtype=dtype, device=device),
    }


def gqa_cache_axes():
    return {
        "k": ("batch", "kv_heads", "cache_seq", "head_dim"),
        "v": ("batch", "kv_heads", "cache_seq", "head_dim"),
    }


def gqa_decode(p, x, cache, step: int, cfg: ModelConfig, *, window=None):
    """x (B, D), one token at absolute position ``step`` (an int).

    Writes the token's k and v into ``cache`` in place (the reference's
    functional update, donated) and returns ``(x, cache)``.  The slot is
    ``step % L`` with a window (the ring buffer) and ``min(step, L - 1)``
    without one, as in the reference.  Under a mesh ``cache`` holds this
    rank's slots a … a + n − 1 of the L (``_seq_split``): the rank holding
    the slot writes it, each attends over its own and the ranks' attentions
    are combined; the output goes through this rank's rows of ``wo`` and
    one sum over ``model``.
    """
    B, D = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p, mesh, (h0, Hl) = _gqa_weights(p, cfg, whole_q=True)
    _, over, i, parts = _seq_split()
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    q = (h @ p["wq"]).reshape(B, H, hd)
    k = (h @ p["wk"]).reshape(B, KV, hd)
    v = (h @ p["wv"]).reshape(B, KV, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    cos, sin = make_rope(torch.full((1,), step, device=x.device), hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    n = cache["k"].shape[2]
    L, a = n * parts, i * n
    slot = step % L if window else min(step, L - 1)
    if a <= slot < a + n:
        cache["k"][:, :, slot - a] = k.to(cache["k"].dtype)
        cache["v"][:, :, slot - a] = v.to(cache["v"].dtype)
    slots = a + torch.arange(n, device=x.device)
    valid = ((slots <= step) | (step >= L)).expand(B, n)
    o = decode_attention(q, cache["k"], cache["v"], valid, over=over).reshape(B, H * hd)
    return x + col.reduce_from(o[:, h0 * hd:(h0 + Hl) * hd] @ p["wo"], mesh), cache


# ===========================================================================
# Cross-attention block (VLM): text queries attend to image patch embeddings
# ===========================================================================


def cross_specs(cfg: ModelConfig) -> dict:
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "ln": PSpec((D,), ("embed",), "zeros"),
        "wq": PSpec((D, H * hd), ("embed", "heads")),
        "wk": PSpec((D, KV * hd), ("embed", "kv_heads")),
        "wv": PSpec((D, KV * hd), ("embed", "kv_heads")),
        "wo": PSpec((H * hd, D), ("heads", "embed")),
        "gate": PSpec((1,), (None,), "zeros"),  # tanh gate (llama-vision)
        "k_norm": PSpec((hd,), ("head_dim",), "zeros"),
        "q_norm": PSpec((hd,), ("head_dim",), "zeros"),
    }


def _image_kv(p, img, cfg: ModelConfig):
    """The image's keys (qk-normed) and values, (B, KV, P, hd) each."""
    if img is None:
        raise ValueError("a cross-attention layer needs the image embeddings (batch['image_embeds'] or img=)")
    B, P_img, _ = img.shape
    KV, hd = cfg.n_kv_heads, cfg.head_dim
    k = rms_norm((img @ p["wk"]).reshape(B, P_img, KV, hd).transpose(1, 2), p["k_norm"], cfg.norm_eps)
    v = (img @ p["wv"]).reshape(B, P_img, KV, hd).transpose(1, 2)
    return k, v


def cross_apply(p, x, img, cfg: ModelConfig):
    """x (B,S,D) text; img (B,P,D) precomputed patch embeddings (a stub of
    the vision tower).  The output is scaled by tanh(gate)."""
    B, S, D = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    q = rms_norm((h @ p["wq"]).reshape(B, S, H, hd).transpose(1, 2), p["q_norm"], cfg.norm_eps)
    k, v = _image_kv(p, img, cfg)
    o = flash_attention(q, k, v, causal=False, q_block=cfg.attn_q_block, kv_block=cfg.attn_kv_block)
    o = o.transpose(1, 2).reshape(B, S, H * hd)
    return x + torch.tanh(p["gate"]).to(x.dtype) * (o @ p["wo"])


def cross_decode(p, x, img, cfg: ModelConfig):
    """One-token cross-attention; the image acts as a fixed KV cache,
    projected again at every step as in the reference."""
    B, D = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    q = rms_norm((h @ p["wq"]).reshape(B, H, hd), p["q_norm"], cfg.norm_eps)
    k, v = _image_kv(p, img, cfg)
    valid = torch.ones((B, k.shape[2]), dtype=torch.bool, device=x.device)
    o = decode_attention(q, k, v, valid).reshape(B, H * hd)
    return x + torch.tanh(p["gate"]).to(x.dtype) * (o @ p["wo"])


# ===========================================================================
# MLA (DeepSeek-V2 multi-head latent attention)
# ===========================================================================


def mla_specs(cfg: ModelConfig) -> dict:
    D, H = cfg.d_model, cfg.n_heads
    m: MLAConfig = cfg.mla
    dq = m.qk_nope_dim + m.qk_rope_dim
    return {
        "ln": PSpec((D,), ("embed",), "zeros"),
        "wq_a": PSpec((D, m.q_lora), ("embed", "lora")),
        "q_ln": PSpec((m.q_lora,), ("lora",), "zeros"),
        "wq_b": PSpec((m.q_lora, H * dq), ("lora", "heads")),
        "wkv_a": PSpec((D, m.kv_lora + m.qk_rope_dim), ("embed", "lora")),
        "kv_ln": PSpec((m.kv_lora,), ("lora",), "zeros"),
        "wkv_b": PSpec((m.kv_lora, H * (m.qk_nope_dim + m.v_dim)), ("lora", "heads")),
        "wo": PSpec((H * m.v_dim, D), ("heads", "embed")),
    }


def mla_latent(p, h, cfg: ModelConfig, positions):
    """The normed latent (..., S, kv_lora) and the roped key half shared by
    every head (..., S, dr): what the decode cache holds."""
    m: MLAConfig = cfg.mla
    kv_a = h @ p["wkv_a"]  # (..., S, kv_lora + dr)
    latent = rms_norm(kv_a[..., : m.kv_lora], p["kv_ln"], cfg.norm_eps)
    cos, sin = make_rope(positions, m.qk_rope_dim, cfg.rope_theta)
    return latent, apply_rope(kv_a[..., m.kv_lora:], cos, sin)


def _mla_qkv(p, h, cfg: ModelConfig, positions):
    B, S, D = h.shape
    H = cfg.n_heads
    m: MLAConfig = cfg.mla
    dn, dr = m.qk_nope_dim, m.qk_rope_dim

    q = rms_norm(h @ p["wq_a"], p["q_ln"], cfg.norm_eps) @ p["wq_b"]
    q = q.reshape(B, S, H, dn + dr).transpose(1, 2)
    cos, sin = make_rope(positions, dr, cfg.rope_theta)
    latent, k_rope = mla_latent(p, h, cfg, positions)
    return q[..., :dn], apply_rope(q[..., dn:], cos, sin), latent, k_rope[:, None]  # k_rope (B, 1, S, dr)


def mla_apply(p, x, cfg: ModelConfig, *, pos_offset=0):
    """Full-sequence MLA block (pre-norm, residual): the latent is expanded
    to per-head keys and values (the train/prefill path)."""
    B, S, D = x.shape
    H = cfg.n_heads
    m: MLAConfig = cfg.mla
    dn, dr, dv = m.qk_nope_dim, m.qk_rope_dim, m.v_dim
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    positions = pos_offset + torch.arange(S, device=x.device)
    q_nope, q_rope, latent, k_rope = _mla_qkv(p, h, cfg, positions)

    kv = (latent @ p["wkv_b"]).reshape(B, S, H, dn + dv).transpose(1, 2)
    k = torch.cat([kv[..., :dn], k_rope.expand(B, H, S, dr)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    o = flash_attention(q, k, kv[..., dn:], causal=True, q_block=cfg.attn_q_block, kv_block=cfg.attn_kv_block)
    o = o.transpose(1, 2).reshape(B, S, H * dv)
    return x + o @ p["wo"]


def mla_init_cache(cfg: ModelConfig, B: int, S: int, dtype, device=None):
    m: MLAConfig = cfg.mla
    return {
        "latent": torch.zeros((B, S, m.kv_lora), dtype=dtype, device=device),
        "k_rope": torch.zeros((B, S, m.qk_rope_dim), dtype=dtype, device=device),
    }


def mla_cache_axes():
    return {
        "latent": ("batch", "cache_seq", "lora"),
        "k_rope": ("batch", "cache_seq", "head_dim"),
    }


def mla_decode(p, x, cache, step: int, cfg: ModelConfig):
    """Weight-absorbed MLA decode: attention runs in latent space.

    q̃ = q_nopeᵀ W_uk (B,H,kv_lora); scores = q̃·latentᵀ + q_rope·k_ropeᵀ;
    ctx = attn·latent; out_h = ctx·W_uv, with W_uk and W_uv slices of
    ``wkv_b``: no key or value is expanded per head.  Writes the token's
    latent and k_rope into ``cache`` in place (slot ``min(step, S − 1)``)
    and returns ``(x, cache)``.  Under a mesh ``p`` is whole and ``cache``
    holds this rank's slots of the S (``_seq_split``): the rank holding the
    slot writes it, and each rank's ctx over its own positions is combined
    with the others'.
    """
    B, D = x.shape
    H = cfg.n_heads
    m: MLAConfig = cfg.mla
    dn, dr, dv = m.qk_nope_dim, m.qk_rope_dim, m.v_dim
    h = rms_norm(x, p["ln"], cfg.norm_eps)

    q = (rms_norm(h @ p["wq_a"], p["q_ln"], cfg.norm_eps) @ p["wq_b"]).reshape(B, H, dn + dr)
    pos = torch.full((1,), step, device=x.device)
    cos, sin = make_rope(pos, dr, cfg.rope_theta)
    q_nope, q_rope = q[..., :dn], apply_rope(q[..., dn:], cos, sin)
    latent_new, k_rope_new = mla_latent(p, h[None], cfg, pos)

    mesh, over, i, parts = _seq_split()
    n = cache["latent"].shape[1]
    S, a = n * parts, i * n
    slot = min(step, S - 1)
    if a <= slot < a + n:
        cache["latent"][:, slot - a] = latent_new[0].to(cache["latent"].dtype)
        cache["k_rope"][:, slot - a] = k_rope_new[0].to(cache["k_rope"].dtype)
    latent, k_rope = cache["latent"], cache["k_rope"]

    wkv_b = p["wkv_b"].reshape(m.kv_lora, H, dn + dv)
    q_abs = torch.einsum("bhd,lhd->bhl", q_nope, wkv_b[..., :dn])  # (B, H, kv_lora)
    s = (torch.einsum("bhl,bsl->bhs", q_abs.float(), latent.float())
         + torch.einsum("bhr,bsr->bhs", q_rope.float(), k_rope.float())) / math.sqrt(dn + dr)
    valid = a + torch.arange(n, device=x.device) <= step
    s = torch.where(valid, s, NEG_INF)
    probs = torch.softmax(s, dim=-1)
    ctx = _combine(torch.einsum("bhs,bsl->bhl", probs.to(latent.dtype), latent), s, over, mesh)
    o = torch.einsum("bhl,lhd->bhd", ctx, wkv_b[..., dn:]).reshape(B, H * dv)
    return x + o @ p["wo"], cache
