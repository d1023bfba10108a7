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

No Pallas kernel runs here in the reference, so none is owed; the products
are ``torch.einsum``.  Cross-attention and MLA (``cross_*``, ``mla_*``)
belong to the second half of the ML stack (ROADMAP A14b) and raise.
"""
from __future__ import annotations

import math

import torch

from ..configs.base import ModelConfig
from .common import PSpec, apply_rope, make_rope, rms_norm

NEG_INF = -1e30

__all__ = [
    "flash_attention",
    "decode_attention",
    "gqa_specs",
    "gqa_apply",
    "gqa_init_cache",
    "gqa_cache_axes",
    "gqa_decode",
    "cross_specs",
    "mla_specs",
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


def decode_attention(q, k_cache, v_cache, valid_mask):
    """One-token attention.  q (B,Hq,dk); caches (B,Hkv,S,d*); mask (B,S)."""
    B, Hq, dk = q.shape
    Hkv = k_cache.shape[1]
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, dk).float()
    s = torch.einsum("bhgd,bhsd->bhgs", qg, k_cache.float()) / math.sqrt(dk)
    s = torch.where(valid_mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgs,bhsd->bhgd", p.to(v_cache.dtype).float(), v_cache.float())
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


def _project_qkv(p, x, cfg: ModelConfig, positions):
    B, S, D = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(B, S, H, hd).transpose(1, 2)
    k = (x @ p["wk"]).reshape(B, S, KV, hd).transpose(1, 2)
    v = (x @ p["wv"]).reshape(B, S, KV, hd).transpose(1, 2)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    cos, sin = make_rope(positions, hd, cfg.rope_theta)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def gqa_apply(p, x, cfg: ModelConfig, *, window=None, pos_offset=0):
    """Full-sequence self-attention block (pre-norm, residual)."""
    B, S, D = x.shape
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    positions = pos_offset + torch.arange(S, device=x.device)
    q, k, v = _project_qkv(p, h, cfg, positions)
    o = flash_attention(
        q, k, v,
        causal=True, window=window, q_offset=0,
        q_block=cfg.attn_q_block, kv_block=cfg.attn_kv_block,
    )
    o = o.transpose(1, 2).reshape(B, S, cfg.n_heads * cfg.head_dim)
    return x + o @ p["wo"]


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
    without one, as in the reference.
    """
    B, D = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
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

    L = cache["k"].shape[2]
    slot = step % L if window else min(step, L - 1)
    cache["k"][:, :, slot] = k.to(cache["k"].dtype)
    cache["v"][:, :, slot] = v.to(cache["v"].dtype)
    slots = torch.arange(L, device=x.device)
    valid = ((slots <= step) | (step >= L)).expand(B, L)
    o = decode_attention(q, cache["k"], cache["v"], valid).reshape(B, H * hd)
    return x + o @ p["wo"], cache


# ===========================================================================
# Cross-attention and MLA: the second half of the ML stack
# ===========================================================================


def _a14b(what: str):
    raise NotImplementedError(
        f"{what} arrives with the second half of the ML stack (ROADMAP A14b)"
    )


def cross_specs(cfg: ModelConfig) -> dict:
    _a14b("cross-attention (the vision front end's mixer)")


def mla_specs(cfg: ModelConfig) -> dict:
    _a14b("MLA (multi-head latent attention)")
