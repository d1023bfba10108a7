"""RG-LRU recurrent block (Griffin / RecurrentGemma).

Port of ``repro/models/rglru.py``.
Block: x -> [W_main -> causal conv -> RG-LRU] ⊙ GeLU(W_gate x) -> W_out.
RG-LRU: r_t = σ(W_a u_t), i_t = σ(W_x u_t),
        log a_t = -c · softplus(Λ) · r_t,
        h_t = a_t h_{t-1} + √(1 − a_t²) · (i_t ⊙ u_t).

The gates and the recurrence run in f32.  Train/prefill solve the linear
recurrence over the sequence with a log-depth doubling scan in torch ops
(⌈log2 S⌉ rounds, 11 at S = 2048) where the reference runs
``lax.associative_scan``: the same pairs are combined, in another order, so
the two agree to rounding, not bitwise.  Decode carries the f32 state
``h`` and the convolution's input tail, O(1) a token.  No Pallas kernel
runs here in the reference.

Under a mesh (``sharding.use_mesh``) the block runs tensor-parallel over
``model`` on each rank's rows, one body with or without a mesh
(``common.tp_weights``): a rank holds R/tp channels, its ``rnn`` columns of
``w_main``, ``w_gate``, ``conv_w`` and ``conv_b`` and its rows of ``w_out``
(row-parallel, followed by one sum over ``model``).  ``rg_wa`` and ``rg_wx``
are ``("rnn", None)``: a rank holds their rows, so ``u_local @ rows`` is a
partial sum of the R×R gate product, reduced over ``model`` and scattered
to the rank's R/tp columns before the sigmoid (``collectives.scatter_sum``,
in f32 where more than two ranks add, its gradient gathered backward; kind
``rnn_gate``).  ``rg_ba``, ``rg_bx`` and ``lam`` (replicated) enter through
``copy_to`` and are cut to the rank's channels; the scan runs on them.  The
decode cache follows the rules: ``h`` and ``conv`` are the rank's channels.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..sharding import collectives as col
from .common import PSpec, causal_conv, conv_step, rms_norm, tp_weights

__all__ = [
    "rglru_specs",
    "linear_scan",
    "rglru_apply",
    "rglru_prefill",
    "rglru_init_cache",
    "rglru_cache_axes",
    "rglru_decode",
]


def rglru_specs(cfg: ModelConfig) -> dict:
    D = cfg.d_model
    R = cfg.d_rnn
    W = cfg.rglru.conv_width
    return {
        "ln": PSpec((D,), ("embed",), "zeros"),
        "w_main": PSpec((D, R), ("embed", "rnn")),
        "w_gate": PSpec((D, R), ("embed", "rnn")),
        "conv_w": PSpec((W, R), ("conv", "rnn")),
        "conv_b": PSpec((R,), ("rnn",), "zeros"),
        "rg_wa": PSpec((R, R), ("rnn", None)),
        "rg_ba": PSpec((R,), (None,), "zeros"),
        "rg_wx": PSpec((R, R), ("rnn", None)),
        "rg_bx": PSpec((R,), (None,), "zeros"),
        "lam": PSpec((R,), (None,), "rglru_lambda", torch.float32),
        "w_out": PSpec((R, D), ("rnn", "embed")),
    }


def _rglru_weights(p, cfg: ModelConfig):
    """``tp_weights`` for RG-LRU, over its channels: the ``rnn`` columns of
    the input side, the rows of ``rg_wa``, ``rg_wx`` and ``w_out``."""
    return tp_weights(p, rglru_specs(cfg), cfg.d_rnn, ("w_main", "w_gate", "conv_w", "conv_b"),
                      ("rg_wa", "rg_wx", "w_out"))


def _gates(p, u, cfg: ModelConfig, mesh=None, chans=None):
    """u (..., R) -> (a, scaled input b) in f32.  Under a mesh ``u`` is this
    rank's channels ``chans`` = (c0, n) and ``p["rg_wa"]``/``p["rg_wx"]``
    its rows: the products are summed over ``model`` and cut to the rank's
    columns (``scatter_sum``)."""
    sl = slice(chans[0], chans[0] + chans[1]) if chans else slice(None)

    def gate(w, b):
        return torch.sigmoid(col.scatter_sum(u @ w, -1, mesh, kind="rnn_gate").float() + col.copy_to(b, mesh)[sl])

    r = gate(p["rg_wa"], p["rg_ba"])
    i = gate(p["rg_wx"], p["rg_bx"])
    a = torch.exp(-cfg.rglru.c * F.softplus(col.copy_to(p["lam"], mesh)[sl]) * r)
    beta = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12))
    return a, beta * (i * u.float())


def linear_scan(a, b):
    """h_t = a_t h_{t-1} + b_t along dim 1 from h_{-1} = 0, for every t:
    a doubling scan (after the round at offset d, position t holds the
    composition of positions (t − 2d, t])."""
    S, d = a.shape[1], 1
    while d < S:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def rglru_apply(p, x, cfg: ModelConfig, *, return_state=False, state0=None):
    """Full-sequence Griffin recurrent block.  x (B, S, D).  ``state0``
    (B, R) enters before the first position; with ``return_state``, also
    (the last f32 state, the convolution's input tail) for the cache (under
    a mesh, this rank's channels of both)."""
    p, mesh, chans = _rglru_weights(p, cfg)
    h = col.copy_to(rms_norm(x, p["ln"], cfg.norm_eps), mesh)
    pre = h @ p["w_main"]
    u = causal_conv(pre, p["conv_w"], p["conv_b"])
    gate = F.gelu(h @ p["w_gate"], approximate="tanh")

    a, b = _gates(p, u, cfg, mesh, chans)  # (B,S,R) f32
    if state0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * state0[:, None], b[:, 1:]], dim=1)
    hseq = linear_scan(a, b)
    out = x + col.reduce_from((hseq.to(x.dtype) * gate) @ p["w_out"], mesh)
    if return_state:
        return out, (hseq[:, -1], pre[:, -(cfg.rglru.conv_width - 1):])
    return out


def rglru_prefill(p, x, cache, cfg: ModelConfig):
    """``rglru_apply`` over a prompt, writing its last state and the
    convolution's tail into ``cache`` in place (under a mesh, this rank's
    channels: the rules split ``h`` and ``conv`` over ``rnn``)."""
    out, (state, tail) = rglru_apply(p, x, cfg, return_state=True)
    cache["h"].copy_(state)
    cache["conv"].copy_(tail)
    return out


def rglru_init_cache(cfg: ModelConfig, B: int, dtype, device=None):
    R, W = cfg.d_rnn, cfg.rglru.conv_width
    return {
        "h": torch.zeros((B, R), dtype=torch.float32, device=device),
        "conv": torch.zeros((B, W - 1, R), dtype=dtype, device=device),
    }


def rglru_cache_axes():
    return {"h": ("batch", "rnn"), "conv": ("batch", "conv", "rnn")}


def rglru_decode(p, x, cache, step: int, cfg: ModelConfig):
    """One-token recurrent update.  x (B, D).  Writes the new state and tail
    into ``cache`` in place and returns ``(x, cache)`` (under a mesh, this
    rank's channels of both)."""
    p, mesh, chans = _rglru_weights(p, cfg)
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    u, tail = conv_step(cache["conv"], h @ p["w_main"], p["conv_w"], p["conv_b"])
    gate = F.gelu(h @ p["w_gate"], approximate="tanh")

    a, b = _gates(p, u, cfg, mesh, chans)
    h_new = a * cache["h"] + b
    y = (h_new.to(x.dtype) * gate) @ p["w_out"]
    cache["h"].copy_(h_new)
    cache["conv"].copy_(tail)
    return x + col.reduce_from(y, mesh), cache
