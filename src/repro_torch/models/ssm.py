"""Mamba2 (SSD — state-space duality) mixer.

Port of ``repro/models/ssm.py``.  Train/prefill use the chunked dual form:
quadratic attention-like products within chunks and a pass over the chunk
states, O(S·l) in all.  Decode carries the (B, H, P, N) recurrent state in
f32 and a width-(w-1) tail for each of the three convolutions, O(1) a
token and no KV cache.

One departure in the order of operations, not in the result: the
reference runs the pass over chunk states as ``lax.associative_scan``;
torch has none, and the pass is a loop over the S/l chunks (16 at S = 2048
with l = 128) in chunk order, which rounds differently.  No Pallas kernel
runs here in the reference; the products are ``torch.einsum``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig, SSMConfig
from .common import PSpec, causal_conv, conv_step, rms_norm

__all__ = [
    "ssd_specs",
    "ssd_chunked",
    "ssd_apply",
    "ssd_init_cache",
    "ssd_cache_axes",
    "ssd_decode",
]


def _dims(cfg: ModelConfig):
    s: SSMConfig = cfg.ssm
    d_inner = s.expand * cfg.d_model
    return s, d_inner, d_inner // s.head_dim


def ssd_specs(cfg: ModelConfig) -> dict:
    s, d_inner, nh = _dims(cfg)
    D, N, W = cfg.d_model, s.d_state, s.d_conv
    return {
        "ln": PSpec((D,), ("embed",), "zeros"),
        "w_z": PSpec((D, d_inner), ("embed", "inner")),
        "w_x": PSpec((D, d_inner), ("embed", "inner")),
        "w_B": PSpec((D, N), ("embed", "state")),
        "w_C": PSpec((D, N), ("embed", "state")),
        "w_dt": PSpec((D, nh), ("embed", None)),
        "conv_x": PSpec((W, d_inner), ("conv", "inner")),
        "conv_B": PSpec((W, N), ("conv", "state")),
        "conv_C": PSpec((W, N), ("conv", "state")),
        "conv_b_x": PSpec((d_inner,), ("inner",), "zeros"),
        "conv_b_B": PSpec((N,), ("state",), "zeros"),
        "conv_b_C": PSpec((N,), ("state",), "zeros"),
        "A_log": PSpec((nh,), (None,), "ssm_a_log", torch.float32),
        "D_skip": PSpec((nh,), (None,), "ones", torch.float32),
        "dt_bias": PSpec((nh,), (None,), "ssm_dt_bias", torch.float32),
        "norm": PSpec((d_inner,), ("inner",), "zeros"),
        "w_out": PSpec((d_inner, D), ("inner", "embed")),
    }


def _causal_conv(x, w, b):
    """Depthwise causal conv along seq, then SiLU: x (B,S,C), w (W,C)."""
    return F.silu(causal_conv(x, w, b))


def _segsum(dA):
    """dA (..., l) -> (..., l, l): sum_{j<k<=i} dA_k, -inf above diagonal."""
    l = dA.shape[-1]
    cs = torch.cumsum(dA, -1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool, device=dA.device))
    return torch.where(mask, diff, -torch.inf)


def ssd_chunked(x, dt, A, B, C, chunk: int, h0=None):
    """SSD dual form.

    x (b,s,h,p) inputs; dt (b,s,h); A (h,) negative; B, C (b,s,n) shared
    across heads (n_groups = 1).  Returns y (b,s,h,p) and the final state
    (b,h,p,n).
    """
    b, s, h, p = x.shape
    n = B.shape[-1]
    l = min(chunk, s)
    while s % l:
        l -= 1
    nc = s // l

    xc = (x * dt[..., None]).reshape(b, nc, l, h, p)
    dAc = (dt * A).reshape(b, nc, l, h)
    Bc = B.reshape(b, nc, l, n)
    Cc = C.reshape(b, nc, l, n)

    # ---- intra-chunk (quadratic within the chunk) ----
    L = torch.exp(_segsum(dAc.movedim(-1, -2)))  # (b,nc,h,l,l)
    G = torch.einsum("bcin,bcjn->bcij", Cc, Bc)  # (b,nc,l,l)
    y_diag = torch.einsum("bchij,bcjhp->bcihp", G[:, :, None] * L, xc)

    # ---- chunk states ----
    dA_cum = torch.cumsum(dAc, dim=2)  # (b,nc,l,h)
    total = dA_cum[:, :, -1:]  # (b,nc,1,h)
    decay_out = torch.exp(total - dA_cum)  # decay from position i to the chunk's end
    states = torch.einsum("bcln,bclhp->bchpn", Bc, xc * decay_out[..., None])

    # ---- inter-chunk pass, in chunk order: H_{c+1} = e^{total_c} H_c + S_c ----
    chunk_decay = torch.exp(total[:, :, 0])  # (b,nc,h)
    state = torch.zeros((b, h, p, n), dtype=states.dtype, device=x.device) if h0 is None else h0
    s_in = []  # the state entering each chunk
    for c in range(nc):
        s_in.append(state)
        state = chunk_decay[:, c, :, None, None] * state + states[:, c]
    s_in = torch.stack(s_in, dim=1)  # (b,nc,h,p,n)

    # ---- off-diagonal: the entering state's contribution ----
    decay_in = torch.exp(dA_cum)  # decay from the chunk's start to position i
    y_off = torch.einsum("bcln,bchpn->bclhp", Cc, s_in) * decay_in[..., None]

    return (y_diag + y_off).reshape(b, s, h, p), state


def ssd_apply(p, x, cfg: ModelConfig, *, return_state: bool = False, h0=None):
    """Full-sequence Mamba2 block (pre-norm, residual).  With
    ``return_state``, also (the final f32 state, the three convolutions'
    input tails of the last W-1 positions) for the decode cache."""
    s_cfg, d_inner, nh = _dims(cfg)
    B_, S, D = x.shape
    h = rms_norm(x, p["ln"], cfg.norm_eps)

    z = h @ p["w_z"]
    pre = {n: h @ p[f"w_{n}"] for n in "xBC"}
    xin = _causal_conv(pre["x"], p["conv_x"], p["conv_b_x"])
    Bv = _causal_conv(pre["B"], p["conv_B"], p["conv_b_B"])
    Cv = _causal_conv(pre["C"], p["conv_C"], p["conv_b_C"])
    dt = F.softplus((h @ p["w_dt"]).float() + p["dt_bias"])  # (B,S,nh)
    A = -torch.exp(p["A_log"])  # (nh,)

    xh = xin.reshape(B_, S, nh, s_cfg.head_dim).float()
    y, h_fin = ssd_chunked(xh, dt, A, Bv.float(), Cv.float(), s_cfg.chunk, h0=h0)
    y = y + p["D_skip"][None, None, :, None] * xh
    y = y.reshape(B_, S, d_inner).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = x + y @ p["w_out"]
    if return_state:
        return out, (h_fin, {n: t[:, -(s_cfg.d_conv - 1):] for n, t in pre.items()})
    return out


def ssd_init_cache(cfg: ModelConfig, B: int, dtype, device=None):
    s, d_inner, nh = _dims(cfg)
    W = s.d_conv
    return {
        "state": torch.zeros((B, nh, s.head_dim, s.d_state), dtype=torch.float32, device=device),
        "conv_x": torch.zeros((B, W - 1, d_inner), dtype=dtype, device=device),
        "conv_B": torch.zeros((B, W - 1, s.d_state), dtype=dtype, device=device),
        "conv_C": torch.zeros((B, W - 1, s.d_state), dtype=dtype, device=device),
    }


def ssd_cache_axes():
    return {
        "state": ("batch", None, "head_dim", "state"),
        "conv_x": ("batch", "conv", "inner"),
        "conv_B": ("batch", "conv", "state"),
        "conv_C": ("batch", "conv", "state"),
    }


def _conv_step(tail, new, w, b):
    """tail (B, W-1, C) history; new (B, C).  Returns (SiLU(out), new_tail)."""
    out, tail = conv_step(tail, new, w, b)
    return F.silu(out), tail


def ssd_decode(p, x, cache, step: int, cfg: ModelConfig):
    """One-token recurrent update.  x (B, D).  Writes the new state and
    tails into ``cache`` in place (the reference's functional update,
    donated) and returns ``(x, cache)``."""
    s_cfg, d_inner, nh = _dims(cfg)
    B_, D = x.shape
    h = rms_norm(x, p["ln"], cfg.norm_eps)

    z = h @ p["w_z"]
    xin, t_x = _conv_step(cache["conv_x"], h @ p["w_x"], p["conv_x"], p["conv_b_x"])
    Bv, t_B = _conv_step(cache["conv_B"], h @ p["w_B"], p["conv_B"], p["conv_b_B"])
    Cv, t_C = _conv_step(cache["conv_C"], h @ p["w_C"], p["conv_C"], p["conv_b_C"])
    dt = F.softplus((h @ p["w_dt"]).float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])

    xh = xin.reshape(B_, nh, s_cfg.head_dim).float()
    dA = torch.exp(dt * A)  # (B, nh)
    state = cache["state"] * dA[..., None, None] + (dt[..., None] * xh)[..., None] * Bv.float()[:, None, None, :]
    y = torch.einsum("bhpn,bn->bhp", state, Cv.float())
    y = y + p["D_skip"][None, :, None] * xh
    y = y.reshape(B_, d_inner).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    for name, new in (("state", state), ("conv_x", t_x), ("conv_B", t_B), ("conv_C", t_C)):
        cache[name].copy_(new)
    return x + y @ p["w_out"], cache
