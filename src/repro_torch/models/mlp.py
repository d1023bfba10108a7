"""Dense FFN block (gated-GLU / squared-ReLU / GELU variants).

Port of ``repro/models/mlp.py``.
"""
from __future__ import annotations

from ..configs.base import ModelConfig
from .common import PSpec, activation, rms_norm

GATED = {"silu_glu", "gelu_glu"}

__all__ = ["GATED", "mlp_specs", "mlp_apply"]


def mlp_specs(cfg: ModelConfig, d_ff: int | None = None) -> dict:
    D = cfg.d_model
    F = d_ff or cfg.d_ff
    specs = {
        "ln": PSpec((D,), ("embed",), "zeros"),
        "w_in": PSpec((D, F), ("embed", "mlp")),
        "w_out": PSpec((F, D), ("mlp", "embed")),
    }
    if cfg.act in GATED:
        specs["w_gate"] = PSpec((D, F), ("embed", "mlp"))
    return specs


def mlp_apply(p, x, cfg: ModelConfig):
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    up = h @ p["w_in"]
    act = activation(cfg.act, up, h @ p["w_gate"]) if cfg.act in GATED else activation(cfg.act, up)
    return x + act @ p["w_out"]
