"""Dense FFN block (gated-GLU / squared-ReLU / GELU variants).

Port of ``repro/models/mlp.py``.  Under a mesh (``sharding.use_mesh``)
``mlp_apply`` takes each rank's blocks and its rows: ``w_in`` and
``w_gate`` are column-parallel over ``mlp`` and ``w_out`` row-parallel,
followed by one sum over ``model`` (the reference's ``act_ff``
constraints); where ``mlp`` does not split over ``model`` every model rank
computes the whole block with the weights gathered whole.
"""
from __future__ import annotations

from .. import sharding
from ..configs.base import ModelConfig
from ..sharding import collectives as col
from .common import PSpec, activation, gather_tree, mesh_specs, rms_norm

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
    """Pre-norm FFN with residual.  Under a mesh, ``p`` is this rank's
    blocks and ``x`` its rows."""
    mesh = sharding.current_mesh()
    if mesh is not None:
        specs = mesh_specs(mlp_specs(cfg), mesh)
        if mesh.shape.get("model", 1) > 1 and specs["w_out"].axes(0) == ("model",) and all(
                specs[k].axes(1) == ("model",) for k in ("w_in", "w_gate") if k in p):
            p = {k: col.gather_param(w, specs[k], mesh, whole=k == "ln") for k, w in p.items()}
        else:  # mlp does not split over model: every model rank computes the whole block
            p, mesh = gather_tree(p, mlp_specs(cfg), mesh), None
    h = col.copy_to(rms_norm(x, p["ln"], cfg.norm_eps), mesh)
    up = h @ p["w_in"]
    act = activation(cfg.act, up, h @ p["w_gate"]) if cfg.act in GATED else activation(cfg.act, up)
    return x + col.reduce_from(act @ p["w_out"], mesh)
