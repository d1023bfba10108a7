"""llama-3.2-vision-11b [vlm]: 40L text backbone; cross-attention to image
patches at layers 3,8,...,38 (pattern period 5, cross at slot 3).  Vision
tower is a STUB: ``input_specs`` provides precomputed, pre-projected
(B, n_patches, d_model) patch embeddings.
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]
"""
from .base import LayerSpec, ModelConfig

_S = LayerSpec("attn")
_X = LayerSpec("cross_attn")


def get_config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-11b", family="vlm",
        d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=14336, vocab=128256,
        pattern=(_S, _S, _S, _X, _S), n_periods=8,
        act="silu_glu", rope_theta=500000.0,
        frontend="vision", n_patches=1600,
    )


def smoke_config() -> ModelConfig:
    return get_config().replace(
        d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab=256, n_periods=2, n_patches=16,
        attn_q_block=64, attn_kv_block=64, loss_chunk=64, dtype="float32",
    )
