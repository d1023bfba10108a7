"""qwen3-0.6b [dense]: 28L GQA with per-head qk-norm, head_dim 128.
[hf:Qwen/Qwen3-8B (family); hf]
"""
from .base import LayerSpec, ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-0.6b", family="dense",
        d_model=1024, n_heads=16, n_kv_heads=8, head_dim=128,
        d_ff=3072, vocab=151936,
        pattern=(LayerSpec("attn"),), n_periods=28,
        act="silu_glu", qk_norm=True, rope_theta=1000000.0,
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return get_config().replace(
        d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab=256, n_periods=2,
        attn_q_block=64, attn_kv_block=64, loss_chunk=64, dtype="float32",
    )
