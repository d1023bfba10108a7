"""llama3.2-1b [dense]: 16L GQA, tied embeddings.
[hf:meta-llama/Llama-3.2-1B; unverified]
"""
from .base import LayerSpec, ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-1b", family="dense",
        d_model=2048, n_heads=32, n_kv_heads=8, head_dim=64,
        d_ff=8192, vocab=128256,
        pattern=(LayerSpec("attn"),), n_periods=16,
        act="silu_glu", rope_theta=500000.0, tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return get_config().replace(
        d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab=256, n_periods=2,
        attn_q_block=64, attn_kv_block=64, loss_chunk=64, dtype="float32",
    )
