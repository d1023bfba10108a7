"""musicgen-medium [audio]: 48L decoder-only over EnCodec tokens.

Backbone only (per assignment): the EnCodec/text-conditioning frontend is a
STUB — ``input_specs`` feeds precomputed (B,S,d_model) frame embeddings.
Single-codebook head (vocab 2048); the 4-codebook delay pattern is frontend
territory and out of scope.  [arXiv:2306.05284; hf]
"""
from .base import LayerSpec, ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium", family="audio",
        d_model=1536, n_heads=24, n_kv_heads=24, head_dim=64,
        d_ff=6144, vocab=2048,
        pattern=(LayerSpec("attn"),), n_periods=48,
        act="gelu", frontend="frames", rope_theta=10000.0,
    )


def smoke_config() -> ModelConfig:
    return get_config().replace(
        d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
        d_ff=256, vocab=128, n_periods=2,
        attn_q_block=64, attn_kv_block=64, loss_chunk=64, dtype="float32",
    )
