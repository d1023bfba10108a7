"""nemotron-4-15b [dense]: 32L GQA, squared-ReLU (non-gated) MLP.
Partial-rotary (50%) of the real model simplified to full rotary — noted in
DESIGN.md.  [arXiv:2402.16819; unverified]
"""
from .base import LayerSpec, ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-15b", family="dense",
        d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
        d_ff=24576, vocab=256000,
        pattern=(LayerSpec("attn"),), n_periods=32,
        act="sq_relu", rope_theta=10000.0,
    )


def smoke_config() -> ModelConfig:
    return get_config().replace(
        d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab=256, n_periods=2,
        attn_q_block=64, attn_kv_block=64, loss_chunk=64, dtype="float32",
    )
