"""mistral-nemo-12b [dense]: 40L GQA, head_dim 128 (H*hd < d_model), 128k ctx.
[hf:mistralai/Mistral-Nemo-Base-2407; hf]
"""
from .base import LayerSpec, ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="mistral-nemo-12b", family="dense",
        d_model=5120, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=14336, vocab=131072,
        pattern=(LayerSpec("attn"),), n_periods=40,
        act="silu_glu", rope_theta=1000000.0,
    )


def smoke_config() -> ModelConfig:
    return get_config().replace(
        d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab=256, n_periods=2,
        attn_q_block=64, attn_kv_block=64, loss_chunk=64, dtype="float32",
    )
