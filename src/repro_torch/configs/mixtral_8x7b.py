"""mixtral-8x7b [moe]: 32L GQA + 8-expert top-2 MoE, SWA window 4096.
The 4096 sliding window bounds the decode KV cache -> long_500k cell runs.
[arXiv:2401.04088; hf]
"""
from .base import LayerSpec, ModelConfig, MoEConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b", family="moe",
        d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=14336, vocab=32000,
        pattern=(LayerSpec("attn", window=4096, moe=True),), n_periods=32,
        act="silu_glu", rope_theta=1000000.0,
        moe=MoEConfig(n_experts=8, top_k=2, d_expert=14336, norm_topk=True),
    )


def smoke_config() -> ModelConfig:
    return get_config().replace(
        d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab=256, n_periods=2,
        pattern=(LayerSpec("attn", window=64, moe=True),),
        moe=MoEConfig(n_experts=4, top_k=2, d_expert=64, norm_topk=True),
        attn_q_block=64, attn_kv_block=64, loss_chunk=64, dtype="float32",
    )
