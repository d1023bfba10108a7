"""deepseek-v2-236b [moe]: 60L MLA (kv_lora 512) + 160-expert top-6 MoE with
2 shared experts; first layer uses a dense d_ff=12288 MLP (prefix).
Decode uses the weight-absorbed MLA path.  [arXiv:2405.04434; hf]
"""
from .base import LayerSpec, MLAConfig, ModelConfig, MoEConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b", family="moe",
        d_model=5120, n_heads=128, n_kv_heads=128, head_dim=128,
        d_ff=12288, vocab=102400,
        prefix=(LayerSpec("mla", moe=False),),
        pattern=(LayerSpec("mla", moe=True),), n_periods=59,
        act="silu_glu", rope_theta=10000.0,
        mla=MLAConfig(kv_lora=512, q_lora=1536, qk_nope_dim=128,
                      qk_rope_dim=64, v_dim=128),
        moe=MoEConfig(n_experts=160, top_k=6, d_expert=1536, n_shared=2,
                      norm_topk=False),
        # 236B on 16 GB/chip: bf16 Adam moments + bf16 grad accumulation
        # (master stays f32); multi-pod adds ZeRO-1 over the pod axis.
        opt_moments_dtype="bfloat16",
        grad_accum_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return get_config().replace(
        d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
        d_ff=256, vocab=256, n_periods=2,
        mla=MLAConfig(kv_lora=32, q_lora=48, qk_nope_dim=16,
                      qk_rope_dim=8, v_dim=16),
        moe=MoEConfig(n_experts=4, top_k=2, d_expert=64, n_shared=1,
                      norm_topk=False),
        attn_q_block=64, attn_kv_block=64, loss_chunk=64, dtype="float32",
    )
