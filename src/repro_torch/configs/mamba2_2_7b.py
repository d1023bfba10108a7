"""mamba2-2.7b [ssm]: 64 attention-free SSD layers (state-space duality).
d_inner = 2*2560 = 5120, head_dim 64 -> 80 SSD heads, d_state 128.
Constant-size recurrent state -> long_500k decode cell runs.
[arXiv:2405.21060; unverified]
"""
from .base import LayerSpec, ModelConfig, SSMConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-2.7b", family="ssm",
        d_model=2560, n_heads=80, n_kv_heads=80, head_dim=64,
        d_ff=0, vocab=50280,
        pattern=(LayerSpec("ssd", ffn=False),), n_periods=64,
        ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=128),
    )


def smoke_config() -> ModelConfig:
    return get_config().replace(
        d_model=64, n_heads=16, n_kv_heads=16, head_dim=8,
        vocab=256, n_periods=2,
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=8, chunk=32),
        loss_chunk=64, dtype="float32",
    )
