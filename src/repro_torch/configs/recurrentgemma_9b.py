"""recurrentgemma-9b [hybrid]: Griffin — (RG-LRU, RG-LRU, local-attn) x 12
+ 2 trailing RG-LRU blocks = 38 layers.  MQA local attention, window 2048.
[arXiv:2402.19427; unverified]
"""
from .base import LayerSpec, ModelConfig, RGLRUConfig

_REC = LayerSpec("rglru")
_LOC = LayerSpec("attn", window=2048)


def get_config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b", family="hybrid",
        d_model=4096, n_heads=16, n_kv_heads=1, head_dim=256,
        d_ff=12288, vocab=256000,
        pattern=(_REC, _REC, _LOC), n_periods=12, suffix=(_REC, _REC),
        act="gelu_glu", rglru=RGLRUConfig(d_rnn=0, conv_width=4, c=8.0),
        rope_theta=10000.0,
    )


def smoke_config() -> ModelConfig:
    return get_config().replace(
        d_model=128, n_heads=4, n_kv_heads=1, head_dim=32,
        d_ff=256, vocab=256, n_periods=2, suffix=(_REC, _REC),
        attn_q_block=64, attn_kv_block=64, loss_chunk=64, dtype="float32",
        rglru=RGLRUConfig(d_rnn=128, conv_width=4, c=8.0),
    )
