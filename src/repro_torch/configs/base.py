"""Model / run configuration dataclasses.

A model is a *pattern* of layer specs scanned ``n_periods`` times (stacked
params, small HLO), plus optional unrolled ``prefix``/``suffix`` layers.
This single substrate expresses all ten assigned architectures (dense GQA,
MoE, MLA+MoE, SSM, RG-LRU hybrid, cross-attn VLM, audio-token decoder).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int
    n_shared: int = 0
    capacity_factor: float = 1.25
    norm_topk: bool = True
    aux_weight: float = 0.01


@dataclass(frozen=True)
class MLAConfig:
    kv_lora: int = 512
    q_lora: int = 1536
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256


@dataclass(frozen=True)
class RGLRUConfig:
    d_rnn: int = 0  # 0 -> d_model
    conv_width: int = 4
    c: float = 8.0  # Griffin's fixed exponent scale


@dataclass(frozen=True)
class LayerSpec:
    """One layer slot in the pattern."""

    mixer: str  # 'attn' | 'mla' | 'ssd' | 'rglru' | 'cross_attn'
    window: int | None = None  # sliding-window size for 'attn'
    moe: bool = False  # MoE FFN instead of dense FFN
    ffn: bool = True  # False -> mixer-only block (mamba2)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense|moe|ssm|hybrid|audio|vlm
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    pattern: tuple[LayerSpec, ...]
    n_periods: int
    prefix: tuple[LayerSpec, ...] = ()
    suffix: tuple[LayerSpec, ...] = ()
    act: str = "silu_glu"  # 'silu_glu' | 'gelu_glu' | 'sq_relu' | 'gelu'
    qk_norm: bool = False
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    ssm: SSMConfig | None = None
    rglru: RGLRUConfig | None = None
    frontend: str = "token"  # 'token' | 'frames' (audio stub) | 'vision' (vlm stub)
    n_patches: int = 0  # vlm: image patch embeddings per sample
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    # blockwise-attention tile sizes
    attn_q_block: int = 512
    attn_kv_block: int = 1024
    # remat policy for the layer scan: 'none'|'full'|'dots'
    remat: str = "full"
    # MoE dispatch implementation: 'auto' uses the shard_map expert-parallel
    # path when lowering under a mesh with a 'model' axis, else the
    # GSPMD-dispatch path.  'gspmd' forces the baseline (kept for §Perf
    # before/after), 'shard_map' forces the EP path.
    moe_impl: str = "auto"
    # optimizer/accumulator storage dtypes (bf16 for memory-bound giants)
    opt_moments_dtype: str = "float32"
    grad_accum_dtype: str = "float32"
    # cross-entropy vocab chunking (seq chunk size; 0 = unchunked)
    loss_chunk: int = 2048

    @property
    def n_layers(self) -> int:
        return (
            len(self.prefix)
            + self.n_periods * len(self.pattern)
            + len(self.suffix)
        )

    @property
    def d_rnn(self) -> int:
        if self.rglru is None:
            return 0
        return self.rglru.d_rnn or self.d_model

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str  # train_4k | prefill_32k | decode_32k | long_500k
    kind: str  # 'train' | 'prefill' | 'decode'
    seq_len: int
    global_batch: int
    microbatch: int | None = None  # grad-accum microbatch (train only)


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256, microbatch=16),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}
