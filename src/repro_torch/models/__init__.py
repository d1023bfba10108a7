"""The LM substrate (port of ``repro.models``): the ten architectures on one
pattern-loop stack — GQA (sliding window, qk-norm), MLA, cross-attention,
Mamba2's SSD and Griffin's RG-LRU mixers, dense and MoE FFNs, and the
token, frames and vision front ends."""
from . import attention, common, mlp, moe, rglru, ssm, transformer
from .transformer import (Transformer, backbone, cache_axes, decode_step,
                          forward, init_cache, init_params, loss_fn,
                          model_specs, params_axes, params_shapes, prefill)

__all__ = ["attention", "common", "mlp", "moe", "rglru", "ssm", "transformer",
           "Transformer", "backbone", "cache_axes", "decode_step", "forward",
           "init_cache", "init_params", "loss_fn", "model_specs",
           "params_axes", "params_shapes", "prefill"]
