"""The LM substrate (port of ``repro.models``): the attention-only patterns
with a dense FFN (``dense`` and ``audio`` families) on one pattern-loop
stack.  MoE, SSM, RG-LRU, MLA, cross-attention and the vision front end
belong to the second half of the ML stack (ROADMAP A14b)."""
from . import attention, common, mlp, transformer
from .transformer import (Transformer, backbone, cache_axes, decode_step,
                          forward, init_cache, init_params, loss_fn,
                          model_specs, params_axes, params_shapes, prefill)

__all__ = ["attention", "common", "mlp", "transformer", "Transformer",
           "backbone", "cache_axes", "decode_step", "forward", "init_cache",
           "init_params", "loss_fn", "model_specs", "params_axes",
           "params_shapes", "prefill"]
