"""The port's optimizer (``repro.optim``).

- ``adamw`` — AdamW with f32 master weights and moments, global-norm
  clipping and a warmup-cosine schedule;
- ``compression`` — the CountSketch-compressed gradient all-reduce
  (``sketched_psum_grads``) with local error feedback, kernel B1 sketching
  each large gradient on the card.
"""
from . import adamw, compression
from .adamw import AdamWConfig, adamw_init, adamw_update, cast_params, global_norm, lr_at
from .compression import CompressionConfig, compress_state_init, sketched_psum_grads

__all__ = [
    "adamw", "compression",
    "AdamWConfig", "adamw_init", "adamw_update", "cast_params", "global_norm", "lr_at",
    "CompressionConfig", "compress_state_init", "sketched_psum_grads",
]
