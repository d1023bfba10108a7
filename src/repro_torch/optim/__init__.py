"""The port's optimizer-side collectives (``repro.optim``'s compression).

- ``compression`` — the CountSketch-compressed gradient all-reduce
  (``sketched_psum_grads``) with local error feedback, kernel B1 sketching
  each large gradient on the card.

The rest of ``repro.optim`` (AdamW) belongs to the model stack (ROADMAP
A14).
"""
from . import compression
from .compression import CompressionConfig, compress_state_init, sketched_psum_grads

__all__ = ["compression", "CompressionConfig", "compress_state_init", "sketched_psum_grads"]
