"""Batched serving: prefill a prompt batch, then greedy decode.

Port of ``repro/train/serve.py``.  The reference's scan runs ``max_new``
decode steps and drops the last step's token; here the loop stops one step
earlier, which returns the same tokens.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..models import transformer as tfm
from .step import set_matmul_precision

__all__ = ["generate"]


@torch.no_grad()
def generate(cfg: ModelConfig, params, prompts: torch.Tensor, *, max_new: int = 32,
             cache_len: int | None = None) -> torch.Tensor:
    """Prefill + greedy decode of ``prompts`` (B, S_prompt) on their device.
    Returns the (B, max_new) int32 generated tokens.  Under
    ``sharding.use_mesh`` every rank passes its blocks of ``params`` and its
    rows of the prompts and gets the tokens of those rows (each argmax is
    over whole logits: the head is gathered whole); the cache length must
    divide over the ranks its positions split across."""
    set_matmul_precision()
    B, S = prompts.shape
    logits, cache = tfm.prefill(cfg, params, {"tokens": prompts}, S_cache=cache_len or (S + max_new))
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    out = [tok]
    for i in range(max_new - 1):
        logits, cache = tfm.decode_step(cfg, params, cache, tok, S + i)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        out.append(tok)
    return torch.stack(out, dim=1)
