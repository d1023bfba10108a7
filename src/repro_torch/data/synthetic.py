"""Deterministic, stateless-indexable synthetic data pipeline.

Port of ``repro/data/synthetic.py``.  ``batch_at(cfg, step)`` is a pure
function of (seed, step) — no iterator state — so exact resume after
preemption is trivial: restore the step counter and the stream continues
bit for bit.

Two stream kinds:
  'uniform' — iid tokens (shape/perf work)
  'bigram'  — tokens follow a seed-derived random bigram chain: a learnable
              distribution with entropy well below ln(V), so training
              shows real loss curves.

The draws come from ``torch.Generator``s on the batch's device seeded by
hashes of ``(seed, step)`` (the chain's logits: of the seed alone); each
next token is the reference's categorical draw, argmax(logits + Gumbel
noise).  The stream is deterministic per step on a device type, but it is
not JAX's threefry bits: parity tests feed the reference's batches through
``convert.batch_from_reference``.
"""
from __future__ import annotations

import hashlib
from typing import NamedTuple

import torch

from ..core.backend import resolve_device

__all__ = ["SyntheticConfig", "batch_at", "make_batch_specs"]


class SyntheticConfig(NamedTuple):
    vocab: int
    seq_len: int
    global_batch: int
    kind: str = "bigram"  # 'bigram' | 'uniform'
    seed: int = 0
    bigram_sharpness: float = 2.0


def _generator(tag: str, device) -> torch.Generator:
    digest = hashlib.blake2b(tag.encode(), digest_size=8).digest()
    return torch.Generator(device=device).manual_seed(int.from_bytes(digest, "little") >> 1)


def _bigram_logits(cfg: SyntheticConfig, device):
    V = min(cfg.vocab, 4096)  # the chain lives in a V_eff-token sub-vocabulary
    gen = _generator(f"bigram:{cfg.seed}", device)
    return torch.randn((V, V), generator=gen, device=device) * cfg.bigram_sharpness, V


@torch.no_grad()
def batch_at(cfg: SyntheticConfig, step: int, *, device=None) -> dict:
    """Returns {'tokens': (B, S) int32, 'labels': (B, S) int32} on
    ``device``; the labels are the tokens shifted by one."""
    dev = resolve_device(device)
    B, S = cfg.global_batch, cfg.seq_len
    gen = _generator(f"batch:{cfg.seed}:{int(step)}", dev)
    if cfg.kind == "uniform":
        toks = torch.randint(0, cfg.vocab, (B, S + 1), generator=gen, dtype=torch.int32, device=dev)
    else:
        logits, V = _bigram_logits(cfg, dev)
        tok = torch.randint(0, V, (B,), generator=gen, device=dev)
        cols = [tok]
        for _ in range(S):
            u = torch.rand((B, V), generator=gen, device=dev).clamp_(min=torch.finfo(torch.float32).tiny)
            tok = torch.argmax(logits[tok] - torch.log(-torch.log(u)), dim=-1)
            cols.append(tok)
        toks = torch.stack(cols, dim=1).to(torch.int32)  # (B, S+1)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def make_batch_specs(cfg: SyntheticConfig) -> dict:
    """The batch's ``(shape, dtype)`` leaves."""
    shape = (cfg.global_batch, cfg.seq_len)
    return {"tokens": (shape, torch.int32), "labels": (shape, torch.int32)}
