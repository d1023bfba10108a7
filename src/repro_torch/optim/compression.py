"""Sketched gradient compression for data-parallel training.

Port of ``repro/optim/compression.py``.  The paper's CountSketch applied
to the framework's own collective bottleneck: instead of all-reducing
full gradients over the data-parallel group, each rank sketches its large
gradient tensors into a fixed s-bucket space (kernel B1 on the card: the
CountSketch is linear, so the sum of sketches is the sketch of the sum),
all-reduces the sketches, and unsketches with the transpose (SᵀS has a
unit diagonal; E[SᵀSx] = x).  The unsketch error is kept *local* through
error feedback (the residual is added to the next step's gradient), so
compression changes the optimization trajectory only transiently.

Collective bytes shrink by ``ratio`` = numel / sketch_size per tensor.
Tensors below ``min_size`` (norms, biases) are all-reduced whole.

The reference draws each tensor's buckets and signs from
``fold_in(fold_in(key(seed), i), step)``.  Here they come from a fresh
``torch.Generator`` on the gradient's device seeded by a hash of
``(seed, i, step)`` (:func:`_buckets_signs`), never from a shared
generator, so every rank draws the same S for the same tensor and step.
Gradient trees are dicts (visited in sorted key order, as JAX flattens
them), lists and tuples of tensors; an error-feedback tree has the same
structure with ``None`` where a tensor is below ``min_size``.
"""
from __future__ import annotations

import hashlib
from typing import NamedTuple

import torch

from .. import sharding
from ..kernels.countsketch import countsketch_apply
from ..models.common import tree_get, tree_paths, tree_rebuild

__all__ = ["CompressionConfig", "compress_state_init", "sketched_psum_grads"]


class CompressionConfig(NamedTuple):
    ratio: int = 8  # sketch_size = numel // ratio
    min_size: int = 65536  # tensors smaller than this go uncompressed
    error_feedback: bool = True
    seed: int = 17


def _buckets_signs(seed: int, i: int, step: int, numel: int, s: int, device):
    """Tensor i's draw at ``step``: (numel,) int32 buckets in [0, s) and
    f32 ±1 signs, from a generator on ``device`` seeded by (seed, i, step)."""
    digest = hashlib.blake2b(f"{seed}:{i}:{step}".encode(), digest_size=8).digest()
    gen = torch.Generator(device=device).manual_seed(int.from_bytes(digest, "little") >> 1)
    buckets = torch.randint(0, s, (numel,), generator=gen, dtype=torch.int32, device=device)
    bits = torch.randint(0, 2, (numel,), generator=gen, dtype=torch.int8, device=device)
    return buckets, bits.to(torch.float32) * 2 - 1


def compress_state_init(cfg: CompressionConfig, params):
    """Error-feedback residual buffers: f32 zeros on each parameter's
    device, ``None`` for tensors below ``min_size``."""
    bufs = {}
    for path in tree_paths(params):
        p = tree_get(params, path)
        big = p.numel() >= cfg.min_size
        bufs[path] = torch.zeros(p.shape, dtype=torch.float32, device=p.device) if big else None
    return tree_rebuild(params, bufs, torch.is_tensor)


def sketched_psum_grads(cfg: CompressionConfig, grads, ef_state, group=None, step: int = 0):
    """The average of ``grads`` over the group's ranks, with CountSketch
    compression: returns ``(avg_grads, new_ef_state)``.

    Every rank of ``group`` calls it (``None``: the default group; a
    ``DeviceMesh`` axis through ``repro_torch.sharding.group_for``).
    ``step`` MUST vary per call (a fresh sketch per step).

    The applied reconstruction is SᵀS(g + e)/ratio: the raw unsketch is
    unbiased but not a contraction (‖x − SᵀSx‖ ≈ √(ratio − 1)·‖x‖), so
    error feedback would amplify geometrically; the 1/ratio scale makes it
    contractive with δ = 1/ratio, and the gain is recovered over ~ratio
    steps through the feedback (the reference's reasoning, unchanged).
    """
    group = sharding.resolve_group(group, who="sketched_psum_grads")
    n_dev = torch.distributed.get_world_size(group)
    out, out_ef = {}, {}
    for i, path in enumerate(tree_paths(grads)):
        g = tree_get(grads, path)
        ef = None if ef_state is None else tree_get(ef_state, path)
        if g.numel() < cfg.min_size:
            out[path] = sharding.psum(g, group) / n_dev
            out_ef[path] = ef
            continue
        numel = g.numel()
        s = max(numel // cfg.ratio, 1)
        buckets, signs = _buckets_signs(cfg.seed, i, step, numel, s, g.device)

        gf = g.to(torch.float32).reshape(-1)
        if cfg.error_feedback and ef is not None:
            gf = gf + ef.reshape(-1)
        sk = countsketch_apply(gf, buckets, signs, s)  # kernel B1 on the card
        sk_global = sharding.psum(sk, group) / n_dev
        recon = (signs * sk_global[buckets]).to(torch.float32) / cfg.ratio
        if cfg.error_feedback and ef is not None:
            # local error: my contribution minus what the global recon
            # carries of it (same 1/ratio scaling -> contraction)
            local_recon = (signs * sk[buckets]) / cfg.ratio
            out_ef[path] = (gf - local_recon).reshape(g.shape)
        else:
            out_ef[path] = ef
        out[path] = recon.reshape(g.shape).to(g.dtype)

    new_ef = tree_rebuild(grads, out_ef, torch.is_tensor) if ef_state is not None else None
    return tree_rebuild(grads, out, torch.is_tensor), new_ef
