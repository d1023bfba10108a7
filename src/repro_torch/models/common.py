"""Shared model-building blocks: the parameter spec, norms, rope, activations.

Port of ``repro/models/common.py``.  Parameters are the reference's nested
dicts (and lists) of tensors.  Every init site declares a ``PSpec`` (shape,
logical axes, initializer); ``init_tree`` materializes a spec tree leaf by
leaf, each leaf from a generator of its own (the reference's
``fold_in(key, i)``), so a leaf's values depend on the draw's seed and its
index only.

The reference's ``maybe_scan``/``unrolled_scans`` steer XLA's cost analysis;
here the layer loops are plain Python loops and they have no counterpart.
``constrain`` (a sharding annotation) is ``sharding.constrain``, the
identity.  Under a mesh (``sharding.use_mesh``) the model functions take
each rank's blocks: ``mesh_specs`` gives a module's blocks' specs and
``tp_weights`` the weights a tensor-parallel module uses on this rank.

Tree helpers (``tree_paths``, ``tree_leaves``, ``tree_map``) visit dict keys
in sorted order and lists in order, as JAX flattens a pytree; ``None`` holds
no leaf.
"""
from __future__ import annotations

import hashlib
import math
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

__all__ = [
    "PSpec",
    "init_tree",
    "axes_tree",
    "shape_tree",
    "is_shape",
    "tree_paths",
    "tree_leaves",
    "tree_get",
    "tree_map",
    "tree_rebuild",
    "rms_norm",
    "make_rope",
    "apply_rope",
    "activation",
    "causal_conv",
    "conv_step",
    "DTYPES",
    "mesh_specs",
    "tp_weights",
]

DTYPES = {
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float16": torch.float16,
}


class PSpec(NamedTuple):
    """Declarative parameter spec: shape, logical axes, init, dtype."""

    shape: tuple
    axes: tuple
    init: str = "fan_in"  # 'fan_in' | 'zeros' | 'ones' | 'normal' | 'embed' | a key of _UNIFORM
    dtype: Any = None  # None -> model dtype


def _is_pspec(x) -> bool:
    return isinstance(x, PSpec)


def is_shape(x) -> bool:
    """A ``(shape, dtype)`` leaf of a shape tree."""
    return isinstance(x, tuple) and len(x) == 2 and isinstance(x[1], torch.dtype)


def tree_paths(tree, prefix=(), is_leaf=None):
    """Paths (tuples of keys and indices) to the leaves of ``tree``, in the
    reference's flatten order."""
    if is_leaf is not None and is_leaf(tree):
        yield prefix
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_paths(tree[k], prefix + (k,), is_leaf)
    elif isinstance(tree, (list, tuple)) and not _is_pspec(tree):
        for j, sub in enumerate(tree):
            yield from tree_paths(sub, prefix + (j,), is_leaf)
    elif tree is not None:
        yield prefix


def tree_get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def tree_leaves(tree, is_leaf=None) -> list:
    return [tree_get(tree, p) for p in tree_paths(tree, is_leaf=is_leaf)]


def tree_map(fn, tree, *rest, is_leaf=None):
    """``tree``'s structure with ``fn(leaf, *leaves of rest)`` at each leaf."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not _is_pspec(tree):
        mapped = [tree_map(fn, v, *(r[j] for r in rest), is_leaf=is_leaf) for j, v in enumerate(tree)]
        return type(tree)(*mapped) if hasattr(tree, "_fields") else type(tree)(mapped)
    if tree is None:
        return None
    return fn(tree, *rest)


def _leaf_generator(base: int, i: int, device) -> torch.Generator:
    """Leaf ``i``'s generator: seeded by a hash of (the draw's base, i)."""
    digest = hashlib.blake2b(f"{base}:{i}".encode(), digest_size=8).digest()
    return torch.Generator(device=device).manual_seed(int.from_bytes(digest, "little") >> 1)


# The recurrent and SSM initializers: a uniform draw in [lo, hi), mapped to
# the parameter in f32.
_UNIFORM = {
    # Griffin: a = sigmoid(Λ) uniform in [0.9, 0.999] -> Λ = logit(a)
    "rglru_lambda": (0.9, 0.999, lambda u: torch.log(u / (1 - u))),
    # Mamba2: A in [1, 16] -> log
    "ssm_a_log": (1.0, 16.0, torch.log),
    # softplus^-1 of dt in [1e-3, 1e-1]
    "ssm_dt_bias": (1e-3, 1e-1, lambda u: u + torch.log(-torch.expm1(-u))),
}


def init_tree(specs, generator: torch.Generator, default_dtype, device, keep=None):
    """Materialize a PSpec tree into tensors on ``device``.

    One draw from ``generator`` gives the base seed; leaf ``i`` (in flatten
    order) draws from a generator of its own seeded by (base, i).  The
    Gaussians are drawn in f32 and scaled there, then cast, as the
    reference's are.  ``keep(path, leaf)``, if given, replaces each leaf as
    soon as it is drawn (a rank's block of it), so only one whole leaf is
    ever held.
    """
    base = int(torch.randint(0, 2**62, (1,), generator=generator, device=generator.device))
    paths = list(tree_paths(specs, is_leaf=_is_pspec))
    leaves = {}
    for i, path in enumerate(paths):
        spec = tree_get(specs, path)
        dtype = spec.dtype or default_dtype
        if spec.init == "zeros":
            arr = torch.zeros(spec.shape, dtype=dtype, device=device)
        elif spec.init == "ones":
            arr = torch.ones(spec.shape, dtype=dtype, device=device)
        elif spec.init in ("normal", "embed", "fan_in"):
            # 'embed': the 0.02-std GPT/llama convention, which also keeps
            # tied-embedding logits at an O(1) scale at init.
            if spec.init == "fan_in":
                fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
                std = 1.0 / math.sqrt(max(fan_in, 1))
            else:
                std = 0.02
            g = _leaf_generator(base, i, device)
            arr = (torch.randn(spec.shape, generator=g, dtype=torch.float32, device=device) * std).to(dtype)
        elif spec.init in _UNIFORM:
            lo, hi, to_param = _UNIFORM[spec.init]
            g = _leaf_generator(base, i, device)
            u = torch.rand(spec.shape, generator=g, dtype=torch.float32, device=device) * (hi - lo) + lo
            arr = to_param(u).to(torch.float32)
        else:
            raise ValueError(f"unknown init {spec.init!r}")
        leaves[path] = arr if keep is None else keep(path, arr)
        del arr
    return tree_rebuild(specs, leaves)


def tree_rebuild(tree, leaves: dict, is_leaf=_is_pspec, prefix=()):
    """``tree``'s structure with ``leaves[path]`` at each leaf's path."""
    if is_leaf(tree):
        return leaves[prefix]
    if isinstance(tree, dict):
        return {k: tree_rebuild(v, leaves, is_leaf, prefix + (k,)) for k, v in tree.items()}
    return type(tree)(tree_rebuild(v, leaves, is_leaf, prefix + (j,)) for j, v in enumerate(tree))


def axes_tree(specs):
    """PSpec tree -> logical-axes tree (same structure)."""
    return tree_map(lambda s: s.axes, specs, is_leaf=_is_pspec)


def shape_tree(specs, default_dtype):
    """PSpec tree -> ``(shape, dtype)`` tree (the checkpoint store's restore
    targets; the reference's ``ShapeDtypeStruct``)."""
    return tree_map(lambda s: (tuple(s.shape), s.dtype or default_dtype), specs, is_leaf=_is_pspec)


def rms_norm(x, scale, eps=1e-6):
    """RMS norm computed in f32 and cast back, times ``1 + scale``."""
    dt = x.dtype
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(dt) * (1.0 + scale.to(dt))


def make_rope(positions, dim: int, theta: float, dtype=torch.float32):
    """positions (...,) -> (cos, sin) of shape (..., dim//2), in f32."""
    half = dim // 2
    device = positions.device
    freqs = torch.exp(-math.log(theta) * torch.arange(0, half, dtype=torch.float32, device=device) / half)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


def apply_rope(x, cos, sin):
    """x (..., S, d); cos/sin (S, d//2) or broadcastable.  Rotate-half form,
    in the promoted dtype (f32 tables), cast back to x's."""
    d = x.shape[-1]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    while cos.ndim < x1.ndim:
        cos, sin = cos[None], sin[None]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def activation(kind: str, h, g=None):
    """Apply the activation; ``g`` is the gate branch for GLU variants."""
    if kind == "silu_glu":
        return F.silu(h) * g
    if kind == "gelu_glu":
        return F.gelu(h, approximate="tanh") * g
    if kind == "sq_relu":
        r = F.relu(h)
        return r * r
    if kind == "gelu":
        return F.gelu(h, approximate="tanh")
    raise ValueError(f"unknown activation {kind!r}")


def causal_conv(x, w, b):
    """Depthwise causal convolution along the sequence, plus the bias:
    x (B, S, C), w (W, C).  The taps are added one by one in the reference's
    order, in f32, and the sum is cast to x's dtype once (XLA fuses the
    reference's loop and keeps its bf16 intermediates in f32, as
    ``conv_step``'s einsum does at decode)."""
    W, S = w.shape[0], x.shape[1]
    x32, w32 = x.float(), w.float()
    out = torch.zeros_like(x32)
    for i in range(W):
        out = out + F.pad(x32, (0, 0, W - 1 - i, 0))[:, :S] * w32[i]
    return (out + b.float()).to(x.dtype)


def conv_step(tail, new, w, b):
    """``causal_conv`` at one new position: ``tail`` (B, W-1, C) holds the
    previous inputs, ``new`` (B, C).  The taps' products and the bias are
    summed in f32 and cast back once, as ``causal_conv`` does.  Returns
    (out, new tail)."""
    buf = torch.cat([tail, new[:, None]], dim=1)
    out = torch.einsum("bwc,wc->bc", buf.float(), w.float()) + b.float()
    return out.to(buf.dtype), buf[:, 1:]


def mesh_specs(specs, mesh):
    """The ``PartitionSpec`` of each leaf of a ``PSpec`` tree on ``mesh``
    under the current rules (``sharding.use_mesh``'s, else the defaults)."""
    from ..sharding import current_rules, logical_to_spec

    rules = current_rules()
    return tree_map(lambda s: logical_to_spec(s.axes, mesh, rules, shape=s.shape), specs, is_leaf=_is_pspec)


def tp_weights(p, specs, units: int, split=(), row=()):
    """The weights a tensor-parallel module uses on this rank, the mesh its
    sums over ``model`` run on, and its share (i0, n) of the ``units``
    (heads or channels) the module splits over ``model``.

    With no mesh (``sharding.use_mesh``): ``p``, ``None`` and every unit.
    Under a mesh whose ``model`` axis splits the units (the rules place the
    leaves ``split`` by their last dimension and those of ``row`` by their
    first over ``model``), every weight is gathered over the data axes only:
    a ``model``-split leaf stays this rank's block, the rest are whole, and
    the module passes those through ``collectives.copy_to`` where it uses
    them inside its region.  Where ``model`` does not split the units, every
    weight is gathered whole and the module runs whole on every model rank
    (mesh ``None``)."""
    from .. import sharding
    from ..sharding.collectives import gather_param

    mesh = sharding.current_mesh()
    if mesh is None:
        return p, None, (0, units)
    placed = mesh_specs(specs, mesh)
    tp = mesh.shape.get("model", 1)
    whole = (tp == 1 or units % tp or any(placed[k].axes(len(specs[k].shape) - 1) != ("model",) for k in split)
             or any(placed[k].axes(0) != ("model",) for k in row))
    w = {k: gather_param(t, placed[k], mesh, whole=whole) for k, t in p.items()}
    if whole:
        return w, None, (0, units)
    return w, mesh, (mesh.axis_index("model") * (units // tp), units // tp)
