"""Multi-pod dry run: every (arch × shape × mesh) cell run on one rank of a
fake world, counted.

    python -m repro_torch.launch.dryrun --arch A --shape S | --all
        [--mesh single|multi|both] [--out DIR] [--force] [--override k=v]
        [--micro n] [--smoke] [--mesh-shape DxM] [--seq N] [--batch N]
        [--jobs N]

Port of ``repro/launch/dryrun.py``.  The reference lowers and compiles each
cell on 512 forced host devices; the port has no compiler, so one process
stands for one rank of the mesh (rank 0: every rank runs the same ops on
blocks of the same shapes, the MoE's routing aside): it joins a fake
world of the mesh's size (``torch.distributed``'s ``"fake"`` backend, whose
collectives do nothing), builds the mesh and its groups with
``launch.mesh.make_mesh`` (``make_production_mesh``: 16×16, or 2×16×16 on
``--mesh multi``; ``--mesh-shape DxM`` names another ``("data",
"model")`` mesh), and runs the cell's step on meta tensors: this rank's
blocks of the state (``train.state_pspecs`` and ``tfm.params_shapes``,
never ``init_params``), of the caches (``tfm.init_cache`` under the mesh)
and of the batch.  The step, the prefill and the decode are the port's own
(``train.jit_train_step``, ``make_prefill_step``, ``make_decode_step``), so
a cell that runs proves the sharding coherent.  A dispatch mode
(``_Counter``) counts what runs: the matrix products' flops (PyTorch's
``flop_counter`` rules), an estimate of the bytes the device reads and
writes (each non-view op's inputs and outputs), and the live bytes of
every storage (the peak a rank, held against ``HW["hbm_bytes"]``).  The
collectives' bytes come from ``collective_stats`` (``collectives.CALLS``).

Each cell has two artifacts, as in the reference:

  full    — the cell at its own sequence length and batch, counted exactly:
            the port's loops are Python loops, so every op is counted every
            time it runs, and a period (or a micro-batch) runs the same ops
            as any other.  Hence runs at 1 and 2 periods (and, with several
            micro-batches, at 2 and 3: one micro-batch takes another code
            path) determine the whole depth and accumulation exactly:
            c(n) = c(1) + (n − 1)·(c(2) − c(1)) for the flops, bytes and
            collective calls; the peak and resident bytes are extrapolated
            the same way in the periods (exact where each period's
            transients are alike), and the peak of the second micro-batch
            is that of every later one.  Runs at full depth would cost the
            same answer many times over: at 32k positions a prefill layer
            runs ~40k ops, which fake ops take tens of seconds to run.
  derived — the reference's ``_derive_costs``, ported: 1- and 2-period
            runs with one micro-batch at two sequence lengths and the
            smallest batch that splits over the data axes, fitted as
            α·S + β·S² and scaled by the batch and the micro-batches.  For
            the port it is exact in the periods (as above), and in S for
            flops at lengths that are multiples of the kv block (the causal
            block pairs are then (S/1024)·(S/1024 + 1)); it is not exact for
            what does not grow with S or the batch (weight reads and
            gathers, the update), which the fit through the origin and the
            batch scaling misplace.  Each record keeps ``derived_rel_err``
            against ``full``.

The roofline uses ``full``'s exact counts and ``launch.mesh.HW``'s H100
constants; the collective term divides each mesh axis's ring bytes by the
rate of the link its group crosses (``_link``): NVLink within a node of
``NODE_CARDS`` cards (ranks in row-major order, 8 consecutive ranks a
node), the network beyond it.  Cells are written one JSON file each under
``--out`` (default ``build/dryrun``) with the reference's keys.  On
``--mesh multi`` the train cells need ZeRO-1 over ``pod``, which
``jit_train_step`` refuses: their status is the error, as the reference
records a failed cell.  Every cell's wall time is printed.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import os
import time
import traceback
import weakref

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from ..configs import ModelConfig, ShapeConfig, get_config, get_shape, registry, smoke_config
from ..models import transformer as tfm
from ..models.common import DTYPES, is_shape, tree_leaves, tree_map, tree_paths
from ..optim import AdamWConfig
from ..sharding import collectives as col
from ..sharding import logical_to_spec, use_mesh
from .collective_stats import collective_stats
from .mesh import HW, make_mesh

__all__ = ["CARD", "NET_BW", "NODE_CARDS", "run_cell", "main"]

# The card the roofline's constants describe (launch.mesh.HW), and the
# links between cards.
CARD = "NVIDIA H100 SXM5 80GB, 700 W"
NODE_CARDS = 8  # cards a node joined by NVLink/NVSwitch (NVIDIA HGX/DGX H100 data sheet)
# bytes/s a direction a card over the network: one ConnectX-7 NDR InfiniBand
# NIC of 400 Gb/s a card (NVIDIA DGX H100 data sheet)
NET_BW = 400e9 / 8
CONSTANTS = {
    "peak_flops_bf16": (HW["peak_flops_bf16"], "dense bf16 tensor-core ops/s, H100 SXM5 data sheet"),
    "hbm_bw": (HW["hbm_bw"], "HBM3 bytes/s, H100 SXM5 data sheet"),
    "hbm_bytes": (HW["hbm_bytes"], "HBM3 capacity a card, H100 SXM5 data sheet"),
    "nvlink_bw": (HW["nvlink_bw"], "NVLink 4 bytes/s a direction a card (18 links), H100 SXM5 data sheet"),
    "net_bw": (NET_BW, "one ConnectX-7 NDR 400 Gb/s NIC a card, DGX H100 data sheet"),
}

# --smoke: each shape's length cut to this and its batch to one row a data
# rank, where the derived costs' runs are the full artifact's
SMOKE_SEQ = 128
META = torch.device("meta")
_NO_BYTES = {"empty", "empty_strided", "_local_scalar_dense"}  # ops that move no device bytes


# ---------------------------------------------------------------------------
# counting


def _tensors(x) -> list:
    """The tensors in ``x`` (a tensor, or lists and tuples of them)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for y in x for t in _tensors(y)]
    return []


class _Counter(TorchDispatchMode):
    """Counts, for every op run under it: the flops of the products
    (``torch.utils.flop_counter``'s rules), the bytes its tensor inputs and
    outputs hold (views, allocations and collectives excluded: an estimate of
    the device's reads and writes), and the bytes of every live storage
    (each storage once, from the op that makes it to its release; a view
    makes none)."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self.registry = flop_registry
        self.counting = False
        self.flops = self.bytes = 0
        self.live = self.peak = 0
        self._held = {}  # storage -> (its weak reference, its bytes)
        self._ops = {}  # op -> (its flop rule, a view, moves bytes)

    def _hold(self, t):
        st = t.untyped_storage()
        key = st._cdata
        if key in self._held:
            return
        n = st.nbytes()
        self._held[key] = (weakref.ref(st, functools.partial(self._drop, key)), n)
        self.live += n
        if self.live > self.peak:
            self.peak = self.live

    def _drop(self, key, _ref):
        self.live -= self._held.pop(key)[1]

    def reset_peak(self):
        self.peak = self.live

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        op = self._ops.get(func)
        if op is None:
            view = func.is_view
            op = self._ops[func] = (self.registry.get(func._overloadpacket), view,
                                    not (view or func.namespace == "c10d" or func._opname in _NO_BYTES))
        flop, view, moves = op
        if view:
            return out
        outs = _tensors(out)
        for t in outs:
            self._hold(t)
        if self.counting:
            if flop is not None:
                self.flops += int(flop(*args, **kwargs, out_val=out))
            if moves:
                self.bytes += sum(t.numel() * t.element_size() for t in _tensors(args) + _tensors(list(kwargs.values()))
                                  + outs)
        return out


# ---------------------------------------------------------------------------
# the fake world and the cell's inputs


@contextlib.contextmanager
def fake_world(dims, axes):
    """This process as rank 0 of a fake world over a mesh of ``dims`` named
    ``axes`` (the ``"fake"`` backend: every collective returns at once);
    yields the mesh (``launch.mesh.make_mesh``)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry run starts its own (fake) world; one is initialized already")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=math.prod(dims))
    try:
        yield make_mesh(dims, axes)
    finally:
        dist.destroy_process_group()


def dp_size(mesh) -> int:
    return mesh.shape.get("data", 1) * mesh.shape.get("pod", 1)


def pick_micro(shape: ShapeConfig, mesh) -> int:
    if shape.kind != "train" or not shape.microbatch:
        return 1
    return max(1, min(shape.microbatch, shape.global_batch // dp_size(mesh)))


def _rows(B: int, mesh) -> int:
    """The rows of a global batch of ``B`` this rank serves: its block over
    the data axes, or all of them where ``B`` does not split (the rules'
    divisibility drop)."""
    return col.block_shape((B,), logical_to_spec(("batch",), mesh, shape=(B,)), mesh)[0]


def _blocks(shapes, specs, mesh, dtype=None):
    return tree_map(lambda sh, sp: torch.empty(col.block_shape(sh[0], sp, mesh), dtype=dtype or sh[1],
                                               device=META), shapes, specs, is_leaf=is_shape)


def state_bytes(cfg: ModelConfig, mesh) -> int:
    """The bytes of this rank's blocks of the train state
    (``train.state_pspecs``: parameters, f32 master, moments)."""
    from ..sharding import PartitionSpec
    from ..train import state_pspecs

    specs = state_pspecs(cfg, mesh)
    shapes = tree_leaves(tfm.params_shapes(cfg), is_leaf=is_shape)
    is_spec = lambda x: isinstance(x, PartitionSpec)  # noqa: E731
    moments = DTYPES[cfg.opt_moments_dtype].itemsize
    total = 0
    for (shape, dtype), p, o in zip(shapes, tree_leaves(specs.params, is_leaf=is_spec),
                                    tree_leaves(specs.opt["master"], is_leaf=is_spec)):
        total += math.prod(col.block_shape(shape, p, mesh)) * dtype.itemsize
        total += math.prod(col.block_shape(shape, o, mesh)) * (4 + 2 * moments)
    return total


def _inputs(cfg: ModelConfig, rows: int, S: int, kind: str) -> dict:
    """This rank's rows of the cell's batch, on meta."""
    D, dtype = cfg.d_model, DTYPES[cfg.dtype]
    batch = {}
    if cfg.frontend == "frames":
        batch["embeds"] = torch.empty((rows, S, D), dtype=dtype, device=META)
    else:
        batch["tokens"] = torch.empty((rows, S), dtype=torch.int32, device=META)
    if cfg.frontend == "vision":
        batch["image_embeds"] = torch.empty((rows, cfg.n_patches, D), dtype=dtype, device=META)
    if kind == "train":
        batch["labels"] = torch.empty((rows, S), dtype=torch.int32, device=META)
    return batch


def _run(cfg: ModelConfig, kind: str, mesh, rows: int, S: int, n_micro: int, B: int) -> dict:
    """One run of the cell's step on this rank: its counts."""
    from ..train import TrainState, jit_train_step, make_decode_step, make_prefill_step, state_pspecs

    counter = _Counter()
    col.reset_bytes()
    t0 = time.perf_counter()
    with counter:
        specs = state_pspecs(cfg, mesh)
        shapes = tfm.params_shapes(cfg)
        params = _blocks(shapes, specs.params, mesh)
        if kind == "train":
            moments = DTYPES[cfg.opt_moments_dtype]
            opt = {"master": _blocks(shapes, specs.opt["master"], mesh, torch.float32),
                   "m": _blocks(shapes, specs.opt["m"], mesh, moments),
                   "v": _blocks(shapes, specs.opt["v"], mesh, moments)}
            # the step counter is a host scalar, as in the port's state
            state = TrainState(step=torch.zeros((), dtype=torch.int32, device="cpu"), params=params, opt=opt)
            del opt
            batch = _inputs(cfg, rows, S, kind)
            fn = jit_train_step(cfg, AdamWConfig(), mesh, n_micro=n_micro)
            call = lambda: fn(state, batch)  # noqa: E731
        elif kind == "prefill":
            batch = _inputs(cfg, rows, S, kind)
            fn = make_prefill_step(cfg, mesh)
            call = lambda: fn(params, batch)  # noqa: E731
        else:
            with use_mesh(mesh):
                cache = tfm.init_cache(cfg, B, S, device=META)
            D, dtype = cfg.d_model, DTYPES[cfg.dtype]
            tokens = torch.empty((rows,), dtype=torch.int32, device=META)
            embeds = torch.empty((rows, D), dtype=dtype, device=META) if cfg.frontend == "frames" else None
            img = (torch.empty((rows, cfg.n_patches, D), dtype=dtype, device=META)
                   if cfg.frontend == "vision" else None)
            fn = make_decode_step(cfg, mesh)
            call = lambda: fn(params, cache, tokens, S - 1, embeds=embeds, img=img)  # noqa: E731
        resident = counter.live
        counter.reset_peak()
        counter.counting = True
        out = call()
        counter.counting = False
        del out
    return {"flops": counter.flops, "bytes": counter.bytes, "calls": {k: {c: list(v) for c, v in d.items()}
                                                                    for k, d in col.CALLS.items()},
            "resident_bytes": resident, "peak_bytes": counter.peak, "t_run_s": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# the full artifact: exact counts at the cell's own length and batch


def _line(c1, c2, n: int):
    """c(n) from c(1) and c(2) of a count linear in n (c(1) alone: n = 1)."""
    return c1 if c2 is None else c1 + (n - 1) * (c2 - c1)


def _full(cfg: ModelConfig, shape: ShapeConfig, mesh, n_micro: int, memo: dict) -> dict:
    """The cell at its own length and batch, on every period and
    micro-batch: exact counts from runs at 1 and 2 periods (and 2 and 3
    micro-batches where there are more than 2)."""
    B, S = shape.global_batch, shape.seq_len
    rows = _rows(B, mesh)
    if rows % n_micro:
        raise ValueError(f"{rows} rows a rank do not split into {n_micro} micro-batches")
    per_micro = rows // n_micro
    periods = [1, 2] if cfg.n_periods >= 2 else [1]
    micros = [n_micro] if n_micro <= 2 else [2, 3]
    runs = {}
    for p in periods:
        for k in micros:
            key = (p, per_micro * k, S, B, k)
            if key not in memo:
                memo[key] = _run(cfg.replace(n_periods=p), shape.kind, mesh, per_micro * k, S, k, B)
            runs[(p, k)] = memo[key]

    def count(get, micro=True):
        """A count at n_periods (and n_micro) from its values in the runs."""
        by_k = [_line(get(runs[(1, k)]), get(runs[(2, k)]) if (2, k) in runs else None, cfg.n_periods)
                for k in micros]
        return by_k[0] if len(micros) == 1 or not micro else _line(by_k[0], by_k[1], n_micro - 1)

    calls = {}
    for kind in col.CALLS:
        keys = set().union(*(r["calls"].get(kind, {}).keys() for r in runs.values()))
        calls[kind] = {c: [count(lambda r: r["calls"].get(kind, {}).get(c, [0, 0])[i]) for i in (0, 1)]
                       for c in keys}
    coll = collective_stats(calls)
    # the memory of the first micro-batch count run (the second micro-batch's
    # peak is every later one's)
    peak, resident = count(lambda r: r["peak_bytes"], False), count(lambda r: r["resident_bytes"], False)
    return {
        "flops": float(count(lambda r: r["flops"])),
        "bytes": float(count(lambda r: r["bytes"])),
        "coll_bytes": coll["total_bytes"],
        "coll_handoff_bytes": coll["total_handoff_bytes"],
        "coll_by_kind": coll["by_kind"],
        "coll_by_axes": coll["by_axes"],
        "handoff_by_kind": {k: sum(v[1] for v in c.values()) for k, c in calls.items()},
        "t_run_s": sum(r["t_run_s"] for r in runs.values()),
        "runs": {f"p{p}_m{k}": {x: r[x] for x in ("flops", "bytes", "resident_bytes", "peak_bytes", "t_run_s")}
                 for (p, k), r in runs.items()},
        "memory": {"state_bytes": state_bytes(cfg, mesh) if shape.kind == "train" else None,
                   "resident_bytes": int(resident), "peak_bytes": int(peak),
                   "hbm_bytes": HW["hbm_bytes"], "fits": peak <= HW["hbm_bytes"]},
    }


# ---------------------------------------------------------------------------
# the reference's derived costs


def _window_max(cfg: ModelConfig) -> int:
    w = 0
    for spec in cfg.prefix + cfg.pattern + cfg.suffix:
        if spec.mixer == "attn" and spec.window:
            w = max(w, spec.window)
    return w


def _derive_costs(cfg, shape, mesh, n_micro, rec, memo):
    """``repro/launch/dryrun.py:_derive_costs``: per-period costs by 1- vs
    2-period differencing; for train and prefill at two sequence lengths
    and the smallest shardable batch, fitted as α·S + β·S² and scaled."""
    keys = ("flops", "bytes", "coll_bytes")

    def cost(c, S, B):
        key = (c.n_periods, _rows(B, mesh), S, B, 1)
        if key not in memo:
            memo[key] = _run(c, shape.kind, mesh, _rows(B, mesh), S, 1, B)
        r = memo[key]
        return {"flops": float(r["flops"]), "bytes": float(r["bytes"]),
                "coll_bytes": collective_stats(r["calls"])["total_bytes"]}

    def periods(S, B):
        c2 = cost(cfg.replace(n_periods=2), S, B) if cfg.n_periods >= 2 else None
        return cost(cfg.replace(n_periods=1), S, B), c2

    if shape.kind == "decode":
        c1, c2 = periods(shape.seq_len, shape.global_batch)
        rec["cost_artifacts"] = {"c1": c1, "c2": c2}
        out = {}
        for k in keys:
            per = max(c2[k] - c1[k], 0.0) if c2 else 0.0
            base = max(c1[k] - per, 0.0)
            out[k] = base + cfg.n_periods * per
            out[f"{k}_per_period"] = per
            out[f"{k}_base"] = base
        return out

    S = shape.seq_len
    w = _window_max(cfg)
    S_a = min(max(2048, 2 * w), S)
    S_b = min(2 * S_a, S)
    if S_b == S_a:  # (clamped to S: below 1024 the reference's 512 would outrun the cell)
        S_a = min(max(S_b // 2, 512), S)
    if shape.kind == "train":
        B_full = shape.global_batch // n_micro
        outer = n_micro
    else:
        B_full = shape.global_batch
        outer = 1
    B_cost = max(dp_size(mesh), 1)
    while B_full % B_cost:
        B_cost += 1
    b_scale = B_full / B_cost

    pts, arts = {}, {}
    for S_c in sorted({S_a, S_b}):
        p1, p2 = periods(S_c, B_cost)
        arts[f"S{S_c}"] = {"c1": p1, "c2": p2}
        pts[S_c] = (p1, p2 or p1)
    rec["cost_artifacts"] = arts
    rec["cost_fit"] = {"S_a": S_a, "S_b": S_b, "B_cost": B_cost, "b_scale": b_scale}

    def fit(vals):  # vals: {S: v}; v(S) = alpha*S + beta*S^2 (one point: v at that S)
        if len(vals) == 1:
            (s1, v1), = vals.items()
            return v1 * S / s1
        (s1, v1), (s2, v2) = sorted(vals.items())
        det = s1 * s2 * s2 - s2 * s1 * s1
        beta = (v2 * s1 - v1 * s2) / det
        alpha = (v1 - beta * s1 * s1) / s1
        return alpha * S + beta * S * S

    out = {}
    for k in keys:
        one = cfg.n_periods < 2
        per_v = {s_c: 0.0 if one else max(p2[k] - p1[k], 0.0) for s_c, (p1, p2) in pts.items()}
        base_v = {s_c: max(p1[k] - per_v[s_c], 0.0) for s_c, (p1, p2) in pts.items()}
        per_full = max(fit(per_v), 0.0)
        base_full = max(fit(base_v), 0.0)
        out[k] = outer * b_scale * (base_full + cfg.n_periods * per_full)
        out[f"{k}_per_period"] = b_scale * per_full
        out[f"{k}_base"] = b_scale * base_full
    return out


# ---------------------------------------------------------------------------
# the roofline


def n_params(cfg: ModelConfig) -> tuple[float, float]:
    """(total, active) parameter counts from the spec tree."""
    shapes = tfm.params_shapes(cfg)
    paths = list(tree_paths(shapes, is_leaf=is_shape))
    leaves = tree_leaves(shapes, is_leaf=is_shape)
    total = sum(float(math.prod(s[0])) for s in leaves)
    active = total
    if cfg.moe is not None:
        m = cfg.moe
        expert = sum(float(math.prod(s[0])) for path, s in zip(paths, leaves)
                     if path[-1] in ("w_in", "w_out", "w_gate") and "ffn" in path and m.n_experts in s[0])
        active = total - expert * (1 - m.top_k / m.n_experts)
    return total, active


def _link(mesh, axes: str) -> tuple[str, float]:
    """The link this rank's group over ``axes`` (joined by ``+``) crosses and
    its rate: NVLink when every member sits in this rank's node of
    NODE_CARDS consecutive ranks, else the network."""
    members = col._peers(mesh, tuple(a for a in mesh.axis_names if a in axes.split("+")))
    if len({m.rank // NODE_CARDS for m in members}) == 1:
        return "nvlink", HW["nvlink_bw"]
    return "network", NET_BW


def roofline(cfg: ModelConfig, shape: ShapeConfig, mesh, counts: dict) -> dict:
    n_chips = math.prod(mesh.shape.values())
    total, active = n_params(cfg)
    tokens = shape.global_batch * (shape.seq_len if shape.kind in ("train", "prefill") else 1)
    model_flops = (6.0 if shape.kind == "train" else 2.0) * active * tokens
    t_comp = counts["flops"] / HW["peak_flops_bf16"]
    t_mem = counts["bytes"] / HW["hbm_bw"]
    links = {}
    for axes, nbytes in counts["coll_by_axes"].items():
        link, bw = _link(mesh, axes)
        links[axes] = {"link": link, "bytes_per_s": bw, "ring_bytes": nbytes, "t_s": nbytes / bw}
    t_coll = sum(v["t_s"] for v in links.values())
    return {
        "card": CARD,
        "constants": {k: {"value": v, "source": s} for k, (v, s) in CONSTANTS.items()},
        "counts_from": "full",
        "params_total": total,
        "params_active": active,
        "model_flops_global": model_flops,
        "model_flops_per_chip": model_flops / n_chips,
        "hlo_flops_per_chip": counts["flops"],
        "useful_flops_ratio": (model_flops / n_chips) / max(counts["flops"], 1.0),
        "t_compute_s": t_comp,
        "t_memory_s": t_mem,
        "t_collective_s": t_coll,
        "links": links,
        "bottleneck": max([("compute", t_comp), ("memory", t_mem), ("collective", t_coll)], key=lambda kv: kv[1])[0],
    }


# ---------------------------------------------------------------------------
# a cell


_HELD_WHOLE = ("ssd", "rglru")


def _mesh_of(multi_pod: bool, mesh_shape):
    if mesh_shape:
        dims = tuple(int(d) for d in mesh_shape.split("x"))
        return dims, ("pod", "data", "model")[-len(dims):] if len(dims) > 1 else ("data",)
    return ((2, 16, 16), ("pod", "data", "model")) if multi_pod else ((16, 16), ("data", "model"))


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str, force=False, overrides=None, micro=None,
             *, smoke=False, mesh_shape=None, seq=None, batch=None, cfg: ModelConfig | None = None):
    """Run one cell and write its record (``out_dir/<mesh>/<arch>__<shape>.json``);
    returns the record.  ``cfg``: a config in place of the arch's (its
    ``--smoke`` shapes still follow ``smoke``)."""
    mesh_name = mesh_shape or ("multi" if multi_pod else "single")
    tag = shape_name + (f"_s{seq}" if seq else "") + (f"_b{batch}" if batch else "") + ("_smoke" if smoke else "")
    out_path = os.path.join(out_dir, mesh_name, f"{arch}__{tag}.json")
    if os.path.exists(out_path) and not force:
        print(f"[skip] {out_path} exists")
        with open(out_path) as f:
            return json.load(f)
    os.makedirs(os.path.dirname(out_path), exist_ok=True)

    if cfg is None:
        cfg = smoke_config(arch) if smoke else get_config(arch)
    if overrides:
        typed = {}
        for k, v in overrides.items():
            cur = getattr(cfg, k)
            typed[k] = type(cur)(v) if cur is not None and not isinstance(cur, str) else v
        cfg = cfg.replace(**typed)
    shape = get_shape(shape_name)
    dims, axes = _mesh_of(multi_pod, mesh_shape)
    if smoke:  # the smoke configs' shapes: the length cut, and the batch to a row a data rank
        seq = seq or min(shape.seq_len, SMOKE_SEQ)
        batch = batch or min(shape.global_batch, math.prod(d for d, a in zip(dims, axes) if a != "model"))
    shape = dataclasses.replace(shape, seq_len=seq or shape.seq_len, global_batch=batch or shape.global_batch)
    t0 = time.perf_counter()
    rec = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "chips": math.prod(dims),
        "n_micro": None,
        "n_layers": cfg.n_layers,
        "overrides": overrides or {},
        "status": "error",
        "rank": 0,
        "seq_len": shape.seq_len,
        "global_batch": shape.global_batch,
        "smoke": smoke,
    }
    if shape.kind != "train" and any(s.mixer in _HELD_WHOLE for s in cfg.prefix + cfg.pattern + cfg.suffix):
        rec["deviations"] = ["the SSD/RG-LRU states and conv tails are held whole over 'model' (the rules split "
                             "conv_x over 'inner' and h/conv over 'rnn'); ROADMAP A14c, part 2"]
    try:
        with fake_world(dims, axes) as mesh:
            n_micro = micro if micro else pick_micro(shape, mesh)
            rec["n_micro"] = n_micro
            memo = {}
            full = _full(cfg, shape, mesh, n_micro, memo)
            rec["full"] = full
            print(f"[{arch}/{tag}/{mesh_name}] full OK ({full['t_run_s']:.1f}s) "
                  f"peak={full['memory']['peak_bytes'] / 2**30:.2f} GiB", flush=True)
            if multi_pod:  # the roofline table is single-pod, as in the reference
                rec["roofline"] = None
            else:
                derived = _derive_costs(cfg, shape, mesh, n_micro, rec, memo)
                rec["derived"] = derived
                rec["derived_rel_err"] = {k: (derived[k] - full[k]) / full[k] if full[k] else None
                                          for k in ("flops", "bytes", "coll_bytes")}
                rec["roofline"] = roofline(cfg, shape, mesh, full)
            rec["status"] = "ok"
    except Exception as e:
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()
        print(f"[{arch}/{tag}/{mesh_name}] FAILED: {rec['error']}", flush=True)
    rec["t_cell_s"] = time.perf_counter() - t0
    print(f"[{arch}/{tag}/{mesh_name}] {rec['status']} in {rec['t_cell_s']:.1f} s", flush=True)
    with open(out_path, "w") as f:
        json.dump(rec, f, indent=1, default=str)
    return rec


def _run_cell_job(kw):
    return run_cell(**kw)


def main(argv=None):
    ap = argparse.ArgumentParser(description="multi-pod dry run (one fake rank a cell)")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--override", action="append", default=[], help="ModelConfig overrides, e.g. n_periods=2")
    ap.add_argument("--micro", type=int, default=None, help="override gradient-accumulation microbatch count")
    ap.add_argument("--smoke", action="store_true",
                    help=f"each arch's smoke config, each shape's length cut to {SMOKE_SEQ} and its batch to one "
                         "row a data rank (unless --seq, --batch)")
    ap.add_argument("--mesh-shape", default=None, help="another mesh, e.g. 2x4 (data x model), in place of --mesh")
    ap.add_argument("--seq", type=int, default=None, help="the shape's sequence length (decode: the cache's)")
    ap.add_argument("--batch", type=int, default=None, help="the shape's global batch")
    ap.add_argument("--jobs", type=int, default=1, help="cells run at once, a process each")
    args = ap.parse_args(argv)
    overrides = dict(kv.split("=", 1) for kv in args.override)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = registry.all_cells()
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]
    jobs = [dict(arch=arch, shape_name=shape, multi_pod=mesh_name == "multi", out_dir=args.out, force=args.force,
                 overrides=overrides, micro=args.micro, smoke=args.smoke, mesh_shape=args.mesh_shape,
                 seq=args.seq, batch=args.batch)
            for mesh_name in meshes for arch, shape in cells]
    t0 = time.perf_counter()
    if args.jobs > 1 and len(jobs) > 1:
        import concurrent.futures
        import multiprocessing

        with concurrent.futures.ProcessPoolExecutor(args.jobs, mp_context=multiprocessing.get_context("spawn")) as pool:
            recs = list(pool.map(_run_cell_job, jobs))
    else:
        recs = [run_cell(**kw) for kw in jobs]
    failures = sum(r["status"] != "ok" for r in recs)
    for r in recs:
        print(f"  {r['mesh']:>6} {r['arch']:>22} {r['shape']:>12} {r['status']:>5} {r.get('t_cell_s', 0.0):8.1f} s")
    print(f"done; {failures} failures in {time.perf_counter() - t0:.1f} s")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
