"""Port parity: the sharding rules (``repro_torch.sharding``), the state's
specs (``train.state_pspecs``, ``batch_pspec``) and the FSDP × TP train
step over a mesh of ranks (``train.jit_train_step``, ``launch.mesh``)
against the JAX reference's rules and the one-process step.

The reference's spec tables come from one subprocess on 512 forced host
devices (``repro.launch.mesh.make_mesh``): every leaf of the parameters,
the master and the moments of all ten archs at full config on (2, 4),
(16, 16) and (2, 16, 16), and the batch's spec; the port's are computed on
abstract meshes (``sharding.Mesh(shape, axes)``) and must be equal.

The step runs on one CPU gloo world of 8 ranks
(``tests/test_torch_distributed.py:run_world``), once per module, with
the meshes (2, 4), (4, 2), (8,) and (2, 2, 2) over it.  Every rank draws
the whole state from seed 0, keeps its blocks (``shard_state``) and its
rows of each bigram batch (``batch_pspec``).  The step is held to the
one-process step on the same weights, never to the reference's sharded
output (``tests/test_multidevice.py:98`` fails in the reference under JAX
0.9, ROADMAP §C); its own contract, a finite loss for mixtral's smoke
config at 2 periods on (2, 4) with ``n_micro`` 2, seq 64 and batch 4, is
held as stated.

Tolerances (f32; the step's sums over ranks regroup the one-process
sums): loss, cross-entropy, aux and ``grad_norm`` within 1e-5 relative;
every leaf of m and v (the first step's learning rate is 0, so they carry
the gradient) within 1e-4 relative + 1e-5 of the leaf's largest entry, on
every rank's own blocks; the parameters after three steps within 1e-5
absolute.  The MoE cases hold the step to the one-process mean over the
data shards and micro-batches of the per-shard step (the capacity comes
from a shard's tokens and the aux loss is each shard's, by the
reference's definition of the expert-parallel path); at the drop-free
capacity 4.0 the cross-entropy is also held to ``make_train_step`` on the
whole batch.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro_torch import sharding  # noqa: E402
from repro_torch.configs import get_config, list_archs, smoke_config  # noqa: E402
from repro_torch.data import SyntheticConfig, batch_at  # noqa: E402
from repro_torch.models.common import tree_leaves, tree_map  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update  # noqa: E402
from repro_torch.sharding import Mesh, PartitionSpec, collectives  # noqa: E402
from repro_torch.train import batch_pspec, init_train_state, make_train_step, state_pspecs  # noqa: E402
from repro_torch.train.checkpoint import _flatten  # noqa: E402
from repro_torch.train.step import _loss_and_grads, _microbatches  # noqa: E402

from test_torch_distributed import run_reference, run_world  # noqa: E402

MESHES = {
    "2x4": ((2, 4), ("data", "model")),
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}
OCFG = dict(lr=5e-3, warmup_steps=2, total_steps=50)
# case: (arch, mesh shape, seq, global batch, n_micro, steps, capacity factor or None)
CASES = {
    "mixtral_2x4": ("mixtral-8x7b", (2, 4), 64, 4, 2, 1, None),
    "mixtral_2x4_c4": ("mixtral-8x7b", (2, 4), 64, 4, 2, 1, 4.0),
    "llama_2x4": ("llama3.2-1b", (2, 4), 64, 8, 2, 3, None),
    "llama_4x2": ("llama3.2-1b", (4, 2), 64, 8, 2, 1, None),
    "qwen3_2x4": ("qwen3-0.6b", (2, 4), 64, 4, 2, 1, None),  # the qk norms over model
}
WORLD = 8

REFERENCE = """
import json
import jax
from jax.sharding import PartitionSpec
from repro.configs import get_config, list_archs
from repro.launch.mesh import make_mesh
from repro.train.step import batch_pspec, state_pspecs

def enc(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]

out = {}
for name, (shape, axes) in %(meshes)r.items():
    mesh = make_mesh(shape, axes)
    out[name + "/batch"] = enc(batch_pspec(mesh))
    for arch in list_archs():
        s = state_pspecs(get_config(arch), mesh)
        for part, tree in (("params", s.params), ("master", s.opt["master"]), ("m", s.opt["m"]), ("v", s.opt["v"])):
            flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]
            for path, spec in flat:
                out[f"{name}/{arch}/{part}" + jax.tree_util.keystr(path)] = enc(spec)
json.dump(out, open(%(path)r, "w"))
"""

RANK_BODY = """
import dataclasses
from repro_torch.configs import smoke_config
from repro_torch.data import SyntheticConfig, batch_at
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.common import tree_leaves
from repro_torch.optim import AdamWConfig
from repro_torch.sharding import PartitionSpec, collectives as col
from repro_torch.train import (TrainState, batch_pspec, init_train_state, jit_train_step, make_dp_train_step,
                               shard_state, state_pspecs)

ocfg = AdamWConfig(**%(ocfg)r)
is_spec = lambda x: isinstance(x, PartitionSpec)
meshes = {}
for case, (arch, shape, seq, gb, micro, steps, cap) in %(cases)r.items():
    if shape not in meshes:
        meshes[shape] = make_mesh(shape, ("data", "model"))
    mesh = meshes[shape]
    cfg = smoke_config(arch).replace(n_periods=2)
    if cap is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=cap))
    dcfg = SyntheticConfig(vocab=cfg.vocab, seq_len=seq, global_batch=gb)
    whole = init_train_state(cfg, 0, device="cpu")
    state = shard_state(cfg, TrainState(whole.step, whole.params, None), mesh)
    specs = state_pspecs(cfg, mesh)
    step = jit_train_step(cfg, ocfg, mesh, n_micro=micro)
    recs = []
    for i in range(steps):
        batch = {k: col.shard_block(v, batch_pspec(mesh), mesh) for k, v in batch_at(dcfg, i, device="cpu").items()}
        state, m = step(state, batch)
        rec = {k: float(v) for k, v in m.items()}
        if i == 0:
            rec["m"] = [t.clone() for t in tree_leaves(state.opt["m"])]
            rec["v"] = [t.clone() for t in tree_leaves(state.opt["v"])]
        recs.append(rec)
    params = [col.unshard(b, s, mesh) for b, s in zip(tree_leaves(state.params),
                                                      tree_leaves(specs.params, is_leaf=is_spec))]
    results[case] = dict(steps=recs, params=params, coords=mesh.coords)

# gather and reduce-scatter along one dimension over one axis
mesh24 = meshes[(2, 4)]
t = torch.arange(6.0) + 10 * rank
results["gather"] = col.gather(t.reshape(2, 3), 1, "model", mesh24)
results["reduce_scatter"] = col.reduce_scatter(t.reshape(2, 3).repeat(1, 2), 1, "data", mesh24)

# make_dp_train_step over a mesh's axis, against the default group
mesh8 = make_mesh((8,), ("data",))
cfg = smoke_config("llama3.2-1b").replace(n_periods=2)
dcfg = SyntheticConfig(vocab=cfg.vocab, seq_len=32, global_batch=8)
mine = {k: v[rank:rank + 1] for k, v in batch_at(dcfg, 0, device="cpu").items()}
out = []
for kw in (dict(mesh=mesh8, axes="data"), {}):
    (state, _), m = make_dp_train_step(cfg, ocfg, **kw)(init_train_state(cfg, 0, device="cpu"), None, mine)
    out.append((float(m["loss"]), [t.clone() for t in tree_leaves(state.params)]))
results["dp_mesh"] = out

# the reference's ZeRO-1 over 'pod' (OPT_RULES) has no port: it raises
pod = make_mesh((2, 2, 2), ("pod", "data", "model"))
try:
    jit_train_step(smoke_config("qwen3-0.6b"), ocfg, pod)
    results["pod"] = None
except NotImplementedError as e:
    results["pod"] = str(e)
"""


def _enc(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


@pytest.fixture(scope="module")
def reference_specs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_specs")
    run_reference(REFERENCE % dict(meshes=MESHES, path=str(tmp / "specs.json")), devices=512)
    return json.loads((tmp / "specs.json").read_text())


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_world")
    return run_world(tmp / "world8", WORLD, RANK_BODY % dict(ocfg=OCFG, cases=CASES), timeout=300.0)


def _config(arch, cap):
    cfg = smoke_config(arch).replace(n_periods=2)
    return cfg if cap is None else cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=cap))


def _one_process(case):
    """The one-process references of a case: ``make_train_step`` on the
    whole batch for each step, and, for the first step, the mean over the
    data shards and micro-batches of the per-shard gradients (the mesh
    step's definition) through ``adamw_update``."""
    arch, shape, seq, gb, micro, steps, cap = CASES[case]
    cfg = _config(arch, cap)
    dcfg = SyntheticConfig(vocab=cfg.vocab, seq_len=seq, global_batch=gb)
    ocfg = AdamWConfig(**OCFG)
    state = init_train_state(cfg, 0, device="cpu")
    batch = batch_at(dcfg, 0, device="cpu")
    n_dp, rows = shape[0], gb // shape[0]
    grads, parts = None, []
    for d in range(n_dp):
        shard = {k: v[d * rows:(d + 1) * rows] for k, v in batch.items()}
        for mb in _microbatches(shard, micro):
            loss, g, metrics = _loss_and_grads(cfg, state.params, mb)
            parts.append((float(loss), float(metrics["ce"]), float(metrics["aux"])))
            grads = g if grads is None else tree_map(lambda a, b: a + b, grads, g)
    grads = tree_map(lambda g: g / (n_dp * micro), grads)
    opt, om = adamw_update(ocfg, grads, adamw_init(state.params), 0)
    shardwise = dict(loss=np.mean([p[0] for p in parts]), ce=np.mean([p[1] for p in parts]),
                     aux=np.mean([p[2] for p in parts]), grad_norm=float(om["grad_norm"]),
                     m=tree_leaves(opt["m"]), v=tree_leaves(opt["v"]))
    shardwise["ce_whole"] = np.mean([float(_loss_and_grads(cfg, state.params, mb)[2]["ce"])
                                     for mb in _microbatches(batch, micro)])
    step = make_train_step(cfg, ocfg, n_micro=micro)
    whole = []
    for i in range(steps):
        state, m = step(state, batch_at(dcfg, i, device="cpu"))
        whole.append(dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]), m=tree_leaves(state.opt["m"]),
                          v=tree_leaves(state.opt["v"]), params=tree_leaves(state.params)))
    return cfg, shardwise, whole


@pytest.fixture(scope="module")
def one_process():
    return {case: _one_process(case) for case in CASES}


def _close(got, want, what):
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5 * float(want.abs().max()), msg=what)


# ---------------------------------------------------------------------------
# the rules and the specs
# ---------------------------------------------------------------------------


def test_rules_are_the_references():
    from repro import sharding as jsharding

    assert sharding.DEFAULT_RULES == jsharding.DEFAULT_RULES
    assert sharding.OPT_RULES == jsharding.OPT_RULES


@pytest.mark.parametrize("arch", list_archs())
def test_state_pspecs_match_the_reference(reference_specs, arch):
    cfg = get_config(arch)
    for name, (shape, axes) in MESHES.items():
        mesh = Mesh(shape, axes)
        assert _enc(batch_pspec(mesh)) == reference_specs[name + "/batch"]
        s = state_pspecs(cfg, mesh)
        got = {}
        for part, tree in (("params", s.params), ("master", s.opt["master"]), ("m", s.opt["m"]),
                           ("v", s.opt["v"])):
            got.update({f"{name}/{arch}/{part}{k}": _enc(v) for k, v in _flatten(tree).items()})
        want = {k: v for k, v in reference_specs.items() if k.startswith(f"{name}/{arch}/")}
        assert got == want, name


def test_logical_to_spec_edges():
    mesh = Mesh((2, 4), ("data", "model"))
    lts = sharding.logical_to_spec
    assert lts(("embed", "heads"), mesh, shape=(128, 256)) == PartitionSpec("data", "model")
    assert lts(("embed", "heads"), mesh, shape=(127, 6)) == PartitionSpec(None, None)  # the divisibility drop
    assert lts(("batch", "seq"), mesh) == PartitionSpec("data", None)  # 'pod' is absent
    assert lts(("batch",), Mesh((2, 2, 2), ("pod", "data", "model"))) == PartitionSpec(("pod", "data"))
    # the expert fallback: 8 experts on 16-way TP shard the expert FFN dim
    wide = Mesh((1, 16), ("data", "model"))
    assert lts(("experts", "embed", "expert_mlp"), wide, shape=(8, 64, 32)) == PartitionSpec(None, "data", "model")
    assert lts(("experts", "embed", "expert_mlp"), mesh, shape=(8, 64, 32)) == PartitionSpec("model", "data", None)
    assert repr(PartitionSpec("data", None)) == "PartitionSpec('data', None)"
    assert sharding.named_sharding(("embed",), mesh) == sharding.NamedSharding(mesh, PartitionSpec("data"))
    x = torch.ones(3)
    assert sharding.constrain(x, ("embed",), mesh) is x
    assert sharding.current_mesh() is None
    with sharding.use_mesh(mesh):
        other = Mesh((8,), ("data",))
        with sharding.use_mesh(other, rules={"embed": None}):
            assert sharding.current_mesh() is other and sharding.current_rules() == {"embed": None}
        assert sharding.current_mesh() is mesh and sharding.current_rules() is None
        # the autograd engine's threads (the card's backward pass) see it too
        import threading

        seen = []
        t = threading.Thread(target=lambda: seen.append(sharding.current_mesh()))
        t.start()
        t.join()
        assert seen == [mesh]
    assert sharding.current_mesh() is None


def test_blocks_tile_the_tensor():
    """Each rank's block (``block_slices``) is the slice its coordinates
    select, and the ranks' blocks tile the tensor exactly once."""
    t = torch.arange(4 * 8 * 6).reshape(4, 8, 6)
    spec = PartitionSpec("model", ("pod", "data"), None)
    count = torch.zeros_like(t)
    for r in range(8):
        mesh = Mesh((2, 2, 2), ("pod", "data", "model"), rank=r)
        c = mesh.coords
        sl = collectives.block_slices(t.shape, spec, mesh)
        assert sl[0] == slice(2 * c["model"], 2 * c["model"] + 2)
        assert sl[1] == slice(2 * (2 * c["pod"] + c["data"]), 2 * (2 * c["pod"] + c["data"]) + 2)
        count[sl] += 1
    assert bool((count == 1).all())


def test_init_sharded_state_is_the_blocks_of_init_train_state():
    from repro_torch.train import init_sharded_state, shard_state

    cfg = smoke_config("mixtral-8x7b")
    whole = init_train_state(cfg, 3, device="cpu")
    for r in (0, 5):
        mesh = Mesh((2, 4), ("data", "model"), rank=r)
        got, want = init_sharded_state(cfg, 3, mesh, device="cpu"), shard_state(cfg, whole, mesh)
        for a, b in zip(tree_leaves(got), tree_leaves(want)):
            assert a.dtype == b.dtype and torch.equal(a, b)
        assert sum(t.numel() for t in tree_leaves(got.params)) < sum(t.numel() for t in tree_leaves(whole.params)) / 4


def test_a_mesh_needs_a_world():
    from repro_torch.launch import mesh as launch_mesh

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialized torch.distributed"):
        launch_mesh.make_mesh((2, 4), ("data", "model"))
    with pytest.raises(RuntimeError, match="initialized torch.distributed"):
        launch_mesh.make_production_mesh()
    with pytest.raises(ValueError, match="abstract mesh"):
        Mesh((2, 4), ("data", "model")).group("data")
    assert set(launch_mesh.HW) == {"peak_flops_bf16", "hbm_bw", "nvlink_bw", "hbm_bytes"}


# ---------------------------------------------------------------------------
# the 2-D step on a gloo world of 8
# ---------------------------------------------------------------------------


def test_fsdp_tp_train_step_2d_mesh(world):
    """``tests/test_multidevice.py:98``'s contract: mixtral's smoke config at
    2 periods on a (2, 4) mesh, ``n_micro`` 2: the loss is finite, and the
    same on every rank."""
    losses = [rank["mixtral_2x4"]["steps"][0]["loss"] for rank in world]
    assert np.isfinite(losses[0]) and len(set(losses)) == 1


@pytest.mark.parametrize("case", list(CASES))
def test_2d_step_matches_the_one_process_step(world, one_process, case):
    cfg, shardwise, whole = one_process[case]
    first = world[0][case]["steps"][0]
    for key in ("loss", "ce", "aux", "grad_norm"):
        assert first[key] == pytest.approx(shardwise[key], rel=1e-5, abs=1e-7), key
        assert all(rank[case]["steps"][0][key] == first[key] for rank in world), key  # the same on every rank
    if cfg.moe is None or cfg.moe.capacity_factor == 4.0:  # drop-free: the whole batch's cross-entropy
        assert first["ce"] == pytest.approx(shardwise["ce_whole"], rel=1e-5)
    if cfg.moe is None:  # a dense model: the shard-wise mean is the whole batch's step
        assert first["grad_norm"] == pytest.approx(whole[0]["grad_norm"], rel=1e-5)


@pytest.mark.parametrize("case", list(CASES))
def test_model_sum_is_applied_once(world, one_process, case):
    """Every rank's own blocks of m and v against the one-process moments
    (``shardwise``) cut to that rank's coordinates: the leaves replicated
    over ``model`` (the norms, ``wk``/``wv``, the router, the final norm)
    are whole on every model rank, neither missing a part nor ``tp`` times
    the gradient."""
    cfg, shardwise, _ = one_process[case]
    arch, shape, *_ = CASES[case]
    specs = tree_leaves(state_pspecs(cfg, Mesh(shape, ("data", "model"))).params,
                        is_leaf=lambda x: isinstance(x, PartitionSpec))
    replicated = 0
    for r, rank in enumerate(world):
        mesh = Mesh(shape, ("data", "model"), rank=r)
        for tag in ("m", "v"):
            for i, (got, want, spec) in enumerate(zip(rank[case]["steps"][0][tag], shardwise[tag], specs)):
                _close(got, want[collectives.block_slices(want.shape, spec, mesh)], f"{case} {tag}[{i}] rank {r}")
                replicated += "model" not in [a for d in range(len(spec)) for a in spec.axes(d)]
    assert replicated > 0


def test_parameters_after_three_steps(world, one_process):
    _, _, whole = one_process["llama_2x4"]
    for r, rank in enumerate(world):
        steps = rank["llama_2x4"]["steps"]
        assert [s["loss"] for s in steps] == pytest.approx([w["loss"] for w in whole], rel=1e-5)
        for got, want in zip(rank["llama_2x4"]["params"], whole[-1]["params"]):
            torch.testing.assert_close(got, want.detach(), rtol=0, atol=1e-5, msg=f"rank {r}")


def test_gather_and_reduce_scatter_along_one_axis(world):
    """``gather(t, dim, axis)`` concatenates the ranks' blocks along ``dim``
    in their order over ``axis``; ``reduce_scatter`` sums over ``axis`` and
    keeps this rank's block along ``dim``."""
    for r, rank in enumerate(world):
        d, m = divmod(r, 4)
        row = [torch.arange(6.0).reshape(2, 3) + 10 * (4 * d + j) for j in range(4)]
        assert torch.equal(rank["gather"], torch.cat(row, 1))
        total = sum((torch.arange(6.0) + 10 * (4 * i + m)).reshape(2, 3).repeat(1, 2) for i in range(2))
        assert torch.equal(rank["reduce_scatter"], total[:, 3 * d:3 * d + 3])


def test_dp_step_takes_a_mesh(world):
    """``make_dp_train_step(mesh=, axes=)`` sums over the mesh's group: the
    same bits as over the default group."""
    for rank in world:
        (l_mesh, p_mesh), (l_group, p_group) = rank["dp_mesh"]
        assert l_mesh == l_group and all(torch.equal(a, b) for a, b in zip(p_mesh, p_group))


def test_pod_mesh_raises(world):
    assert all("ZeRO-1 over 'pod'" in rank["pod"] for rank in world)
