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
rows of each bigram batch (``batch_pspec``).  The families' smoke configs
run truly tensor-parallel on (2, 4): deepseek-v2 (MLA and the MoE at the
drop-free 4.0), mamba2 (SSD), recurrentgemma (RG-LRU) and the vision model
(cross-attention, its gates opened, image embeddings drawn from a seed a
step).  ``llama_2x2x2`` takes ZeRO-1 over ``pod`` on a ``("pod", "data",
"model")`` mesh: three steps, the optimizer's blocks, and its state saved
and restored elastically onto (2, 4) bitwise; its first step is also held
to the JAX reference's ``jit_train_step`` on the same weights and batch
(a subprocess on 8 forced host devices, a (2, 2, 2) mesh with ``Auto``
axes, ``n_micro`` 1, beside the world).  The step is held to the
one-process step on the same weights, never to the reference's sharded
output (``tests/test_multidevice.py:98`` fails in the reference under JAX
0.9, ROADMAP §C); its own contract, a finite loss for mixtral's smoke
config at 2 periods on (2, 4) with ``n_micro`` 2, seq 64 and batch 4, is
held as stated.

Tolerances (f32; the step's sums over ranks regroup the one-process
sums): loss, cross-entropy, aux and ``grad_norm`` within 1e-5 relative
(against the JAX reference's ZeRO-1 step, 1e-5 too);
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
import inspect
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro_torch import sharding  # noqa: E402
from repro_torch.configs import get_config, list_archs, smoke_config  # noqa: E402
from repro_torch.data import SyntheticConfig, batch_at  # noqa: E402
from repro_torch.models.common import is_shape, tree_leaves, tree_map  # noqa: E402
from repro_torch.models.transformer import params_shapes  # noqa: E402
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
    "deepseek_2x4": ("deepseek-v2-236b", (2, 4), 64, 4, 1, 1, 4.0),  # MLA
    "mamba2_2x4": ("mamba2-2.7b", (2, 4), 64, 4, 1, 1, None),  # SSD
    "recurrentgemma_2x4": ("recurrentgemma-9b", (2, 4), 64, 4, 1, 1, None),  # RG-LRU
    "vision_2x4": ("llama-3.2-vision-11b", (2, 4), 64, 4, 1, 1, None),  # cross-attention
    "llama_2x2x2": ("llama3.2-1b", (2, 2, 2), 64, 8, 1, 3, None),  # ZeRO-1 over pod
}
WORLD = 8
# a mesh shape's axes
AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}
# the JAX reference's ZeRO-1 step: (the port's case whose weights and first
# batch it takes, n_micro)
ZERO_REF = ("llama_2x2x2", 1)

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
import numpy as np
from repro_torch.configs import smoke_config
from repro_torch.data import SyntheticConfig, batch_at
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.optim import AdamWConfig
from repro_torch.sharding import NamedSharding, PartitionSpec, collectives as col
from repro_torch.train import (TrainState, batch_pspec, checkpoint as ckpt, init_train_state, jit_train_step,
                               make_dp_train_step, restore_elastic, shard_state, state_pspecs)
%(helpers)s
ocfg = AdamWConfig(**%(ocfg)r)
is_spec = lambda x: isinstance(x, PartitionSpec)
meshes = {}
for case, (arch, shape, seq, gb, micro, steps, cap) in %(cases)r.items():
    if shape not in meshes:
        meshes[shape] = make_mesh(shape, %(axes)r[len(shape)])
    mesh = meshes[shape]
    cfg = config(arch, cap)
    dcfg = SyntheticConfig(vocab=cfg.vocab, seq_len=seq, global_batch=gb)
    whole = init_train_state(cfg, 0, device="cpu")
    state = shard_state(cfg, TrainState(whole.step, opened(cfg, whole.params), None), mesh)
    specs = state_pspecs(cfg, mesh)
    step = jit_train_step(cfg, ocfg, mesh, n_micro=micro)
    recs = []
    for i in range(steps):
        batch = {k: col.shard_block(v, batch_pspec(mesh), mesh) for k, v in batch_of(cfg, dcfg, i).items()}
        state, m = step(state, batch)
        rec = {k: float(v) for k, v in m.items()}
        if i == 0:
            rec["m"] = [t.clone() for t in tree_leaves(state.opt["m"])]
            rec["v"] = [t.clone() for t in tree_leaves(state.opt["v"])]
        recs.append(rec)
    params = [col.unshard(b, s, mesh) for b, s in zip(tree_leaves(state.params),
                                                      tree_leaves(specs.params, is_leaf=is_spec))]
    results[case] = dict(steps=recs, params=params, coords=mesh.coords,
                         shapes={k: [tuple(t.shape) for t in tree_leaves(tree)]
                                 for k, tree in (("params", state.params), ("master", state.opt["master"]))})
    if len(shape) == 3:  # the ZeRO-1 state saved, then restored onto (2, 4) by the same world
        places = tree_map(lambda s: NamedSharding(mesh, s), specs, is_leaf=is_spec)
        ckpt.save(f"{tmp}/../zero1", steps, state, shardings=places)
        small = meshes[(2, 4)]
        restored, at = restore_elastic(f"{tmp}/../zero1", cfg, small, device="cpu")
        small_places = ckpt._flatten(tree_map(lambda s: NamedSharding(small, s), state_pspecs(cfg, small),
                                              is_leaf=is_spec))
        bitwise = True
        with np.load(f"{tmp}/../zero1/step_{at}/arrays.npz") as saved:
            for key, block in ckpt._flatten(restored).items():
                arr = saved[key]
                want = arr[col.block_slices(arr.shape, small_places[key].spec, small)]
                got = np.asarray(block)
                bitwise = bitwise and got.dtype == want.dtype and got.tobytes() == np.ascontiguousarray(want).tobytes()
        results[case]["restored"] = dict(step=at, bitwise=bitwise)

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

# a vocabulary that does not divide over 'model' (255 over 4): the table
# is used whole, and the loss and gradients are the one-process ones
mesh24 = meshes[(2, 4)]
cfg = smoke_config("qwen3-0.6b").replace(n_periods=1, vocab=255)
whole = init_train_state(cfg, 0, device="cpu")
state = shard_state(cfg, TrainState(whole.step, whole.params, None), mesh24)
dcfg = SyntheticConfig(vocab=cfg.vocab, seq_len=32, global_batch=4)
batch = {k: col.shard_block(v, batch_pspec(mesh24), mesh24) for k, v in batch_at(dcfg, 0, device="cpu").items()}
col.reset_bytes()
state, m = jit_train_step(cfg, ocfg, mesh24)(state, batch)
results["odd_vocab"] = dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]), bytes=dict(col.BYTES),
                            embed=tuple(state.params["embed"].shape))
"""

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small tensors, the module's fixtures
    included: the suite runs several test workers at once, and more threads
    only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# shared by the ranks and the test process: the config of a case (f32
# moments and accumulation), the
# vision model's cross-attention gates opened (zero at init adds nothing)
# and its image embeddings (a seed a step)
def config(arch, cap):
    # f32 moments and accumulation (deepseek-v2's smoke config keeps bf16
    # ones): the cases hold the mesh's sums, not bf16 rounding
    cfg = smoke_config(arch).replace(n_periods=2, opt_moments_dtype="float32", grad_accum_dtype="float32")
    return cfg if cap is None else cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=cap))


def opened(cfg, params):
    for i, spec in enumerate(cfg.pattern):
        if spec.mixer == "cross_attn":
            gate = params["pattern"][i]["mixer"]["gate"]
            with torch.no_grad():
                gate.copy_(torch.linspace(0.3, 0.7, gate.numel()).reshape(gate.shape))
    return params


def batch_of(cfg, dcfg, i):
    batch = batch_at(dcfg, i, device="cpu")
    if cfg.frontend == "vision":
        gen = torch.Generator().manual_seed(100 + i)
        batch["image_embeds"] = torch.randn((dcfg.global_batch, cfg.n_patches, cfg.d_model), generator=gen)
    return batch


# the same functions in the ranks' script
HELPERS = "import dataclasses\n" + "\n".join(inspect.getsource(f) for f in (config, opened, batch_of))

# the JAX reference's jit_train_step on a (2, 2, 2) mesh of forced host
# devices with Auto axes, on the port's weights (leaves in flatten order)
# and batch
ZERO_REFERENCE = """
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs import smoke_config
from repro.optim import AdamWConfig, adamw_init
from repro.train.step import TrainState, init_train_state, jit_train_step

d = np.load(sys.argv[1])
cfg = smoke_config(%(arch)r).replace(n_periods=2)
shapes = jax.eval_shape(lambda: init_train_state(cfg, jax.random.key(0))).params
params = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(shapes),
                                      [jnp.asarray(d[f"p{i}"]) for i in range(len(jax.tree_util.tree_leaves(shapes)))])
state = TrainState(step=jnp.zeros((), jnp.int32), params=params, opt=adamw_init(params))
mesh = jax.make_mesh(%(shape)r, ("pod", "data", "model"), axis_types=(AxisType.Auto,) * 3)
with mesh:
    step = jax.jit(jit_train_step(cfg, AdamWConfig(**%(ocfg)r), mesh, n_micro=%(micro)d))
    _, m = step(state, {"tokens": jnp.asarray(d["tokens"]), "labels": jnp.asarray(d["labels"])})
json.dump({k: float(v) for k, v in m.items()}, open(sys.argv[2], "w"))
"""


def _enc(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


@pytest.fixture(scope="module")
def reference_specs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_specs")
    run_reference(REFERENCE % dict(meshes=MESHES, path=str(tmp / "specs.json")), devices=512)
    return json.loads((tmp / "specs.json").read_text())


@pytest.fixture(scope="module")
def world(world_and_reference):
    return world_and_reference[0]


@pytest.fixture(scope="module")
def world_and_reference(tmp_path_factory):
    """(the ranks' results, the JAX reference's ZeRO-1 metrics); the
    reference's process runs beside the world."""
    import subprocess
    import sys

    from test_torch_distributed import ROOT, _env

    tmp = tmp_path_factory.mktemp("mesh_world")
    case, micro = ZERO_REF
    arch, shape, seq, gb, *_ = CASES[case]
    cfg = config(arch, None)
    batch = batch_of(cfg, SyntheticConfig(vocab=cfg.vocab, seq_len=seq, global_batch=gb), 0)
    leaves = tree_leaves(init_train_state(cfg, 0, device="cpu").params)
    np.savez(tmp / "zero_ref.npz", tokens=batch["tokens"].numpy(), labels=batch["labels"].numpy(),
             **{f"p{i}": t.detach().numpy() for i, t in enumerate(leaves)})
    code = ZERO_REFERENCE % dict(arch=arch, shape=shape, ocfg=OCFG, micro=micro)
    proc = subprocess.Popen([sys.executable, "-c", code, str(tmp / "zero_ref.npz"), str(tmp / "zero_ref.json")],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=ROOT,
                            env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=8", JAX_PLATFORMS="cpu"))
    try:
        ranks = run_world(tmp / "world8", WORLD, RANK_BODY % dict(ocfg=OCFG, cases=CASES, axes=AXES, helpers=HELPERS),
                          timeout=300.0)
        log = proc.communicate(timeout=300)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, log[-3000:]
    return ranks, json.loads((tmp / "zero_ref.json").read_text())


def _one_process(case):
    """The one-process references of a case: ``make_train_step`` on the
    whole batch for each step, and, for the first step, the mean over the
    data shards and micro-batches of the per-shard gradients (the mesh
    step's definition) through ``adamw_update``."""
    arch, shape, seq, gb, micro, steps, cap = CASES[case]
    cfg = config(arch, cap)
    dcfg = SyntheticConfig(vocab=cfg.vocab, seq_len=seq, global_batch=gb)
    ocfg = AdamWConfig(**OCFG)
    state = init_train_state(cfg, 0, device="cpu")
    opened(cfg, state.params)
    state = state._replace(opt=adamw_init(state.params))
    batch = batch_of(cfg, dcfg, 0)
    n_dp = math.prod(shape[:-1])
    rows = gb // n_dp
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
        state, m = step(state, batch_of(cfg, dcfg, i))
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
    (``shardwise``) cut to that rank's coordinates under the optimizer's
    specs: the leaves replicated over ``model`` (the norms, ``wk``/``wv``,
    the router, the final norm, MLA's latent projections, SSD's head-wise
    and ``state`` leaves, RG-LRU's gate biases and Λ, the cross gate) are
    whole on every model rank, neither missing a part nor ``tp`` times the
    gradient."""
    cfg, shardwise, _ = one_process[case]
    arch, shape, *_ = CASES[case]
    specs = tree_leaves(state_pspecs(cfg, Mesh(shape, AXES[len(shape)])).opt["master"],
                        is_leaf=lambda x: isinstance(x, PartitionSpec))
    replicated = 0
    for r, rank in enumerate(world):
        mesh = Mesh(shape, AXES[len(shape)], rank=r)
        for tag in ("m", "v"):
            for i, (got, want, spec) in enumerate(zip(rank[case]["steps"][0][tag], shardwise[tag], specs)):
                _close(got, want[collectives.block_slices(want.shape, spec, mesh)], f"{case} {tag}[{i}] rank {r}")
                replicated += "model" not in [a for d in range(len(spec)) for a in spec.axes(d)]
    assert replicated > 0


@pytest.mark.parametrize("case", ["llama_2x4", "llama_2x2x2"])
def test_parameters_after_three_steps(world, one_process, case):
    _, _, whole = one_process[case]
    for r, rank in enumerate(world):
        steps = rank[case]["steps"]
        assert [s["loss"] for s in steps] == pytest.approx([w["loss"] for w in whole], rel=1e-5)
        for got, want in zip(rank[case]["params"], whole[-1]["params"]):
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
    """It no longer raises: ``jit_train_step`` on a ``("pod", "data",
    "model")`` mesh takes ZeRO-1 over ``pod``.  Each rank's
    parameters are its blocks under the rules and its master (and moments)
    its blocks under ``OPT_RULES`` (``embed`` split over ``("pod",
    "data")``: half a parameter block's rows on (2, 2, 2)), and the state
    saved from it restores onto (2, 4) bitwise."""
    arch, shape, *_ = CASES["llama_2x2x2"]
    cfg = config(arch, None)
    specs = state_pspecs(cfg, Mesh(shape, AXES[3]))
    is_spec = lambda x: isinstance(x, PartitionSpec)  # noqa: E731
    shapes = [s for s, _ in tree_leaves(params_shapes(cfg), is_leaf=is_shape)]
    mesh = Mesh(shape, AXES[3])
    want_p = [collectives.block_shape(sh, sp, mesh) for sh, sp in zip(shapes, tree_leaves(specs.params, is_leaf=is_spec))]
    want_o = [collectives.block_shape(sh, sp, mesh) for sh, sp in zip(shapes, tree_leaves(specs.opt["master"],
                                                                                          is_leaf=is_spec))]
    assert want_p != want_o
    assert sum(math.prod(s) for s in want_o) < sum(math.prod(s) for s in want_p)
    for rank in world:
        assert rank["llama_2x2x2"]["shapes"] == {"params": want_p, "master": want_o}
        assert rank["llama_2x2x2"]["restored"] == {"step": 3, "bitwise": True}


def test_zero1_step_matches_the_jax_reference(world_and_reference):
    """The port's ZeRO-1 step on (2, 2, 2) against the reference's
    ``jit_train_step`` on a (2, 2, 2) ``Auto`` mesh, the same weights and
    batch, ``n_micro`` 1 on both."""
    ranks, ref = world_and_reference
    first = ranks[0]["llama_2x2x2"]["steps"][0]
    assert first["loss"] == pytest.approx(ref["loss"], rel=1e-5)
    assert first["grad_norm"] == pytest.approx(ref["grad_norm"], rel=1e-5)


def test_a_vocab_that_does_not_split_is_used_whole(world):
    """255 entries over 4 model ranks: the rules keep ``vocab`` whole, so
    every rank holds its data block of the whole table, no vocab-parallel
    collective runs, and the step is the one-process step."""
    cfg = smoke_config("qwen3-0.6b").replace(n_periods=1, vocab=255)
    whole = init_train_state(cfg, 0, device="cpu")
    dcfg = SyntheticConfig(vocab=cfg.vocab, seq_len=32, global_batch=4)
    _, m = make_train_step(cfg, AdamWConfig(**OCFG))(whole, batch_at(dcfg, 0, device="cpu"))
    for rank in world:
        got = rank["odd_vocab"]
        assert got["embed"] == (255, cfg.d_model // 2)
        assert got["bytes"]["vocab_sum"] == got["bytes"]["vocab_ce"] == 0 and got["bytes"]["gather"] > 0
        assert got["loss"] == pytest.approx(float(m["loss"]), rel=1e-5)
        assert got["grad_norm"] == pytest.approx(float(m["grad_norm"]), rel=1e-5)
