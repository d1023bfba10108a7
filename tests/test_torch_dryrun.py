"""The dry run (``repro_torch.launch.dryrun``) and its collective
statistics (``launch.collective_stats``) against what a gloo world counts
and against the reference's ``dryrun``/``hlo_stats``.

- The dry run's bytes a rank by kind (``full.handoff_by_kind``) and its
  calls equal, exactly, what a CPU gloo world of 8 ranks on (2, 4) hands
  to ``all_reduce`` and ``broadcast`` for the same cells: llama3.2-1b's
  and mixtral's smoke configs (2 periods), a train step at seq 32, global
  batch 8, ``n_micro`` 4 (which the dry run extrapolates from runs at 1
  and 2 periods and 2 and 3 micro-batches), a prefill of 8 prompts of 32
  tokens and a decode step over a 36-position cache.
- The per-rank state bytes (``full.memory.state_bytes``) equal the sum of
  the blocks of ``state_pspecs``; the records carry the reference's keys.
- Every arch × shape cell on 16×16 at smoke config ends ``ok``
  (``--all --smoke``); on the multi-pod mesh the prefill, decode and train
  cells end ``ok``, the train cell with ZeRO-1 over ``pod`` (its
  ``zero_grad`` and ``zero_param`` kinds counted, their links named).
- ``collective_stats`` gives the reference ``collective_stats``'s ring
  bytes for an all-reduce and an all-gather of the same size and group.
"""
import json
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch.collective_stats import collective_stats  # noqa: E402
from repro_torch.sharding import Mesh, PartitionSpec  # noqa: E402
from repro_torch.train import state_pspecs  # noqa: E402

from test_torch_distributed import ROOT, _env, run_world  # noqa: E402

MESH = (2, 4)
ARCHS = ("llama3.2-1b", "mixtral-8x7b")
# cell: (shape, seq, global batch, n_micro)
CELLS = {"train": ("train_4k", 32, 8, 4), "prefill": ("prefill_32k", 32, 8, None), "decode": ("decode_32k", 36, 8, None)}
REFERENCE_KEYS = {"arch", "shape", "mesh", "chips", "n_micro", "n_layers", "overrides", "status", "full", "derived",
                  "roofline"}

RANK_BODY = """
import dataclasses
from repro_torch.configs import smoke_config
from repro_torch.data import SyntheticConfig, batch_at
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import transformer as tfm
from repro_torch.optim import AdamWConfig
from repro_torch.sharding import PartitionSpec, collectives as col, use_mesh
from repro_torch.train import batch_pspec, init_sharded_state, jit_train_step

mesh = make_mesh(%(mesh)r, ("data", "model"))
counts = lambda: (dict(col.BYTES), {k: {c: list(v) for c, v in d.items()} for k, d in col.CALLS.items()})
for arch in %(archs)r:
    cfg = smoke_config(arch)
    _, S, gb, micro = %(cells)r["train"]
    state = init_sharded_state(cfg, 0, mesh, device="cpu")
    batch = {k: col.shard_block(v, batch_pspec(mesh), mesh)
             for k, v in batch_at(SyntheticConfig(vocab=cfg.vocab, seq_len=S, global_batch=gb), 0, device="cpu").items()}
    step = jit_train_step(cfg, AdamWConfig(), mesh, n_micro=micro)
    col.reset_bytes()
    step(state, batch)
    results[arch + "/train"] = counts()
    _, S, gb, _ = %(cells)r["prefill"]
    tokens = col.shard_block(torch.zeros((gb, S), dtype=torch.int32), PartitionSpec("data"), mesh)
    col.reset_bytes()
    with use_mesh(mesh):
        tfm.prefill(cfg, state.params, {"tokens": tokens})
    results[arch + "/prefill"] = counts()
    _, S, gb, _ = %(cells)r["decode"]
    with use_mesh(mesh):
        cache = tfm.init_cache(cfg, gb, S, device="cpu")
        col.reset_bytes()
        tfm.decode_step(cfg, state.params, cache, tokens[:, 0], 5)
    results[arch + "/decode"] = counts()
"""

DRYRUN = """
import json, sys
from repro_torch.launch.dryrun import run_cell
out = {}
for arch, kind, shape, seq, gb, micro, multi, mesh_shape in json.loads(sys.argv[1]):
    rec = run_cell(arch, shape, multi, sys.argv[2], force=True, micro=micro, smoke=True, mesh_shape=mesh_shape,
                   seq=seq, batch=gb)
    out[f"{arch}/{kind}/{mesh_shape or ('multi' if multi else 'single')}"] = rec
json.dump(out, open(sys.argv[3], "w"), default=str)
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


@pytest.fixture(scope="module")
def counted(tmp_path_factory):
    """(the gloo world's counts, the dry run's records) for the same cells;
    the dry run's process runs beside the world."""
    tmp = tmp_path_factory.mktemp("dryrun")
    cells = [(arch, kind, shape, seq, gb, micro, False, "2x4")
             for arch in ARCHS for kind, (shape, seq, gb, micro) in CELLS.items()]
    cells += [("qwen3-0.6b", kind, shape, None, None, None, True, None)
              for kind, shape in (("train", "train_4k"), ("prefill", "prefill_32k"), ("decode", "decode_32k"))]
    out = tmp / "cells.json"
    proc = subprocess.Popen([sys.executable, "-c", DRYRUN, json.dumps(cells), str(tmp / "out"), str(out)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=_env(), cwd=ROOT)
    try:
        world = run_world(tmp / "world8", 8, RANK_BODY % dict(mesh=MESH, archs=ARCHS, cells=CELLS), timeout=180.0)
        log = proc.communicate(timeout=240)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, log[-3000:]
    return world, json.loads(out.read_text())


@pytest.mark.parametrize("cell", [f"{a}/{k}" for a in ARCHS for k in CELLS])
def test_dryrun_bytes_equal_the_worlds(counted, cell):
    world, recs = counted
    rec = recs[cell + "/2x4"]
    assert rec["status"] == "ok", rec.get("error")
    handoff, calls = world[0][cell]
    assert rec["full"]["handoff_by_kind"] == handoff
    assert all(r[cell] == world[0][cell] for r in world)  # every rank hands over the same bytes
    want = collective_stats({k: {c: v for c, v in d.items()} for k, d in calls.items()})
    assert rec["full"]["coll_bytes"] == want["total_bytes"]
    assert {k: (v["count"], v["handoff_bytes"]) for k, v in rec["full"]["coll_by_kind"].items()} == \
        {k: (v["count"], v["handoff_bytes"]) for k, v in want["by_kind"].items()}


def test_dryrun_state_bytes_are_the_blocks(counted):
    from repro_torch.configs import smoke_config
    from repro_torch.models import transformer as tfm
    from repro_torch.models.common import is_shape, tree_leaves
    from repro_torch.sharding import collectives as col

    _, recs = counted
    for arch in ARCHS:
        cfg = smoke_config(arch)
        mesh = Mesh(MESH, ("data", "model"), rank=0)
        specs = state_pspecs(cfg, mesh)
        is_spec = lambda x: isinstance(x, PartitionSpec)  # noqa: E731
        shapes = tree_leaves(tfm.params_shapes(cfg), is_leaf=is_shape)
        want = 0
        for part, dt in (("params", None), ("master", torch.float32), ("m", torch.float32), ("v", torch.float32)):
            tree = specs.params if part == "params" else specs.opt[part]
            for (shape, dtype), spec in zip(shapes, tree_leaves(tree, is_leaf=is_spec)):
                n = 1
                for d in col.block_shape(shape, spec, mesh):
                    n *= d
                want += n * (dt or dtype).itemsize
        mem = recs[f"{arch}/train/2x4"]["full"]["memory"]
        assert mem["state_bytes"] == want
        assert want <= mem["resident_bytes"] <= mem["peak_bytes"]


def test_dryrun_records_carry_the_references_keys(counted):
    _, recs = counted
    for name, rec in recs.items():
        if rec["status"] == "ok" and not name.endswith("/multi"):
            assert REFERENCE_KEYS <= set(rec), name
            assert rec["roofline"]["bottleneck"] in ("compute", "memory", "collective")
            assert {v["link"] for v in rec["roofline"]["links"].values()} == {"nvlink"}  # 8 ranks: one node


def test_multi_pod_serves_and_refuses_the_train_step(counted):
    """It no longer refuses: on the multi-pod mesh the train cell takes
    ZeRO-1 over ``pod`` and ends ``ok``, beside the prefill and decode."""
    _, recs = counted
    assert recs["qwen3-0.6b/prefill/multi"]["status"] == "ok"
    assert recs["qwen3-0.6b/decode/multi"]["status"] == "ok"
    train = recs["qwen3-0.6b/train/multi"]
    assert train["status"] == "ok", train.get("error")
    kinds = train["full"]["coll_by_kind"]
    assert kinds["zero_grad"]["axes"] == ["data"] and kinds["zero_param"]["axes"] == ["pod+data"]
    assert train["full"]["handoff_by_kind"]["zero_grad"] > 0
    assert recs["qwen3-0.6b/prefill/multi"]["chips"] == 512


def test_every_kind_names_its_link(counted):
    """The roofline names the link of each kind's groups, the new kinds
    too: on (2, 4) every group sits in one node."""
    _, recs = counted
    rec = recs["llama3.2-1b/decode/2x4"]
    links = rec["roofline"]["kind_links"]
    assert {"vocab_sum", "vocab_gather", "head_gather", "attn_combine"} <= set(links)
    assert links["vocab_gather"] == {"model": "nvlink"}
    train = recs["llama3.2-1b/train/2x4"]["roofline"]["kind_links"]
    assert train["vocab_ce"] == {"model": "nvlink"} and "vocab_sum" in train


def test_every_cell_at_smoke_config_ends_ok(tmp_path):
    """``python -m repro_torch.launch.dryrun --all --smoke`` on 16×16: every
    cell ``ok``, each record written, the network named for the axes whose
    groups leave a node."""
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--all", "--smoke", "--jobs", "3",
                          "--out", str(tmp_path)], capture_output=True, text=True, timeout=300, env=_env(), cwd=ROOT)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert "done; 0 failures" in res.stdout
    from repro_torch.configs import registry

    recs = [json.loads((tmp_path / "single" / f"{a}__{s}_smoke.json").read_text()) for a, s in registry.all_cells()]
    assert len(recs) == 33 and all(r["status"] == "ok" for r in recs)
    links = {axes: v["link"] for r in recs for axes, v in r["roofline"]["links"].items()}
    assert links["data"] == links["model"] == "network"  # 16 ranks span two nodes of 8


def test_collective_stats_are_the_references():
    """The reference's formulas on HLO text against the port's on the same
    collective, group size and bytes."""
    from repro.launch import hlo_stats

    hlo = "\n".join([
        "%ar = f32[1024,16]{1,0} all-reduce(f32[1024,16]{1,0} %x), replica_groups=[16,16]<=[256], to_apply=%add",
        "%ag = bf16[4096,512]{1,0} all-gather(bf16[256,512]{1,0} %y), replica_groups=[16,16]<=[256], dimensions={0}",
    ])
    ref = hlo_stats.collective_stats(hlo)
    block = 256 * 512 * 2
    port = collective_stats({
        "model_sum": {("all_reduce", ("model",), 16): (1, 1024 * 16 * 4)},
        "gather": {("broadcast", ("data",), 16): (16, 16 * block)},  # a gather of 16 blocks: 16 broadcasts
    })
    assert port["by_kind"]["model_sum"]["bytes"] == pytest.approx(ref["by_kind"]["all-reduce"]["bytes"], rel=1e-12)
    assert port["by_kind"]["gather"]["bytes"] == pytest.approx(ref["by_kind"]["all-gather"]["bytes"], rel=1e-12)
    assert port["total_bytes"] == pytest.approx(ref["total_bytes"], rel=1e-12)
    assert port["by_kind"]["gather"]["handoff_bytes"] == 4096 * 512 * 2
    assert port["by_axes"] == {"model": port["by_kind"]["model_sum"]["bytes"],
                               "data": port["by_kind"]["gather"]["bytes"]}
