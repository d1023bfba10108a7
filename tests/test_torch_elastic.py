"""Port parity: elastic restore (``repro_torch.train.restore_elastic``,
``checkpoint.restore(shardings=)``), the sharded save and the mesh
launcher (``launch/train.py --mesh``) against the JAX reference's
``restore_elastic``.

The reference (one subprocess, 4 forced host devices,
``tests/test_multidevice.py::test_elastic_restore_to_smaller_mesh``'s
setting: qwen3-0.6b's smoke config at 2 periods) saves its step-5 state
and restores it onto a (2, 2) mesh.  The port's world of 4 CPU gloo ranks
(``tests/test_torch_distributed.py:run_world``) restores the reference's
file onto a (4,) mesh, saves that sharded state (assembled leaf by leaf,
written by the first rank), and restores its own file onto (2, 2):

- every block each rank holds on (2, 2) is bitwise its slice of the saved
  array, and the leaves reassembled from the blocks are bitwise the
  reference's ``restore_elastic`` values;
- the file written from the sharded state holds bitwise the arrays, keys
  and byte count of the file the unsharded state writes.

The launcher runs under ``torchrun`` on 4 CPU gloo ranks: 2 steps of
llama3.2-1b's smoke config on ``--mesh 2x2`` with a checkpoint after each,
then a resume onto ``--mesh 4`` for a third step.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.train import latest_step  # noqa: E402

from test_torch_distributed import ROOT, run_reference, run_world  # noqa: E402

REFERENCE = """
import numpy as np
import jax
from jax.sharding import AxisType
from repro.configs import smoke_config
from repro.train import init_train_state, save
from repro.train.elastic import restore_elastic

cfg = smoke_config("qwen3-0.6b").replace(n_periods=2)
state = init_train_state(cfg, jax.random.key(0))
save(%(ckpt)r, 5, state)
mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto, AxisType.Auto))
restored, step = restore_elastic(%(ckpt)r, cfg, mesh)
out = {"step": np.asarray(step)}
for path, leaf in jax.tree_util.tree_flatten_with_path(restored)[0]:
    out["leaf:" + jax.tree_util.keystr(path)] = np.asarray(leaf)
np.savez(%(path)r, **out)
"""

RANK_BODY = """
import torch.distributed as dist
from repro_torch.configs import smoke_config
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.common import tree_map
from repro_torch.sharding import NamedSharding, PartitionSpec, collectives as col
from repro_torch.train import checkpoint as ckpt, restore_elastic, state_pspecs, state_shapes

cfg = smoke_config("qwen3-0.6b").replace(n_periods=2)
is_spec = lambda x: isinstance(x, PartitionSpec)

def shardings(mesh):
    return tree_map(lambda s: NamedSharding(mesh, s), state_pspecs(cfg, mesh), is_leaf=is_spec)

mesh4 = make_mesh((4,), ("data",))
state, step = restore_elastic(%(ref_ckpt)r, cfg, mesh4, device="cpu")  # the reference's file onto (4,)
results["step_from_reference"] = step
ckpt.save(%(port_ckpt)r, 5, state, shardings=shardings(mesh4))
if rank == 0:  # the unsharded state's file
    whole, _ = ckpt.restore(%(ref_ckpt)r, state_shapes(cfg), device="cpu")
    ckpt.save(%(whole_ckpt)r, 5, whole)
dist.barrier()

mesh22 = make_mesh((2, 2), ("data", "model"))
state, step = restore_elastic(%(port_ckpt)r, cfg, mesh22, device="cpu")
results["step"] = step
blocks = ckpt._flatten(state)
places = ckpt._flatten(shardings(mesh22))
with np.load(%(port_ckpt)r + "/step_5/arrays.npz") as saved:
    results["bitwise_blocks"] = {
        k: bool(np.array_equal(b.numpy(), saved[k][col.block_slices(saved[k].shape, places[k].spec, mesh22)]))
        for k, b in blocks.items()}
results["sharded"] = {k: tuple(places[k].spec) for k in blocks}
results["whole"] = {k: col.unshard(b, places[k].spec, mesh22) for k, b in blocks.items()}
"""


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("elastic")
    paths = dict(ref_ckpt=str(tmp / "ref_ckpt"), port_ckpt=str(tmp / "port_ckpt"), whole_ckpt=str(tmp / "whole_ckpt"))
    run_reference(REFERENCE % dict(ckpt=paths["ref_ckpt"], path=str(tmp / "ref.npz")), devices=4)
    ranks = run_world(tmp / "world4", 4, RANK_BODY % paths, timeout=240.0)
    return dict(np.load(tmp / "ref.npz")), ranks, paths


def test_restore_elastic_onto_a_smaller_mesh(worlds):
    """``tests/test_multidevice.py:128``'s contract, on the port's world:
    the reference's step-5 checkpoint restores onto (4,), and the port's
    own file from it onto (2, 2), at step 5."""
    ref, ranks, _ = worlds
    assert int(ref["step"]) == 5
    for rank in ranks:
        assert rank["step_from_reference"] == 5 and rank["step"] == 5


def test_restored_blocks_are_bitwise_slices(worlds):
    _, ranks, _ = worlds
    for r, rank in enumerate(ranks):
        assert rank["bitwise_blocks"] and all(rank["bitwise_blocks"].values()), r
    # the (2, 2) rules split something over each axis, so the blocks are real cuts
    axes = {a for spec in ranks[0]["sharded"].values() for e in spec if e for a in ((e,) if isinstance(e, str) else e)}
    assert axes == {"data", "model"}


def test_reassembled_leaves_are_the_references(worlds):
    ref, ranks, _ = worlds
    for r, rank in enumerate(ranks):
        assert set(rank["whole"]) == {k[len("leaf:"):] for k in ref if k.startswith("leaf:")}
        for key, got in rank["whole"].items():
            want = ref["leaf:" + key]
            assert got.numpy().dtype == want.dtype and np.array_equal(got.numpy(), want), (r, key)


def test_a_sharded_save_writes_the_unsharded_file(worlds):
    _, _, paths = worlds
    sharded, whole = (os.path.join(paths[k], "step_5") for k in ("port_ckpt", "whole_ckpt"))
    with np.load(sharded + "/arrays.npz") as a, np.load(whole + "/arrays.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k
    ma, mb = (json.loads(open(p + "/manifest.json").read()) for p in (sharded, whole))
    assert (ma["keys"], ma["nbytes"], ma["step"]) == (mb["keys"], mb["nbytes"], mb["step"])


def _torchrun(*args, world=4):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", f"--nproc-per-node={world}",
         "-m", "repro_torch.launch.train", *args],
        env=env, capture_output=True, text=True, timeout=300)


def test_launch_train_on_a_mesh_checkpoints_and_resumes(tmp_path):
    common = ("--arch", "llama3.2-1b", "--smoke", "--device", "cpu", "--backend", "gloo", "--seq", "32",
              "--batch", "4", "--ckpt", str(tmp_path), "--ckpt-every", "1")
    out = _torchrun(*common, "--mesh", "2x2", "--steps", "2")
    assert out.returncode == 0, out.stderr[-4000:]
    assert "step     2 loss" in out.stdout and latest_step(str(tmp_path)) == 2
    loss = float(out.stdout.split("step     2 loss")[1].split()[0])
    assert np.isfinite(loss)
    out = _torchrun(*common, "--mesh", "4", "--steps", "3")  # elastic: onto a 1-D mesh of 4
    assert out.returncode == 0, out.stderr[-4000:]
    assert "[resume] step 2 onto mesh (4,)" in out.stdout and "step     3 loss" in out.stdout
    assert latest_step(str(tmp_path)) == 3
