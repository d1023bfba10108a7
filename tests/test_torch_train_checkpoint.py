"""Port parity: the atomic checkpoint store (``repro_torch.train.checkpoint``)
against the JAX reference's ``repro.train.checkpoint``.

- the layout is the reference's: ``step_<n>/arrays.npz`` with one array per
  leaf named as ``jax.tree_util.keystr`` names its path, and a
  ``manifest.json`` with the step and the sorted keys;
- a checkpoint written by either package restores bitwise in the other,
  for f64/f32/int/uint8/bool leaves in nested dicts, lists, tuples and
  namedtuples (bf16 goes through f32 exactly);
- atomic writes: orphaned ``tmp.<step>.<pid>`` staging dirs of dead
  writers are swept by the next save, a live writer's are kept; a step
  without its manifest is not a checkpoint; keep-n GC;
- ``AsyncCheckpointer`` snapshots in the caller's thread (a later in-place
  write does not reach the file) and surfaces a writer's error;
- ``restore`` refuses missing keys and shape mismatches, raises naming
  ROADMAP A14 for ``shardings=``, and runs on the card unless told
  otherwise.

The lock-order watchdog is armed for every test of the file.
"""
import collections
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.train import checkpoint as jckpt  # noqa: E402
from repro_torch.obs import lockcheck  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402

CPU = "cpu"
Pair = collections.namedtuple("Pair", ["x", "y"])


@pytest.fixture(autouse=True)
def _lock_watchdog():
    forced = lockcheck._forced
    lockcheck.enable()
    yield
    lockcheck._forced = forced


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "f64": rng.standard_normal((5, 3)),
        "f32": rng.standard_normal(7).astype(np.float32),
        "i64": np.int64(41),
        "i32": rng.integers(-9, 9, (4,), dtype=np.int32),
        "u8": rng.integers(0, 255, (16,), dtype=np.uint8),
        "flag": np.array([True, False, True]),
    }


def _tensor(v):
    return torch.as_tensor(np.asarray(v))  # a numpy scalar as a 0-d tensor


def _tree(leaf):
    """A nested tree over the arrays: dicts, a list, a tuple, a namedtuple."""
    a = {k: leaf(v) for k, v in _arrays().items()}
    return {"state": a["f64"], "meta": {"rows": a["i64"], "flag": a["flag"]},
            "parts": [a["f32"], (a["i32"], a["u8"])], "pair": Pair(x=a["f64"][0], y=None)}


def test_keys_are_the_references_keystr_names(tmp_path):
    path = ckpt.save(str(tmp_path), 3, _tree(_tensor))
    ref_keys = sorted(jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(_tree(np.asarray))[0])
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["keys"] == ref_keys and manifest["step"] == 3
    assert "['state']" in ref_keys and "['parts'][1][0]" in ref_keys and ".x" in "".join(ref_keys)
    assert sorted(np.load(os.path.join(path, "arrays.npz")).files) == ref_keys
    assert manifest["nbytes"] == sum(np.asarray(v).nbytes for v in jax.tree_util.tree_leaves(_tree(np.asarray)))


def test_port_round_trip_bitwise_with_tensor_and_spec_targets(tmp_path):
    tree = _tree(_tensor)
    ckpt.save(str(tmp_path), 1, tree)
    got, step = ckpt.restore(str(tmp_path), tree)  # tensor targets: their own device
    assert step == 1
    for (p, a), (q, b) in zip(jax.tree_util.tree_flatten_with_path(_tree(np.asarray))[0],
                              jax.tree_util.tree_flatten_with_path(jax.tree_util.tree_map(np.asarray, got))[0]):
        assert p == q and a.dtype == b.dtype and np.array_equal(a, b)
    assert isinstance(got["pair"], Pair) and got["pair"].y is None and isinstance(got["parts"][1], tuple)
    specs = {"state": ((5, 3), torch.float64), "meta": {"rows": ((), np.int64)}}
    got, _ = ckpt.restore(str(tmp_path), specs, device=CPU)
    assert torch.equal(got["state"], tree["state"]) and int(got["meta"]["rows"]) == 41
    assert got["meta"]["rows"].dtype == torch.int64


def test_bf16_round_trips_through_f32(tmp_path):
    x = torch.randn(6, 4, generator=torch.Generator().manual_seed(1)).bfloat16()
    ckpt.save(str(tmp_path), 0, {"w": x})
    got, _ = ckpt.restore(str(tmp_path), {"w": x})
    assert got["w"].dtype == torch.bfloat16 and torch.equal(got["w"], x)


def test_reference_writes_port_restores_bitwise(tmp_path):
    jtree = jax.tree_util.tree_map(jnp.asarray, {"state": _arrays()["f64"], "it": _arrays()["i64"],
                                                 "parts": [_arrays()["f32"], _arrays()["u8"]]})
    jckpt.save(str(tmp_path), 7, jtree)
    target = {"state": ((5, 3), torch.float64), "it": ((), torch.int64),
              "parts": [((7,), torch.float32), ((16,), torch.uint8)]}
    got, step = ckpt.restore(str(tmp_path), target, device=CPU)
    assert step == 7 == ckpt.latest_step(str(tmp_path))
    assert torch.equal(got["state"], torch.as_tensor(_arrays()["f64"]))
    assert torch.equal(got["parts"][0], torch.as_tensor(_arrays()["f32"]))
    assert torch.equal(got["parts"][1], torch.as_tensor(_arrays()["u8"])) and int(got["it"]) == 41


def test_port_writes_reference_restores_bitwise(tmp_path):
    ckpt.save(str(tmp_path), 5, _tree(_tensor))
    target = jax.tree_util.tree_map(lambda a: jax.ShapeDtypeStruct(np.shape(a), np.asarray(a).dtype),
                                    _tree(np.asarray))
    got, step = jckpt.restore(str(tmp_path), target)
    assert step == 5 == jckpt.latest_step(str(tmp_path))
    for a, b in zip(jax.tree_util.tree_leaves(_tree(np.asarray)), jax.tree_util.tree_leaves(got)):
        assert np.array_equal(a, np.asarray(b))


def test_latest_step_needs_the_manifest_and_saves_are_atomic(tmp_path):
    d = str(tmp_path)
    assert ckpt.latest_step(d) is None and ckpt.latest_step(str(tmp_path / "absent")) is None
    ckpt.save(d, 2, {"a": torch.zeros(2)})
    ckpt.save(d, 10, {"a": torch.ones(2)})
    os.makedirs(os.path.join(d, "step_99"))  # a step dir without its manifest
    assert ckpt.latest_step(d) == 10 == jckpt.latest_step(d)
    ckpt.save(d, 10, {"a": torch.full((2,), 3.0)})  # re-saving a step replaces it
    got, _ = ckpt.restore(d, {"a": torch.zeros(2)})
    assert torch.equal(got["a"], torch.full((2,), 3.0))
    assert not any(n.startswith("tmp.") for n in os.listdir(d))


def test_orphaned_staging_dirs_are_swept(tmp_path):
    d = str(tmp_path)
    dead = subprocess.run([sys.executable, "-c", "import os; print(os.getpid())"], capture_output=True,
                          text=True, check=True)
    dead_pid = int(dead.stdout)
    os.makedirs(os.path.join(d, f"tmp.4.{dead_pid}"))
    os.makedirs(os.path.join(d, f"tmp.5.{os.getpid()}x"))  # not a staging name: left alone
    live = os.path.join(d, f"tmp.6.{os.getppid()}")  # a live writer's staging dir
    os.makedirs(live)
    ckpt.save(d, 1, {"a": torch.zeros(1)})
    names = set(os.listdir(d))
    assert f"tmp.4.{dead_pid}" not in names and os.path.isdir(live) and f"tmp.5.{os.getpid()}x" in names


def test_gc_keeps_the_newest(tmp_path):
    d = str(tmp_path)
    for s in (1, 3, 5, 7):
        ckpt.save(d, s, {"a": torch.tensor([float(s)])})
    ckpt.gc_checkpoints(d, keep_n=2)
    assert sorted(os.listdir(d)) == ["step_5", "step_7"]
    ckpt.gc_checkpoints(str(tmp_path / "absent"))  # no dir: nothing to do


def test_async_checkpointer_snapshots_in_the_callers_thread(tmp_path):
    d = str(tmp_path)
    w = torch.zeros(4, dtype=torch.float64)
    writer = ckpt.AsyncCheckpointer(d, keep_n=2)
    for step in range(4):
        w += 1.0
        writer.submit(step, {"w": w})
    w += 100.0  # after the last snapshot: never reaches a file
    writer.finalize()
    assert sorted(os.listdir(d)) == ["step_2", "step_3"]
    got, step = ckpt.restore(d, {"w": w})
    assert step == 3 and torch.equal(got["w"], torch.full((4,), 4.0, dtype=torch.float64))


def test_async_checkpointer_surfaces_a_writer_error(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    writer = ckpt.AsyncCheckpointer(str(blocker))
    writer.submit(0, {"a": torch.zeros(1)})
    with pytest.raises(OSError):
        writer.finalize()


def test_restore_refusals(tmp_path):
    d = str(tmp_path)
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        ckpt.restore(d, {"a": torch.zeros(2)})
    ckpt.save(d, 0, {"a": torch.zeros(2)})
    with pytest.raises(ValueError, match="missing keys"):
        ckpt.restore(d, {"b": torch.zeros(2)})
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore(d, {"a": torch.zeros(3)})
    with pytest.raises(ValueError, match="shardings= does not match"):
        ckpt.restore(d, {"a": torch.zeros(2)}, shardings={"a": None})
    # a block a rank on a mesh (here of one rank: the whole leaf; worlds of
    # several ranks in tests/test_torch_elastic.py)
    from repro_torch.sharding import Mesh, NamedSharding, PartitionSpec

    one = Mesh((1,), ("data",), rank=0, groups={})
    got, _ = ckpt.restore(d, {"a": torch.ones(2)}, shardings={"a": NamedSharding(one, PartitionSpec("data"))})
    assert torch.equal(got["a"], torch.zeros(2))
    if not torch.cuda.is_available():  # a spec target goes to the card unless told otherwise
        with pytest.raises(RuntimeError, match="CUDA"):
            ckpt.restore(d, {"a": ((2,), torch.float32)})
