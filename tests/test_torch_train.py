"""Port parity: ``repro_torch.optim.adamw``, ``repro_torch.train`` (step,
loop, serve, elastic), ``repro_torch.data`` and the launchers against
``repro.optim``, ``repro.train`` and ``tests/test_train.py``'s contracts.

Everything runs on the CPU at llama3.2-1b's smoke size (2 periods, f32);
one train step also at mixtral-8x7b's (MoE, its aux loss in the gradient)
and mamba2-2.7b's (SSD, the f32 ``A_log``/``dt_bias`` leaves), and the
launchers on mixtral's and deepseek-v2-236b's.
The reference's state and batches cross through
``convert.train_state_from_reference`` / ``batch_from_reference``: the
port's synthetic stream is deterministic per step but not JAX's bits.

Tolerances:
- ``adamw_update`` and ``lr_at``: 1e-6 relative (the reference's learning
  rate is f64 under the tests' x64 mode, the port's a host float);
- one ``make_train_step`` at ``n_micro`` 1 and 4 (mixtral and mamba2: 2)
  from the reference's state and batch: loss 1e-5 relative; parameters 1e-5 absolute (the bound
  of the reference's ``test_microbatch_equivalence``); the moments m and
  v, which carry the step's gradient (a first step's learning rate is 0 in
  the warmup schedule), 1e-4 relative + 1e-5 of each leaf's largest entry;
- ``train_loop``: exact resume to 1e-4 in the final loss (the reference's
  bound; a restored tensor's alignment can steer the CPU's GEMM to other
  roundings), a checkpoint round trip bitwise;
- ``generate``: the reference's greedy tokens exactly.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro import train as jtrain  # noqa: E402
from repro.data import SyntheticConfig as JSyntheticConfig  # noqa: E402
from repro.data import batch_at as jbatch_at  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.data import SyntheticConfig, batch_at, make_batch_specs  # noqa: E402
from repro_torch.models.common import tree_get, tree_leaves, tree_map, tree_paths  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, global_norm, lr_at  # noqa: E402
from repro_torch.train import (  # noqa: E402
    AsyncCheckpointer,
    TrainState,
    generate,
    init_train_state,
    latest_step,
    make_decode_step,
    make_prefill_step,
    make_train_step,
    rebalance_microbatch,
    restore,
    save,
    state_shapes,
    train_loop,
)

ROOT = Path(__file__).resolve().parents[1]
OCFG = dict(lr=5e-3, warmup_steps=5, total_steps=100)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for these small tensors: the suite runs several
    test workers at once, and more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg():
    return smoke_config("llama3.2-1b").replace(n_periods=2)


def _keystr(path):
    return "".join(f"[{k!r}]" if isinstance(k, str) else f"[{k}]" for k in path)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("step", [0, 1, 3, 5, 50, 100, 150])
def test_lr_at_is_the_references(step):
    cfg = AdamWConfig(**OCFG)
    want = float(joptim.lr_at(joptim.AdamWConfig(**OCFG), jnp.asarray(step, jnp.int32)))
    assert lr_at(cfg, step) == pytest.approx(want, rel=1e-6, abs=1e-12)


@pytest.mark.parametrize("step", [0, 7])
def test_adamw_update_matches_the_reference(step):
    rng = np.random.default_rng(step)
    shapes = {"a": (6, 5), "b": [{"c": (7,)}, {"c": (3, 2)}]}
    leaf = lambda s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    grads = jax.tree.map(lambda s: leaf(s) * 3, shapes, is_leaf=lambda x: isinstance(x, tuple))
    params = jax.tree.map(leaf, shapes, is_leaf=lambda x: isinstance(x, tuple))
    m = jax.tree.map(lambda s: leaf(s) * 0.1, shapes, is_leaf=lambda x: isinstance(x, tuple))
    v = jax.tree.map(lambda s: np.abs(leaf(s)) * 0.1, shapes, is_leaf=lambda x: isinstance(x, tuple))
    jcfg, cfg = joptim.AdamWConfig(**OCFG, clip_norm=2.0), AdamWConfig(**OCFG, clip_norm=2.0)
    want, jm = joptim.adamw_update(jcfg, grads, {"master": params, "m": m, "v": v}, jnp.asarray(step, jnp.int32))
    as_t = lambda t: tree_map(lambda a: torch.as_tensor(a.copy()), t)  # noqa: E731
    state = {"master": as_t(params), "m": as_t(m), "v": as_t(v)}
    got, tm = adamw_update(cfg, as_t(grads), state, torch.tensor(step, dtype=torch.int32))
    assert got is state  # written in place
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
    assert tm["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6, abs=1e-12)
    for name in ("master", "m", "v"):
        for path in tree_paths(got[name]):
            np.testing.assert_allclose(tree_get(got[name], path).numpy(), np.asarray(tree_get(want[name], path)),
                                       rtol=1e-6, atol=1e-7, err_msg=f"{name}{_keystr(path)}")


def test_adamw_init_and_global_norm():
    params = {"w": torch.ones(3, 2, dtype=torch.bfloat16), "b": [torch.full((2,), 2.0)]}
    opt = adamw_init(params)
    assert opt["master"]["w"].dtype == torch.float32
    assert opt["master"]["b"][0].data_ptr() != params["b"][0].data_ptr()  # a copy even for f32
    assert opt["m"]["w"].dtype == torch.float32 and not opt["v"]["b"][0].any()
    assert float(global_norm(params)) == pytest.approx(np.sqrt(6 + 8))


@pytest.fixture(scope="module")
def reference_step():
    """The reference's state at init, a batch, and its state after one step
    at n_micro 1 and 4."""
    jcfg = jconfigs.smoke_config("llama3.2-1b").replace(n_periods=2)
    dcfg = JSyntheticConfig(vocab=jcfg.vocab, seq_len=64, global_batch=8, kind="bigram")
    ocfg = joptim.AdamWConfig(**OCFG)
    batch = _np_tree(jbatch_at(dcfg, 0))
    state = _np_tree(jtrain.init_train_state(jcfg, jax.random.key(0)))
    out = {}
    for n_micro in (1, 4):
        st, m = jax.jit(jtrain.make_train_step(jcfg, ocfg, n_micro=n_micro))(jax.tree.map(jnp.asarray, state), batch)
        out[n_micro] = (_np_tree(st), float(m["loss"]))
    return state, batch, out


@pytest.mark.parametrize("n_micro", [1, 4])
def test_train_step_matches_the_reference(reference_step, n_micro):
    cfg = _cfg()
    state0, batch, out = reference_step
    want, want_loss = out[n_micro]
    state = convert.train_state_from_reference(cfg, state0, device="cpu")
    new, metrics = make_train_step(cfg, AdamWConfig(**OCFG), n_micro=n_micro)(
        state, convert.batch_from_reference(batch, device="cpu"))
    assert int(new.step) == 1 and new.params is state.params
    np.testing.assert_allclose(float(metrics["loss"]), want_loss, rtol=1e-5)
    for path in tree_paths(new.params):
        np.testing.assert_allclose(tree_get(new.params, path).numpy(), np.asarray(tree_get(want.params, path)),
                                   rtol=0, atol=1e-5, err_msg=_keystr(path))
        for name in ("m", "v"):
            ref = np.asarray(tree_get(want.opt[name], path))
            np.testing.assert_allclose(tree_get(new.opt[name], path).numpy(), ref, rtol=1e-4,
                                       atol=1e-5 * float(np.abs(ref).max()), err_msg=f"{name}{_keystr(path)}")


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "mamba2-2.7b"])
def test_a_family_train_step_matches_the_reference(arch):
    """The moments m and v after one micro-batched step from the
    reference's state, leaf by leaf (the f32 router, ``A_log`` and
    ``dt_bias`` leaves included), and the loss with its aux term."""
    cfg = smoke_config(arch)
    jcfg = jconfigs.smoke_config(arch)
    dcfg = JSyntheticConfig(vocab=jcfg.vocab, seq_len=32, global_batch=4, kind="bigram")
    batch = _np_tree(jbatch_at(dcfg, 0))
    state0 = _np_tree(jtrain.init_train_state(jcfg, jax.random.key(0)))
    want, jm = jax.jit(jtrain.make_train_step(jcfg, joptim.AdamWConfig(**OCFG), n_micro=2))(
        jax.tree.map(jnp.asarray, state0), batch)
    state = convert.train_state_from_reference(cfg, state0, device="cpu")
    new, metrics = make_train_step(cfg, AdamWConfig(**OCFG), n_micro=2)(
        state, convert.batch_from_reference(batch, device="cpu"))
    np.testing.assert_allclose(float(metrics["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    for path in tree_paths(new.params):
        for name in ("m", "v"):
            ref = np.asarray(tree_get(want.opt[name], path))
            np.testing.assert_allclose(tree_get(new.opt[name], path).numpy(), ref, rtol=1e-4,
                                       atol=1e-5 * float(np.abs(ref).max()), err_msg=f"{name}{_keystr(path)}")


def test_microbatch_equivalence():
    """n_micro 1 and 4 take (nearly) the same step (tests/test_train.py)."""
    cfg = _cfg()
    dcfg = SyntheticConfig(vocab=cfg.vocab, seq_len=64, global_batch=8)
    batch = batch_at(dcfg, 0, device="cpu")
    s1, m1 = make_train_step(cfg, AdamWConfig(**OCFG), n_micro=1)(init_train_state(cfg, 0, device="cpu"), batch)
    s4, m4 = make_train_step(cfg, AdamWConfig(**OCFG), n_micro=4)(init_train_state(cfg, 0, device="cpu"), batch)
    assert abs(float(m1["loss"]) - float(m4["loss"])) < 1e-4
    assert max(float((a - b).abs().max()) for a, b in zip(tree_leaves(s1.opt['master']), tree_leaves(s4.opt['master']))) < 1e-5
    assert max(float((a - b).abs().max()) for a, b in zip(tree_leaves(s1.opt["m"]), tree_leaves(s4.opt["m"]))) < 1e-6


def test_state_holds_module_parameters_and_shapes():
    cfg = _cfg()
    state = init_train_state(cfg, 0, device="cpu")
    assert all(isinstance(p, torch.nn.Parameter) for p in tree_leaves(state.params))
    shapes = state_shapes(cfg)
    for name, tree in (("params", state.params), ("master", state.opt["master"]), ("v", state.opt["v"])):
        spec = shapes.params if name == "params" else shapes.opt[name]
        for path in tree_paths(tree):
            shape, dtype = tree_get(spec, path)
            assert tuple(tree_get(tree, path).shape) == shape and tree_get(tree, path).dtype == dtype


@pytest.fixture(scope="module")
def tiny():
    cfg = _cfg()
    dcfg = SyntheticConfig(vocab=cfg.vocab, seq_len=64, global_batch=8, kind="bigram")
    return cfg, dcfg, AdamWConfig(**OCFG)


def test_loss_decreases(tiny, tmp_path):
    cfg, dcfg, ocfg = tiny
    _, losses = train_loop(cfg, dcfg, ocfg, steps=30, log_every=5, ckpt_dir=str(tmp_path), ckpt_every=10,
                           device="cpu", log=lambda s: None)
    assert losses[-1][1] < losses[0][1]
    assert latest_step(str(tmp_path)) == 30


def test_resume_continues_the_stream_exactly(tiny, tmp_path):
    """Train 20; train 10 + resume (10 -> 20): the same final loss (1e-4, the
    reference's bound) and parameters."""
    cfg, dcfg, ocfg = tiny
    d1, d2 = str(tmp_path / "a"), str(tmp_path / "b")
    quiet = dict(device="cpu", log=lambda s: None)
    s_full, l_full = train_loop(cfg, dcfg, ocfg, steps=20, ckpt_dir=d1, ckpt_every=100, log_every=20, **quiet)
    train_loop(cfg, dcfg, ocfg, steps=10, ckpt_dir=d2, ckpt_every=10, log_every=10, **quiet)
    said = []
    s_res, l_res = train_loop(cfg, dcfg, ocfg, steps=20, ckpt_dir=d2, ckpt_every=10, log_every=20, device="cpu",
                              log=said.append)
    assert said[0].startswith("[resume] restored step 10")
    assert abs(l_full[-1][1] - l_res[-1][1]) < 1e-4
    assert int(s_res.step) == 20 and s_res.step.device.type == "cpu"
    for a, b in zip(tree_leaves(s_full.params), tree_leaves(s_res.params)):
        torch.testing.assert_close(a.detach(), b, rtol=0, atol=1e-4)


def test_checkpoint_roundtrip(tiny, tmp_path):
    cfg, _, _ = tiny
    state = init_train_state(cfg, 1, device="cpu")
    save(str(tmp_path), 7, state)
    assert latest_step(str(tmp_path)) == 7
    restored, step = restore(str(tmp_path), state)
    assert step == 7 and isinstance(restored, TrainState)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(state), tree_leaves(restored)))


def test_reference_checkpoints_resume_in_the_port(tmp_path):
    """A state the reference saved restores into the port's shapes, leaf by
    leaf under the same names."""
    jcfg = jconfigs.smoke_config("llama3.2-1b").replace(n_periods=2)
    jstate = jtrain.init_train_state(jcfg, jax.random.key(3))
    jtrain.save(str(tmp_path), 4, jstate)
    got, step = restore(str(tmp_path), state_shapes(_cfg()), device="cpu")
    want = convert.train_state_from_reference(_cfg(), _np_tree(jstate), device="cpu")
    assert step == 4
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got), tree_leaves(want)))


def test_async_checkpointer(tmp_path):
    w = AsyncCheckpointer(str(tmp_path), keep_n=2)
    for s in (10, 20, 30):
        w.submit(s, {"a": torch.full((4,), float(s))})
    w.finalize()
    assert latest_step(str(tmp_path)) == 30
    assert sorted(os.listdir(tmp_path)) == ["step_20", "step_30"]
    got, _ = restore(str(tmp_path), {"a": torch.zeros(4)})
    assert float(got["a"][0]) == 30


@pytest.mark.parametrize("old_dp,new_dp,old_micro", [(16, 8, 16), (8, 16, 4), (4, 3, 2), (2, 2, 1)])
def test_rebalance_microbatch_is_the_references(old_dp, new_dp, old_micro):
    from repro.train.elastic import rebalance_microbatch as jrebalance

    got = rebalance_microbatch(256 if new_dp != 3 else 240, old_dp=old_dp, new_dp=new_dp, old_micro=old_micro)
    want = jrebalance(256 if new_dp != 3 else 240, old_dp=old_dp, new_dp=new_dp, old_micro=old_micro)
    assert got == want and (256 if new_dp != 3 else 240) % (new_dp * got) == 0


def test_generate_returns_the_references_tokens():
    cfg = _cfg()
    jcfg = jconfigs.smoke_config("llama3.2-1b").replace(n_periods=2)
    jp = jt.init_params(jcfg, jax.random.key(0))
    prompts = np.random.default_rng(4).integers(0, cfg.vocab, (3, 24)).astype(np.int32)
    want = np.asarray(jtrain.generate(jcfg, jp, jnp.asarray(prompts), max_new=12))
    tp = convert.params_from_reference(cfg, _np_tree(jp), device="cpu")
    got = generate(cfg, tp, torch.as_tensor(prompts), max_new=12)
    assert got.dtype == torch.int32 and got.shape == (3, 12)
    np.testing.assert_array_equal(got.numpy(), want)
    # the serving step factories compute the same first token
    logits, cache = make_prefill_step(cfg)(tp, {"tokens": torch.as_tensor(prompts)})
    assert torch.equal(torch.argmax(logits, -1).to(torch.int32), got[:, 0])
    logits, _ = make_decode_step(cfg)(tp, cache, got[:, 0], 24)
    assert torch.equal(torch.argmax(logits, -1).to(torch.int32), got[:, 1])


@pytest.mark.parametrize("kind", ["bigram", "uniform"])
def test_batch_at_is_deterministic_per_step(kind):
    dcfg = SyntheticConfig(vocab=300, seq_len=32, global_batch=4, kind=kind, seed=5)
    a, b, c = (batch_at(dcfg, s, device="cpu") for s in (3, 3, 4))
    for k in ("tokens", "labels"):
        assert torch.equal(a[k], b[k]) and a[k].dtype == torch.int32 and a[k].shape == (4, 32)
    assert not torch.equal(a["tokens"], c["tokens"])
    assert torch.equal(a["labels"][:, :-1], a["tokens"][:, 1:])  # the tokens shifted by one
    assert int(a["tokens"].min()) >= 0 and int(a["tokens"].max()) < 300
    assert {k: v for k, v in make_batch_specs(dcfg).items()} == {"tokens": ((4, 32), torch.int32),
                                                                 "labels": ((4, 32), torch.int32)}


def test_the_bigram_stream_follows_its_chain():
    """Each next token is a draw from the chain's row of the previous one:
    the row's most likely successor comes far more often than 1/V."""
    from repro_torch.data import synthetic

    dcfg = SyntheticConfig(vocab=256, seq_len=256, global_batch=8, seed=1)
    t = batch_at(dcfg, 0, device="cpu")["tokens"].long()
    logits, V = synthetic._bigram_logits(dcfg, "cpu")
    top = torch.argmax(logits, dim=-1)[t[:, :-1]]
    assert float((t[:, 1:] == top).float().mean()) > 10 / V


def _run(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", *args], env=env, capture_output=True, text=True, timeout=180)


def test_launch_train_runs_and_resumes(tmp_path):
    args = ("repro_torch.launch.train", "--arch", "llama3.2-1b", "--smoke", "--device", "cpu", "--steps", "4",
            "--seq", "32", "--batch", "4", "--ckpt", str(tmp_path), "--ckpt-every", "2")
    out = _run(*args)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "done" in out.stdout and latest_step(str(tmp_path)) == 4
    out = _run(*args[:7], "6", *args[8:])
    assert out.returncode == 0, out.stderr[-3000:]
    assert "[resume] restored step 4" in out.stdout and latest_step(str(tmp_path)) == 6


def test_launch_train_refuses_a_sharded_mesh():
    """A mesh other than 1x1 runs one process a rank under ``torchrun``
    (``tests/test_torch_elastic.py`` trains on 2x2): started alone, as a
    world of one, the launcher refuses a 2x2 mesh it cannot hold."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "llama3.2-1b", "--smoke", "--device", "cpu",
         "--mesh", "2x2", "--backend", "gloo"],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"), "RANK": "0", "LOCAL_RANK": "0", "WORLD_SIZE": "1",
             "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)})
    assert out.returncode != 0 and "need 4 ranks for mesh (2, 2), the world has 1" in out.stderr


def test_launch_train_runs_a_family():
    out = _run("repro_torch.launch.train", "--arch", "mixtral-8x7b", "--smoke", "--device", "cpu", "--steps", "3",
               "--seq", "32", "--batch", "4", "--micro", "2")
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.count("loss ") == 1 and "done" in out.stdout


def test_launch_serve_runs_a_family_and_refuses_vision():
    out = _run("repro_torch.launch.serve", "--arch", "deepseek-v2-236b", "--smoke", "--device", "cpu", "--batch",
               "2", "--max-new", "5")
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.count("\n[") + out.stdout.startswith("[") == 2 and "served batch=2" in out.stdout
    out = _run("repro_torch.launch.serve", "--arch", "llama-3.2-vision-11b", "--smoke", "--device", "cpu")
    assert out.returncode != 0 and "stub frontend" in out.stderr


def test_launch_serve_runs_and_refuses_frames():
    out = _run("repro_torch.launch.serve", "--arch", "qwen3-0.6b", "--smoke", "--device", "cpu", "--batch", "2",
               "--max-new", "5")
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.count("\n[") + out.stdout.startswith("[") == 2 and "served batch=2" in out.stdout
    out = _run("repro_torch.launch.serve", "--arch", "musicgen-medium", "--smoke", "--device", "cpu")
    assert out.returncode != 0 and "stub frontend" in out.stderr
