"""Port parity: ``repro_torch.train.make_dp_train_step`` (the data-parallel
train step over a ``torch.distributed`` group, with and without the
CountSketch-compressed all-reduce) against the single-process step and
against ``repro.train.make_dp_train_step``.

The port's ranks are CPU gloo worlds of 2 and 4 processes (the harness of
``tests/test_torch_distributed.py:run_world``); the reference runs in one
subprocess on a 4-device ``AxisType.Auto`` mesh.  llama3.2-1b's smoke
config with 2 periods, f32, a bigram batch of 8 × 64 tokens, each rank
its own rows (rank r: rows [r·8/P, (r + 1)·8/P)).

- Uncompressed, P ∈ {2, 4}: one step against ``make_train_step`` on the
  whole batch in one process: the loss to 1e-5 relative, the parameters
  to 1e-5 absolute, the moments m and v (the step's gradient: a first
  step's learning rate is 0 in the warmup schedule) to 1e-4 relative + 1e-5
  of each leaf's largest entry; then three steps with the parameters and
  the f32 master bitwise equal on every rank after each.
- Compressed (ratio 4, min_size 4096, error feedback), P = 4: one step from
  the reference's state and batch on the reference's draws (the port's
  ``compression._buckets_signs`` replaced by the reference's
  ``_buckets_signs(fold_in(fold_in(key(seed), i), step))``, the hook of
  ``tests/test_torch_compression.py``): loss, parameters, m and v as above,
  and rank 0's new error-feedback buffers to 2e-6 + 1e-5 relative
  (the reference keeps its first device's buffers: ``out_specs=P()``).
  Parameters bitwise on every rank over the steps below too.
- The port's own draws, P = 4, held to ``tests/test_multidevice.py:43–96``:
  40 steps, the loss finite, the error-feedback norm (Σ e²) < 1e3 on every
  rank, and the loss falling by 0.05.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.data import SyntheticConfig, batch_at  # noqa: E402
from repro_torch.models.common import tree_get, tree_leaves, tree_paths  # noqa: E402
from repro_torch.optim import AdamWConfig, CompressionConfig  # noqa: E402
from repro_torch.train import init_train_state, make_dp_train_step, make_train_step  # noqa: E402

from test_torch_distributed import run_reference, run_world  # noqa: E402

OCFG = dict(lr=5e-3, warmup_steps=2, total_steps=50)
COMP = dict(ratio=4, min_size=4096)
OWN_STEPS = 40

REFERENCE = """
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs import smoke_config
from repro.data import SyntheticConfig, batch_at
from repro.optim import AdamWConfig, CompressionConfig, compress_state_init
from repro.optim.compression import _buckets_signs
from repro.train import init_train_state, make_dp_train_step

cfg = smoke_config("llama3.2-1b").replace(n_periods=2)
dcfg = SyntheticConfig(vocab=cfg.vocab, seq_len=64, global_batch=8, kind="bigram")
comp = CompressionConfig(**%(comp)r)
mesh = jax.make_mesh((4,), ("data",), axis_types=(AxisType.Auto,))
state = init_train_state(cfg, jax.random.key(0))
efs = compress_state_init(comp, state.params)
batch = batch_at(dcfg, 0)
save = {"tokens": np.asarray(batch["tokens"]), "labels": np.asarray(batch["labels"])}
def put(tag, tree):
    for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
        save[tag + ":" + jax.tree_util.keystr(path)] = np.asarray(v)
put("params0", state.params)
for i, (path, p) in enumerate(jax.tree_util.tree_flatten_with_path(state.params)[0]):
    if p.size >= comp.min_size:
        key = jax.random.fold_in(jax.random.fold_in(jax.random.key(comp.seed), i), 0)
        h, s = _buckets_signs(key, p.size, max(p.size // comp.ratio, 1))
        save["buckets/%%d" %% i], save["signs/%%d" %% i] = np.asarray(h), np.asarray(s)
step = jax.jit(make_dp_train_step(cfg, AdamWConfig(**%(ocfg)r), mesh, compression=comp))
(state, efs), m = step(state, efs, batch)
save["loss"] = np.asarray(m["loss"])
put("params", state.params); put("m", state.opt["m"]); put("v", state.opt["v"]); put("ef", efs)
np.savez(%(path)r, **save)
"""

RANK_BODY = """
from repro_torch.configs import smoke_config
from repro_torch.data import SyntheticConfig, batch_at
from repro_torch.models.common import is_shape, tree_get, tree_leaves, tree_paths, tree_rebuild
from repro_torch.models.transformer import params_shapes
from repro_torch.optim import AdamWConfig, CompressionConfig, adamw_init, compress_state_init, compression
from repro_torch.train import TrainState, init_train_state, make_dp_train_step

cfg = smoke_config("llama3.2-1b").replace(n_periods=2)
dcfg = SyntheticConfig(vocab=cfg.vocab, seq_len=64, global_batch=8)
ocfg, comp = AdamWConfig(**%(ocfg)r), CompressionConfig(**%(comp)r)
rows = 8 // world

def mine(batch):
    return {k: v[rank * rows:(rank + 1) * rows] for k, v in batch.items()}

def keystr(path):
    return "".join(f"[{k!r}]" if isinstance(k, str) else f"[{k}]" for k in path)

def snap(tree):
    return [t.detach().clone() for t in tree_leaves(tree)]

# uncompressed: one step kept whole, then two more
step = make_dp_train_step(cfg, ocfg)
state = init_train_state(cfg, 0, device="cpu")
(state, _), m = step(state, None, mine(batch_at(dcfg, 0, device="cpu")))
results["plain_first"] = (float(m["loss"]), snap(state.params), snap(state.opt["m"]), snap(state.opt["v"]))
trail = [snap(state.params) + snap(state.opt["master"])]
for i in (1, 2):
    (state, _), m = step(state, None, mine(batch_at(dcfg, i, device="cpu")))
    trail.append(snap(state.params) + snap(state.opt["master"]))
results["plain_trail"] = trail

if world == 4:
    ref = dict(np.load(f"{tmp}/../ref.npz"))
    shapes = params_shapes(cfg)
    params = tree_rebuild(shapes, {p: torch.as_tensor(ref["params0:" + keystr(p)]) for p in
                                   tree_paths(shapes, is_leaf=is_shape)}, is_shape)
    state = TrainState(step=torch.zeros((), dtype=torch.int32), params=params, opt=adamw_init(params))

    def draws(seed, i, step, numel, s, device):
        assert (seed, step) == (comp.seed, 0) and numel == ref[f"buckets/{i}"].size
        return torch.as_tensor(ref[f"buckets/{i}"]), torch.as_tensor(ref[f"signs/{i}"])

    own = compression._buckets_signs
    compression._buckets_signs = draws
    batch = {k: torch.as_tensor(ref[k]) for k in ("tokens", "labels")}
    (state, ef), m = make_dp_train_step(cfg, ocfg, compression=comp)(state, compress_state_init(comp, params),
                                                                     mine(batch))
    compression._buckets_signs = own
    results["ref_draws"] = (float(m["loss"]), {keystr(p): tree_get(state.params, p) for p in tree_paths(params)},
                            {keystr(p): tree_get(state.opt["m"], p) for p in tree_paths(params)},
                            {keystr(p): tree_get(state.opt["v"], p) for p in tree_paths(params)},
                            {keystr(p): tree_get(ef, p) for p in tree_paths(ef)})

    # the port's own draws over 40 steps (tests/test_multidevice.py's contract)
    state = init_train_state(cfg, 0, device="cpu")
    ef = compress_state_init(comp, state.params)
    step = make_dp_train_step(cfg, ocfg, compression=comp)
    losses, digests = [], []
    for i in range(%(own_steps)d):
        (state, ef), m = step(state, ef, mine(batch_at(dcfg, i, device="cpu")))
        losses.append(float(m["loss"]))
        digests.append(sum(float(t.double().sum()) for t in tree_leaves(state.params)))
    results["own"] = (losses, sum(float((e * e).sum()) for e in tree_leaves(ef)), digests, snap(state.params))
"""


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_train")
    fmt = dict(ocfg=OCFG, comp=COMP, own_steps=OWN_STEPS, path=str(tmp / "ref.npz"))
    run_reference(REFERENCE % fmt)
    out = {P: run_world(tmp / f"world{P}", P, RANK_BODY % fmt, timeout=240.0) for P in (2, 4)}
    return dict(np.load(tmp / "ref.npz")), out


@pytest.fixture(scope="module")
def single():
    """``make_train_step`` on the whole batch in this process."""
    cfg = smoke_config("llama3.2-1b").replace(n_periods=2)
    dcfg = SyntheticConfig(vocab=cfg.vocab, seq_len=64, global_batch=8)
    state, m = make_train_step(cfg, AdamWConfig(**OCFG))(init_train_state(cfg, 0, device="cpu"),
                                                         batch_at(dcfg, 0, device="cpu"))
    return float(m["loss"]), tree_leaves(state.params), tree_leaves(state.opt["m"]), tree_leaves(state.opt["v"])


def _moments_close(got, want, what):
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5 * float(w.abs().max()), msg=what)


@pytest.mark.parametrize("P", [2, 4])
def test_uncompressed_step_matches_the_single_process_step(worlds, single, P):
    _, out = worlds
    loss, params, m, v = single
    for r, rank in enumerate(out[P]):
        got_loss, got_params, got_m, got_v = rank["plain_first"]
        assert got_loss == pytest.approx(loss, rel=1e-5), r
        for g, w in zip(got_params, params):
            torch.testing.assert_close(g, w.detach(), rtol=0, atol=1e-5)
        _moments_close(got_m, m, f"m, rank {r}")
        _moments_close(got_v, v, f"v, rank {r}")


@pytest.mark.parametrize("P", [2, 4])
def test_parameters_are_bitwise_equal_on_every_rank(worlds, P):
    _, out = worlds
    trails = [rank["plain_trail"] for rank in out[P]]
    assert len(trails[0]) == 3
    for step in range(3):
        for rank in trails[1:]:
            assert all(torch.equal(a, b) for a, b in zip(rank[step], trails[0][step])), step
    own = [rank["own"] for rank in out[4]]
    assert all(o[2] == own[0][2] for o in own)  # compressed: the same digests after every step
    assert all(torch.equal(a, b) for o in own[1:] for a, b in zip(o[3], own[0][3]))


def test_compressed_step_matches_the_reference_on_its_draws(worlds):
    ref, out = worlds
    for r, rank in enumerate(out[4]):
        loss, params, m, v, ef = rank["ref_draws"]
        assert loss == pytest.approx(float(ref["loss"]), rel=1e-5)
        for name, got in params.items():
            np.testing.assert_allclose(got.numpy(), ref["params:" + name], rtol=0, atol=1e-5, err_msg=name)
        for tag, tree in (("m", m), ("v", v)):
            for name, got in tree.items():
                want = ref[f"{tag}:{name}"]
                np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5 * float(np.abs(want).max()),
                                           err_msg=f"{tag}{name} rank {r}")
        names = {k.split(":", 1)[1] for k in ref if k.startswith("ef:")}
        assert {k for k, t in ef.items() if t is not None} == names
        if r == 0:  # the reference's out_specs=P() keeps its first device's buffers
            for name in names:
                np.testing.assert_allclose(ef[name].numpy(), ref["ef:" + name], rtol=1e-5, atol=2e-6, err_msg=name)


def test_own_draws_keep_feedback_bounded_and_the_loss_falling(worlds):
    _, out = worlds
    for rank in out[4]:
        losses, ef_norm, _, _ = rank["own"]
        assert len(losses) == OWN_STEPS and all(np.isfinite(losses))
        assert ef_norm < 1e3, ef_norm  # bounded error feedback (a contraction)
        assert losses[-1] < losses[0] - 0.05, (losses[0], losses[-1])
    assert len({tuple(rank["own"][0]) for rank in out[4]}) == 1  # every rank sees the group's loss


def test_a_missing_process_group_raises():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialized torch.distributed process group"):
        make_dp_train_step(smoke_config("llama3.2-1b"), AdamWConfig())


def test_compression_sees_the_references_large_tensors():
    """llama3.2-1b's tree at full width: the 8 tensors at or above the
    default min_size (65536), in flatten order; the stacked norms are not."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import params_shapes
    from repro_torch.models.common import is_shape

    shapes = params_shapes(get_config("llama3.2-1b"))
    big = [p for p in tree_paths(shapes, is_leaf=is_shape)
           if np.prod(tree_get(shapes, p)[0]) >= CompressionConfig().min_size]
    assert [p[-1] for p in big] == ["embed", "w_gate", "w_in", "w_out", "wk", "wo", "wq", "wv"]
    assert tree_get(shapes, ("pattern", 0, "mixer", "ln"))[0] == (16, 2048)
