"""Port parity: ``repro_torch.optim.compression`` (the CountSketch-compressed
gradient all-reduce) against ``repro.optim.compression``.

The port runs on a gloo world of 4 CPU processes (``file://`` store in the
test's temporary directory); the reference in one subprocess under
``shard_map`` over 4 forced host devices, on an ``AxisType.Auto`` mesh.

- Parity: each rank's gradients (a dict of a list of dicts, tensors above
  and below ``min_size``, non-zero error feedback) go through both on the
  reference's draws (the port's ``_buckets_signs`` replaced by the
  reference's ``_buckets_signs(fold_in(fold_in(key(seed), i), step))``).
  Outputs and new error-feedback buffers agree within 2e-6 absolute plus
  1e-5 relative (f32: the bucket sums and the all-reduce add in other
  orders), and the small tensors' averages likewise.
- The reference test's gates (``test_multidevice.py::
  test_dp_train_with_sketched_compression``: ratio 4, min_size 1, g ~
  N(0, 1) + 0.5 of 65536 entries on every rank, no feedback yet) on the
  port's own draws: corr(g, recon) in (0.3, 0.7), mean gain within 0.05 of
  1/ratio, |g − recon − new_ef| < 1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro.optim import compression as jcomp  # noqa: E402
from repro_torch.optim import CompressionConfig, compress_state_init, sketched_psum_grads  # noqa: E402
from repro_torch.models.common import tree_paths  # noqa: E402
from repro_torch.optim import compression as tcomp  # noqa: E402

from test_torch_distributed import run_reference, run_world  # noqa: E402

CFG = dict(ratio=8, min_size=4096, error_feedback=True, seed=23)
STEP = 3
SHAPES = {"w": (64, 128), "layers": [{"a": (40, 200), "bias": (16,)}, {"a": (50, 90), "bias": (16,)}],
          "norm": (8,)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small tensors, the module's fixtures
    included: the suite runs several test workers at once, and more threads
    only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(shapes, leaf):
    if isinstance(shapes, dict):
        return {k: _tree(v, leaf) for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [_tree(v, leaf) for v in shapes]
    return leaf(shapes)


REFERENCE = """
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType, PartitionSpec as P
from repro.optim import CompressionConfig
from repro.optim.compression import _buckets_signs, sketched_psum_grads
from repro.sharding import shard_map_compat

cfg = CompressionConfig(**%(cfg)r)
shapes = %(shapes)r
rng = np.random.default_rng(0)
def tree(s, leaf):
    if isinstance(s, dict):
        return {k: tree(v, leaf) for k, v in s.items()}
    if isinstance(s, list):
        return [tree(v, leaf) for v in s]
    return leaf(tuple(s))
grads = tree(shapes, lambda s: rng.standard_normal((4,) + s).astype(np.float32) + 0.5)
efs = tree(shapes, lambda s: (0.1 * rng.standard_normal((4,) + s)).astype(np.float32)
           if int(np.prod(s)) >= cfg.min_size else None)
mesh = jax.make_mesh((4,), ("data",), axis_types=(AxisType.Auto,))
def f(g, e):
    g = jax.tree.map(lambda t: t[0], g)
    e = jax.tree.map(lambda t: t[0], e)
    out, ne = sketched_psum_grads(cfg, g, e, ("data",), step=%(step)d)
    return jax.tree.map(lambda t: t[None], out), jax.tree.map(lambda t: t[None], ne)
spec = jax.tree.map(lambda _: P("data"), grads)
espec = jax.tree.map(lambda _: P("data"), efs)
out, ne = shard_map_compat(f, mesh=mesh, in_specs=(spec, espec), out_specs=(spec, espec))(grads, efs)
save = {}
leaves, _ = jax.tree_util.tree_flatten_with_path(grads)
for i, (path, g) in enumerate(leaves):
    name = jax.tree_util.keystr(path)
    save["order/%%d" %% i] = name
    numel = int(np.prod(g.shape[1:]))
    if numel >= cfg.min_size:
        key = jax.random.fold_in(jax.random.fold_in(jax.random.key(cfg.seed), i), %(step)d)
        h, s = _buckets_signs(key, numel, max(numel // cfg.ratio, 1))
        save["buckets/%%d" %% i], save["signs/%%d" %% i] = np.asarray(h), np.asarray(s)
for tag, t in (("grads", grads), ("efs", efs), ("out", out), ("new_ef", ne)):
    for path, v in jax.tree_util.tree_flatten_with_path(t)[0]:
        save[tag + ":" + jax.tree_util.keystr(path)] = np.asarray(v)
np.savez(%(path)r, **save)
"""

RANK_BODY = """
from repro_torch.optim import CompressionConfig, compression, sketched_psum_grads

ref = dict(np.load(f"{tmp}/../ref.npz"))
cfg = CompressionConfig(**%(cfg)r)

def draws(seed, i, step, numel, s, device):
    assert (seed, step) == (cfg.seed, %(step)d) and numel == ref[f"buckets/{i}"].size
    return torch.as_tensor(ref[f"buckets/{i}"]), torch.as_tensor(ref[f"signs/{i}"])

def tree(prefix, shapes, path=""):
    if isinstance(shapes, dict):
        return {k: tree(prefix, v, path + f"['{k}']") for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [tree(prefix, v, path + f"[{j}]") for j, v in enumerate(shapes)]
    key = prefix + ":" + path
    return torch.as_tensor(ref[key][rank]) if key in ref else None

shapes = %(shapes)r
grads, efs = tree("grads", shapes), tree("efs", shapes)
own = compression._buckets_signs
compression._buckets_signs = draws
out, ne = sketched_psum_grads(cfg, grads, efs, step=%(step)d)
compression._buckets_signs = own
results["parity"] = (out, ne)

# the reference test's gates on the port's own draws
g = torch.randn(65536, generator=torch.Generator().manual_seed(0)) + 0.5
cfg4 = CompressionConfig(ratio=4, min_size=1)
r, e = sketched_psum_grads(cfg4, {"w": g}, {"w": torch.zeros(65536)}, step=0)
results["gates"] = (g, r["w"], e["w"])
results["no_ef"] = sketched_psum_grads(cfg, grads, None, step=%(step)d)
"""


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("compression")
    fmt = dict(cfg=CFG, shapes=SHAPES, step=STEP, path=str(tmp / "ref.npz"))
    run_reference(REFERENCE % fmt)
    ranks = run_world(tmp / "world4", 4, RANK_BODY % fmt)
    return dict(np.load(tmp / "ref.npz")), ranks


def _flat(tree, prefix="", path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix, path + f"['{k}']")
    elif isinstance(tree, list):
        for j, v in enumerate(tree):
            yield from _flat(v, prefix, path + f"[{j}]")
    else:
        yield prefix + ":" + path, tree


@pytest.mark.parametrize("rank", range(4))
def test_parity_with_the_reference_on_its_draws(world, rank):
    ref, ranks = world
    out, ne = ranks[rank]["parity"]
    for tag, tree in (("out", out), ("new_ef", ne)):
        for key, t in _flat(tree, tag):
            if key not in ref:
                assert t is None, key  # a None error-feedback leaf stays None
                continue
            want = torch.as_tensor(ref[key][rank])
            assert t.dtype == torch.float32 and t.shape == want.shape, key
            torch.testing.assert_close(t, want, rtol=1e-5, atol=2e-6, msg=key)


def test_every_rank_gets_the_same_average(world):
    _, ranks = world
    outs = [dict(_flat(r["parity"][0], "out")) for r in ranks]
    for key, t in outs[0].items():
        for r in outs[1:]:
            assert torch.equal(r[key], t), key


def test_the_draws_follow_the_references_flatten_order(world):
    ref, _ = world
    order = [str(ref[f"order/{i}"]) for i in range(len([k for k in ref if k.startswith("order/")]))]
    grads = _tree(SHAPES, lambda s: torch.zeros(s))
    assert ["".join(f"[{k!r}]" if isinstance(k, str) else f"[{k}]" for k in p)
            for p in tree_paths(grads)] == order


def test_the_reference_tests_gates_on_the_ports_own_draws(world):
    _, ranks = world
    for rank in ranks:
        g, r, e = rank["gates"]
        corr = float(np.corrcoef(g.numpy(), r.numpy())[0, 1])
        assert 0.3 < corr < 0.7, corr  # the 1/√ratio regime
        assert abs(float(r.mean() / g.mean()) - 1 / 4) < 0.05  # the contractive gain
        assert float((g - r - e).abs().max()) < 1e-5  # exact error-feedback bookkeeping
    assert torch.equal(ranks[0]["gates"][1], ranks[3]["gates"][1])


def test_without_error_feedback_the_state_stays_none(world):
    _, ranks = world
    for rank in ranks:
        out, ne = rank["no_ef"]
        assert ne is None
        assert [k for k, _ in _flat(out)] == [k for k, _ in _flat(rank["parity"][0])]


def test_state_init_keeps_the_structure():
    cfg = CompressionConfig(**CFG)
    params = _tree(SHAPES, lambda s: torch.ones(s, dtype=torch.bfloat16))
    ef = compress_state_init(cfg, params)
    for (key, p), (_, e) in zip(_flat(params), _flat(ef)):
        if p.numel() < cfg.min_size:
            assert e is None, key
        else:
            assert e.dtype == torch.float32 and e.shape == p.shape and not e.any(), key
    assert isinstance(ef["layers"], list) and set(ef) == set(params)


def test_state_init_matches_the_references():
    cfg = CompressionConfig(**CFG)
    params = _tree(SHAPES, lambda s: torch.ones(s))
    jparams = _tree(SHAPES, lambda s: np.ones(s, np.float32))
    mine = [None if e is None else tuple(e.shape) for _, e in _flat(compress_state_init(cfg, params))]
    theirs = jax.tree_util.tree_flatten(jcomp.compress_state_init(jcomp.CompressionConfig(**CFG), jparams),
                                        is_leaf=lambda x: x is None)[0]
    # JAX flattens dicts in sorted order; _flat in insertion order: compare as sets of shapes
    assert sorted(map(str, mine)) == sorted(str(None if t is None else tuple(t.shape)) for t in theirs)


def test_draws_are_fresh_per_tensor_and_step_and_shared_by_seed():
    h0, s0 = tcomp._buckets_signs(17, 0, 0, 1000, 125, "cpu")
    h1, s1 = tcomp._buckets_signs(17, 0, 0, 1000, 125, "cpu")
    assert torch.equal(h0, h1) and torch.equal(s0, s1)
    assert h0.dtype == torch.int32 and s0.dtype == torch.float32
    assert int(h0.min()) >= 0 and int(h0.max()) < 125 and set(s0.tolist()) == {-1.0, 1.0}
    for other in ((17, 1, 0), (17, 0, 1), (18, 0, 0)):
        assert not torch.equal(tcomp._buckets_signs(*other, 1000, 125, "cpu")[0], h0), other


def test_a_missing_process_group_raises():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialized torch.distributed process group"):
        sketched_psum_grads(CompressionConfig(), {"w": torch.ones(4)}, None)
