"""Port parity: ``repro_torch.models.moe`` against ``repro.models.moe``.

The same inputs, drawn with numpy from a seed, go through both packages in
f32 on the CPU, at the smoke sizes of mixtral-8x7b (4 experts, top-2,
renormalized gates) and deepseek-v2-236b (4 experts, top-2, one shared
expert, raw gates); the reference's parameters of one MoE FFN (the first
pattern layer, period 0) cross as numpy arrays.

Tolerances:
- ``_route``'s expert ids and ``_rank_in_expert``'s ranks: exact (they
  decide which assignments a full expert drops); the gate values 1e-6;
- ``moe_apply``'s output and its aux loss at capacity factors 1.25 (where
  assignments are dropped, which the test checks) and 8.0 (none): 1e-5
  absolute and relative; the gradients of a seeded projection of the
  output plus the aux loss, for x and every parameter: 1e-4 relative +
  1e-5 of the leaf's largest entry.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for these small tensors: the suite runs several
    test workers at once, and more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _moe(arch, cf):
    """(port cfg, reference cfg, the FFN's parameters as numpy arrays)."""
    cfg = smoke_config(arch)
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
    jcfg = jconfigs.smoke_config(arch).replace(moe=cfg.moe)
    params = jt.init_params(jcfg, jax.random.key(0))
    return cfg, jcfg, {k: np.array(v[0]) for k, v in params["pattern"][0]["ffn"].items()}


def test_route_breaks_ties_by_the_lower_expert():
    """Experts 1–3 share a router column, so their probabilities tie exactly:
    ``lax.top_k`` takes the lower ids (1, 2), or 0 and 1 where expert 0
    leads.  ``torch.topk`` gives (2, 3) on such rows on the CPU."""
    m = smoke_config("mixtral-8x7b").moe
    rng = np.random.default_rng(0)
    h = rng.standard_normal((16, 128)).astype(np.float32)
    router = np.zeros((128, 4), np.float32)
    router[:, 1:] = rng.standard_normal((128, 1)).astype(np.float32) * 0.1
    probs, vals, idx = tmoe._route(torch.as_tensor(router), torch.as_tensor(h), m)
    assert bool((probs[:, 1] == probs[:, 2]).all() and (probs[:, 2] == probs[:, 3]).all())  # the ties are exact
    _, jvals, jidx = jmoe._route(jnp.asarray(router), jnp.asarray(h), m)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert {tuple(r) for r in idx.tolist()} == {(0, 1), (1, 2)}  # both kinds of rows occur
    np.testing.assert_allclose(vals.numpy(), np.asarray(jvals), rtol=1e-6)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "deepseek-v2-236b"])
def test_route_matches_the_reference(arch):
    cfg, _, p = _moe(arch, 1.25)
    h = np.random.default_rng(1).standard_normal((64, cfg.d_model)).astype(np.float32)
    got = tmoe._route(torch.as_tensor(p["router"]), torch.as_tensor(h), cfg.moe)
    want = jmoe._route(jnp.asarray(p["router"]), jnp.asarray(h), cfg.moe)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


@pytest.mark.parametrize("E,A,seed", [(4, 64, 0), (8, 257, 1), (160, 600, 2), (3, 1, 3)])
def test_rank_in_expert_is_the_references(E, A, seed):
    rng = np.random.default_rng(seed)
    flat_e = rng.integers(0, E, A).astype(np.int32)
    got = tmoe._rank_in_expert(torch.as_tensor(flat_e).long(), E)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jmoe._rank_in_expert(jnp.asarray(flat_e), E)))


@pytest.mark.parametrize("T", [1, 8, 64, 1000])
def test_capacity_is_the_references(T):
    for arch in ("mixtral-8x7b", "deepseek-v2-236b"):
        for cf in (1.25, 8.0):
            cfg, jcfg, _ = _moe(arch, cf)
            assert tmoe._capacity(T, cfg.moe) == jmoe._capacity(T, jcfg.moe)


def test_aux_loss_is_the_references():
    m = smoke_config("deepseek-v2-236b").moe
    rng = np.random.default_rng(4)
    probs = rng.dirichlet(np.ones(m.n_experts), 50).astype(np.float32)
    flat_e = rng.integers(0, m.n_experts, 100).astype(np.int32)
    got = tmoe._aux_loss(torch.as_tensor(probs), torch.as_tensor(flat_e).long(), m)
    want = jmoe._aux_loss(jnp.asarray(probs), jnp.asarray(flat_e), m)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def _x(cfg, seed=5):
    """(2, 128, D) inputs with a shared offset, so the router leans on some
    experts and a capacity factor of 1.25 drops assignments."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, 128, cfg.d_model)) + 2 * rng.standard_normal(cfg.d_model)).astype(np.float32)


def _dropped(cfg, p, x):
    from repro_torch.models.common import rms_norm

    h = rms_norm(torch.as_tensor(x), torch.as_tensor(p["ln"]), cfg.norm_eps).reshape(-1, cfg.d_model)
    _, _, idx = tmoe._route(torch.as_tensor(p["router"]), h, cfg.moe)
    rank = tmoe._rank_in_expert(idx.reshape(-1), cfg.moe.n_experts)
    return int((rank >= tmoe._capacity(h.shape[0], cfg.moe)).sum())


@pytest.mark.parametrize("cf", [1.25, 8.0])
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "deepseek-v2-236b"])
def test_moe_apply_and_its_gradients_match_the_reference(arch, cf):
    """With and without shared experts, with and without drops."""
    cfg, jcfg, p = _moe(arch, cf)
    assert ("shared_in" in p) == (arch == "deepseek-v2-236b")
    x = _x(cfg)
    assert (_dropped(cfg, p, x) > 0) == (cf == 1.25)
    proj = np.random.default_rng(6).standard_normal(x.shape).astype(np.float32)

    def jloss(pp, xx):
        out, aux = jmoe.moe_apply(pp, xx, jcfg, return_aux=True)
        return jnp.sum(out * proj) + aux, (out, aux)

    (_, (jout, jaux)), (jgp, jgx) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    tp = {k: torch.as_tensor(v).requires_grad_() for k, v in p.items()}
    tx = torch.as_tensor(x).requires_grad_()
    out, aux = tmoe.moe_apply(tp, tx, cfg, return_aux=True)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), rtol=1e-5)
    grads = torch.autograd.grad((out * torch.as_tensor(proj)).sum() + aux, [tx, *tp.values()])
    for name, g, want in [("x", grads[0], jgx)] + [(k, g, jgp[k]) for k, g in zip(tp, grads[1:])]:
        want = np.asarray(want)
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-4, atol=1e-5 * float(np.abs(want).max()), err_msg=name)


def test_moe_apply_on_decode_shaped_input():
    """(T, D) input, as a decode step passes it; two calls bitwise equal."""
    cfg, jcfg, p = _moe("deepseek-v2-236b", 8.0)
    x = _x(cfg)[0, :2]
    tp = {k: torch.as_tensor(v) for k, v in p.items()}
    got = tmoe.moe_apply(tp, torch.as_tensor(x), cfg)
    assert got.shape == x.shape and torch.equal(got, tmoe.moe_apply(tp, torch.as_tensor(x), cfg))
    want = jmoe.moe_apply({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), jcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_the_expert_parallel_path_raises_by_name():
    """``"shard_map"`` with no mesh raises the reference's error; ``"auto"``
    and ``"gspmd"`` take the global dispatch.  On a mesh of one rank the
    expert-parallel path is the global dispatch, bit for bit (the path
    over real worlds: ``tests/test_torch_moe_mesh.py``)."""
    from repro_torch.sharding import Mesh, use_mesh

    cfg, _, p = _moe("mixtral-8x7b", 1.25)
    tp = {k: torch.as_tensor(v) for k, v in p.items()}
    x = torch.as_tensor(_x(cfg)[:, :8])
    with pytest.raises(RuntimeError, match="moe_impl='shard_map' requires a mesh with a 'model' axis"):
        tmoe.moe_apply(tp, x, cfg.replace(moe_impl="shard_map"))
    want = tmoe.moe_apply(tp, x, cfg.replace(moe_impl="gspmd"), return_aux=True)
    for impl in ("auto", "gspmd"):  # no mesh: the global dispatch
        got = tmoe.moe_apply(tp, x, cfg.replace(moe_impl=impl), return_aux=True)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    with use_mesh(Mesh((1, 1), ("data", "model"), rank=0, groups={})):
        got = tmoe.moe_apply(tp, x, cfg.replace(moe_impl="shard_map"), return_aux=True)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        with pytest.raises(NotImplementedError, match="global dispatch over the ranks"):
            tmoe.moe_apply(tp, x, cfg.replace(moe_impl="gspmd"))


def test_moe_specs_are_the_references():
    for arch in ("mixtral-8x7b", "deepseek-v2-236b"):
        got = tmoe.moe_specs(smoke_config(arch))
        want = jmoe.moe_specs(jconfigs.smoke_config(arch))
        assert list(got) == list(want)
        for k in got:
            assert (got[k].shape, got[k].axes, got[k].init) == (want[k].shape, want[k].axes, want[k].init), k
        assert got["router"].dtype == torch.float32 and got["w_in"].dtype is None


@pytest.mark.parametrize("E, A, seed", [(4, 64, 0), (8, 1, 1), (160, 4096, 2), (8, 4096, 3)])
def test_the_fixed_shape_count_is_bincount_and_runs_on_fake_tensors(E, A, seed):
    """``_expert_counts`` (a scatter-add of ones into E slots) gives
    ``torch.bincount(flat_e, minlength=E)``'s integers on random routings
    (experts left empty included), and ``_moe_gspmd`` runs under
    ``FakeTensorMode``, where an output shape read from the data cannot."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    flat_e = torch.as_tensor(np.random.default_rng(seed).integers(0, E, A))
    got = tmoe._expert_counts(flat_e, E)
    assert got.dtype == torch.int64 and torch.equal(got, torch.bincount(flat_e, minlength=E))
    cfg, _, p = _moe("deepseek-v2-236b", 1.25)
    x = np.random.default_rng(seed).standard_normal((2, 8, cfg.d_model)).astype(np.float32)
    with FakeTensorMode() as mode:
        fake_p = {k: mode.from_tensor(torch.as_tensor(v)) for k, v in p.items()}
        y, aux = tmoe._moe_gspmd(fake_p, mode.from_tensor(torch.as_tensor(x)), cfg, True)
    assert tuple(y.shape) == x.shape and tuple(aux.shape) == ()
