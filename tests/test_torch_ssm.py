"""Port parity: ``repro_torch.models.ssm`` (Mamba2's SSD mixer) against
``repro.models.ssm``.

The same inputs, drawn with numpy from a seed, go through both packages in
f32 on the CPU; the block tests use mamba2-2.7b's smoke config (16 SSD
heads of 8, d_state 16, conv width 4, chunk 32) and the reference's
parameters of its first layer.

Tolerances (the port passes the chunk states in chunk order where the
reference runs ``lax.associative_scan``, and sums products in other
orders):
- ``ssd_chunked`` at chunk sizes 4, 16 and 64 and with ``h0`` threaded:
  y and the final state 1e-5 relative + 1e-5 absolute (the reference's own
  test holds its chunked form to its naive recurrence at 1e-4 / 1e-5);
- ``ssd_apply`` (with ``return_state`` and ``h0``) and its gradients:
  1e-5, and 1e-4 relative + 1e-5 of each leaf's largest entry;
- ``ssd_decode``: 1e-5 against the reference's step, the cache included,
  and against the last row of ``ssd_apply`` over the longer sequence.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
ARCH = "mamba2-2.7b"


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for these small tensors: the suite runs several
    test workers at once, and more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **(tol or TOL))


def _inputs(b, s, h, p, n, seed=0):
    rng = np.random.default_rng(seed)
    return dict(
        x=rng.standard_normal((b, s, h, p)).astype(np.float32),
        dt=rng.uniform(0.01, 0.2, (b, s, h)).astype(np.float32),
        A=-rng.uniform(0.5, 2.0, h).astype(np.float32),
        B=rng.standard_normal((b, s, n)).astype(np.float32),
        C=rng.standard_normal((b, s, n)).astype(np.float32),
    )


def _args(d, pkg):
    conv = torch.as_tensor if pkg == "t" else jnp.asarray
    return [conv(d[k]) for k in ("x", "dt", "A", "B", "C")]


@pytest.mark.parametrize("chunk", [4, 16, 64])
def test_ssd_chunked_matches_the_reference(chunk):
    d = _inputs(2, 64, 3, 4, 8)
    y, h = tssm.ssd_chunked(*_args(d, "t"), chunk)
    jy, jh = jssm.ssd_chunked(*_args(d, "j"), chunk)
    assert y.shape == (2, 64, 3, 4) and h.shape == (2, 3, 4, 8)
    _close(y, jy)
    _close(h, jh)


def test_ssd_chunked_with_a_ragged_chunk():
    """s = 60 with chunk 16: the chunk steps down to 15, as the reference's."""
    d = _inputs(1, 60, 2, 4, 8, seed=1)
    y, h = tssm.ssd_chunked(*_args(d, "t"), 16)
    jy, jh = jssm.ssd_chunked(*_args(d, "j"), 16)
    _close(y, jy)
    _close(h, jh)


def test_ssd_chunked_threads_h0():
    """Two halves with the first's state threaded give the whole run, and
    ``h0`` enters as in the reference."""
    d = _inputs(1, 32, 2, 4, 8, seed=2)
    x, dt, A, B, C = _args(d, "t")
    y_full, h_full = tssm.ssd_chunked(x, dt, A, B, C, 8)
    y1, h1 = tssm.ssd_chunked(x[:, :16], dt[:, :16], A, B[:, :16], C[:, :16], 8)
    y2, h2 = tssm.ssd_chunked(x[:, 16:], dt[:, 16:], A, B[:, 16:], C[:, 16:], 8, h0=h1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y_full, **TOL)
    torch.testing.assert_close(h2, h_full, **TOL)
    h0 = np.random.default_rng(3).standard_normal((1, 2, 4, 8)).astype(np.float32)
    y, h = tssm.ssd_chunked(x, dt, A, B, C, 8, h0=torch.as_tensor(h0))
    jy, jh = jssm.ssd_chunked(*_args(d, "j"), 8, h0=jnp.asarray(h0))
    _close(y, jy)
    _close(h, jh)


def _layer():
    """(cfg, reference cfg, the first SSD layer's parameters as numpy)."""
    cfg, jcfg = smoke_config(ARCH), jconfigs.smoke_config(ARCH)
    params = jt.init_params(jcfg, jax.random.key(0))
    return cfg, jcfg, {k: np.array(v[0]) for k, v in params["pattern"][0]["mixer"].items()}


def _x(cfg, S, seed=4):
    return np.random.default_rng(seed).standard_normal((2, S, cfg.d_model)).astype(np.float32)


def test_ssd_apply_and_its_gradients_match_the_reference():
    cfg, jcfg, p = _layer()
    x = _x(cfg, 64)
    h0 = np.random.default_rng(5).standard_normal((2, 16, 8, 16)).astype(np.float32) * 0.1
    proj = np.random.default_rng(6).standard_normal(x.shape).astype(np.float32)

    def jloss(pp, xx):
        out, (state, tails) = jssm.ssd_apply(pp, xx, jcfg, return_state=True, h0=jnp.asarray(h0))
        return jnp.sum(out * proj) + jnp.sum(state), (out, state, tails)

    (_, (jout, jstate, jtails)), (jgp, jgx) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    tp = {k: torch.as_tensor(v).requires_grad_() for k, v in p.items()}
    tx = torch.as_tensor(x).requires_grad_()
    out, (state, tails) = tssm.ssd_apply(tp, tx, cfg, return_state=True, h0=torch.as_tensor(h0))
    _close(out, jout)
    _close(state, jstate)
    assert sorted(tails) == sorted(jtails)
    for n in tails:
        _close(tails[n], jtails[n])
    grads = torch.autograd.grad((out * torch.as_tensor(proj)).sum() + state.sum(), [tx, *tp.values()])
    for name, g, want in [("x", grads[0], jgx)] + [(k, g, jgp[k]) for k, g in zip(tp, grads[1:])]:
        want = np.asarray(want)
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-4, atol=1e-5 * float(np.abs(want).max()), err_msg=name)


def test_ssd_decode_matches_the_reference_and_the_last_row():
    """Prefill's state and tails over S − 1 positions, then one decode step:
    the reference's step (output and every cache leaf), and the last row of
    ``ssd_apply`` over all S positions."""
    cfg, jcfg, p = _layer()
    S = 40
    x = _x(cfg, S, seed=7)
    tp = {k: torch.as_tensor(v) for k, v in p.items()}
    with torch.no_grad():
        _, (state, tails) = tssm.ssd_apply(tp, torch.as_tensor(x[:, :-1]), cfg, return_state=True)
        cache = tssm.ssd_init_cache(cfg, 2, torch.float32)
        cache["state"].copy_(state)
        for n, t in tails.items():
            cache[f"conv_{n}"].copy_(t)
        jcache = {k: jnp.asarray(v.numpy().copy()) for k, v in cache.items()}  # decode writes into cache
        got, cache2 = tssm.ssd_decode(tp, torch.as_tensor(x[:, -1]), cache, S - 1, cfg)
        assert cache2 is cache  # written in place
        full = tssm.ssd_apply(tp, torch.as_tensor(x), cfg)
    want, jcache = jssm.ssd_decode({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x[:, -1]), jcache,
                                   jnp.asarray(S - 1), jcfg)
    _close(got, want)
    for k in cache:
        _close(cache[k], jcache[k])
    torch.testing.assert_close(got, full[:, -1], **TOL)


def test_the_cache_and_the_specs_are_the_references():
    cfg, jcfg = smoke_config(ARCH), jconfigs.smoke_config(ARCH)
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = tssm.ssd_init_cache(cfg, 3, dtype)
        want = jssm.ssd_init_cache(jcfg, 3, jdtype)
        assert {k: (tuple(v.shape), str(v.dtype)[6:]) for k, v in got.items()} == \
            {k: (v.shape, v.dtype.name) for k, v in want.items()}
    assert got["state"].dtype == torch.float32  # the state stays f32 in a bf16 model
    assert tssm.ssd_cache_axes() == jssm.ssd_cache_axes()
    specs, jspecs = tssm.ssd_specs(cfg), jssm.ssd_specs(jcfg)
    assert list(specs) == list(jspecs)
    assert all((specs[k].shape, specs[k].axes, specs[k].init) == (jspecs[k].shape, jspecs[k].axes, jspecs[k].init)
               for k in specs)
    assert tt.cache_axes(cfg) == jt.cache_axes(jcfg)


def test_the_ssm_initializers_draw_the_references_ranges():
    """A in [1, 16] and softplus(dt_bias) in [1e-3, 1e-1], in f32 inside a
    bf16 model, seeded per leaf."""
    cfg = smoke_config(ARCH).replace(dtype="bfloat16", n_periods=8)
    p = tt.init_params(cfg, 0, device="cpu")["pattern"][0]["mixer"]
    A, dt = torch.exp(p["A_log"]), torch.nn.functional.softplus(p["dt_bias"])
    assert p["A_log"].dtype == p["dt_bias"].dtype == torch.float32 and p["w_x"].dtype == torch.bfloat16
    assert 1.0 <= float(A.min()) and float(A.max()) <= 16.0 and float(A.std()) > 3
    assert 1e-3 * 0.999 <= float(dt.min()) and float(dt.max()) <= 1e-1 * 1.001
    assert torch.equal(p["A_log"], tt.init_params(cfg, 0, device="cpu")["pattern"][0]["mixer"]["A_log"])
    assert not torch.equal(p["A_log"], tt.init_params(cfg, 1, device="cpu")["pattern"][0]["mixer"]["A_log"])
