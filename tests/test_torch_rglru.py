"""Port parity: ``repro_torch.models.rglru`` (Griffin's RG-LRU block) against
``repro.models.rglru``.

The same inputs, drawn with numpy from a seed, go through both packages in
f32 on the CPU, at recurrentgemma-9b's smoke config (d_rnn 128, conv width
4, c = 8) with the reference's parameters of its first recurrent layer.

Tolerances (the port's doubling scan combines the same pairs as the
reference's ``lax.associative_scan`` in another order, so the two agree to
rounding, not bitwise):
- ``linear_scan``: 1e-6 relative + 1e-6 absolute against a sequential loop
  and against ``lax.associative_scan``, at lengths 1, 2, 5, 64 and 2048;
- ``rglru_apply`` (with ``return_state`` and ``state0``) and its
  gradients: 1e-5, and 1e-4 relative + 1e-5 of each leaf's largest entry;
- ``rglru_decode``: 1e-5 against the reference's step, the cache included,
  and against the last row of ``rglru_apply`` over the longer sequence.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import rglru as jrg  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.models import rglru as trg  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
ARCH = "recurrentgemma-9b"


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for these small tensors: the suite runs several
    test workers at once, and more threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("S", [1, 2, 5, 64, 2048])
def test_linear_scan_is_the_recurrence(S):
    rng = np.random.default_rng(S)
    a = rng.uniform(0.5, 1.0, (2, S, 3)).astype(np.float32)
    b = rng.standard_normal((2, S, 3)).astype(np.float32)
    got = trg.linear_scan(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    h, want = np.zeros((2, 3), np.float64), np.empty((2, S, 3))
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        want[:, t] = h
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    _, ref = jax.lax.associative_scan(lambda e1, e2: (e1[0] * e2[0], e2[0] * e1[1] + e2[1]),
                                      (jnp.asarray(a), jnp.asarray(b)), axis=1)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-6, atol=1e-6)


def _layer():
    """(cfg, reference cfg, the first RG-LRU layer's parameters as numpy)."""
    cfg, jcfg = smoke_config(ARCH), jconfigs.smoke_config(ARCH)
    params = jt.init_params(jcfg, jax.random.key(0))
    return cfg, jcfg, {k: np.array(v[0]) for k, v in params["pattern"][0]["mixer"].items()}


def _x(cfg, S, seed=4):
    return np.random.default_rng(seed).standard_normal((2, S, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("with_state0", [False, True])
def test_rglru_apply_and_its_gradients_match_the_reference(with_state0):
    cfg, jcfg, p = _layer()
    x = _x(cfg, 64)
    s0 = np.random.default_rng(5).standard_normal((2, cfg.d_rnn)).astype(np.float32) if with_state0 else None
    proj = np.random.default_rng(6).standard_normal(x.shape).astype(np.float32)

    def jloss(pp, xx):
        out, (h, tail) = jrg.rglru_apply(pp, xx, jcfg, return_state=True,
                                         state0=None if s0 is None else jnp.asarray(s0))
        return jnp.sum(out * proj) + jnp.sum(h), (out, h, tail)

    (_, (jout, jh, jtail)), (jgp, jgx) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    tp = {k: torch.as_tensor(v).requires_grad_() for k, v in p.items()}
    tx = torch.as_tensor(x).requires_grad_()
    out, (h, tail) = trg.rglru_apply(tp, tx, cfg, return_state=True,
                                     state0=None if s0 is None else torch.as_tensor(s0))
    _close(out, jout)
    _close(h, jh)
    _close(tail, jtail)
    assert h.dtype == torch.float32 and tail.shape == (2, 3, cfg.d_rnn)
    grads = torch.autograd.grad((out * torch.as_tensor(proj)).sum() + h.sum(), [tx, *tp.values()])
    for name, g, want in [("x", grads[0], jgx)] + [(k, g, jgp[k]) for k, g in zip(tp, grads[1:])]:
        want = np.asarray(want)
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-4, atol=1e-5 * float(np.abs(want).max()), err_msg=name)


def test_prefill_state_and_decode_steps_continue_the_sequence():
    """The state and convolution tail after 20 positions, then 28 decode
    steps: each step's output is ``rglru_apply``'s row over all 48."""
    cfg, _, p = _layer()
    x = torch.as_tensor(_x(cfg, 48, seed=8))
    tp = {k: torch.as_tensor(v) for k, v in p.items()}
    cache = trg.rglru_init_cache(cfg, 2, torch.float32)
    with torch.no_grad():
        full = trg.rglru_apply(tp, x, cfg)
        first, (h, tail) = trg.rglru_apply(tp, x[:, :20], cfg, return_state=True)
        torch.testing.assert_close(first, full[:, :20], **TOL)
        cache["h"].copy_(h)
        cache["conv"].copy_(tail)
        for t in range(20, 48):
            y, cache = trg.rglru_decode(tp, x[:, t], cache, t, cfg)
            torch.testing.assert_close(y, full[:, t], **TOL)


def test_rglru_decode_matches_the_reference():
    cfg, jcfg, p = _layer()
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, cfg.d_model)).astype(np.float32)
    cache = {"h": rng.standard_normal((2, cfg.d_rnn)).astype(np.float32),
             "conv": rng.standard_normal((2, 3, cfg.d_rnn)).astype(np.float32)}
    want, jcache = jrg.rglru_decode({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                                    {k: jnp.asarray(v) for k, v in cache.items()}, jnp.asarray(7), jcfg)
    tcache = {k: torch.as_tensor(v.copy()) for k, v in cache.items()}
    got, tcache2 = trg.rglru_decode({k: torch.as_tensor(v) for k, v in p.items()}, torch.as_tensor(x), tcache, 7, cfg)
    assert tcache2 is tcache  # written in place
    _close(got, want)
    for k in cache:
        _close(tcache[k], jcache[k])


def test_the_cache_and_the_specs_are_the_references():
    cfg, jcfg = smoke_config(ARCH), jconfigs.smoke_config(ARCH)
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = trg.rglru_init_cache(cfg, 3, dtype)
        want = jrg.rglru_init_cache(jcfg, 3, jdtype)
        assert {k: (tuple(v.shape), str(v.dtype)[6:]) for k, v in got.items()} == \
            {k: (v.shape, v.dtype.name) for k, v in want.items()}
    assert got["h"].dtype == torch.float32  # the state stays f32 in a bf16 model
    assert trg.rglru_cache_axes() == jrg.rglru_cache_axes()
    specs, jspecs = trg.rglru_specs(cfg), jrg.rglru_specs(jcfg)
    assert list(specs) == list(jspecs)
    assert all((specs[k].shape, specs[k].axes, specs[k].init) == (jspecs[k].shape, jspecs[k].axes, jspecs[k].init)
               for k in specs)
    assert tt.cache_axes(cfg) == jt.cache_axes(jcfg)


def test_the_lambda_initializer_draws_the_references_range():
    """a = sigmoid(Λ) in [0.9, 0.999], Λ in f32 inside a bf16 model."""
    cfg = smoke_config(ARCH).replace(dtype="bfloat16")
    lam = tt.init_params(cfg, 0, device="cpu")["pattern"][0]["mixer"]["lam"]
    a = torch.sigmoid(lam)
    assert lam.dtype == torch.float32 and lam.shape == (2, cfg.d_rnn)
    assert 0.9 * 0.9999 <= float(a.min()) and float(a.max()) <= 0.999 * 1.0001 and float(a.std()) > 0.02
