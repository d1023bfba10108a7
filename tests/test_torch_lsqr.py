"""Port parity: LSQR against the JAX reference, and the per-iteration stop check.

Tolerances (same A and b, made with numpy, through both packages):
- well-conditioned problems that converge through the residual tests:
  ``istop`` equal, |Δitn| ≤ 1 (the two libraries' dot products round
  differently, which can move a stop test across its threshold by one
  iteration), x within 1e-8 relative of the reference's;
- the iteration-limit stop (istop = 7) gives equal ``itn``;
- the host reads the stop flag after every iteration: no operator product
  runs past the stop, and the result is bitwise that of a run whose
  ``iter_lim`` ends at the stop iteration.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import lsqr as jlsqr  # noqa: E402
from repro_torch.core import lsqr as tlsqr  # noqa: E402

CPU = "cpu"


def _problem(seed, m, n, cond, noise=1e-3):
    """A with condition number ``cond``; b = Ax + noise·g."""
    rng = np.random.default_rng(seed)
    U, _ = np.linalg.qr(rng.standard_normal((m, n)))
    V, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = (U * np.logspace(0, -np.log10(cond), n)) @ V.T
    x = rng.standard_normal(n)
    b = A @ x + noise * rng.standard_normal(m)
    return A, b


def _rel(x, y):
    return float(np.linalg.norm(np.asarray(x) - np.asarray(y)) / np.linalg.norm(y))


@pytest.mark.parametrize("seed,cond", [(0, 2.0), (3, 10.0)])
def test_lsqr_dense_matches_reference(seed, cond):
    A, b = _problem(seed, 2000, 50, cond, noise=0.0)
    kw = dict(atol=1e-10, btol=1e-10, iter_lim=400)
    res = tlsqr.lsqr_dense(A, b, device=CPU, **kw)
    ref = jlsqr.lsqr_dense(jnp.asarray(A), jnp.asarray(b), **kw)
    assert int(res.istop) == int(ref.istop) == 1
    assert abs(int(res.itn) - int(ref.itn)) <= 1
    assert _rel(res.x.numpy(), ref.x) < 1e-8
    x_ls = np.linalg.lstsq(A, b, rcond=None)[0]
    assert _rel(res.x.numpy(), x_ls) < 1e-8


def test_lsqr_iteration_limit_and_warm_start():
    A, b = _problem(3, 1500, 40, 1e6)
    x0 = np.linalg.lstsq(A, b, rcond=None)[0] * (1 + 1e-3)
    kw = dict(iter_lim=13, atol=0.0, btol=0.0)
    res = tlsqr.lsqr(
        lambda v: torch.as_tensor(A) @ v, lambda u: torch.as_tensor(A).T @ u,
        torch.as_tensor(b), x0=torch.as_tensor(x0), **kw,
    )
    ref = jlsqr.lsqr(
        lambda v: jnp.asarray(A) @ v, lambda u: jnp.asarray(A).T @ u,
        jnp.asarray(b), x0=jnp.asarray(x0), **kw,
    )
    assert int(res.istop) == int(ref.istop) == 7
    assert int(res.itn) == int(ref.itn) == 13
    assert _rel(res.x.numpy(), ref.x) < 1e-8


@pytest.mark.parametrize(
    "seed,cond,noise,kw,istop",
    [
        (0, 2.0, 0.0, dict(atol=1e-10, btol=1e-10), 1),  # residual test
        (9, 3.0, 1e-3, dict(atol=1e-12, btol=1e-12, steptol=1e-10), 8),  # step floor
        (6, 1e4, 1e-3, dict(atol=0.0, btol=0.0, iter_lim=21), 7),  # iteration limit
    ],
)
def test_windowed_check_equals_per_iteration_check(monkeypatch, seed, cond, noise, kw, istop):
    A, b = _problem(seed, 1200, 30, cond, noise)
    A_t, b_t = torch.as_tensor(A), torch.as_tensor(b)

    def run(**kw):
        products = []

        def matvec(v):
            products.append(1)
            return A_t @ v

        res = tlsqr.lsqr(matvec, lambda u: A_t.T @ u, b_t, history=True, **kw)
        return res, len(products)

    res, n_products = run(**kw)
    itn = int(res.itn)
    assert int(res.istop) == istop
    assert n_products == itn  # none past the stop
    capped, _ = run(**{**kw, "iter_lim": itn})
    assert int(capped.itn) == itn
    assert int(capped.istop) == istop  # the stop test outranks the limit
    assert torch.equal(capped.x, res.x)
    assert torch.equal(capped.history, res.history[:itn])


def test_history_matches_reference():
    A, b = _problem(7, 1000, 20, 2.0)
    kw = dict(atol=1e-10, btol=1e-10, iter_lim=60)
    res = tlsqr.lsqr_dense(A, b, device=CPU, history=True, **kw)
    ref = jlsqr.lsqr_dense(jnp.asarray(A), jnp.asarray(b), history=True, **kw)
    k = min(int(res.itn), int(ref.itn))
    np.testing.assert_allclose(res.history[:k].numpy(), np.asarray(ref.history)[:k], rtol=1e-8)
    assert torch.all(res.history[int(res.itn):].isnan())


def test_zero_rhs_gives_zero_solution():
    A, _ = _problem(8, 300, 10, 10.0)
    res = tlsqr.lsqr_dense(A, np.zeros(300), device=CPU)
    assert int(res.istop) == 0
    assert torch.equal(res.x, torch.zeros(10, dtype=torch.float64))
