"""Port parity: ``saa_sas_batch`` in both layouts against the JAX reference,
and the per-column stop of its block LSQR.

The reference writes the multi-RHS mode as a ``vmap`` of LSQR's
``lax.while_loop``; JAX's batching rule freezes a lane once its own
condition fails, so each lane ends as its own solve would.  The port runs
one LSQR over the (m, k) block (each product takes all k columns) and
freezes a column at its own stop.

Tolerances:
- same-sketch parity at κ = 1e4: x within 1e-10 relative of the
  reference's, per column; ``istop`` equal; ``itn`` within 2 (LSQR's
  step-floor stop can move a step under other rounding);
- the freeze, exactly: column j of a block solve is bitwise column 0 of the
  block solve of k copies of b_j on the same factor (the same product
  kernels, so the same rounding), with the same ``itn`` and ``istop``;
- against single solves on the same factor (matrix-vector products, not
  matrix-block ones): at κ = 1e4 x within 1e-10, ``istop`` equal, ``itn``
  within 2; at κ = 1e10 every column within 1e-5 of its truth, as
  ``saa_sas``;
- the problem batch: each x bitwise its own ``saa_sas`` with the same S
  (the same calls in the same order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import generate_problem as j_generate  # noqa: E402
from repro.core import saa_sas_batch as j_batch  # noqa: E402
from repro.core import sketch as jsketch  # noqa: E402
from repro.core.precond import default_sketch_size  # noqa: E402
from repro_torch.convert import countsketch_from_reference  # noqa: E402
from repro_torch.core import SketchedFactor, saa_sas, saa_sas_batch  # noqa: E402
from repro_torch.core.lsqr import lsqr  # noqa: E402
from repro_torch.core.saa import _solve_with_factor  # noqa: E402

CPU = "cpu"
M, N, K = 4000, 64, 6
STEPTOL = 32 * float(np.finfo(np.float64).eps)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small tensors, the module's fixtures
    included: the suite runs several test workers at once, and more threads
    only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(x, y):
    x, y = np.asarray(x), np.asarray(y)
    return float(np.linalg.norm(x - y) / np.linalg.norm(y))


def _same_sketch(key, m, n):
    op = jsketch.sample("clarkson_woodruff", key, default_sketch_size(n, m), m, dtype=jnp.float64)
    return countsketch_from_reference(op.buckets, op.signs, op.d, device=CPU)


def _multi(cond):
    """A problem and K right-hand sides: b and K − 1 consistent ones A·x_j."""
    p = j_generate(jax.random.key(0), M, N, cond=cond, beta=1e-10)
    rng = np.random.default_rng(1)
    X = rng.standard_normal((N, K - 1))
    X /= np.linalg.norm(X, axis=0)
    A = np.array(p.A)
    B = np.concatenate([np.array(p.b)[:, None], A @ X], axis=1)
    return A, B, np.concatenate([np.asarray(p.x_true)[:, None], X], axis=1)


@pytest.fixture(scope="module")
def mild():
    return _multi(1e4)


def test_multi_rhs_matches_reference(mild):
    A, B, _ = mild
    key = jax.random.key(2)
    ref = j_batch(jnp.asarray(A), jnp.asarray(B), key)
    res = saa_sas_batch(A, B, 0, sketch=_same_sketch(key, M, N), device=CPU)
    assert res.x.shape == (N, K) and res.istop.shape == (K,) and res.itn.shape == (K,)
    assert res.used_fallback.shape == (K,) and not bool(res.used_fallback.any())
    for j in range(K):
        assert _rel(res.x[:, j], ref.x[:, j]) < 1e-10, j
    assert np.array_equal(res.istop.numpy(), np.asarray(ref.istop))
    assert np.abs(res.itn.numpy() - np.asarray(ref.itn)).max() <= 2


def test_problem_batch_matches_reference():
    key = jax.random.key(3)
    probs = [j_generate(jax.random.key(10 + i), 2000, 16, cond=1e4, beta=1e-10) for i in range(3)]
    A = np.stack([np.asarray(p.A) for p in probs])
    b = np.stack([np.asarray(p.b) for p in probs])
    ref = j_batch(jnp.asarray(A), jnp.asarray(b), key)
    op = _same_sketch(key, 2000, 16)
    res = saa_sas_batch(A, b, 0, sketch=op, device=CPU)
    assert res.x.shape == (3, 16) and res.itn.shape == (3,)
    for i in range(3):
        assert _rel(res.x[i], ref.x[i]) < 1e-10, i
        assert _rel(res.x[i], probs[i].x_true) < 1e-8
        single = saa_sas(A[i], b[i], 0, sketch=op, device=CPU)
        assert torch.equal(res.x[i], single.x)
        assert (int(res.itn[i]), int(res.istop[i])) == (int(single.itn), int(single.istop))
    assert np.array_equal(res.istop.numpy(), np.asarray(ref.istop))
    assert np.abs(res.itn.numpy() - np.asarray(ref.itn)).max() <= 2


def _block_lsqr(Y, B, Z0):
    return lsqr(lambda z: Y @ z, lambda u: Y.T @ u, B, x0=Z0, atol=0.0, btol=0.0,
                iter_lim=100, steptol=STEPTOL)


@pytest.mark.parametrize("cond", [1e4, 1e10])
def test_each_column_stops_as_its_own_solve(cond, mild):
    A, B, X_true = mild if cond == 1e4 else _multi(cond)
    A, B = torch.as_tensor(A), torch.as_tensor(B)
    factor, op = SketchedFactor.build(A, 4, device=CPU)
    res = saa_sas_batch(A, B, 0, sketch=op, device=CPU)
    Y = factor.materialize_whitened(A)
    C = op.apply(B)
    Z0 = factor.warm_start(C)
    block = _block_lsqr(Y, B, Z0)
    assert torch.equal(factor.precondition(block.x), res.x)
    # the stops differ between columns, so some froze while others ran
    assert len(set(block.itn.tolist())) > 1
    for j in range(K):
        copies = _block_lsqr(Y, B[:, j:j + 1].repeat(1, K), Z0[:, j:j + 1].repeat(1, K))
        assert torch.equal(copies.x[:, 0], block.x[:, j]), j
        assert (int(copies.itn[0]), int(copies.istop[0])) == (int(block.itn[j]), int(block.istop[j]))
        x1, single = _solve_with_factor(A, B[:, j], factor, C[:, j], materialize_y=True, atol=0.0,
                                        btol=0.0, iter_lim=100, steptol=STEPTOL)
        if cond == 1e4:
            assert _rel(res.x[:, j], x1) < 1e-10, j
            assert int(res.istop[j]) == int(single.istop)
            assert abs(int(res.itn[j]) - int(single.itn)) <= 2
        assert _rel(res.x[:, j], X_true[:, j]) < 1e-5, j


def test_batch_shape_errors(mild):
    A, B, _ = mild
    with pytest.raises(ValueError, match="multi-RHS"):
        saa_sas_batch(A, B[:-1], 0, device=CPU)
    with pytest.raises(ValueError, match="problem-batch"):
        saa_sas_batch(np.stack([A, A]), B.T[:3], 0, device=CPU)
