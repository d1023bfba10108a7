"""Port parity for the whole slice: SAA-SAS (paper Algorithm 1) on the same
problem and the same CountSketch in both packages.

The reference draws the problem and S; ``repro_torch.convert`` carries
both across, and the port receives S as ``sketch=`` (the carry-across hook
of ``SketchedFactor.build``).  Factors are compared only through x and
other sign-invariant quantities: Householder signs differ between LAPACK
builds.

Tolerances:
- relative error against x_true < 1e-5 for both packages, the bound of
  the reference's own ``tests/test_saa.py`` at κ = 1e10;
- x_port against x_reference: relative difference < 1e-5 (each is within
  that of x_true; the sketch, QR and LSQR round differently);
- |Δitn| ≤ 2 — the step-floor stop (three consecutive steps below
  steptol) can shift by a step or two under different rounding;
- the operator form (``materialize_y=False``) against the port's
  materialized form: 1e-4, the bound of the reference's own test;
- the fallback branch (``iter_lim=1``) is held to ground truth, not to
  the reference: its Gaussian perturbation comes from another generator.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import generate_problem as j_generate  # noqa: E402
from repro.core import saa_sas as j_saa  # noqa: E402
from repro.core import sketch as jsketch  # noqa: E402
from repro.core.precond import SketchedFactor as JFactor  # noqa: E402
from repro.core.precond import default_sketch_size  # noqa: E402
from repro_torch.convert import countsketch_from_reference, problem_from_reference  # noqa: E402
from repro_torch.core import (  # noqa: E402
    SketchedFactor,
    estimate_2norm,
    generate_problem,
    qr_solve,
    saa_sas,
)

CPU = "cpu"
M, N = 4000, 64


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


def _both(cond, seed=0):
    p = j_generate(jax.random.key(seed), M, N, cond=cond, beta=1e-10)
    arrays = [np.asarray(a) for a in (p.A, p.b, p.x_true, p.r_true)]
    return p, problem_from_reference(*arrays, p.cond, p.beta, device=CPU)


@pytest.fixture(scope="module")
def prob():
    return _both(1e10)


def _reference_sketch(key):
    """The S that the reference's ``saa_sas(A, b, key)`` draws, and its port."""
    k_sketch = jax.random.split(key, 3)[0]
    op_j = jsketch.sample(
        "clarkson_woodruff", k_sketch, default_sketch_size(N, M), M, dtype=jnp.float64
    )
    return countsketch_from_reference(op_j.buckets, op_j.signs, op_j.d, device=CPU)


def _check_parity(res, ref, x_true):
    assert bool(res.converged) and bool(ref.converged)
    e_port, e_ref = _rel(res.x, x_true), _rel(ref.x, x_true)
    assert e_port < 1e-5 and e_ref < 1e-5
    assert _rel(res.x.numpy(), ref.x) < 1e-5
    assert abs(int(res.itn) - int(ref.itn)) <= 2


def test_saa_matches_reference_on_same_sketch(prob):
    pj, pt = prob
    key = jax.random.key(1)
    ref = j_saa(pj.A, pj.b, key)
    op = _reference_sketch(key)
    res = saa_sas(pt.A, pt.b, 0, sketch=op, device=CPU)
    _check_parity(res, ref, pt.x_true)
    assert not bool(res.used_fallback)
    e_qr = _rel(qr_solve(pt.A, pt.b, device=CPU), pt.x_true)
    assert _rel(res.x, pt.x_true) < 100 * max(e_qr, 1e-12)
    # operator form: Y = AR⁻¹ applied on the fly, never materialized
    res_op = saa_sas(pt.A, pt.b, 0, sketch=op, materialize_y=False, device=CPU)
    assert bool(res_op.converged) and _rel(res_op.x, res.x) < 1e-4
    assert _rel(res_op.x, pt.x_true) < 1e-5


def test_saa_fused_route_matches_reference(prob):
    pj, pt = prob
    key = jax.random.key(2)
    ref = j_saa(pj.A, pj.b, key, fused=True, backend="reference")
    res = saa_sas(pt.A, pt.b, 0, sketch=_reference_sketch(key), fused=True, device=CPU)
    _check_parity(res, ref, pt.x_true)


def test_saa_mixed_precision_matches_reference():
    pj, pt = _both(1e4, seed=3)
    key = jax.random.key(4)
    ref = j_saa(pj.A, pj.b, key, precision="mixed")
    res = saa_sas(pt.A, pt.b, 0, sketch=_reference_sketch(key), precision="mixed", device=CPU)
    _check_parity(res, ref, pt.x_true)
    assert not bool(res.used_fallback) and not bool(ref.used_fallback)


def test_saa_with_own_generator_reaches_truth(prob):
    _, pt = prob
    res = saa_sas(pt.A, pt.b, torch.Generator().manual_seed(5), device=CPU)
    assert bool(res.converged) and int(res.itn) < 40
    assert _rel(res.x, pt.x_true) < 1e-5


def test_fallback_branch_against_truth(prob):
    """iter_lim=1 cannot converge, so the perturbation branch runs; its one
    LSQR step from the sketch-and-solve warm start lands within the
    embedding distortion (≈ √(n/s) = 0.5) of x_true."""
    _, pt = prob
    res = saa_sas(pt.A, pt.b, 6, iter_lim=1, device=CPU)
    assert bool(res.used_fallback)
    assert int(res.itn) == 1 and int(res.istop) == 7
    e_port = _rel(res.x, pt.x_true)
    assert np.isfinite(e_port) and e_port < 0.5


def test_factor_sign_invariant_quantities_match_reference(prob):
    pj, pt = prob
    op_t = _reference_sketch(jax.random.key(7))
    factor_t, _ = SketchedFactor.build(pt.A, 0, sketch=op_t, device=CPU)
    B_j = jnp.asarray(op_t.apply(pt.A).numpy())
    factor_j = JFactor.from_sketch(B_j)
    c = op_t.apply(pt.b)
    x_t = factor_t.sketch_and_solve(c).numpy()
    x_j = factor_j.sketch_and_solve(jnp.asarray(c.numpy()))
    assert _rel(x_t, x_j) < 1e-6
    g = pt.A.T @ pt.b
    assert _rel(factor_t.normal_solve(g).numpy(), factor_j.normal_solve(jnp.asarray(g.numpy()))) < 1e-4
    Y = factor_t.materialize_whitened(pt.A)
    z = torch.randn(N, dtype=torch.float64, generator=torch.Generator().manual_seed(8))
    u = torch.randn(M, dtype=torch.float64, generator=torch.Generator().manual_seed(9))
    # A·(R⁻¹z) and (AR⁻¹)·z round apart by up to κ(R)·ε ≈ 1e10 · 2.2e-16
    assert _rel(factor_t.whiten_mv(pt.A, z).numpy(), (Y @ z).numpy()) < 1e-5
    assert _rel(factor_t.whiten_rmv(pt.A, u).numpy(), (Y.T @ u).numpy()) < 1e-5
    sv = torch.linalg.svdvals(Y)  # Y is a near-isometry: the preconditioner works
    assert float(sv[0] / sv[-1]) < 10


def test_estimate_2norm_against_truth(prob):
    _, pt = prob  # σ_max(A) = 1 by construction
    est = float(estimate_2norm(pt.A, 0, device=CPU))
    assert abs(est - 1.0) < 1e-6


def test_generate_problem_properties():
    p = generate_problem(11, 2000, 32, cond=1e8, beta=1e-6, device=CPU)
    assert p.A.shape == (2000, 32) and p.b.shape == (2000,)
    sv = torch.linalg.svdvals(p.A)
    assert abs(float(sv[0] / sv[-1]) / 1e8 - 1) < 1e-3
    assert abs(float(torch.linalg.vector_norm(p.r_true)) - 1e-6) < 1e-12
    assert float(torch.linalg.vector_norm(p.A.T @ p.r_true)) < 1e-14
    assert torch.allclose(p.A @ p.x_true + p.r_true, p.b, rtol=0, atol=1e-14)
    fast = generate_problem(11, 2000, 32, method="fast", device=CPU)
    assert fast.A.shape == (2000, 32) and torch.isfinite(fast.A).all()
