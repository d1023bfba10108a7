"""Port parity: the forward-stable solvers (iterative sketching, FOSSILS)
against the JAX reference, on the same problem and the same CountSketch.

The reference draws the problem and S (its solvers sample S from the key
they are given); ``repro_torch.convert`` carries both across and the port
receives S as ``sketch=``.

Tolerances:
- same-sketch parity at κ = 1e4 (ROADMAP §C: long runs stay comparable
  there): x within 1e-10 relative of the reference's, ``istop`` equal,
  ``itn`` within 4 (the stall test waits for a step-norm minimum that
  rounding can move by a few iterations);
- at κ = 1e10, the reference's own bounds (``tests/test_iterative.py``):
  converged, and the error against x_true under 10x ``qr_solve``'s; on the
  forward-stability problem (β = 1e-5) both solvers within 10x of QR;
- products with A: exactly the reference's counts — ``heavy_ball_refine``
  ``itn + 1`` matvecs and rmatvecs; each FOSSILS inner step one matvec, one
  rmatvec and two triangular solves;
- ``damping_momentum``/``default_inner_iter_lim``: equal to the
  reference's (pure arithmetic).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import fossils as j_fossils  # noqa: E402
from repro.core import generate_problem as j_generate  # noqa: E402
from repro.core import iterative as jiter  # noqa: E402
from repro.core import iterative_sketching as j_iterative  # noqa: E402
from repro.core import qr_solve as j_qr  # noqa: E402
from repro.core import sketch as jsketch  # noqa: E402
from repro.core.precond import default_sketch_size  # noqa: E402
from repro_torch.convert import countsketch_from_reference, problem_from_reference  # noqa: E402
from repro_torch.core import (  # noqa: E402
    DenseOperator,
    SketchedFactor,
    damping_momentum,
    fossils,
    fossils_refine,
    heavy_ball_refine,
    iterative,
    iterative_sketching,
    qr_solve,
)

CPU = "cpu"
M, N = 4000, 64
EPS = float(np.finfo(np.float64).eps)


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


def _both(key, m, n, cond, beta):
    p = j_generate(key, m, n, cond=cond, beta=beta)
    arrays = [np.asarray(a) for a in (p.A, p.b, p.x_true, p.r_true)]
    return p, problem_from_reference(*arrays, p.cond, p.beta, device=CPU)


def _same_sketch(key, m, n):
    """The S the reference's solvers draw from ``key``, and the port's copy."""
    op = jsketch.sample("clarkson_woodruff", key, default_sketch_size(n, m), m, dtype=jnp.float64)
    return countsketch_from_reference(op.buckets, op.signs, op.d, device=CPU)


@pytest.fixture(scope="module")
def mild():
    return _both(jax.random.key(0), M, N, 1e4, 1e-10)


@pytest.fixture(scope="module")
def hard():
    """The reference's own fixture of ``tests/test_iterative.py``."""
    return _both(jax.random.key(0), M, N, 1e10, 1e-10)


@pytest.mark.parametrize("solver", ["iterative", "fossils"])
def test_same_sketch_parity(mild, solver):
    pj, pt = mild
    key = jax.random.key(1)
    j_fn, t_fn = {"iterative": (j_iterative, iterative_sketching), "fossils": (j_fossils, fossils)}[solver]
    ref = j_fn(pj.A, pj.b, key)
    res = t_fn(pt.A, pt.b, 0, sketch=_same_sketch(key, M, N), device=CPU)
    assert _rel(res.x, ref.x) < 1e-10
    assert int(res.istop) == int(ref.istop) == 8
    assert abs(int(res.itn) - int(ref.itn)) <= 4


@pytest.mark.parametrize("solver", ["iterative", "fossils"])
def test_reference_bounds_at_cond_1e10(hard, solver):
    pj, pt = hard
    key = jax.random.key(1)
    fn = {"iterative": iterative_sketching, "fossils": fossils}[solver]
    res = fn(pt.A, pt.b, 0, sketch=_same_sketch(key, M, N), device=CPU)
    assert bool(res.converged)
    e_qr = _rel(qr_solve(pt.A, pt.b, device=CPU), pt.x_true)
    assert _rel(res.x, pt.x_true) < 10 * max(e_qr, 1e-12)


def test_forward_stability_against_qr():
    """The reference's forward-stability problem (κ = 1e10, β = 1e-5) and
    sketch key: both forward-stable solvers within 10x of QR."""
    pj, pt = _both(jax.random.key(7), 20000, 100, 1e10, 1e-5)
    e_qr = _rel(np.asarray(j_qr(pj.A, pj.b)), pt.x_true)
    op = _same_sketch(jax.random.key(104), 20000, 100)
    e_it = _rel(iterative_sketching(pt.A, pt.b, 0, sketch=op, device=CPU).x, pt.x_true)
    e_fo = _rel(fossils(pt.A, pt.b, 0, sketch=op, device=CPU).x, pt.x_true)
    assert e_it < 10 * e_qr, (e_it, e_qr)
    assert e_fo < 10 * e_qr, (e_fo, e_qr)


@dataclasses.dataclass(frozen=True)
class _Counting(DenseOperator):
    """A dense operator that counts its products with A and Aᵀ."""

    counts: dict = dataclasses.field(default_factory=lambda: {"matvec": 0, "rmatvec": 0})

    def matvec(self, x):
        self.counts["matvec"] += 1
        return super().matvec(x)

    def rmatvec(self, u):
        self.counts["rmatvec"] += 1
        return super().rmatvec(u)


@pytest.mark.parametrize("iter_lim", [100, 5])
def test_heavy_ball_products_match_reference_count(mild, iter_lim):
    _, pt = mild
    A = _Counting(pt.A)
    factor, op = SketchedFactor.build(A, 3, device=CPU)
    x0 = factor.sketch_and_solve(op.apply(pt.b))
    alpha, beta = damping_momentum(op.d, N)
    res = heavy_ball_refine(A, pt.b, factor, x0, alpha, beta, steptol=32 * EPS, iter_lim=iter_lim)
    itn = int(res.itn)
    assert int(res.istop) == (8 if iter_lim == 100 else 7)
    assert A.counts == {"matvec": itn + 1, "rmatvec": itn + 1}


def test_fossils_products_match_reference_count(mild, monkeypatch):
    _, pt = mild
    A = _Counting(pt.A)
    factor, op = SketchedFactor.build(A, 3, device=CPU)
    x0 = factor.sketch_and_solve(op.apply(pt.b))
    alpha, beta = damping_momentum(op.d, N)
    # the inner loop alone: one matvec, one rmatvec and two triangular
    # solves per step
    solves = []
    real = torch.linalg.solve_triangular

    def counting(*a, **k):
        solves.append(1)
        return real(*a, **k)

    r = pt.b - A.matvec(x0)
    A.counts.update(matvec=0, rmatvec=0)
    monkeypatch.setattr(torch.linalg, "solve_triangular", counting)
    z, itn, done = iterative._whitened_heavy_ball(
        factor, A, r, factor.warm_start(op.apply(r)), alpha=alpha, beta=beta,
        iter_lim=200, steptol=32 * EPS,
    )
    monkeypatch.undo()
    itn = int(itn)
    assert bool(done) and A.counts == {"matvec": itn, "rmatvec": itn} and len(solves) == 2 * itn
    # the whole refinement: one residual matvec per step, one pair at the end
    A.counts.update(matvec=0, rmatvec=0)
    res = fossils_refine(A, pt.b, factor, op, x0, alpha, beta, refine_steps=2,
                         inner_iter_lim=200, steptol=32 * EPS)
    itn = int(res.itn)
    assert A.counts == {"matvec": 2 + itn + 1, "rmatvec": itn + 1}


def test_step_floor_semantics_match_reference():
    """The two-signal floor test, step by step, on one sequence of steps:
    the same (n_small, min_step, n_stall, reached) as the reference's."""
    steps = [1.0, 0.5, 0.6, 0.496, 0.494, 0.3] + [0.2995] * 12 + [1e-20] * 3
    for steptol in (0.0, 1e-10):
        j = jiter._StepFloor.init(jnp.float64)
        t = iterative._StepFloor.init(torch.float64, CPU)
        for s in steps:
            j, j_hit = j.update(jnp.asarray(s), jnp.asarray(s), steptol)
            t, t_hit = t.update(torch.tensor(s, dtype=torch.float64), torch.tensor(s, dtype=torch.float64), steptol)
            assert (int(t.n_small), float(t.min_step), int(t.n_stall), bool(t_hit)) == (
                int(j.n_small), float(j.min_step), int(j.n_stall), bool(j_hit))


def test_stop_precedence_and_zero_rhs(mild):
    _, pt = mild
    factor, op = SketchedFactor.build(pt.A, 3, device=CPU)
    alpha, beta = damping_momentum(op.d, N)
    zero = torch.zeros_like(pt.b)
    res = heavy_ball_refine(pt.A, zero, factor, torch.zeros(N, dtype=torch.float64), alpha, beta,
                            steptol=32 * EPS)
    assert int(res.istop) == 0  # ‖b‖ = 0 gives istop 0
    res = fossils_refine(pt.A, zero, factor, op, torch.zeros(N, dtype=torch.float64), alpha, beta,
                         inner_iter_lim=5, steptol=32 * EPS)
    assert int(res.istop) == 0
    # btol large: residual-level convergence (1) wins over every other test
    x0 = factor.sketch_and_solve(op.apply(pt.b))
    res = heavy_ball_refine(pt.A, pt.b, factor, x0, alpha, beta, btol=1.0, steptol=32 * EPS)
    assert (int(res.istop), int(res.itn)) == (1, 1)
    # refine_steps=0: the unrefined estimate is never certified as converged
    res = fossils_refine(pt.A, pt.b, factor, op, x0, alpha, beta, refine_steps=0,
                         inner_iter_lim=5, steptol=32 * EPS)
    assert (int(res.istop), int(res.itn)) == (7, 0)


def test_history_and_coefficients_match_reference(mild):
    _, pt = mild
    for s, n in [(256, 64), (4000, 1000), (65, 64)]:
        assert damping_momentum(s, n) == jiter.damping_momentum(s, n)
        beta = damping_momentum(s, n)[1]
        assert iterative.default_inner_iter_lim(beta) == jiter.default_inner_iter_lim(beta)
    res = iterative_sketching(pt.A, pt.b, 4, history=True, iter_lim=50, device=CPU)
    h = res.history
    assert h.shape == (50,) and bool(torch.isfinite(h[: int(res.itn)]).all())
    assert bool(torch.isnan(h[int(res.itn):]).all())
    res = fossils(pt.A, pt.b, 4, history=True, device=CPU)
    assert res.history.shape == (3,) and float(res.history[-1]) <= float(res.history[0])
