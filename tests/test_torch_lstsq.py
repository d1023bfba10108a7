"""Port parity: the ``lstsq`` driver and ``select_method`` against the JAX
reference.

Tolerances: ``select_method`` must agree exactly (pure arithmetic);
``direct`` x within 100·κ·ε relative of the reference's (one Householder
QR each, κ = 1e10); ``lsqr`` stopped after 5 iterations within 1e-8;
``saa`` x within 1e-5 of the reference's and of x_true (as in
``test_torch_saa.py``), on the same S.
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import generate_problem as j_generate  # noqa: E402
from repro.core import lstsq as j_lstsq  # noqa: E402
from repro.core import select_method as j_select  # noqa: E402
from repro.core import sketch as jsketch  # noqa: E402
from repro.core.precond import default_sketch_size  # noqa: E402
from repro_torch.convert import countsketch_from_reference, problem_from_reference  # noqa: E402
from repro_torch.core import generate_problem, lstsq, select_method  # noqa: E402

CPU = "cpu"
M, N = 4000, 64


def _rel(x, y):
    x, y = np.asarray(x), np.asarray(y)
    return float(np.linalg.norm(x - y) / np.linalg.norm(y))


GRID = list(
    itertools.product(
        [100, 1000, 4096, 20000, 2**20],  # m
        [1, 16, 64, 500, 1000],  # n
        [None, "n+1", "4n", 10],  # sketch_size
    )
)


@pytest.mark.parametrize("accuracy", ["fast", "balanced", "high"])
@pytest.mark.parametrize("matrix_free", [False, True])
@pytest.mark.parametrize("has_key", [True, False])
def test_select_method_agrees_with_reference(accuracy, matrix_free, has_key):
    for m, n, s in GRID:
        s = {"n+1": n + 1, "4n": 4 * n}.get(s, s)
        kw = dict(has_key=has_key, accuracy=accuracy, sketch_size=s, matrix_free=matrix_free)
        assert select_method(m, n, **kw) == j_select(m, n, **kw), (m, n, kw)


def test_select_method_rejects_certified_like_reference():
    with pytest.raises(ValueError):
        j_select(4096, 64, accuracy="certified")
    with pytest.raises(ValueError):
        select_method(4096, 64, accuracy="certified")


@pytest.fixture(scope="module")
def prob():
    p = j_generate(jax.random.key(0), M, N, cond=1e10, beta=1e-10)
    arrays = [np.asarray(a) for a in (p.A, p.b, p.x_true, p.r_true)]
    return p, problem_from_reference(*arrays, p.cond, p.beta, device=CPU)


@pytest.fixture(scope="module")
def big():
    """m·n² > DIRECT_FLOP_CUTOFF: auto selects a sketched method."""
    return generate_problem(3, 20000, 64, cond=1e4, beta=1e-10, device=CPU)


def _sketch_of(key, m, n):
    op = jsketch.sample(
        "clarkson_woodruff", jax.random.split(key, 3)[0],
        default_sketch_size(n, m), m, dtype=jnp.float64,
    )
    return countsketch_from_reference(op.buckets, op.signs, op.d, device=CPU)


def test_lstsq_direct_matches_reference(prob):
    pj, pt = prob
    ref = j_lstsq(pj.A, pj.b, method="direct")
    res = lstsq(pt.A, pt.b, method="direct", device=CPU)
    assert res.method == ref.method == "direct"
    # two Householder QRs agree to the problem's κ·ε
    assert _rel(res.x, ref.x) < 100 * pt.cond * np.finfo(np.float64).eps
    assert _rel(res.x, pt.x_true) < 1e-6
    # ‖b − Ax‖ ≈ β = 1e-10 is computed with cancellation: ε·‖b‖ apart
    assert abs(float(res.rnorm) - float(ref.rnorm)) <= 1e-14 * float(np.linalg.norm(pj.b))
    # small problems: auto selects direct in both packages
    assert lstsq(pt.A[:512], pt.b[:512], device=CPU).method == "direct"
    assert j_lstsq(pj.A[:512], pj.b[:512]).method == "direct"


@pytest.mark.parametrize("name", ["qr_solve", "svd_solve", "normal_equations"])
def test_direct_solvers_match_reference(name):
    """κ = 1e3 keeps the normal equations (κ² = 1e6) well inside f64."""
    from repro.core import direct as jdirect
    from repro_torch.core import direct as tdirect

    p = j_generate(jax.random.key(5), 1000, 20, cond=1e3, beta=1e-6)
    x_ref = getattr(jdirect, name)(p.A, p.b)
    x = getattr(tdirect, name)(np.asarray(p.A), np.asarray(p.b), device=CPU)
    assert _rel(x, x_ref) < 1e-9
    assert _rel(x, p.x_true) < 1e-9


def test_lstsq_lsqr_matches_reference(prob):
    pj, pt = prob
    # few iterations: on κ = 1e4 the two libraries' rounding grows with
    # every Lanczos step (see test_torch_lsqr.py for converged parity)
    ref = j_lstsq(pj.A, pj.b, method="lsqr", iter_lim=5)
    res = lstsq(pt.A, pt.b, method="lsqr", iter_lim=5, device=CPU)
    assert res.method == ref.method == "lsqr"
    assert int(res.itn) == int(ref.itn) == 5
    assert _rel(res.x, ref.x) < 1e-8


def test_lstsq_saa_matches_reference(prob):
    pj, pt = prob
    key = jax.random.key(1)
    ref = j_lstsq(pj.A, pj.b, key, method="saa")
    res = lstsq(pt.A, pt.b, 0, method="saa", sketch=_sketch_of(key, M, N), device=CPU)
    assert res.method == ref.method == "saa"
    assert _rel(res.x, pt.x_true) < 1e-5 and _rel(ref.x, pt.x_true) < 1e-5
    assert _rel(res.x, ref.x) < 1e-5


def test_lstsq_auto_fast_selects_saa(big):
    res = lstsq(big.A, big.b, 1, accuracy="fast", device=CPU)
    assert res.method == select_method(20000, 64, accuracy="fast") == "saa"
    assert bool(res.converged) and _rel(res.x, big.x_true) < 1e-5


def test_lstsq_saa_fused_and_mixed_reach_truth(big):
    for kw in (dict(fused=True), dict(precision="mixed"), dict(fused=True, precision="mixed")):
        res = lstsq(big.A, big.b, 2, method="saa", device=CPU, **kw)
        assert bool(res.converged), kw
        assert _rel(res.x, big.x_true) < 1e-5, kw


def test_tolerance_audit_like_reference(prob):
    pj, pt = prob
    with pytest.raises(ValueError):
        j_lstsq(pj.A, pj.b, method="direct", iter_lim=5)
    with pytest.raises(ValueError):
        lstsq(pt.A, pt.b, method="direct", iter_lim=5, device=CPU)
    with pytest.raises(ValueError):
        lstsq(pt.A, pt.b, method="lsqr", precision="mixed", device=CPU)
    # auto drops the knobs its selected method does not consume
    res = lstsq(pt.A[:512], pt.b[:512], iter_lim=5, device=CPU)
    assert res.method == "direct"


class _RowSource:
    shape = (100, 4)

    def tiles(self):
        return iter(())


@pytest.mark.parametrize(
    "kw,slice_",
    [
        (dict(method="sap"), "A6"),
        (dict(method="iterative"), "A6"),
        (dict(method="fossils"), "A6"),
        (dict(), "A6"),  # auto + balanced selects iterative at this shape
        (dict(accuracy="certified"), "A6"),
        (dict(certified_rtol=1e-6), "A6"),
        (dict(reg=0.1), "A8"),
        (dict(cluster=object()), "A11"),
        (dict(trace=True), "A4"),
        (dict(certified_probes=4), "A6"),
    ],
)
def test_unported_options_raise(big, kw, slice_):
    with pytest.raises(NotImplementedError, match=slice_):
        lstsq(big.A, big.b, 0, device=CPU, **kw)


def test_unported_inputs_raise(prob):
    _, pt = prob
    with pytest.raises(NotImplementedError, match="A9"):
        lstsq(_RowSource(), np.zeros(100), 0, device=CPU)
    with pytest.raises(NotImplementedError, match="A8"):
        lstsq(pt.A.to_sparse(), pt.b, 0, device=CPU)
