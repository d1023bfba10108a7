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
from repro_torch.core import generate_problem, lstsq, qr_solve, select_method  # noqa: E402

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
        pytest.param(dict(cluster=object()), "A11", id="kw1-A11"),
    ],
)
def test_unported_options_raise(big, kw, slice_):
    with pytest.raises(NotImplementedError, match=slice_):
        lstsq(big.A, big.b, 0, device=CPU, **kw)


def test_reg_solves_the_ridge_problem(big):
    """reg= (which raised before A8 was ported) solves min‖Ax − b‖² +
    λ‖x‖²: the closed form within 1e-8, arnorm the ridge gradient's."""
    lam = 0.1
    A, b = big.A.numpy(), big.b.numpy()
    x_ridge = np.linalg.solve(A.T @ A + lam * np.eye(A.shape[1]), A.T @ b)
    res = lstsq(big.A, big.b, 0, reg=lam, device=CPU)
    assert res.method == "iterative"  # selected on the data's shape
    assert _rel(res.x, x_ridge) < 1e-8
    assert float(res.arnorm) < 1e-8 * float(np.linalg.norm(b))


def test_trace_returns_timeline_rooted_at_lstsq(big):
    """trace=True (which raised before the tracer was ported) returns the
    call's Timeline, its root the lstsq span; untraced calls attach none."""
    from repro_torch.obs import trace as obs_trace

    res = lstsq(big.A, big.b, 0, trace=True, device=CPU)
    assert isinstance(res.timeline, obs_trace.Timeline)
    root = [s for s in res.timeline.spans() if s["depth"] == 0]
    assert [s["name"] for s in root] == ["lstsq"] and res.timeline.names()[-1] == "lstsq"
    assert root[0]["args"] == {"accuracy": "balanced", "method": res.method}
    assert lstsq(big.A, big.b, 0, device=CPU).timeline is None
    assert not obs_trace.enabled()


@pytest.mark.parametrize(
    "kw,method",
    [
        (dict(method="sap"), "sap"),
        (dict(method="iterative"), "iterative"),
        (dict(method="fossils"), "fossils"),
        (dict(), "iterative"),  # auto + balanced selects iterative at this shape
        (dict(accuracy="high"), "fossils"),
        (dict(accuracy="certified"), None),  # a rung of the certified ladder
        (dict(certified_rtol=1e-6), "iterative"),  # read only by the certified tier
        (dict(certified_probes=4), "iterative"),
    ],
)
def test_forward_stable_and_certified_calls_reach_truth(big, kw, method):
    """The calls that raised before the forward-stable solvers and the
    certified tier were ported: the selected method, a converged stop
    (istop 8, the step floor) and the error within 100x ``qr_solve``'s; a
    certificate that passed, with the distance to QR's x within 10x its
    bound (``tests/test_certify.py``)."""
    res = lstsq(big.A, big.b, 0, device=CPU, **kw)
    x_qr = qr_solve(big.A, big.b, device=CPU)
    e_qr = _rel(x_qr, big.x_true)
    if method is None:
        assert res.method in ("saa", "iterative", "fossils", "direct")
        cert = res.certificate
        assert bool(cert.passed)
        assert float((res.x - x_qr).norm()) <= 10 * float(cert.error_bound)
    else:
        assert res.method == method and res.certificate is None
        assert int(res.istop) == 8
    assert _rel(res.x, big.x_true) <= 100 * max(e_qr, 1e-12)


def test_unported_inputs_raise(prob):
    with pytest.raises(NotImplementedError, match="A9"):
        lstsq(_RowSource(), np.zeros(100), 0, device=CPU)


def test_sparse_input_solves(big):
    """A torch sparse A (which raised before A8 was ported) solves through
    the matrix-free selection: never direct, within 100x qr_solve's error."""
    res = lstsq(big.A.to_sparse(), big.b, 0, device=CPU)
    assert res.method == "iterative"
    e_qr = _rel(qr_solve(big.A, big.b, device=CPU), big.x_true)
    assert _rel(res.x, big.x_true) <= 100 * max(e_qr, 1e-12)
