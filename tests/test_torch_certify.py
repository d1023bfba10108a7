"""Port parity: the trust layer (``core/certify.py``), ``SketchedFactor.extend``
and the certified escalation ladder of ``lstsq``, against the JAX reference.

Estimators are compared on the SAME factor (the reference's Q and R carried
across) and the SAME probes (the reference's W, fed through the port's
private ``_probe_distortion_w``/``_certify_w``).  The certified solution x̂
is a deliberately sloppy sketch-and-solve estimate: at a converged x̂ the
gradient Aᵀ(b − Ax̂) is rounding noise, which two libraries round apart.

Tolerances:
- every Certificate field, ``probe_distortion``, ``probe_spectrum_floor``,
  ``factor_spectrum``, ``error_bound`` and ``_adaptive_target``: within
  1e-12 relative of the reference's; ``passed`` equal;
- the exact whitened floor of a mixed certificate (the port: σ_min of the R
  factor of a QR of Y; the reference: ``svd(Y)[-1]``): within 1e-12
  relative in a healthy factor; in a collapsed one (a bf16 sketch at
  κ = 1e10, σ_min(Y) ≈ 3e-7) within 10·n·ε·σ_max(Y) absolute, the rounding
  of either backward-stable factorization, and the bound and relative bound
  within twice that gap relative, plus 1e-12 (bound ∝ σ_min⁻²);
- ``extend`` with B given and the same extension block: B_new bitwise the
  reference's; without B (Q·R) within 1e-12 relative;
- the certified ladder held to ground truth as the reference's own
  ``tests/test_certify.py`` holds it (its draws differ from the
  reference's, so it is not held to the reference's output).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import certify as jcert  # noqa: E402
from repro.core import generate_problem as j_generate  # noqa: E402
from repro.core.precond import SketchedFactor as JFactor  # noqa: E402
from repro_torch.convert import countsketch_from_reference, problem_from_reference  # noqa: E402
from repro_torch.core import SketchedFactor, generate_problem, lstsq, qr_solve  # noqa: E402
from repro_torch.core import certify as tcert  # noqa: E402
from repro_torch.core import sketch as tsketch  # noqa: E402

CPU = "cpu"
EPS = float(np.finfo(np.float64).eps)
FLOOR_FIELDS = ("error_bound", "rel_error_bound")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small tensors, the module's fixtures
    included: the suite runs several test workers at once, and more threads
    only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.array(a))


def _relgap(a, b):
    a, b = float(a), float(b)
    if math.isnan(a) and math.isnan(b):
        return 0.0
    return abs(a - b) / max(abs(b), 1e-300)


def _case(cond, precision):
    """A (2048, 24) problem, the reference's factor (built at
    ``precision``) and its port copy, a sloppy x̂ and the probes W."""
    p = j_generate(jax.random.key(30), 2048, 24, cond=cond, beta=1e-4)
    jf, jop = JFactor.build(p.A, jax.random.key(31), precision=precision)
    x = jf.sketch_and_solve(jop.apply(p.b))
    W = jax.random.normal(jax.random.key(32), (24, 8), jnp.float64)
    f = SketchedFactor(Q=_t(jf.Q), R=_t(jf.R))
    return p, jf, x, W, f


@pytest.fixture(scope="module")
def healthy():
    return _case(1e4, "full")


def test_estimators_match_reference(healthy):
    p, jf, x, W, f = healthy
    A, b, xt = _t(p.A), _t(p.b), _t(x)
    eps_j = jcert.probe_distortion(p.A, jf, jax.random.key(32), n_probes=8)
    eps_t = tcert._probe_distortion_w(A, f, _t(W))
    assert _relgap(eps_t, eps_j) < 1e-12
    assert _relgap(tcert.probe_spectrum_floor(A, f), jcert.probe_spectrum_floor(p.A, jf)) < 1e-12
    for got, want in zip(tcert.factor_spectrum(f), jcert.factor_spectrum(jf)):
        assert _relgap(got, want) < 1e-12
    for got, want in zip(tcert.error_bound(A, b, xt, f, eps_t), jcert.error_bound(p.A, p.b, x, jf, eps_j)):
        assert _relgap(got, want) < 1e-12
    smax, _, cond = jcert.factor_spectrum(jf)
    args = (float(cond), 1e-3, float(smax), 2.5)
    want = jcert._adaptive_target(jnp.float64, *map(jnp.asarray, args))
    got = tcert._adaptive_target(torch.float64, *map(lambda v: torch.tensor(v, dtype=torch.float64), args))
    assert _relgap(got, want) < 1e-12


@pytest.mark.parametrize("with_x", [True, False])
@pytest.mark.parametrize("precision", ["full", "mixed"])
@pytest.mark.parametrize("cond,built", [(1e4, "full"), (1e10, "mixed")])
def test_certify_matches_reference(cond, built, precision, with_x):
    p, jf, x, W, f = _case(cond, built)
    kw = dict(sketch_rows=jf.sketch_size, escalations=2, precision=precision)
    args = (p.b, x) if with_x else (None, None)
    ref = jcert.certify(p.A, *args, jf, jax.random.key(32), **kw)
    targs = (_t(p.b), _t(x)) if with_x else (None, None)
    got = tcert._certify_w(_t(p.A), *targs, f, _t(W), **kw)
    assert got._fields == ref._fields
    # a collapsed factor's exact floor: the rounding of either factorization
    collapsed = built == "mixed" and precision == "mixed" and with_x
    floor_tol = 2 * _floor_gap(p, jf, f) + 1e-12 if collapsed else 1e-12
    for name, a, r in zip(got._fields, got, ref):
        if name in ("sketch_rows", "escalations", "precision"):
            assert a == r, name
        elif name == "passed":
            assert bool(a) == bool(r)
        else:
            tol = floor_tol if name in FLOOR_FIELDS else 1e-12
            assert _relgap(a, r) <= tol, (name, float(a), float(r))


def _floor_gap(p, jf, f):
    """Relative gap of the two packages' σ_min(Y), checked against
    10·n·ε·σ_max(Y) absolute."""
    sv = jnp.linalg.svd(jf.materialize_whitened(p.A), compute_uv=False)
    got = float(tcert._exact_whitened_floor(_t(p.A), f))
    assert abs(got - float(sv[-1])) <= 10 * f.n * EPS * float(sv[0])
    return _relgap(got, sv[-1])


@pytest.mark.parametrize("cond,built", [(1e4, "full"), (1e10, "mixed")])
def test_exact_whitened_floor_matches_svd(cond, built):
    p, jf, _, _, f = _case(cond, built)
    gap = _floor_gap(p, jf, f)
    if built == "full":
        assert gap < 1e-12
    else:  # the bf16 sketch collapsed σ_min(Y) far below the healthy ~0.7
        assert float(tcert._exact_whitened_floor(_t(p.A), f)) < 1e-5


def test_extend_matches_reference(monkeypatch):
    m, n, d, extra = 640, 12, 48, 48
    A = jax.random.normal(jax.random.key(7), (m, n), jnp.float64)
    jf, jop, jB = JFactor.build_full(A, jax.random.key(8), sketch_size=d, backend="reference")
    jf2, jop2, jB2 = jf.extend(A, jop, jax.random.key(9), extra, B=jB, backend="reference")
    op = countsketch_from_reference(jop.buckets, jop.signs, d, device=CPU)
    block = jop2.bottom
    block = countsketch_from_reference(block.buckets, block.signs, block.d, device=CPU)
    # the port's extension block is the reference's
    monkeypatch.setattr(tsketch.CountSketch, "_fresh_like", lambda self, key, e: block)
    f, _, B = SketchedFactor.build_full(_t(A), 0, sketch=op, device=CPU)
    assert torch.equal(B, _t(jB))
    f2, op2, B2 = f.extend(_t(A), op, 1, extra, B=B)
    assert torch.equal(B2, _t(jB2))
    assert op2.d == d + extra and f2.sketch_size == d + extra
    assert torch.equal(B2, op2.apply_op(_t(A)))  # never a re-sketch of the top
    _, _, B3 = f.extend(_t(A), op, 1, extra, B=None)
    assert float((B3 - B2).norm() / B2.norm()) < 1e-12


# --------------------------------------------------------------------------
# The certified ladder, held to ground truth (tests/test_certify.py:178–248)
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def hard():
    p = j_generate(jax.random.key(20), 4000, 64, cond=1e10, beta=1e-10)
    arrays = [np.asarray(a) for a in (p.A, p.b, p.x_true, p.r_true)]
    return problem_from_reference(*arrays, p.cond, p.beta, device=CPU)


def test_certified_bound_holds_vs_qr(hard):
    x_qr = qr_solve(hard.A, hard.b, device=CPU)
    res = lstsq(hard.A, hard.b, 21, accuracy="certified", device=CPU)
    cert = res.certificate
    assert cert is not None and bool(cert.passed)
    bound = float(cert.error_bound)
    assert float((res.x - x_qr).norm()) <= 10.0 * bound
    assert bound / float(res.x.norm()) < 1e-4
    assert float((res.x - hard.x_true).norm()) < 1e-4
    assert float(cert.cond_R) > 1e9
    assert cert.passed.device == res.x.device and cert.passed.ndim == 0


def test_certified_escalates_without_resketching(hard, monkeypatch):
    matrix_applies = []
    real_apply = tsketch.CountSketch.apply

    def counting_apply(self, M, *, backend="auto"):
        if getattr(M, "ndim", 1) == 2:
            matrix_applies.append(tuple(M.shape))
        return real_apply(self, M, backend=backend)

    monkeypatch.setattr(tsketch.CountSketch, "apply", counting_apply)
    n = hard.A.shape[1]
    res = lstsq(hard.A, hard.b, 22, accuracy="certified", sketch_size=n + 2, device=CPU)
    cert = res.certificate
    assert bool(cert.passed)
    assert cert.escalations >= 1
    assert cert.sketch_rows > n + 2
    assert res.method != "saa"
    assert len(matrix_applies) == 1 + cert.escalations
    assert all(shape[0] == hard.A.shape[0] for shape in matrix_applies)


def test_certified_rejects_forced_method_and_missing_key(hard):
    with pytest.raises(ValueError, match="certified"):
        lstsq(hard.A, hard.b, 23, accuracy="certified", method="saa", device=CPU)
    with pytest.raises(ValueError, match="key"):
        lstsq(hard.A, hard.b, accuracy="certified", device=CPU)


def test_certified_explicit_slo_target():
    rng = np.random.default_rng(24)
    A, b = rng.standard_normal((2000, 16)), rng.standard_normal(2000)
    res = lstsq(A, b, 26, accuracy="certified", certified_rtol=1e-3, device=CPU)
    assert bool(res.certificate.passed) and res.method == "saa"
    res2 = lstsq(A, b, 27, accuracy="certified", certified_rtol=1e-300, device=CPU)
    assert res2.certificate is not None and not bool(res2.certificate.passed)
    # the best failed attempt comes back, from a rung of the ladder
    assert res2.method in ("saa", "iterative", "fossils", "direct")


def test_certified_mixed_precision():
    """Where bf16 rounding is harmless nothing escalates; at κ = 1e8 the
    ladder reaches the target, escalating precision if it must, and says
    at which precision it certified (tests/test_mixed_precision.py)."""
    p = generate_problem(2, 2048, 32, cond=1e3, beta=1e-8, device=CPU)
    cert = lstsq(p.A, p.b, 3, accuracy="certified", precision="mixed", device=CPU).certificate
    assert bool(cert.passed) and cert.escalations == 0 and cert.precision == "mixed"
    p = generate_problem(0, 2048, 32, cond=1e8, beta=1e-10, device=CPU)
    x_qr = qr_solve(p.A, p.b, device=CPU)
    for precision in ("full", "mixed"):
        res = lstsq(p.A, p.b, 1, accuracy="certified", precision=precision,
                    certified_rtol=1e-6, device=CPU)
        cert = res.certificate
        assert bool(cert.passed) and float(cert.rel_error_bound) <= 1e-6
        assert float((res.x - x_qr).norm() / x_qr.norm()) <= 1e-6
        assert cert.precision in (("full",) if precision == "full" else ("mixed", "full"))


def test_certified_probes_option(hard):
    res = lstsq(hard.A, hard.b, 5, accuracy="certified", certified_probes=2, device=CPU)
    assert bool(res.certificate.passed)
