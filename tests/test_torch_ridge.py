"""Port parity: ridge (``reg=λ``) solves — ``TikhonovAugmented`` through
``lstsq``, the certified tier and ``SketchedSolver`` — and
``AugmentedSketch`` (blockdiag(S, I)), against the closed form and the JAX
reference on the same S.

Tolerances:
- every method against the closed form (AᵀA + λI)⁻¹Aᵀb on a small
  well-conditioned problem: within 1e-8 relative, ``rnorm`` the original
  problem's within 1e-9, ``arnorm`` (the ridge gradient) < 1e-8·‖b‖ — the
  reference's own bounds (``tests/test_lstsq.py:86–101``);
- ``saa`` on the reference's S: itn within 1 of the reference's (the
  step-floor stop reads steps at the rounding level, which the two
  libraries round apart), x within 1e-10 of the reference's;
- ``AugmentedSketch``: ``apply_op`` and ``as_dense`` within 1e-12 of the
  reference's (bitwise for the bucket kinds on a sparse core, and for the
  CountSketch and uniform-sparse sketch on a dense one; the sparse-sign
  sketch's dense apply sums its k·m entries in CSR order, as B1 does);
  ``extend_sketch`` **bitwise** a fresh ``apply_op`` of the escalated
  operator;
- the session: its stored B within 1e-12 of the reference session's, each
  solve (itn within 1) within 1e-10 of the reference's and 1e-8 of the
  closed form.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.sparse import BCOO  # noqa: E402

from repro.core import SketchedSolver as JSolver  # noqa: E402
from repro.core import linop as jlinop  # noqa: E402
from repro.core import lstsq as j_lstsq  # noqa: E402
from repro.core import select_method as j_select  # noqa: E402
from repro.core import sketch as jsketch  # noqa: E402
from repro.core.precond import SketchedFactor as JFactor  # noqa: E402
from repro.core.precond import default_sketch_size  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import (  # noqa: E402
    AugmentedSketch,
    CustomOperator,
    SketchedFactor,
    SketchedSolver,
    TikhonovAugmented,
    lstsq,
    select_method,
)

CPU = "cpu"
M, N, LAM = 600, 12, 0.7
KINDS = ["clarkson_woodruff", "sparse_sign", "uniform_sparse", "gaussian", "uniform_dense", "srht"]
BITWISE = {"clarkson_woodruff", "sparse_sign", "uniform_sparse"}


def _rel(x, y):
    x, y = np.asarray(x), np.asarray(y)
    return float(np.linalg.norm(x - y) / np.linalg.norm(y))


def _convert(op):
    name = type(op).__name__
    if name == "CountSketch":
        return convert.countsketch_from_reference(op.buckets, op.signs, op.d, device=CPU)
    if name == "SparseSignSketch":
        return convert.sparse_sign_from_reference(op.buckets, op.signs, op.d, op.k, device=CPU)
    if name == "UniformSparseSketch":
        return convert.uniform_sparse_from_reference(op.buckets, op.values, op.d, device=CPU)
    if name == "SRHTSketch":
        return convert.srht_from_reference(op.signs, op.rows, op.d, op.m, device=CPU)
    if name == "GaussianSketch":
        return convert.gaussian_from_reference(
            np.asarray(jax.random.key_data(op.key)), op.d, op.m, op.S, device=CPU
        )
    return convert.uniform_dense_from_reference(op.S, device=CPU)


@pytest.fixture(scope="module")
def prob():
    rng = np.random.default_rng(3)
    A = rng.standard_normal((M, N))
    b = rng.standard_normal(M)
    x_ridge = np.linalg.solve(A.T @ A + LAM * np.eye(N), A.T @ b)
    return A, b, x_ridge


def _forms(A):
    At = torch.as_tensor(A)
    M_ = BCOO.fromdense(jnp.asarray(A))
    return {
        "dense": A,
        "sparse": convert.sparse_from_reference(M_.indices, M_.data, A.shape, device=CPU),
        "custom": CustomOperator(lambda v: At @ v, lambda u: At.T @ u, A.shape, torch.float64, CPU),
    }


@pytest.mark.parametrize("method", ("direct", "saa", "sap", "iterative", "fossils", "lsqr"))
def test_ridge_matches_normal_equations(prob, method):
    A, b, x_ridge = prob
    res = lstsq(A, b, 1, method=method, reg=LAM, device=CPU)
    assert res.method == method
    assert _rel(res.x, x_ridge) < 1e-8
    r = b - A @ res.x.numpy()
    assert float(res.rnorm) == pytest.approx(float(np.linalg.norm(r)), rel=1e-9)
    assert float(res.arnorm) < 1e-8 * float(np.linalg.norm(b))
    assert float(np.linalg.norm(A.T @ r)) > 1e-3  # the plain gradient is not 0


@pytest.mark.parametrize("form", ("sparse", "custom"))
@pytest.mark.parametrize("method", ("saa", "iterative", "lsqr"))
def test_ridge_on_sparse_and_custom_inputs(prob, form, method):
    A, b, x_ridge = prob
    res = lstsq(_forms(A)[form], b, 2, method=method, reg=LAM, device=CPU)
    assert _rel(res.x, x_ridge) < 1e-8
    assert float(res.arnorm) < 1e-8 * float(np.linalg.norm(b))


def test_ridge_saa_on_the_reference_s(prob):
    A, b, _ = prob
    key = jax.random.key(5)
    inner = jsketch.sample("clarkson_woodruff", jax.random.split(key, 3)[0], default_sketch_size(N, M), M)
    ref = j_lstsq(jnp.asarray(A), jnp.asarray(b), key, method="saa", reg=LAM)
    res = lstsq(A, b, 0, method="saa", reg=LAM, sketch=_convert(inner), device=CPU)
    assert abs(int(res.itn) - int(ref.itn)) <= 1 and int(res.istop) == int(ref.istop)
    assert _rel(res.x, ref.x) < 1e-10
    assert float(res.rnorm) == pytest.approx(float(ref.rnorm), rel=1e-10)
    assert not bool(res.used_fallback)


def test_ridge_selection_uses_data_shape():
    """As tests/test_certify.py:269: m = 3n is below the sketching regime,
    so auto picks ``direct`` although the augmented shape m + n = 4n is
    not."""
    m, n = 864, 288
    assert select_method(m, n) == j_select(m, n) == "direct"
    assert select_method(m + n, n) == j_select(m + n, n) != "direct"
    rng = np.random.default_rng(28)
    A, b = rng.standard_normal((m, n)), rng.standard_normal(m)
    res = lstsq(A, b, 30, reg=0.7, device=CPU)
    assert res.method == "direct"
    x_ridge = np.linalg.solve(A.T @ A + 0.7 * np.eye(n), A.T @ b)
    assert _rel(res.x, x_ridge) < 1e-8
    # a sparse A in the regime never selects direct
    big = rng.standard_normal((4000, 40))
    assert lstsq(torch.as_tensor(big).to_sparse(), big[:, 0], 31, reg=0.7, device=CPU).method == "iterative"


def test_ridge_increases_with_lambda_shrinks_x(prob):
    A, b, _ = prob
    norms = [float(lstsq(A, b, method="direct", reg=lam, device=CPU).x.norm()) for lam in (0.0, 1.0, 100.0)]
    assert norms[0] > norms[1] > norms[2]


def test_certified_ridge(prob):
    A, b, x_ridge = prob
    for Ain in (A, _forms(A)["sparse"]):
        res = lstsq(Ain, b, 6, accuracy="certified", reg=LAM, device=CPU)
        assert bool(res.certificate.passed) and res.method != "direct"
        assert _rel(res.x, x_ridge) < 1e-8
        assert float(res.arnorm) < 1e-8 * float(np.linalg.norm(b))
        assert res.certificate.sketch_rows == default_sketch_size(N, M)  # the data block's S


def test_certified_ridge_never_densifies_a_sparse_input(prob):
    A, b, _ = prob
    res = lstsq(_forms(A)["sparse"], b, 7, accuracy="certified", reg=LAM,
                certified_rtol=1e-300, device=CPU)
    assert res.method == "fossils" and not bool(res.certificate.passed)
    dense = lstsq(A, b, 7, accuracy="certified", reg=LAM, certified_rtol=1e-300, device=CPU)
    assert dense.method in ("fossils", "direct")


def test_mixed_precision_ridge_rounds_the_data_and_lambda(prob):
    """The bf16 sketch of [A; √λI] on the reference backend: the data and λ
    rounded to bf16 and upcast, as the reference's _lowp_operator does."""
    A, b, x_ridge = prob
    key = jax.random.key(8)
    inner = jsketch.sample("clarkson_woodruff", key, default_sketch_size(N, M), M)
    jt = jlinop.TikhonovAugmented.wrap(jnp.asarray(A), LAM)
    _, _, B_ref = JFactor.build_full(jt, key, precision="mixed", backend="reference")
    t = TikhonovAugmented.wrap(torch.as_tensor(A), LAM, device=CPU)
    _, op, B = SketchedFactor.build_full(t, 0, sketch=_convert(inner), precision="mixed", backend="reference")
    assert isinstance(op, AugmentedSketch) and B.dtype == torch.float64
    assert np.abs(B.numpy() - np.asarray(B_ref)).max() < 1e-12 * np.abs(np.asarray(B_ref)).max()
    res = lstsq(A, b, 9, method="iterative", reg=LAM, precision="mixed", device=CPU)
    assert _rel(res.x, x_ridge) < 1e-8
    with pytest.raises(ValueError, match="dense"):
        lstsq(_forms(A)["sparse"], b, 9, method="saa", reg=LAM, precision="mixed", device=CPU)


# ---------------------------------------------------------- AugmentedSketch


def _tikhonov_pair(A, core):
    Aj = jnp.asarray(A)
    At = torch.as_tensor(A)
    if core == "sparse":
        jcore, tcore = BCOO.fromdense(Aj), _forms(A)["sparse"]
    elif core == "custom":
        jcore = jlinop.CustomOperator(lambda v: Aj @ v, lambda u: Aj.T @ u, A.shape, Aj.dtype)
        tcore = _forms(A)["custom"]
    else:
        jcore, tcore = Aj, At
    return jlinop.TikhonovAugmented.wrap(jcore, LAM), TikhonovAugmented.wrap(tcore, LAM, device=CPU)


@pytest.mark.parametrize("core", ("dense", "sparse", "custom"))
@pytest.mark.parametrize("kind", KINDS)
def test_augmented_sketch_matches_reference(prob, kind, core):
    A = prob[0]
    d = 48
    inner = jsketch.sample(kind, jax.random.key(11), d, M)
    jaug = jsketch.AugmentedSketch(inner=inner, tail=N)
    taug = AugmentedSketch(inner=_convert(inner), tail=N)
    assert (taug.d, taug.m) == (jaug.d, jaug.m) == (d + N, M + N)
    jt, tt = _tikhonov_pair(A, core)
    want = np.asarray(jaug.apply_op(jt))
    got = taug.apply_op(tt).numpy()
    tol = 1e-6 if kind == "gaussian" else 1e-12
    assert np.abs(got - want).max() <= tol * np.abs(want).max(), (kind, core)
    if kind in BITWISE and (core == "sparse" or (core == "dense" and kind != "sparse_sign")):
        assert np.array_equal(got, want)
    assert np.array_equal(got[d:], np.sqrt(LAM) * np.eye(N))  # the exact tail
    dense = taug.as_dense().numpy()
    assert np.abs(dense - np.asarray(jaug.as_dense())).max() <= tol
    # apply() on the augmented right-hand side [b; 0]
    b = np.random.default_rng(12).standard_normal(M)
    bb = np.concatenate([b, np.zeros(N)])
    assert np.abs(taug.apply(torch.as_tensor(bb)).numpy() - np.asarray(jaug.apply(jnp.asarray(bb)))).max() <= tol * 10


@pytest.mark.parametrize("core", ("dense", "sparse", "custom"))
@pytest.mark.parametrize("kind", KINDS)
def test_augmented_extend_sketch_is_bitwise_a_fresh_apply(prob, kind, core):
    A = prob[0]
    inner = _convert(jsketch.sample(kind, jax.random.key(13), 40, M))
    aug = AugmentedSketch(inner=inner, tail=N)
    _, tt = _tikhonov_pair(A, core)
    B_top = aug.apply_op(tt)
    grown = aug.extend_rows(0, 24)
    assert isinstance(grown, AugmentedSketch) and grown.d == 40 + 24 + N and grown.tail == N
    assert torch.equal(grown.extend_sketch(B_top, tt), grown.apply_op(tt)), (kind, core)
    with pytest.raises(TypeError):
        aug.extend_sketch(B_top, tt)  # not escalated
    with pytest.raises(TypeError):
        grown.extend_sketch(B_top, torch.as_tensor(A))  # not a Tikhonov operator


def test_augmented_escalation_matches_reference(prob):
    """SketchedFactor.extend on [A; √λI] with the reference's extension
    block: the grown B within 1e-12 of the reference's."""
    A = prob[0]
    inner = jsketch.sample("clarkson_woodruff", jax.random.key(14), 40, M)
    jt, tt = _tikhonov_pair(A, "dense")
    jaug = jsketch.AugmentedSketch(inner=inner, tail=N)
    jB = jaug.apply_op(jt)
    jfac = JFactor.from_sketch(jB)
    jfac2, jop2, jB2 = jfac.extend(jt, jaug, jax.random.key(15), 24, B=jB)
    taug = AugmentedSketch(inner=_convert(inner), tail=N)
    fac, _, B = SketchedFactor.build_full(tt, 0, sketch=taug)
    assert np.array_equal(B.numpy(), np.asarray(jB))
    bottom = _convert(jop2.inner.bottom)
    real = type(taug.inner)._fresh_like
    type(taug.inner)._fresh_like = lambda self, key, extra: bottom
    try:
        _, op2, B2 = fac.extend(tt, taug, 0, 24, B=B)
    finally:
        type(taug.inner)._fresh_like = real
    assert np.abs(B2.numpy() - np.asarray(jB2)).max() < 1e-12
    assert op2.inner.d == jop2.inner.d


# ------------------------------------------------------------------ session


@pytest.mark.parametrize("form", ("dense", "sparse", "custom"))
def test_session_reg_matches_reference(prob, form):
    A, b, x_ridge = prob
    jforms = {"dense": jnp.asarray(A), "sparse": BCOO.fromdense(jnp.asarray(A)),
              "custom": _tikhonov_pair(A, "custom")[0].op}
    key = jax.random.key(16)
    inner = jsketch.sample("clarkson_woodruff", key, default_sketch_size(N, M), M)
    ref = JSolver(jforms[form], key, reg=LAM)
    s = SketchedSolver(_forms(A)[form], 0, reg=LAM, sketch=_convert(inner), device=CPU)
    assert isinstance(s._sketch_op, AugmentedSketch) and s.sketch_size == ref.sketch_size
    assert (s._Y is None) == (ref._Y is None) == (form != "dense")
    assert np.abs(s._B.numpy() - np.asarray(ref._B)).max() < 1e-12
    res, jres = s.solve(b), ref.solve(jnp.asarray(b))
    assert abs(int(res.itn) - int(jres.itn)) <= 1 and _rel(res.x, jres.x) < 1e-10
    assert _rel(res.x, x_ridge) < 1e-8
    assert float(res.rnorm) == pytest.approx(float(jres.rnorm), rel=1e-10)
    assert float(res.arnorm) < 1e-8 * float(np.linalg.norm(b))
    B = np.stack([b, -b, 2 * b], axis=1)
    many = s.solve_many(B)
    assert _rel(many.x[:, 2], 2 * x_ridge) < 1e-8 and many.arnorm.shape == (3,)
    cert = s.certify()
    assert bool(cert.passed) and cert.sketch_rows == s.sketch_size
    assert bool(s.certify(b, res).passed)
    assert s.stats == {"sketches": 1, "qr_factorizations": 1, "solves": 4}


def test_session_reg_update_rows_pads_the_delta(prob):
    """A ridge session's row update restricts the inner S and keeps the
    identity rows: its B is the reference's, its next solve the closed
    form of the new A."""
    A, b, _ = prob
    key = jax.random.key(17)
    inner = jsketch.sample("clarkson_woodruff", key, default_sketch_size(N, M), M)
    ref = JSolver(jnp.asarray(A), key, reg=LAM)
    s = SketchedSolver(A, 0, reg=LAM, sketch=_convert(inner), device=CPU)
    idx = np.array([3, 10, 500])
    rows = np.random.default_rng(18).standard_normal((3, N))
    s.update_rows(idx, rows)
    ref.update_rows(jnp.asarray(idx), jnp.asarray(rows))
    assert np.abs(s._B.numpy() - np.asarray(ref._B)).max() < 1e-12
    A2 = A.copy()
    A2[idx] = rows
    x2 = np.linalg.solve(A2.T @ A2 + LAM * np.eye(N), A2.T @ b)
    assert _rel(s.solve(b).x, x2) < 1e-8
    assert s._B.shape == (s.sketch_size + N, N)
