"""Port parity: ``SketchedSolver`` (``core/session.py``) against the JAX
reference's, on the same S, the same probes and the same extension blocks.

Both sessions see one (1500, 24) f64 A made from a numpy seed (κ ≈ 1.3,
inside the κ ≤ 10 regime where converged LSQR runs of the two libraries
agree, ROADMAP §C).  The reference session draws S from its key; the port
gets that S converted (``repro_torch.convert``) as ``sketch=``.  Probe
matrices W and escalation blocks are the reference's draws, fed to the
port through ``certify._draw_probes`` and the kind's ``_fresh_like``.

Tolerances:
- the stored sketch B after the build and after ``update_rows``: bitwise
  the reference's for the kinds whose plain apply is bitwise the
  reference's (CountSketch, uniform-sparse, SRHT); within 1e-12 relative
  for sparse-sign (its plain version sums the k·m entries in CSR order,
  as kernel B1 does, not in the reference's k partial sums) and the
  uniform-dense kind (a matrix product); within 3e-7 relative for the
  Gaussian kind, whose S the port regenerates from the key within 3 f32
  ulps of the reference's Gaussians (``tests/test_torch_dense_sketch.py``;
  the delta-sketch takes the stored columns S[:, idx], so the updated B
  is held to a fresh apply of the new A within the same 3e-7);
- ``solve``/``solve_many``: the same itn and istop (itn within 2 for
  the Gaussian kind, whose factor differs by ~1e-7), x within 1e-10
  relative of the reference's, and within 1e-8 of ``qr_solve`` (the
  reference's own bound, ``tests/test_session.py``);
- certificates: every field within 1e-12 relative, ``passed`` equal;
- amortization counted at the call sites (operator draws, QR factors,
  2-D CountSketch applies), as ``tests/test_session.py:31`` counts them.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import SketchedSolver as JSolver  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import SketchedSolver, SolveResult, qr_solve  # noqa: E402
from repro_torch.core import certify as tcert  # noqa: E402
from repro_torch.core import precond as tprecond  # noqa: E402
from repro_torch.core import sketch as tsketch  # noqa: E402
from repro_torch.obs import REGISTRY, prometheus_text  # noqa: E402

CPU = "cpu"
M_ROWS, N_COLS = 1500, 24
KINDS = ["countsketch", "sparse_sign", "uniform_sparse", "gaussian", "uniform_dense", "srht"]
BITWISE = {"countsketch", "uniform_sparse", "srht"}
B_TOL = {"gaussian": 3e-7}


@pytest.fixture(scope="module")
def prob():
    rng = np.random.default_rng(0)
    A = rng.standard_normal((M_ROWS, N_COLS))
    b = rng.standard_normal(M_ROWS)
    return A, b


def _t(a):
    return torch.as_tensor(np.array(a))


def _rel(x, ref):
    x, ref = np.asarray(x), np.asarray(ref)
    return float(np.linalg.norm(x - ref) / np.linalg.norm(ref))


def _relgap(a, b):
    a, b = float(a), float(b)
    if math.isnan(a) and math.isnan(b):
        return 0.0
    return abs(a - b) / max(abs(b), 1e-300)


def _convert(op):
    """The port's operator for a reference sketch operator."""
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
        S = None if op.S is None else np.asarray(op.S)
        key_data = np.asarray(jax.random.key_data(op.key))
        return convert.gaussian_from_reference(key_data, op.d, op.m, S, device=CPU)
    if name == "UniformDenseSketch":
        return convert.uniform_dense_from_reference(np.asarray(op.S), device=CPU)
    raise TypeError(name)


def _pair(A, kind="countsketch", seed=1, **kw):
    """A reference session and the port's on its S."""
    ref = JSolver(jnp.asarray(A), jax.random.key(seed), sketch=kind, **kw)
    ours = SketchedSolver(A, 0, sketch=_convert(ref._sketch_op), device=CPU, **kw)
    return ref, ours


def _same_b(ours, ref, kind):
    B, B_ref = ours._B, _t(ref._B)
    if kind in BITWISE:
        assert torch.equal(B, B_ref), kind
    else:
        assert float((B - B_ref).norm() / B_ref.norm()) < B_TOL.get(kind, 1e-12), kind


class _Draws:
    """Feed the reference session's probe matrices and escalation blocks
    to the port, in the order the port draws them (the reference's key
    derivation: probe or extension key ``fold_in(certify_key, call)``)."""

    def __init__(self, ref, monkeypatch, kind_cls):
        self.ref, self.calls = ref, 0
        monkeypatch.setattr(tcert, "_draw_probes", self._probes)
        monkeypatch.setattr(kind_cls, "_fresh_like", lambda op, key, extra: self._fresh(op, key, extra))

    def _key(self):
        self.calls += 1
        return jax.random.fold_in(self.ref._certify_key, self.calls)

    def _probes(self, factor, key, n_probes):
        W = jax.random.normal(self._key(), (factor.n, int(n_probes)), jnp.float64)
        return _t(W)

    def _fresh(self, op, key, extra):
        jop = self._ref_op(op)
        return _convert(jop._fresh_like(self._key(), extra))

    def _ref_op(self, op):
        """The reference operator of the same kind (its _fresh_like only
        reads the kind, m and dtype)."""
        j = self.ref._sketch_op
        while type(j).__name__ == "StackedSketch":
            j = j.top
        return j


# --------------------------------------------------------------------------
# amortization and solves
# --------------------------------------------------------------------------


def test_k_solves_one_sketch_one_qr(prob, monkeypatch):
    """Serving k right-hand sides draws S once, factors once and sketches A
    once — counted at the call sites, not by the session's bookkeeping."""
    A, b = prob
    counts = {"sample": 0, "qr": 0, "apply_A": 0}
    real_sample = tsketch.sample
    real_from_sketch = tprecond.SketchedFactor.from_sketch.__func__
    real_apply = tsketch.CountSketch.apply

    def counting_sample(*a, **kw):
        counts["sample"] += 1
        return real_sample(*a, **kw)

    def counting_from_sketch(cls, B):
        counts["qr"] += 1
        return real_from_sketch(cls, B)

    def counting_apply(op, M, *, backend="auto"):
        if M.ndim == 2 and M.shape == (M_ROWS, N_COLS):
            counts["apply_A"] += 1
        return real_apply(op, M, backend=backend)

    monkeypatch.setattr(tsketch, "sample", counting_sample)
    monkeypatch.setattr(tprecond.SketchedFactor, "from_sketch", classmethod(counting_from_sketch))
    monkeypatch.setattr(tsketch.CountSketch, "apply", counting_apply)

    solver = SketchedSolver(A, 1, device=CPU)
    assert counts == {"sample": 1, "qr": 1, "apply_A": 1}
    k = 6
    for i in range(k):
        solver.solve(b + 0.01 * i)
    solver.solve_many(np.stack([b, -b], axis=1))
    assert counts == {"sample": 1, "qr": 1, "apply_A": 1}  # nothing rebuilt per solve
    assert solver.stats == {"sketches": 1, "qr_factorizations": 1, "solves": k + 2}


def test_solve_matches_reference(prob):
    A, b = prob
    ref, ours = _pair(A)
    _same_b(ours, ref, "countsketch")
    r_ref = ref.solve(jnp.asarray(b))
    res = ours.solve(b)
    assert isinstance(res, SolveResult) and res.method == "session" == r_ref.method
    assert int(res.itn) == int(r_ref.itn) and int(res.istop) == int(r_ref.istop)
    assert _rel(res.x, r_ref.x) < 1e-10
    assert _rel(res.x, qr_solve(A, b, device=CPU)) < 1e-8
    assert not bool(res.used_fallback)
    # history, as the reference records it
    h = ours.solve(b, history=True).history
    h_ref = ref.solve(jnp.asarray(b), history=True).history
    assert h.shape == h_ref.shape
    done = ~np.isnan(np.asarray(h_ref))
    assert np.array_equal(~np.isnan(h.numpy()), done)
    assert np.allclose(h.numpy()[done], np.asarray(h_ref)[done], rtol=1e-10)


def test_solve_operator_form_matches_reference(prob):
    """materialize_y=False: LSQR on A and R in operator form."""
    A, b = prob
    ref, ours = _pair(A, seed=4, materialize_y=False)
    assert ours._Y is None
    r_ref, res = ref.solve(jnp.asarray(b)), ours.solve(b)
    assert int(res.itn) == int(r_ref.itn)
    assert _rel(res.x, r_ref.x) < 1e-10


def test_solve_many_matches_reference_columnwise(prob):
    A, b = prob
    ref, ours = _pair(A, seed=3)
    B = np.stack([b, 0.5 * b + 0.1, -2.0 * b], axis=1)
    r_ref = ref.solve_many(jnp.asarray(B))
    res = ours.solve_many(B)
    assert res.x.shape == (N_COLS, 3) and res.method == "session"
    assert res.itn.tolist() == np.asarray(r_ref.itn).tolist()
    assert res.istop.tolist() == np.asarray(r_ref.istop).tolist()
    assert res.used_fallback.tolist() == [False] * 3
    for j in range(3):
        assert _rel(res.x[:, j], r_ref.x[:, j]) < 1e-10, j
        assert _rel(res.x[:, j], qr_solve(A, B[:, j], device=CPU)) < 1e-8, j
    assert ours.stats["solves"] == 3
    with pytest.raises(ValueError, match="solve_many needs B"):
        ours.solve_many(b)


def test_solve_many_column_freezes_at_its_own_stop(prob):
    """A column that has stopped keeps its state: each column of the block
    is bitwise column 0 of the block solve of k copies of it."""
    A, b = prob
    _, ours = _pair(A, seed=5)
    B = np.stack([b, 1e-3 * b + A[:, 0], A @ np.arange(N_COLS)], axis=1)
    res = ours.solve_many(B)
    for j in range(3):
        copies = ours.solve_many(np.repeat(B[:, j:j + 1], 3, axis=1))
        assert torch.equal(copies.x[:, 0], res.x[:, j]), j
        assert int(copies.itn[0]) == int(res.itn[j])


# --------------------------------------------------------------------------
# right-hand-side validation and dtype policy
# --------------------------------------------------------------------------


def test_rhs_validation_up_front(prob):
    """Shape mismatches fail fast with the reference's messages."""
    A, b = prob
    ref, ours = _pair(A, seed=11)
    cases = [
        ("solve", b[:-1], "solve needs b of shape"),
        ("solve", np.stack([b, b], axis=1), "solve needs b of shape"),
        ("solve_many", np.stack([b, b], axis=1)[:-1], "solve_many needs B"),
        ("solve_many", np.zeros((M_ROWS - 3, 2)), "solve_many needs B"),
    ]
    for meth, arg, msg in cases:
        with pytest.raises(ValueError, match=msg) as e_ref:
            getattr(ref, meth)(jnp.asarray(arg))
        with pytest.raises(ValueError, match=msg) as e_ours:
            getattr(ours, meth)(arg)
        assert str(e_ours.value) == str(e_ref.value)


def test_rhs_dtype_policy(prob):
    """A safe upcast is taken explicitly; a promoting right-hand side is an
    error (torch.promote_types where the reference uses result_type)."""
    A, b = prob
    ref, ours = _pair(A, seed=12)
    x_qr = qr_solve(A, b, device=CPU)
    res = ours.solve(b.astype(np.float32))
    assert res.x.dtype == torch.float64
    assert _rel(res.x, x_qr) < 1e-5  # b was rounded to f32, not the solve
    assert _rel(res.x, ref.solve(jnp.asarray(b, jnp.float32)).x) < 1e-10
    resm = ours.solve_many(np.stack([b, -b], axis=1).astype(np.float32))
    assert resm.x.dtype == torch.float64
    for arg in (b.astype(np.complex128), torch.as_tensor(b).to(torch.complex128)):
        with pytest.raises(TypeError, match="promote"):
            ours.solve(arg)
    with pytest.raises(TypeError, match="promote"):
        ours.solve_many(np.stack([b, b], axis=1).astype(np.complex128))
    with pytest.raises(TypeError, match="promote"):
        ref.solve(jnp.asarray(b, jnp.complex128))
    # an f32 session refuses an f64 right-hand side
    solver32 = SketchedSolver(A.astype(np.float32), 13, device=CPU)
    with pytest.raises(TypeError, match="promote"):
        solver32.solve(b)


# --------------------------------------------------------------------------
# row updates
# --------------------------------------------------------------------------


def _update(A, kind, seed, idx):
    ref, ours = _pair(A, kind=kind, seed=seed)
    rows = np.random.default_rng(seed).standard_normal((len(idx), N_COLS))
    A_before = np.array(A)
    ref.update_rows(jnp.asarray(idx), jnp.asarray(rows))
    ours.update_rows(idx, rows)
    assert np.array_equal(A, A_before)  # the caller's A is never written
    A_new = A.copy()
    A_new[idx] = rows
    return ref, ours, A_new


@pytest.mark.parametrize(
    "kind,sketches_after_update",
    [
        ("countsketch", 1),
        ("sparse_sign", 1),
        ("uniform_sparse", 1),
        ("gaussian", 1),
        ("uniform_dense", 1),
        ("srht", 2),  # the one kind without restrict_cols: a re-sketch, same S
    ],
)
def test_update_rows_stats_pinned_per_kind(prob, kind, sketches_after_update):
    """Every kind with a column restriction refreshes the factor through
    the O(|idx|·n) delta-sketch (``sketches`` stays 1); the SRHT sketches
    the new A again with the same S.  Both land on the reference's B and on
    the sketch of the updated A."""
    A, b = prob
    ref, ours, A_new = _update(A, kind, 11, np.array([2, 71, M_ROWS - 3]))
    assert ours.stats == ref.stats == {
        "sketches": sketches_after_update, "qr_factorizations": 2, "solves": 0,
    }
    _same_b(ours, ref, kind)
    fresh = ours._sketch_op.apply(torch.as_tensor(A_new))
    assert float((ours._B - fresh).norm() / fresh.norm()) < B_TOL.get(kind, 1e-12)
    assert torch.equal(ours.A.A, torch.as_tensor(A_new))
    res, r_ref = ours.solve(b), ref.solve(jnp.asarray(b))
    # a factor ~1e-7 apart (the Gaussian kind) may stop one step apart
    assert abs(int(res.itn) - int(r_ref.itn)) <= (2 if kind in B_TOL else 0)
    assert _rel(res.x, r_ref.x) < 1e-10
    assert _rel(res.x, qr_solve(A_new, b, device=CPU)) < 1e-8
    assert ours.certificate is None


def test_update_rows_srht_resketches_with_same_s(prob, monkeypatch):
    """The SRHT update applies the SAME operator to the whole new A: no new
    draw, one 2-D apply on (m, n)."""
    A, b = prob
    ref, ours = _pair(A, kind="srht", seed=7)
    op = ours._sketch_op
    shapes = []
    real = tsketch.SRHTSketch.apply

    def counting(self, M, *, backend="auto"):
        shapes.append((self is op, tuple(M.shape)))
        return real(self, M, backend=backend)

    monkeypatch.setattr(tsketch.SRHTSketch, "apply", counting)
    idx, rows = np.array([1, 2]), np.random.default_rng(8).standard_normal((2, N_COLS))
    ours.update_rows(idx, rows)
    ref.update_rows(jnp.asarray(idx), jnp.asarray(rows))
    assert shapes == [(True, (M_ROWS, N_COLS))] and ours._sketch_op is op
    assert ours.stats["sketches"] == 2
    _same_b(ours, ref, "srht")
    A_new = A.copy()
    A_new[idx] = rows
    assert _rel(ours.solve(b).x, qr_solve(A_new, b, device=CPU)) < 1e-8


def test_update_rows_accepts_tensors_and_negative_indices(prob):
    A, b = prob
    ref, ours = _pair(A, seed=14)
    rows = np.random.default_rng(14).standard_normal((2, N_COLS))
    ours.update_rows(torch.tensor([-1, 3], dtype=torch.int32), torch.as_tensor(rows))
    ref.update_rows(jnp.asarray([M_ROWS - 1, 3]), jnp.asarray(rows))
    _same_b(ours, ref, "countsketch")


def test_update_rows_validation(prob):
    A, b = prob
    ref, ours = _pair(A, seed=9)
    for idx, rows, msg in [
        ([0], np.zeros((2, N_COLS)), "rows must have shape"),
        ([3, 3], np.zeros((2, N_COLS)), "unique row indices"),
    ]:
        with pytest.raises(ValueError, match=msg) as e_ref:
            ref.update_rows(jnp.asarray(idx), jnp.asarray(rows))
        with pytest.raises(ValueError, match=msg) as e_ours:
            ours.update_rows(idx, rows)
        assert str(e_ours.value) == str(e_ref.value)
    # out of range: JAX would drop the write; the port refuses it
    with pytest.raises(ValueError, match="row indices must lie in"):
        ours.update_rows([M_ROWS], np.zeros((1, N_COLS)))
    with pytest.raises(ValueError, match="unique row indices"):
        ours.update_rows([-1, M_ROWS - 1], np.zeros((2, N_COLS)))  # one row twice
    assert ours.stats == {"sketches": 1, "qr_factorizations": 1, "solves": 0}


# --------------------------------------------------------------------------
# certificates and auto-recertification
# --------------------------------------------------------------------------


def _same_certificate(got, want):
    assert got._fields == want._fields
    for name, a, r in zip(got._fields, got, want):
        if name in ("sketch_rows", "escalations", "precision"):
            assert a == r, name
        elif name == "passed":
            assert bool(a) == bool(r)
        else:
            assert _relgap(a, r) < 1e-12, (name, float(a), float(r))


def test_certify_matches_reference(prob, monkeypatch):
    """The embedding-level certificate and one for a deliberately sloppy
    answer (the sketch-and-solve estimate: at a converged x̂ the gradient
    is rounding noise, which two libraries round apart), on the
    reference's probes."""
    A, b = prob
    ref, ours = _pair(A, seed=21)
    _Draws(ref, monkeypatch, tsketch.CountSketch)
    _same_certificate(ours.certify(), ref.certify())
    assert ours.certificate is not None and bool(ours.certificate.passed)
    r_ref = ref.solve(jnp.asarray(b))
    x_sloppy = ref.factor.sketch_and_solve(ref._sketch_op.apply(jnp.asarray(b)))
    sloppy_ref = r_ref._replace(x=x_sloppy)
    sloppy = ours.solve(b)._replace(x=_t(x_sloppy))
    c_ref = ref.certify(jnp.asarray(b), sloppy_ref, n_probes=4, target=1e-3)
    c = ours.certify(b, sloppy, n_probes=4, target=1e-3)
    _same_certificate(c, c_ref)
    assert math.isfinite(float(c.error_bound))
    with pytest.raises(ValueError, match="together"):
        ours.certify(b)
    with pytest.raises(ValueError, match="one right-hand side"):
        ours.certify(b, ours.solve_many(np.stack([b, b], axis=1)))


def test_auto_recertify_escalates_like_reference(prob, monkeypatch):
    """From n + 2 rows the drifted embedding fails its probe, and the
    session appends rows (stored B extended, never recomputed) until it
    certifies: the same escalations, certificates and stats as the
    reference's session on the same draws."""
    A, b = prob
    ref, ours = _pair(A, seed=31, sketch_size=N_COLS + 2, auto_recertify=True)
    _Draws(ref, monkeypatch, tsketch.CountSketch)
    idx = np.arange(0, M_ROWS, 150)
    rows = np.random.default_rng(31).standard_normal((len(idx), N_COLS))
    ref.update_rows(jnp.asarray(idx), jnp.asarray(rows))
    ours.update_rows(idx, rows)
    assert ours.escalations == ref.escalations >= 1
    assert ours.recertifications == ref.recertifications == ours.escalations + 1
    assert ours.sketch_size == ref.sketch_size > N_COLS + 2
    assert ours.stats == ref.stats
    _same_certificate(ours.certificate, ref.certificate)
    assert bool(ours.certificate.passed)
    assert float((ours._B - _t(ref._B)).norm() / _t(ref._B).norm()) < 1e-12
    A_new = A.copy()
    A_new[idx] = rows
    assert _rel(ours.solve(b).x, qr_solve(A_new, b, device=CPU)) < 1e-8


def test_escalation_reuses_stored_sketch(prob):
    """An escalation sketches only the appended block: the top of the new
    B is the old B times its weight, bitwise."""
    A, _ = prob
    _, ours = _pair(A, seed=41, sketch_size=N_COLS + 2)
    B_old = ours._B.clone()
    ours._escalate(N_COLS + 2)
    op = ours._sketch_op
    assert torch.equal(ours._B[: B_old.shape[0]], op.w_top * B_old)
    assert ours.stats["sketches"] == 2 and ours.stats["qr_factorizations"] == 2
    assert ours.sketch_size == op.d == 2 * (N_COLS + 2) and ours.escalations == 1


# --------------------------------------------------------------------------
# metrics, spans, and what this slice does not take
# --------------------------------------------------------------------------


def test_stats_mirror_into_the_registry(prob):
    A, b = prob
    REGISTRY.reset()
    s1 = SketchedSolver(A, 1, device=CPU)
    s2 = SketchedSolver(A, 2, device=CPU, sketch="srht")
    s1.solve(b)
    s2.solve_many(np.stack([b, b], axis=1))
    s2.update_rows([0], A[:1] * 2)
    lines = prometheus_text().splitlines()
    for key in ("sketches", "qr_factorizations", "solves"):
        total = s1.stats[key] + s2.stats[key]
        assert f"repro_session_{key} {total}" in lines


def test_session_spans(prob):
    from repro_torch.obs import trace as obs_trace

    A, b = prob
    obs_trace.disable()
    with obs_trace.tracing() as tr:
        s = SketchedSolver(A, 1, device=CPU)
        s.solve(b)
        s.solve_many(np.stack([b, b], axis=1))
        s.update_rows([5], A[:1])
        s.certify()
    names = [e["name"] for e in tr.events if e["ph"] == "X"]
    assert names == [
        "sketch.apply", "factor.qr", "session.build", "session.solve", "session.solve_many",
        "factor.qr", "session.update_rows", "certify.probe", "session.certify",
    ]
    solve = next(e for e in tr.events if e["name"] == "session.solve")
    assert solve["args"]["itn"] >= 1
    assert not obs_trace.enabled()


def test_unported_inputs_raise_naming_a8(prob):
    A, b = prob
    with pytest.raises(NotImplementedError, match="A8"):
        SketchedSolver(A, 0, reg=0.8, device=CPU)
    with pytest.raises(NotImplementedError, match="A8"):
        SketchedSolver(torch.as_tensor(A).to_sparse(), 0, device=CPU)

    class _MatrixFree:
        shape = (M_ROWS, N_COLS)

        def matvec(self, v):
            return A @ v

        def rmatvec(self, u):
            return A.T @ u

    with pytest.raises(NotImplementedError, match="A8"):
        SketchedSolver(_MatrixFree(), 0, device=CPU)


def test_shape_and_every_kind_builds(prob):
    A, b = prob
    for kind in KINDS:
        ref, ours = _pair(A, kind=kind, seed=51)
        assert ours.shape == (M_ROWS, N_COLS) and ours.sketch_size == ref.sketch_size
        _same_b(ours, ref, kind)
