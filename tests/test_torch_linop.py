"""Port parity: the operator protocol (``repro_torch.core.linop``) against
the JAX reference's ``repro.core.linop``, for the dense, sparse and custom
forms of one matrix.

One (2000, 32) A with ~5% nonzeros and a unit diagonal block (full rank),
made from a numpy seed, exactly representable in each form.  The sparse
forms are a torch COO, CSR or CSC tensor and the reference's BCOO carried
across (``convert.sparse_from_reference``); the custom form is a
``CustomOperator`` of the closures A @ v and Aᵀ @ u.

Tolerances:
- products: within 1e-12 of numpy's A @ x and of the reference operator's
  products (sums of ≤ 2000 terms of size ≤ 4);
- ``materialize``: the dense form is A itself; the sparse forms bitwise A;
- ``TikhonovAugmented``: products within 1e-12 of the materialized
  [A; √λI] and of the reference's; √λ bitwise ``np.sqrt(λ)``;
- ``estimate_2norm``: within 1e-2 relative of ``np.linalg.norm(A, 2)``
  (ground truth: the reference's own test of this fails at the seed,
  ROADMAP §C), for every form;
- sparse products: two calls bitwise equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.sparse import BCOO  # noqa: E402

from repro.core import linop as jlinop  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import linop  # noqa: E402
from repro_torch.core.linop import (  # noqa: E402
    CustomOperator,
    DenseOperator,
    SparseOperator,
    TikhonovAugmented,
    as_operator,
    ensure_dense,
    estimate_2norm,
)

CPU = "cpu"
M_ROWS, N_COLS = 2000, 32
FORMS = ["dense", "coo", "csr", "csc", "bcoo", "custom", "duck"]
TOL = 1e-12


@pytest.fixture(scope="module")
def A():
    rng = np.random.default_rng(0)
    A = np.where(rng.random((M_ROWS, N_COLS)) < 0.05, rng.standard_normal((M_ROWS, N_COLS)), 0.0)
    A[np.arange(N_COLS), np.arange(N_COLS)] += 1.0
    return A


class _Duck:
    """A SciPy-style operator: matvec, rmatvec, shape, dtype (numpy's)."""

    def __init__(self, A, with_dtype=True):
        self._A = torch.as_tensor(A)
        self.shape = A.shape
        if with_dtype:
            self.dtype = np.float64
            self.device = CPU

    def matvec(self, v):
        return self._A @ v

    def rmatvec(self, u):
        return self._A.T @ u


def _custom(A):
    At = torch.as_tensor(A)
    return CustomOperator(lambda v: At @ v, lambda u: At.T @ u, A.shape, torch.float64, CPU)


def _form(A, name):
    At = torch.as_tensor(A)
    if name == "dense":
        return as_operator(A, device=CPU)
    if name == "coo":
        return as_operator(At.to_sparse(), device=CPU)
    if name == "csr":
        return as_operator(At.to_sparse_csr(), device=CPU)
    if name == "csc":
        return as_operator(At.to_sparse_csc(), device=CPU)
    if name == "bcoo":
        M = BCOO.fromdense(jnp.asarray(A))
        return convert.sparse_from_reference(M.indices, M.data, A.shape, device=CPU)
    if name == "custom":
        return _custom(A)
    return as_operator(_Duck(A), device=CPU)


def _probes():
    rng = np.random.default_rng(1)
    return (rng.standard_normal(N_COLS), rng.standard_normal(M_ROWS),
            rng.standard_normal((N_COLS, 3)), rng.standard_normal((M_ROWS, 2)))


@pytest.mark.parametrize("form", FORMS)
def test_operator_products_match_dense_and_reference(A, form):
    op = _form(A, form)
    jop = jlinop.as_operator(jnp.asarray(A))
    assert op.shape == (M_ROWS, N_COLS) and op.dtype == torch.float64
    assert op.device == torch.device(CPU)
    for fn, arg, want in zip(
        ("matvec", "rmatvec", "matmat", "rmatmat"), _probes(),
        (A @ _probes()[0], A.T @ _probes()[1], A @ _probes()[2], A.T @ _probes()[3]),
    ):
        got = getattr(op, fn)(torch.as_tensor(arg)).numpy()
        assert np.abs(got - want).max() < TOL, (form, fn)
        ref = np.asarray(getattr(jop, fn)(jnp.asarray(arg)))
        assert np.abs(got - ref).max() < TOL, (form, fn)
    x = torch.as_tensor(_probes()[0])
    assert np.abs((op @ x).numpy() - A @ _probes()[0]).max() < TOL


@pytest.mark.parametrize("form", ["coo", "csr", "bcoo"])
def test_sparse_products_are_bitwise_repeatable(A, form):
    op = _form(A, form)
    x, u, X, U = (torch.as_tensor(a) for a in _probes())
    assert torch.equal(op.matvec(x), op.matvec(x))
    assert torch.equal(op.rmatvec(u), op.rmatvec(u))
    assert torch.equal(op.matmat(X), op.matmat(X))
    assert torch.equal(op.rmatmat(U), op.rmatmat(U))


def test_sparse_keeps_entries_in_order_with_duplicates():
    """The entries stay in the caller's order, repeats included; the CSRs
    sum the repeats; materialize() is the sequential sum."""
    rows = np.array([2, 0, 2, 1, 2, 0])
    cols = np.array([1, 0, 1, 2, 1, 2])
    vals = np.array([0.1, 1.0, 0.2, 3.0, 0.3, -2.0])
    op = SparseOperator.from_entries(rows, cols, vals, (3, 3), device=CPU)
    assert op.nse == 6
    assert np.array_equal(op.rows.numpy(), rows) and np.array_equal(op.vals.numpy(), vals)
    want = np.zeros((3, 3))
    np.add.at(want, (rows, cols), vals)
    assert np.array_equal(op.materialize().numpy(), want)
    assert op.csr.val.numel() == 4 and op.csr_t.val.numel() == 4
    x = torch.tensor([1.0, 2.0, 3.0], dtype=torch.float64)
    assert np.abs(op.matvec(x).numpy() - want @ x.numpy()).max() < TOL
    assert np.abs(op.rmatvec(x).numpy() - want.T @ x.numpy()).max() < TOL


def test_sparse_from_reference_keeps_the_bcoo_order():
    idx = np.array([[3, 1], [0, 0], [3, 1], [1, 2]])
    data = np.array([1.5, -1.0, 2.0, 4.0])
    M = BCOO((jnp.asarray(data), jnp.asarray(idx)), shape=(4, 3))
    op = convert.sparse_from_reference(M.indices, M.data, M.shape, device=CPU)
    assert np.array_equal(op.rows.numpy(), idx[:, 0]) and np.array_equal(op.cols.numpy(), idx[:, 1])
    assert np.array_equal(op.vals.numpy(), data)
    x = np.array([1.0, -2.0, 0.5])
    assert np.abs(op.matvec(torch.as_tensor(x)).numpy() - np.asarray(M @ jnp.asarray(x))).max() < TOL
    with pytest.raises(ValueError):
        convert.sparse_from_reference(idx[:, :1], data, (4, 3), device=CPU)


def test_sparse_operator_rejects_bad_entries():
    with pytest.raises(ValueError, match="lie in"):
        SparseOperator.from_entries([0, 5], [0, 0], [1.0, 2.0], (3, 3), device=CPU)
    with pytest.raises(ValueError, match="one length"):
        SparseOperator.from_entries([0, 1], [0], [1.0, 2.0], (3, 3), device=CPU)
    with pytest.raises(TypeError, match="floating"):
        SparseOperator.from_entries([0], [0], np.array([1]), (3, 3), device=CPU)
    hybrid = torch.sparse_coo_tensor(torch.tensor([[0, 1]]), torch.ones(2, 2), (2, 2))
    with pytest.raises(ValueError, match="2-D sparse"):
        as_operator(hybrid, device=CPU)


def test_materialize(A):
    At = torch.as_tensor(A)
    assert as_operator(At, device=CPU).materialize() is At  # no copy
    for form in ("coo", "csr", "csc", "bcoo"):
        assert np.array_equal(_form(A, form).materialize().numpy(), A), form
    op = _custom(A)
    assert not op.materializable
    with pytest.raises(TypeError, match="materialized"):
        op.materialize()
    mat = CustomOperator(lambda v: At @ v, lambda u: At.T @ u, A.shape, torch.float64, CPU,
                         materialize_fn=lambda: At)
    assert mat.materializable and mat.materialize() is At


def test_as_operator_coercion(A):
    op = as_operator(A, device=CPU)
    assert isinstance(op, DenseOperator)
    assert as_operator(op) is op  # idempotent
    for form in ("coo", "csr", "csc"):
        assert isinstance(_form(A, form), SparseOperator), form
    duck = as_operator(_Duck(A), device=CPU)
    assert isinstance(duck, CustomOperator) and duck.dtype == torch.float64
    assert duck.device == torch.device(CPU) and not duck.materializable
    with pytest.raises(TypeError, match="dtype"):
        as_operator(_Duck(A, with_dtype=False), device=CPU)
    with pytest.raises(ValueError, match="2-D"):
        as_operator(np.ones(5), device=CPU)


@pytest.mark.parametrize("core", ["dense", "bcoo", "custom"])
def test_tikhonov_augmented(A, core):
    lam = 0.3
    t = TikhonovAugmented.wrap(_form(A, core), lam, device=CPU)
    jt = jlinop.TikhonovAugmented.wrap(jnp.asarray(A), lam)
    assert t.shape == (M_ROWS + N_COLS, N_COLS) and t.dtype == torch.float64
    assert t.reg.ndim == 0 and t.reg.dtype == torch.float64 and t.reg.device == torch.device(CPU)
    assert float(t.sqrt_reg) == float(np.sqrt(np.float64(lam)))
    Ad = np.concatenate([A, np.sqrt(lam) * np.eye(N_COLS)])
    rng = np.random.default_rng(5)
    x, u = rng.standard_normal(N_COLS), rng.standard_normal(M_ROWS + N_COLS)
    X, U = rng.standard_normal((N_COLS, 2)), rng.standard_normal((M_ROWS + N_COLS, 3))
    for fn, arg, want in (("matvec", x, Ad @ x), ("rmatvec", u, Ad.T @ u),
                          ("matmat", X, Ad @ X), ("rmatmat", U, Ad.T @ U)):
        got = getattr(t, fn)(torch.as_tensor(arg)).numpy()
        assert np.abs(got - want).max() < TOL, (core, fn)
        assert np.abs(got - np.asarray(getattr(jt, fn)(jnp.asarray(arg)))).max() < TOL, (core, fn)
    b = rng.standard_normal(M_ROWS)
    assert np.array_equal(t.augment_rhs(torch.as_tensor(b)).numpy(), np.concatenate([b, np.zeros(N_COLS)]))
    B = torch.as_tensor(rng.standard_normal((M_ROWS, 2)))
    assert t.augment_rhs(B).shape == (M_ROWS + N_COLS, 2)
    if core == "custom":
        assert not t.materializable
    else:
        assert np.abs(t.materialize().numpy() - np.asarray(jt.materialize())).max() == 0.0


def test_ensure_dense(A):
    At = torch.as_tensor(A)
    assert ensure_dense(At, device=CPU) is At
    assert np.array_equal(ensure_dense(_form(A, "csr")).numpy(), A)
    with pytest.raises(TypeError, match="materializable"):
        ensure_dense(_custom(A), who="test")


@pytest.mark.parametrize("form", FORMS)
def test_estimate_2norm_every_form_against_numpy(A, form):
    true = float(np.linalg.norm(A, 2))
    est = float(estimate_2norm(_form(A, form), 7))
    assert est == pytest.approx(true, rel=1e-2), form


def test_estimate_2norm_raw_array(A):
    assert float(estimate_2norm(A, 7, device=CPU)) == pytest.approx(
        float(np.linalg.norm(A, 2)), rel=1e-2
    )


def test_custom_blocked_products_are_one_vmapped_call(A):
    """matmat/rmatmat batch the closures with torch.vmap: one call of the
    callable for the whole block, not one per column."""
    At = torch.as_tensor(A)
    calls = {"mv": 0, "rmv": 0}

    def mv(v):
        calls["mv"] += 1
        return At @ v

    def rmv(u):
        calls["rmv"] += 1
        return At.T @ u

    op = CustomOperator(mv, rmv, A.shape, torch.float64, CPU)
    X = torch.as_tensor(np.random.default_rng(2).standard_normal((N_COLS, 6)))
    U = torch.as_tensor(np.random.default_rng(3).standard_normal((M_ROWS, 5)))
    assert np.abs(op.matmat(X).numpy() - A @ X.numpy()).max() < TOL
    assert np.abs(op.rmatmat(U).numpy() - A.T @ U.numpy()).max() < TOL
    assert calls == {"mv": 1, "rmv": 1}


def test_custom_callable_vmap_cannot_batch_raises(A):
    """A callable that leaves tensor code raises under matmat instead of
    running column by column."""
    At = torch.as_tensor(A)

    def mv(v):
        if float(v.sum().item()) > 1e300:  # data-dependent host read
            return v
        return At @ v

    op = CustomOperator(mv, lambda u: At.T @ u, A.shape, torch.float64, CPU)
    assert op.matvec(torch.ones(N_COLS, dtype=torch.float64)).shape == (M_ROWS,)
    with pytest.raises(RuntimeError):
        op.matmat(torch.ones(N_COLS, 2, dtype=torch.float64))


def test_reference_exports_match(A):
    """The port's linop exports the reference's public names."""
    for name in jlinop.__all__:
        assert hasattr(linop, name), name
    assert jax.numpy.asarray(A).shape == (M_ROWS, N_COLS)
