"""Port parity: sparse and matrix-free inputs through the sketches and every
solver, and the bucket sketches' coordinate scatter, against the JAX
reference on the same S.

The reference draws S; ``repro_torch.convert`` carries it across, and a
BCOO's entries (``sparse_from_reference``), in their order and with their
repeated coordinates.

Tolerances:
- the coordinate scatter's plain version ``countsketch_coo_ref``:
  **bitwise** a sequential numpy scatter (``np.add.at``) in the
  reference's j-major, entry-order ravel; **bitwise** the reference's
  ``_apply_bcoo`` for the CountSketch and the uniform-sparse sketch (XLA's
  CPU scatter adds in that order too) and for the sparse-sign sketch, each
  checked also within 2·γ_K·|S||A| (K = the most products in one cell);
- the kernel's order, emulated on the CPU from ``countsketch_coo_plan``
  (bucket by bucket, each bucket's products in plan order into per-column
  sums, each product rounded on its own): **bitwise** the plain version,
  for k = 1 and 8, on row-ordered entries (the plan by row: B1's bucket
  CSR and a row pointer, no sort over the entries), on shuffled entries
  with repeated coordinates (the plan by product), nnz = 0 and a vector;
- ``apply_op`` for every kind on every form: within 1e-12 of the
  reference's on the converted S (a Gaussian S within 3 f32 ulps of the
  reference's, so 1e-6 there); the bucket kinds on a sparse A bitwise;
- solvers: x within 1e-6 of ``qr_solve``'s for every solver and form, as
  ``tests/test_linop.py:189``; the sparse and custom forms within 1e-8 of
  the port's dense path with the same seed; ``saa`` on the reference's S
  within 1e-10 of the reference's x;
- ``extend_sketch`` on a sparse A: bitwise a fresh ``apply_op``.
"""
import dataclasses
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.sparse import BCOO  # noqa: E402

from repro.core import lstsq as j_lstsq  # noqa: E402
from repro.core import qr_solve as j_qr  # noqa: E402
from repro.core import sketch as jsketch  # noqa: E402
from repro.core.precond import default_sketch_size  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import (  # noqa: E402
    CustomOperator,
    SketchedSolver,
    StackedSketch,
    TikhonovAugmented,
    lstsq,
    select_method,
)
from repro_torch.core import sketch as tsketch  # noqa: E402
from repro_torch.core.linop import SparseOperator  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    _build,
    countsketch_coo_apply,
    countsketch_coo_plan,
    countsketch_coo_ref,
    countsketch_csr,
)
from repro_torch.kernels.countsketch import ops as cs_ops  # noqa: E402

CPU = "cpu"
KINDS = ["clarkson_woodruff", "sparse_sign", "uniform_sparse", "gaussian", "uniform_dense", "srht"]
BUCKETS = ["clarkson_woodruff", "sparse_sign", "uniform_sparse"]
M_ROWS, N_COLS = 2000, 32


def _gamma(k, dtype=torch.float64):
    u = torch.finfo(dtype).eps / 2
    return k * u / (1 - k * u)


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


def _weights(op):
    return op.values if isinstance(op, jsketch.UniformSparseSketch) else op.signs


def _entries(seed, m, n, nnz, dup=0.2):
    """Unsorted entries of an (m, n) sparse matrix, a share of them on
    repeated coordinates, as numpy arrays; and the BCOO holding them."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, m, nnz)
    cols = rng.integers(0, n, nnz)
    rep = rng.integers(0, nnz, int(dup * nnz))
    rows, cols = np.concatenate([rows, rows[rep]]), np.concatenate([cols, cols[rep]])
    vals = rng.standard_normal(rows.size)
    M = BCOO((jnp.asarray(vals), jnp.asarray(np.stack([rows, cols], 1))), shape=(m, n))
    return rows, cols, vals, M


@pytest.fixture(scope="module")
def prob():
    """The sparse-patterned problem of tests/test_linop.py, from a numpy
    seed: dense, BCOO-carried and custom forms of one A."""
    rng = np.random.default_rng(0)
    A = np.where(rng.random((M_ROWS, N_COLS)) < 0.05, rng.standard_normal((M_ROWS, N_COLS)), 0.0)
    A[np.arange(N_COLS), np.arange(N_COLS)] += 1.0
    x_true = np.arange(1.0, N_COLS + 1.0)
    b = A @ x_true + 1e-9 * rng.standard_normal(M_ROWS)
    return A, b, np.asarray(j_qr(jnp.asarray(A), jnp.asarray(b)))


def _forms(A):
    At = torch.as_tensor(A)
    M = BCOO.fromdense(jnp.asarray(A))
    return {
        "sparse": convert.sparse_from_reference(M.indices, M.data, A.shape, device=CPU),
        "csr": At.to_sparse_csr(),
        "custom": CustomOperator(lambda v: At @ v, lambda u: At.T @ u, A.shape, torch.float64, CPU),
    }


# ------------------------------------------------------ coordinate scatter


@pytest.mark.parametrize("kind", BUCKETS)
@pytest.mark.parametrize("seed", [0, 1])
def test_coo_ref_is_the_sequential_scatter(kind, seed):
    m, n, d = 500, 23, 40
    rows, cols, vals, _ = _entries(seed, m, n, 1500)
    op = jsketch.sample(kind, jax.random.key(seed), d, m)
    h, w = np.asarray(op.buckets).reshape(-1, m), np.asarray(_weights(op)).reshape(-1, m)
    want = np.zeros(d * n)
    np.add.at(want, (h[:, rows] * n + cols).ravel(), (w[:, rows] * vals).ravel())
    got = countsketch_coo_ref(
        torch.as_tensor(rows), torch.as_tensor(cols), torch.as_tensor(vals), (m, n),
        torch.as_tensor(np.asarray(op.buckets)), torch.as_tensor(np.asarray(_weights(op))), d,
    )
    assert np.array_equal(got.numpy().ravel(), want)


@pytest.mark.parametrize("kind", BUCKETS)
def test_apply_bcoo_matches_reference(kind):
    m, n, d = 600, 17, 48
    rows, cols, vals, M = _entries(3, m, n, 2400)
    jop = jsketch.sample(kind, jax.random.key(4), d, m)
    top = _convert(jop)
    sp = convert.sparse_from_reference(M.indices, M.data, M.shape, device=CPU)
    want = np.asarray(jop._apply_bcoo(M))
    got = top._apply_bcoo(sp).numpy()
    assert np.array_equal(got, want), kind
    # and within 2·γ_K·|S||A| whatever XLA's order
    h = np.asarray(jop.buckets).reshape(-1, m)
    keys = (h[:, rows] * n + cols).ravel()
    K = int(np.bincount(keys, minlength=d * n).max())
    absw = np.abs(np.asarray(_weights(jop))).reshape(-1, m)
    mag = np.zeros(d * n)
    np.add.at(mag, keys, (absw[:, rows] * np.abs(vals)).ravel())
    assert (np.abs(got - want).ravel() <= 2 * _gamma(K) * mag).all()
    # the reference backend runs the same plain version
    assert np.array_equal(top._apply_bcoo(sp, backend="reference").numpy(), got)


def _walk(plan, rows, cols, vals, weights, n, d):
    """The kernel's order on the CPU: (cell, product) of every product,
    bucket by bucket, each bucket's products in plan order (one warp a
    bucket adds its batch's products to a column in lane order, so each
    cell sums its products in this order)."""
    bucket_of = torch.repeat_interleave(torch.arange(d), plan.offsets.diff())  # of each item
    if plan.rowptr is not None:
        r = plan.items.long()
        span = plan.rowptr[r + 1] - plan.rowptr[r]
        item = torch.repeat_interleave(torch.arange(r.numel()), span)
        first = torch.cumsum(span, 0) - span
        e = plan.rowptr[r][item] + torch.arange(item.numel()) - first[item]
        prod = plan.weights[item] * vals[e]
        return (bucket_of[item] * n + cols[e]).numpy(), prod.numpy()
    nnz = vals.numel()
    j, e = plan.items // nnz, plan.items % nnz
    m = weights.shape[-1]
    prod = weights.reshape(-1, m).to(vals.dtype)[j, rows[e]] * vals[e]
    return (bucket_of * n + cols[e]).numpy(), prod.numpy()


def _emulate(plan, rows, cols, vals, weights, n, d):
    cell, prod = _walk(plan, rows, cols, vals, weights, n, d)
    out = np.zeros(d * n, dtype=prod.dtype)
    np.add.at(out, cell, prod)  # sequential, in the walk's order
    return out


def _row_ordered(rows, cols, vals):
    """The same entries in row order, each row's in their given order (a
    stable sort by row: what a coalesced COO or a CSR hands over)."""
    order = np.argsort(rows, kind="stable")
    return rows[order], cols[order], vals[order]


@pytest.mark.parametrize("kind", BUCKETS)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernel_order_emulated_is_bitwise_the_plain_version(kind, dtype):
    """Shuffled entries with repeated coordinates: the plan by product (a
    stable sort of the k·nnz products by bucket), walked bucket by bucket,
    is bitwise the plain version."""
    m, n, d = 400, 19, 32
    rows, cols, vals, _ = _entries(5, m, n, 1200)
    top = _convert(jsketch.sample(kind, jax.random.key(6), d, m))
    rows_t, cols_t, vals_t = torch.as_tensor(rows), torch.as_tensor(cols), torch.as_tensor(vals).to(dtype)
    h, w = top.buckets, top._weights()
    plan = countsketch_coo_plan(rows_t, h, w, d, dtype)
    nnz = rows.size
    k = h.numel() // m
    assert plan.rowptr is None and plan.weights is None
    assert plan.items.shape == (k * nnz,) and plan.offsets.shape == (d + 1,)
    assert torch.equal(torch.sort(plan.items).values, torch.arange(k * nnz))  # every product once
    emulated = _emulate(plan, rows_t, cols_t, vals_t, w, n, d)
    plain = countsketch_coo_ref(rows_t, cols_t, vals_t, (m, n), h, w, d)
    assert np.array_equal(emulated, plain.numpy().ravel())


@pytest.mark.parametrize("kind", BUCKETS)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_bucket_plan_by_row_is_bitwise_the_plain_version(kind, dtype):
    """Entries in row order, repeated coordinates included: the plan is B1's
    bucket CSR and a row pointer (nothing sorted over the entries), and its
    walk is bitwise the plain version."""
    m, n, d = 400, 19, 32
    rows, cols, vals = _row_ordered(*_entries(11, m, n, 1200)[:3])
    top = _convert(jsketch.sample(kind, jax.random.key(12), d, m))
    rows_t, cols_t, vals_t = torch.as_tensor(rows), torch.as_tensor(cols), torch.as_tensor(vals).to(dtype)
    h, w = top.buckets, top._weights()
    plan = countsketch_coo_plan(rows_t, h, w, d, dtype)
    csr = countsketch_csr(h, w, d, dtype)
    assert plan.rowptr is not None and plan.rowptr.shape == (m + 1,) and int(plan.rowptr[-1]) == rows.size
    assert torch.equal(plan.items, csr.rows) and torch.equal(plan.weights, csr.signs)
    assert torch.equal(plan.offsets, csr.offsets)
    emulated = _emulate(plan, rows_t, cols_t, vals_t, w, n, d)
    plain = countsketch_coo_ref(rows_t, cols_t, vals_t, (m, n), h, w, d)
    assert np.array_equal(emulated, plain.numpy().ravel())
    # the same entries shuffled give the plan by product, and its walk the same bits
    order = np.random.default_rng(13).permutation(rows.size)
    shuffled = [torch.as_tensor(a[order]) for a in (rows, cols)] + [vals_t[torch.as_tensor(order)]]
    plan_p = countsketch_coo_plan(shuffled[0], h, w, d, dtype)
    assert plan_p.rowptr is None
    assert np.array_equal(_emulate(plan_p, *shuffled, w, n, d),
                          countsketch_coo_ref(*shuffled, (m, n), h, w, d).numpy().ravel())


@pytest.mark.parametrize("kind", BUCKETS)
@pytest.mark.parametrize("edge", ["nnz0", "vector_by_row", "vector_shuffled"])
def test_bucket_plan_edges_are_bitwise_the_plain_version(kind, edge):
    m, d = 300, 24
    top = _convert(jsketch.sample(kind, jax.random.key(14), d, m))
    h, w = top.buckets, top._weights()
    rng = np.random.default_rng(15)
    if edge == "nnz0":
        rows, n = np.zeros(0, dtype=np.int64), 7
    else:
        rows, n = rng.permutation(m)[: m // 3], 1
        if edge == "vector_by_row":
            rows = np.sort(rows)
    rows_t = torch.as_tensor(rows)
    cols_t = torch.zeros_like(rows_t) if n == 1 else torch.as_tensor(rng.integers(0, n, rows.size))
    vals_t = torch.as_tensor(rng.standard_normal(rows.size))
    plan = countsketch_coo_plan(rows_t, h, w, d, torch.float64)
    assert (plan.rowptr is None) == (edge == "vector_shuffled")
    shape = (m, n) if n > 1 else (m,)
    plain = countsketch_coo_ref(rows_t, cols_t, vals_t, shape, h, w, d)
    assert np.array_equal(_emulate(plan, rows_t, cols_t, vals_t, w, n, d), plain.numpy().ravel())
    if edge == "nnz0":
        assert not plain.any()


def test_sparse_operator_caches_its_row_pointer():
    rows, cols, vals = _row_ordered(*_entries(16, 50, 6, 200)[:3])
    A = SparseOperator.from_entries(rows, cols, vals, (50, 6), device=CPU)
    ptr = A.row_pointer()
    assert ptr is A.row_pointer()  # built once
    assert torch.equal(ptr.diff(), torch.bincount(torch.as_tensor(rows), minlength=50))
    shuffled = SparseOperator.from_entries(rows[::-1].copy(), cols[::-1].copy(), vals[::-1].copy(), (50, 6),
                                           device=CPU)
    assert shuffled.row_pointer() is None
    assert A == dataclasses.replace(A)  # the cache takes no part in equality


def test_coo_apply_on_the_cpu_is_its_plain_version():
    m, n, d = 300, 9, 20
    rows, cols, vals, _ = _entries(7, m, n, 700)
    op = _convert(jsketch.sample("sparse_sign", jax.random.key(8), d, m))
    args = (torch.as_tensor(rows), torch.as_tensor(cols), torch.as_tensor(vals))
    out = countsketch_coo_apply(*args, (m, n), op.buckets, op.signs, d)
    assert torch.equal(out, countsketch_coo_ref(*args, (m, n), op.buckets, op.signs, d))
    # a sparse vector b (cols all 0), and nnz = 0
    vec = countsketch_coo_apply(args[0], torch.zeros_like(args[1]), args[2], (m,), op.buckets, op.signs, d)
    assert vec.shape == (d,)
    assert torch.equal(vec, countsketch_coo_ref(args[0], torch.zeros_like(args[1]), args[2], (m,),
                                                op.buckets, op.signs, d))
    empty = countsketch_coo_apply(args[0][:0], args[1][:0], args[2][:0], (m, n), op.buckets, op.signs, d)
    assert empty.shape == (d, n) and not bool(empty.any())


def test_coo_apply_checks_its_arguments():
    h = torch.zeros(10, dtype=torch.int32)
    w = torch.ones(10, dtype=torch.float64)
    r = torch.zeros(4, dtype=torch.int64)
    v = torch.ones(4, dtype=torch.float64)
    with pytest.raises(TypeError):
        countsketch_coo_apply(r.to(torch.int32), r, v, (10, 3), h, w, 5)
    with pytest.raises(ValueError):
        countsketch_coo_apply(r[:3], r, v, (10, 3), h, w, 5)
    with pytest.raises(ValueError):
        countsketch_coo_apply(r, r, v, (9, 3), h, w, 5)
    with pytest.raises(ValueError):
        countsketch_coo_apply(r, r, v, (10, 3, 1), h, w, 5)
    meta = dict(device="meta")
    with pytest.raises(ValueError):
        countsketch_coo_apply(r.to(**meta), r.to(**meta), v.to(**meta), (10, 3), h.to(**meta), w.to(**meta), 5)


class _Lib:
    def __init__(self):
        self.calls = {}

    def __getattr__(self, name):
        if not name.startswith("repro_"):
            raise AttributeError(name)

        def record(*args):
            self.calls[name] = args
            return 0

        return record


def _c_args(name):
    src = (_build.CSRC / "countsketch.cu").read_text()
    match = re.search(rf'extern "C" int {name}\(([^)]*)\)', src)
    return [a.strip() for a in match.group(1).split(",")]


@pytest.mark.parametrize("k,shape", [(1, (300, 7)), (8, (300, 7)), (1, (300,))])
@pytest.mark.parametrize("order", ["shuffled", "by_row"])
def test_coo_launch_hands_the_c_entry_its_arguments(monkeypatch, k, shape, order):
    """The CUDA branch, run on CPU tensors against a recording library: its
    argument list has the C entry's length, its sizes are d, n, nnz, m, and
    the plan's form decides the pointers: by row the CSR's rows and weights
    and the row pointer, and no (k, m) weights; by product the ids and the
    weights, and no row pointer.  Rows, columns and buckets out of range,
    and a given plan's row pointer that does not cover the entries, raise
    before the launch."""
    import contextlib

    lib = _Lib()
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    m, d = shape[0], 16
    n = shape[1] if len(shape) == 2 else 1
    rows, cols, vals, _ = _entries(9, m, n, 500)
    if order == "by_row":
        rows, cols, vals = _row_ordered(rows, cols, vals)
    h = torch.randint(0, d, (k, m) if k > 1 else (m,), dtype=torch.int32)
    w = torch.ones(h.shape, dtype=torch.float64)
    before = countsketch_coo_apply.launches
    out = cs_ops._coo_launch(torch.as_tensor(rows), torch.as_tensor(cols), torch.as_tensor(vals),
                             shape, h, w, d, None)
    args = lib.calls["repro_coo_scatter"]
    assert len(args) == len(_build._SIGNATURES["repro_coo_scatter"]) == len(_c_args("repro_coo_scatter"))
    assert args[0] == _build.dtype_code(torch.float64)
    assert args[10:14] == (d, n, rows.size, m)
    by_row = order == "by_row"
    assert (args[3] is not None, args[4] is not None, args[8] is not None) == (by_row, by_row, not by_row)
    assert out.shape == ((d, n) if len(shape) == 2 else (d,))
    assert countsketch_coo_apply.launches == before + 1
    with pytest.raises(TypeError):
        cs_ops._coo_launch(torch.as_tensor(rows), torch.as_tensor(cols),
                           torch.as_tensor(vals).to(torch.bfloat16), shape, h, w, d, None)
    bad = torch.as_tensor(rows).clone()
    bad[0] = m  # a row out of range never reaches the kernel
    with pytest.raises(ValueError, match="rows"):
        cs_ops._coo_launch(bad, torch.as_tensor(cols), torch.as_tensor(vals), shape, h, w, d, None)
    with pytest.raises(ValueError, match="buckets"):
        cs_ops._coo_launch(torch.as_tensor(rows), torch.as_tensor(cols), torch.as_tensor(vals),
                           shape, h, w, int(h.max()), None)
    # a plan of other entries or another dtype is refused
    other = countsketch_coo_plan(torch.as_tensor(rows[:-1]), h, w, d, torch.float64)
    with pytest.raises(ValueError, match="plan"):
        cs_ops._coo_launch(torch.as_tensor(rows), torch.as_tensor(cols), torch.as_tensor(vals),
                           shape, h, w, d, other)
    f32 = countsketch_coo_plan(torch.as_tensor(rows), h, w, d, torch.float32)
    if by_row:
        with pytest.raises(ValueError, match="plan weights"):
            cs_ops._coo_launch(torch.as_tensor(rows), torch.as_tensor(cols), torch.as_tensor(vals),
                               shape, h, w, d, f32)


def test_coo_scatter_signature_types():
    c = _c_args("repro_coo_scatter")
    kinds = {"int": "_I", "const void*": "_P", "void*": "_P", "int64_t": "_I64"}
    ctypes_names = {v: k for k, v in vars(_build).items() if k in ("_I", "_P", "_I64")}
    want = [ctypes_names[t] for t in _build._SIGNATURES["repro_coo_scatter"]]
    got = [kinds[" ".join(a.split()[:-1])] for a in c]
    assert got == want


# ------------------------------------------------------- sketch × operator


def _ref_form(A, name, lam=0.5):
    from repro.core import linop as jlinop

    Aj = jnp.asarray(A)
    if name == "sparse":
        return BCOO.fromdense(Aj)
    if name == "custom":
        return jlinop.CustomOperator(lambda v: Aj @ v, lambda u: Aj.T @ u, A.shape, Aj.dtype)
    if name == "tikhonov":
        return jlinop.TikhonovAugmented.wrap(Aj, lam)
    if name == "tikhonov_custom":
        return jlinop.TikhonovAugmented.wrap(_ref_form(A, "custom"), lam)
    return Aj


def _port_form(A, name, lam=0.5):
    At = torch.as_tensor(A)
    if name == "sparse":
        M = BCOO.fromdense(jnp.asarray(A))
        return convert.sparse_from_reference(M.indices, M.data, A.shape, device=CPU)
    if name == "custom":
        return CustomOperator(lambda v: At @ v, lambda u: At.T @ u, A.shape, torch.float64, CPU)
    if name == "tikhonov":
        return TikhonovAugmented.wrap(At, lam, device=CPU)
    if name == "tikhonov_custom":
        return TikhonovAugmented.wrap(_port_form(A, "custom"), lam, device=CPU)
    return At


@pytest.mark.parametrize("form", ["dense", "sparse", "custom", "tikhonov", "tikhonov_custom"])
@pytest.mark.parametrize("kind", sorted(set(KINDS)))
def test_apply_op_every_kind_every_form(kind, form):
    m, n, d = 300, 9, 64
    rng = np.random.default_rng(10)
    A = np.where(rng.random((m, n)) < 0.2, rng.standard_normal((m, n)), 0.0)
    rows = m + n if form.startswith("tikhonov") else m
    jop = jsketch.sample(kind, jax.random.key(12), d, rows)
    top = _convert(jop)
    want = np.asarray(jop.apply_op(_ref_form(A, form)))
    got = top.apply_op(_port_form(A, form)).numpy()
    assert got.shape == (d, n)
    tol = 1e-6 if kind == "gaussian" else 1e-12
    assert np.abs(got - want).max() <= tol * max(1.0, np.abs(want).max()), (kind, form)
    if kind in BUCKETS and form == "sparse":
        assert np.array_equal(got, want)
    # against S·A itself
    dense = np.concatenate([A, np.sqrt(0.5) * np.eye(n)]) if form.startswith("tikhonov") else A
    assert np.abs(got - top.as_dense().numpy() @ dense).max() < tol * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("kind", sorted(set(KINDS)))
def test_as_dense_t_and_its_panels(kind, monkeypatch):
    jop = jsketch.sample(kind, jax.random.key(13), 48, 200)
    top = _convert(jop)
    St = top.as_dense_t().numpy()
    tol = 1e-6 if kind == "gaussian" else 1e-12
    assert np.abs(St - np.asarray(jop.as_dense_t())).max() < tol
    assert np.array_equal(St, top.as_dense().numpy().T) or kind in ("srht", "gaussian")
    parts = [top._dense_t_panel(p, min(48, p + 7)).numpy() for p in range(0, 48, 7)]
    assert np.array_equal(np.concatenate(parts, axis=1), St)
    # the matrix-free apply in panels of 5 columns of Sᵀ (5 · 200 · 8 bytes)
    A = np.random.default_rng(14).standard_normal((200, 6))
    At = torch.as_tensor(A)
    op = CustomOperator(lambda v: At @ v, lambda u: At.T @ u, A.shape, torch.float64, CPU)
    whole = top.apply_op(op).numpy()
    monkeypatch.setattr(tsketch, "T_PANEL_BYTES", 5 * 200 * 8)
    assert tsketch.t_panel_cols(200, 48, torch.float64) == 5
    assert np.abs(top.apply_op(op).numpy() - whole).max() < 1e-12


def test_t_panel_cols_at_the_paper_size():
    assert tsketch.t_panel_cols(2**20, 4000, torch.float64) == 128
    assert tsketch.t_panel_cols(2**20, 4000, torch.float32) == 256
    assert tsketch.t_panel_cols(100, 30, torch.float64) == 30


@pytest.mark.parametrize("kind", sorted(set(KINDS)))
def test_stacked_apply_op_and_extend_sketch_on_sparse_and_custom(kind):
    m, n, d, e = 300, 9, 40, 24
    rng = np.random.default_rng(15)
    A = np.where(rng.random((m, n)) < 0.2, rng.standard_normal((m, n)), 0.0)
    jop = jsketch.sample(kind, jax.random.key(16), d, m)
    top = _convert(jop)
    jst = jop.extend_rows(jax.random.key(17), e)
    tst = StackedSketch(top=top, bottom=_convert(jst.bottom), w_top=jst.w_top, w_bottom=jst.w_bottom)
    for form in ("sparse", "custom"):
        Ap = _port_form(A, form)
        fresh = tst.apply_op(Ap)
        want = np.asarray(jst.apply_op(_ref_form(A, form)))
        tol = 1e-6 if kind == "gaussian" else 1e-12
        assert np.abs(fresh.numpy() - want).max() <= tol * max(1.0, np.abs(want).max()), (kind, form)
        assert torch.equal(tst.extend_sketch(top.apply_op(Ap), Ap), fresh), (kind, form)


def test_mixed_precision_raises_for_sparse_and_custom(prob):
    A, b, _ = prob
    for form, Ain in _forms(A).items():
        with pytest.raises(ValueError, match="dense"):
            lstsq(Ain, b, 0, method="saa", precision="mixed", device=CPU)


# ------------------------------------------------------ solvers × operator


@pytest.mark.parametrize("method", ("saa", "sap", "iterative", "fossils", "lsqr"))
@pytest.mark.parametrize("form", ("sparse", "csr", "custom"))
def test_every_solver_accepts_every_input_form(prob, method, form):
    A, b, x_qr = prob
    res = lstsq(_forms(A)[form], b, 20, method=method, device=CPU)
    res_dense = lstsq(A, b, 20, method=method, device=CPU)
    assert _rel(res.x, x_qr) < 1e-6, (method, form)
    assert float(np.linalg.norm(res.x.numpy() - res_dense.x.numpy()) / np.linalg.norm(x_qr)) < 1e-8


@pytest.mark.parametrize("form", ("sparse", "custom"))
def test_saa_on_the_reference_s_matches_the_reference(prob, form):
    A, b, _ = prob
    m, n = A.shape
    key = jax.random.key(30)
    k_sketch = jax.random.split(key, 3)[0]
    jop = jsketch.sample("clarkson_woodruff", k_sketch, default_sketch_size(n, m), m)
    ref = j_lstsq(_ref_form(A, form), jnp.asarray(b), key, method="saa")
    res = lstsq(_forms(A)[form], b, 0, method="saa", sketch=_convert(jop), device=CPU)
    assert int(res.itn) == int(ref.itn) and int(res.istop) == int(ref.istop)
    assert _rel(res.x, ref.x) < 1e-10
    assert not bool(res.used_fallback)


def test_direct_materializes_sparse_but_rejects_custom(prob):
    A, b, x_qr = prob
    res = lstsq(_forms(A)["sparse"], b, method="direct", device=CPU)
    assert np.abs(res.x.numpy() - x_qr).max() < 1e-8
    with pytest.raises(TypeError, match="materializable"):
        lstsq(_forms(A)["custom"], b, method="direct", device=CPU)


def test_auto_selection_matrix_free(prob):
    A, b, _ = prob
    assert select_method(2000, 32, matrix_free=True) == "iterative"
    assert select_method(2000, 32, matrix_free=True, accuracy="fast") == "saa"
    assert select_method(2000, 32, matrix_free=True, has_key=False) == "lsqr"
    assert select_method(100, 60, matrix_free=True) == "lsqr"
    assert lstsq(_forms(A)["sparse"], b, 21, device=CPU).method == "iterative"
    assert lstsq(_forms(A)["custom"], b, device=CPU).method == "lsqr"
    assert lstsq(A, b, 21, device=CPU).method == "direct"  # the dense form, small


def test_saa_operator_form_disables_fallback(prob):
    A, b, _ = prob
    for Ain in _forms(A).values():
        res = lstsq(Ain, b, 22, method="saa", iter_lim=1, device=CPU)
        assert int(res.istop) == 7 and not bool(res.used_fallback)


def test_certified_never_densifies_sparse_inputs():
    """As tests/test_certify.py:250: an unreachable target exhausts the
    ladder up to its fossils rung and returns a failed certificate."""
    rng = np.random.default_rng(50)
    A, b = rng.standard_normal((2000, 16)), rng.standard_normal(2000)
    for Ain in (torch.as_tensor(A).to_sparse(), _forms(A)["custom"]):
        res = lstsq(Ain, b, 52, accuracy="certified", certified_rtol=1e-300, device=CPU)
        assert res.method == "fossils" and not bool(res.certificate.passed)
    dense = lstsq(A, b, 52, accuracy="certified", certified_rtol=1e-300, device=CPU)
    assert dense.method in ("fossils", "direct")


def test_certified_on_sparse_passes_with_the_reference_bound(prob):
    A, b, x_qr = prob
    res = lstsq(_forms(A)["sparse"], b, 23, accuracy="certified", device=CPU)
    assert bool(res.certificate.passed) and res.method != "direct"
    assert float(np.linalg.norm(res.x.numpy() - x_qr)) <= 10 * float(res.certificate.error_bound)


@pytest.mark.parametrize("form", ("sparse", "custom"))
def test_session_on_sparse_and_custom_matches_the_reference(prob, form):
    from repro.core import SketchedSolver as JSolver

    A, b, x_qr = prob
    jop = jsketch.sample("clarkson_woodruff", jax.random.key(40), default_sketch_size(N_COLS, M_ROWS), M_ROWS)
    ref = JSolver(_ref_form(A, form), jax.random.key(40))
    s = SketchedSolver(_forms(A)[form], 0, sketch=_convert(jop), device=CPU)
    assert s._Y is None and ref._Y is None  # operator form, Y never formed
    if form == "sparse":
        assert np.array_equal(s._B.numpy(), np.asarray(ref._B))
    else:  # Sᵀ through one blocked product with Aᵀ in each package
        assert np.abs(s._B.numpy() - np.asarray(ref._B)).max() < 1e-12
    res, jres = s.solve(b), ref.solve(jnp.asarray(b))
    assert int(res.itn) == int(jres.itn) and _rel(res.x, jres.x) < 1e-10
    assert _rel(res.x, x_qr) < 1e-8
    B = np.stack([b, 2 * b], axis=1)
    many = s.solve_many(B)
    assert _rel(many.x[:, 1], 2 * x_qr) < 1e-8
    assert bool(s.certify().passed)
    assert s.stats == {"sketches": 1, "qr_factorizations": 1, "solves": 3}
    with pytest.raises(TypeError, match="dense"):
        s.update_rows([0], A[:1])
