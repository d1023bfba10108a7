"""Port parity: the sparse-sign and uniform-sparse sketches, kernel B1 on
their CSRs, the fused sketch→QR on them, and SAA-SAS / ``lstsq`` with them,
against the JAX reference on the same S.

The reference draws S; ``repro_torch.convert`` carries its buckets and
weights across.  The reference has no Pallas kernel for these kinds
(``core/sketch.py:524``, ``:596``); the port applies them through B1's
CSR (k·m ±1 entries, or m weighted ones) on its kernel route and through
the reference's segment sums on its reference route.

Tolerances:
- B1's CSR walk (each bucket's entries in CSR order, each product rounded
  on its own, as the CUDA kernel sums them): **bitwise** the plain
  version, for ±1 and for uniform weights;
- applies against the reference: each output within ``2·γ_k·(|S||A|)``
  (γ_k = k·u/(1 − k·u), k the most entries of one bucket), since the
  kernel route groups the sparse-sign sum across blocks in another order
  than the reference's k partial sums; the reference route is bitwise;
- ``apply_rows``/``restrict_cols``/``as_dense``: bitwise;
- ``sketch_qr`` (the unfused branch in both packages): B within 1e-13 and
  R within 1e-10 relative, ‖QR − B‖/‖B‖ < 1e-12;
- solves: x within 1e-5 of x_true for both packages and of each other, at
  κ = 10 and at κ = 1e10.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import generate_problem as j_generate  # noqa: E402
from repro.core import lstsq as j_lstsq  # noqa: E402
from repro.core import sketch as jsketch  # noqa: E402
from repro.core.precond import default_sketch_size  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    problem_from_reference,
    sparse_sign_from_reference,
    uniform_sparse_from_reference,
)
from repro_torch.core import (  # noqa: E402
    SketchedFactor,
    SparseSignSketch,
    UniformSparseSketch,
    lstsq,
    saa_sas,
    sample_sketch,
)
from repro_torch.kernels import countsketch_apply, countsketch_csr, countsketch_ref  # noqa: E402

ttsqr = importlib.import_module("repro_torch.kernels.tsqr")
jtsqr = importlib.import_module("repro.kernels.tsqr")

CPU = "cpu"
KINDS = ["sparse_sign", "uniform_sparse"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small tensors, the module's fixtures
    included: the suite runs several test workers at once, and more threads
    only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gamma(k, dtype=torch.float64):
    u = torch.finfo(dtype).eps / 2
    return k * u / (1 - k * u)


def _rel(x, y):
    x, y = np.asarray(x), np.asarray(y)
    return float(np.linalg.norm(x - y) / np.linalg.norm(y))


def _convert(op_j):
    if isinstance(op_j, jsketch.SparseSignSketch):
        return sparse_sign_from_reference(
            np.asarray(op_j.buckets), np.asarray(op_j.signs), op_j.d, op_j.k, device=CPU
        )
    return uniform_sparse_from_reference(
        np.asarray(op_j.buckets), np.asarray(op_j.values), op_j.d, device=CPU
    )


def _walk_csr(A, csr, d):
    """The CUDA kernel's sum, on the CPU: each bucket's entries in CSR order,
    each weighted row rounded on its own before it is added."""
    A2 = A if A.ndim == 2 else A[:, None]
    out = torch.zeros((d, A2.shape[1]), dtype=A2.dtype)
    off = csr.offsets.tolist()
    for k in range(d):
        acc = torch.zeros(A2.shape[1], dtype=A2.dtype)
        for j in range(off[k], off[k + 1]):
            acc = acc + csr.signs[j] * A2[int(csr.rows[j])]
        out[k] = acc
    return out if A.ndim == 2 else out[:, 0]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("weights", ["pm1_k8", "pm1_k1", "uniform"])
def test_csr_walk_is_bitwise_the_plain_version(weights, dtype):
    rng = np.random.default_rng(3)
    m, n, d = 500, 3, 37
    k = 8 if weights == "pm1_k8" else 1
    buckets = torch.as_tensor(rng.integers(0, d, (k, m)).astype(np.int32))
    if weights == "uniform":
        w = torch.as_tensor(rng.uniform(-np.sqrt(3), np.sqrt(3), (k, m)))
    else:
        w = torch.as_tensor((rng.integers(0, 2, (k, m)) * 2 - 1).astype(np.float64))
    if k == 1:
        buckets, w = buckets[0], w[0]
    A = torch.as_tensor(rng.standard_normal((m, n))).to(dtype)
    csr = countsketch_csr(buckets, w, d, dtype)
    assert csr.rows.shape == (k * m,) and int(csr.offsets[-1]) == k * m
    plain = countsketch_ref(A, buckets, w, d)
    assert torch.equal(_walk_csr(A, csr, d), plain)
    assert torch.equal(countsketch_apply(A, buckets, w, d), plain)
    assert torch.equal(_walk_csr(A[:, 0], csr, d), countsketch_ref(A[:, 0], buckets, w, d))


def test_b1_wrapper_checks_the_entry_count():
    A = torch.zeros(6, 2, dtype=torch.float64)
    h = torch.zeros(2, 6, dtype=torch.int32)
    s = torch.ones(2, 6, dtype=torch.float64)
    with pytest.raises(ValueError, match="buckets/signs"):
        countsketch_apply(A, h, s[:, :5], 3)
    with pytest.raises(ValueError, match="buckets/signs"):
        countsketch_apply(A, h[:, :5], s[:, :5], 3)
    meta = torch.zeros(6, 2, device="meta")
    with pytest.raises(ValueError):
        countsketch_apply(meta, h.to("meta"), s.to("meta"), 3)


@pytest.mark.parametrize("backend", ["auto", "reference"])
@pytest.mark.parametrize("tail", [(9,), ()])
@pytest.mark.parametrize("kind", KINDS)
def test_sparse_apply_matches_reference(kind, tail, backend):
    d, m = 48, 700
    op_j = jsketch.sample(kind, jax.random.key(2), d, m, dtype=jnp.float64)
    op = _convert(op_j)
    A = np.random.default_rng(0).standard_normal((m,) + tail)
    want = np.asarray(op_j.apply(jnp.asarray(A), backend="reference"))
    got = op.apply(torch.as_tensor(A), backend=backend)
    assert got.dtype == torch.float64 and got.shape == want.shape
    if backend == "reference":
        assert np.array_equal(got.numpy(), want)
    else:
        S = np.abs(np.asarray(op_j.as_dense()))
        k = int(np.max(np.count_nonzero(S, axis=1)))
        mag = S @ np.abs(A).reshape(m, -1)
        assert np.all(np.abs(got.numpy() - want).reshape(d, -1) <= 2 * _gamma(k) * mag)


@pytest.mark.parametrize("kind", KINDS)
def test_sparse_rows_cols_and_dense_forms_match_reference(kind):
    d, m = 40, 600
    op_j = jsketch.sample(kind, jax.random.key(5), d, m, dtype=jnp.float64)
    op = _convert(op_j)
    S = op.as_dense()
    assert np.array_equal(S.numpy(), np.asarray(op_j.as_dense()))
    tile = np.random.default_rng(2).standard_normal((150, 5))
    want = np.asarray(op_j.apply_rows(jnp.asarray(tile), 200, backend="reference"))
    assert np.array_equal(op.apply_rows(torch.as_tensor(tile), 200, backend="reference").numpy(), want)
    idx = np.array([5, 599, 0, 5])
    sub, sub_j = op.restrict_cols(torch.as_tensor(idx)), op_j.restrict_cols(jnp.asarray(idx))
    assert type(sub) is type(op) and (sub.d, sub.m) == (d, 4)
    assert np.array_equal(sub.as_dense().numpy(), np.asarray(sub_j.as_dense()))
    assert torch.equal(op.restrict_cols(slice(100, 110)).as_dense(), S[:, 100:110])
    assert op.stream_semantics == op_j.stream_semantics == "add"


def test_sparse_draws_follow_the_reference_conventions():
    d, m = 64, 4096
    ss = SparseSignSketch.sample(7, d, m, device=CPU)
    assert ss.buckets.shape == ss.signs.shape == (8, m) and ss.k == 8
    assert set(ss.signs.unique().tolist()) == {-1.0, 1.0}
    assert int(ss.buckets.max()) < d and int(ss.buckets.min()) >= 0
    S = ss.as_dense()
    # iid buckets may collide, so columns are unit-norm in expectation only
    assert abs(float((S * S).sum(0).mean()) - 1) < 0.02
    assert sample_sketch("sparse_sign", 7, d, m, k=4, device=CPU).buckets.shape == (4, m)
    us = UniformSparseSketch.sample(7, d, m, device=CPU)
    assert float(us.values.abs().max()) <= np.sqrt(3) and abs(float(us.values.var()) - 1) < 0.1
    assert torch.equal(us.values, UniformSparseSketch.sample(7, d, m, device=CPU).values)
    assert UniformSparseSketch.sample(7, d, m, torch.float32, device=CPU).values.dtype == torch.float32
    with pytest.raises(ValueError, match="entries per row"):
        sparse_sign_from_reference(np.zeros((2, 5), np.int32), np.ones((2, 5)), 3, 8, device=CPU)
    with pytest.raises(ValueError, match="buckets must lie"):
        uniform_sparse_from_reference(np.array([0, 3]), np.ones(2), 3, device=CPU)


@pytest.mark.parametrize("kind", KINDS)
def test_mixed_sparse_apply_rounds_data_and_weights_to_bf16(kind):
    """The kernel route takes bf16 A with the weights rounded to A's dtype
    (the reference's ``astype(A.dtype)``) and sums in f32."""
    m, d = 1024, 32
    op = sample_sketch(kind, 3, d, m, device=CPU)
    A = torch.as_tensor(np.random.default_rng(6).standard_normal((m, 8))).to(torch.bfloat16)
    got = op.apply(A)
    assert got.dtype == torch.float32
    w = op.signs if kind == "sparse_sign" else op.values
    want = countsketch_ref(A.float(), op.buckets, w.to(torch.bfloat16).double(), d)
    if kind == "sparse_sign":
        want = want / torch.sqrt(torch.tensor(8.0, dtype=torch.float32))
    assert torch.equal(got, want)


@pytest.mark.parametrize("backend", ["auto", "reference"])
@pytest.mark.parametrize("kind", KINDS)
def test_sketch_qr_sparse_matches_reference(kind, backend):
    """Neither package fuses these kinds: the unfused apply, a library Gram
    and the CholeskyQR3 finisher."""
    m, n, d = 4096, 48, 192
    U, _ = np.linalg.qr(np.random.default_rng(7).standard_normal((m, n)))
    A = U * np.logspace(0, -6, n)
    op_j = jsketch.sample(kind, jax.random.key(8), d, m, dtype=jnp.float64)
    Q, R, B = ttsqr.sketch_qr(_convert(op_j), A, backend=backend, device=CPU)
    Q_j, R_j, B_j = jtsqr.sketch_qr(op_j, jnp.asarray(A), backend="reference")
    assert Q.dtype == R.dtype == B.dtype == torch.float64
    assert _rel(B.numpy(), B_j) < 1e-13
    assert _rel(R.numpy(), R_j) < 1e-10
    assert float(torch.linalg.norm(Q @ R - B) / torch.linalg.norm(B)) < 1e-12


M, N = 4000, 64


@pytest.fixture(scope="module", params=[10.0, 1e10], ids=["cond10", "cond1e10"])
def prob(request):
    p = j_generate(jax.random.key(0), M, N, cond=request.param, beta=1e-10)
    arrays = [np.asarray(a) for a in (p.A, p.b, p.x_true, p.r_true)]
    return p, problem_from_reference(*arrays, p.cond, p.beta, device=CPU)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("fused", [False, True])
def test_lstsq_sparse_sketch_matches_reference(prob, kind, fused):
    pj, pt = prob
    key = jax.random.key(1)
    ref = j_lstsq(pj.A, pj.b, key, method="saa", sketch=kind, fused=fused)
    # the reference's saa_sas draws S from the first of three split keys
    k_sketch = jax.random.split(key, 3)[0]
    op_j = jsketch.sample(kind, k_sketch, default_sketch_size(N, M), M, dtype=jnp.float64)
    res = lstsq(pt.A, pt.b, 0, method="saa", sketch=_convert(op_j), fused=fused, device=CPU)
    assert res.method == ref.method == "saa"
    assert not bool(res.used_fallback) and not bool(ref.used_fallback)
    assert _rel(res.x, pt.x_true) < 1e-5 and _rel(ref.x, pt.x_true) < 1e-5
    assert _rel(res.x, ref.x) < 1e-5


@pytest.mark.parametrize("kind", KINDS)
def test_sparse_fallback_and_draw(prob, kind):
    _, pt = prob
    res = saa_sas(pt.A, pt.b, 4, sketch=kind, iter_lim=1, device=CPU)
    assert bool(res.used_fallback) and _rel(res.x, pt.x_true) < 1.0
    _, op = SketchedFactor.build(pt.A, torch.Generator().manual_seed(5), sketch=kind, device=CPU)
    cls = SparseSignSketch if kind == "sparse_sign" else UniformSparseSketch
    assert isinstance(op, cls) and (op.d, op.m) == (default_sketch_size(N, M), M)
