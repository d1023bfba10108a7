"""Port parity: micro-batching and padded shape buckets
(``repro_torch/serve/batching.py``) against the reference's
``repro.serve.batching``.

Every contract of ``tests/test_batching.py`` on inputs made from a numpy
seed, plus the port held to the reference on the same inputs:

- ``MicroBatcher`` releases the same batches as the reference's for one
  scripted trace of ``(key, now)`` adds and ``ready``/``drain`` polls;
- ``bucket_shape`` equals the reference's over a hypothesis grid of
  (m, n); ``pad_problem`` is bitwise the reference's;
- ``solve_bucket``'s x agrees within 1e-12 relative of the reference's
  on the same stack (ridge and plain problems sharing the bucket), cond,
  σ_max and ‖r̂‖ within 1e-8 relative, and the bound and ‖Yᵀr̂‖ (both at
  the rounding floor, bounds on ‖x − x⋆‖) within 1e-8·‖x‖; the padded
  coordinates come out ≤ 1e-12.

The padding theorem: A_pad = [[A, 0], [0, I]], b_pad = [b, 0] decouples,
so the padded minimizer is exactly [x*, 0], also under ridge.  The
reference's ``test_padded_vmapped_batch_matches_unbatched`` drives
``saa_sas_batch`` (batched Algorithm 1) over the padded stack,
and fails there for the CountSketch and uniform-sparse kinds; the
service's bucket path is a direct QR, so this file holds the padded batch
to direct-QR truth through ``solve_bucket``.  The padded ridge solve
through the sketched path runs for every kind on the reference's own S
(converted), within 1e-8 of the direct ridge solve and of the
reference's answer.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro import serve as jserve  # noqa: E402
from repro.core import lstsq as jlstsq  # noqa: E402
from repro.core import linop as jlinop  # noqa: E402
from repro.core.precond import SketchedFactor as JFactor  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import lstsq  # noqa: E402
from repro_torch.serve import MicroBatcher, bucket_shape, pad_problem, solve_bucket  # noqa: E402

CPU = "cpu"
SKETCH_KINDS = (
    "gaussian", "uniform_dense", "srht", "clarkson_woodruff",
    "sparse_sign", "uniform_sparse",
)


# ---------------------------------------------------------------- batcher


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small tensors, the module's fixtures
    included: the suite runs several test workers at once, and more threads
    only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_size_triggered_release():
    mb = MicroBatcher(max_batch=3, max_delay_s=100.0)
    for i in range(7):
        mb.add("k", i, now=0.0)
    out = mb.ready(now=0.0)
    assert [(k, len(v)) for k, v in out] == [("k", 3), ("k", 3)]
    assert mb.pending == 1  # remainder stays queued, too young to release


def test_age_triggered_release():
    mb = MicroBatcher(max_batch=64, max_delay_s=0.010)
    mb.add("k", "a", now=0.0)
    assert mb.ready(now=0.005) == []
    out = mb.ready(now=0.011)
    assert out == [("k", ["a"])]
    assert mb.pending == 0


def test_drain_releases_everything():
    mb = MicroBatcher(max_batch=64, max_delay_s=100.0)
    mb.add("a", 1, now=0.0)
    mb.add("b", 2, now=0.0)
    out = dict(mb.ready(now=0.0, drain=True))
    assert out == {"a": [1], "b": [2]}


def test_keys_do_not_coalesce_across():
    mb = MicroBatcher(max_batch=2, max_delay_s=100.0)
    mb.add("a", 1, now=0.0)
    mb.add("b", 2, now=0.0)
    mb.add("a", 3, now=0.0)
    out = mb.ready(now=0.0)
    assert out == [("a", [1, 3])]


def test_occupancy_accounting():
    mb = MicroBatcher(max_batch=4, max_delay_s=0.0)
    assert mb.mean_occupancy == 0.0
    for i in range(6):
        mb.add("k", i, now=0.0)
    mb.ready(now=1.0)
    assert mb.batch_sizes == [4, 2]
    assert mb.mean_occupancy == pytest.approx(6 / 8)
    assert mb.enqueued == 6
    with pytest.raises(ValueError, match="max_batch"):
        MicroBatcher(max_batch=0)


def test_scripted_trace_releases_the_references_batches():
    rng = np.random.default_rng(11)
    ours = MicroBatcher(max_batch=4, max_delay_s=0.003)
    ref = jserve.MicroBatcher(max_batch=4, max_delay_s=0.003)
    now, released, released_ref = 0.0, [], []
    for step in range(400):
        now += float(rng.exponential(0.0007))
        if rng.random() < 0.7:
            key, item = f"k{int(rng.integers(3))}", step
            ours.add(key, item, now=now)
            ref.add(key, item, now=now)
        else:
            drain = bool(rng.random() < 0.1)
            released.append(ours.ready(now=now, drain=drain))
            released_ref.append(ref.ready(now=now, drain=drain))
            assert ours.pending == ref.pending
    assert released == released_ref
    assert ours.batch_sizes == ref.batch_sizes
    assert ours.mean_occupancy == ref.mean_occupancy


# ------------------------------------------------------------ shape buckets


def test_bucket_shape_geometric():
    assert bucket_shape(60, 7) == (64, 8)
    assert bucket_shape(64, 7) == (128, 8)  # identity rows need the room
    assert bucket_shape(100, 3) == (128, 8)  # min_n floor
    m_pad, n_pad = bucket_shape(1000, 17)
    assert m_pad >= 1000 + (n_pad - 17) and n_pad == 32
    with pytest.raises(ValueError):
        bucket_shape(0, 3)


def test_bucket_shape_bounds_compile_count():
    shapes = {bucket_shape(m, n) for m in range(40, 200) for n in (3, 5, 9)}
    assert len(shapes) <= 6  # O(log) buckets for 160x3 distinct shapes


@settings(max_examples=200, deadline=None)
@given(st.integers(1, 5000), st.integers(1, 300), st.integers(1, 64))
def test_bucket_shape_equals_the_references(m, n, min_n):
    assert bucket_shape(m, n, min_n=min_n) == jserve.bucket_shape(m, n, min_n=min_n)


def test_pad_problem_structure():
    rng = np.random.default_rng(0)
    A = torch.as_tensor(rng.standard_normal((10, 3)))
    b = torch.as_tensor(rng.standard_normal(10))
    A_pad, b_pad = pad_problem(A, b, 16, 8)
    assert A_pad.shape == (16, 8) and b_pad.shape == (16,)
    assert torch.equal(A_pad[:10, :3], A)
    assert torch.equal(A_pad[10:15, 3:8], torch.eye(5, dtype=A.dtype))
    assert float(b_pad[10:].abs().max()) == 0.0
    with pytest.raises(ValueError, match="does not fit"):
        pad_problem(A, b, 12, 8)


@pytest.mark.parametrize("shape,bucket", [((10, 3), (16, 8)), ((61, 5), (64, 8)), ((8, 8), (8, 8))])
def test_pad_problem_is_bitwise_the_references(shape, bucket):
    rng = np.random.default_rng(1)
    A, b = rng.standard_normal(shape), rng.standard_normal(shape[0])
    A_pad, b_pad = pad_problem(torch.as_tensor(A), torch.as_tensor(b), *bucket)
    jA, jb = jserve.pad_problem(jnp.asarray(A), jnp.asarray(b), *bucket)
    assert np.array_equal(A_pad.numpy(), np.asarray(jA))
    assert np.array_equal(b_pad.numpy(), np.asarray(jb))


def _mixed_problems(seed, k=4, n=5, ridge=True):
    """k problems of DIFFERENT shapes that share one (m_pad, n_pad) bucket."""
    rng = np.random.default_rng(seed)
    problems = []
    for i in range(k):
        m = 40 + 7 * i
        A = rng.standard_normal((m, n))
        b = rng.standard_normal(m)
        lam = 0.25 if (ridge and i % 2) else 0.0  # ridge and plain share the bucket
        problems.append((A, b, lam))
    return problems


def _stack_padded(problems, m_pad, n_pad):
    pads = [pad_problem(torch.as_tensor(A), torch.as_tensor(b), m_pad, n_pad) for A, b, _ in problems]
    return (
        torch.stack([p[0] for p in pads]),
        torch.stack([p[1] for p in pads]),
        torch.tensor([lam for _, _, lam in problems], dtype=torch.float64),
    )


def _direct(A, b, lam):
    """The QR solution of the augmented [A; √λI] problem."""
    A, b = torch.as_tensor(A), torch.as_tensor(b)
    n = A.shape[1]
    A_aug = torch.cat([A, (lam ** 0.5) * torch.eye(n, dtype=A.dtype)])
    b_aug = torch.cat([b, b.new_zeros(n)])
    Q, R = torch.linalg.qr(A_aug)
    return torch.linalg.solve_triangular(R, (Q.T @ b_aug)[:, None], upper=True)[:, 0]


def test_bucket_direct_matches_unbatched_lstsq():
    problems = _mixed_problems(0)
    m_pad, n_pad = bucket_shape(40 + 7 * 3, 5)
    A_stack, b_stack, lam = _stack_padded(problems, m_pad, n_pad)
    out = solve_bucket(A_stack, b_stack, lam, certify=True)
    for i, (A, b, lam_i) in enumerate(problems):
        n = A.shape[1]
        x_ref = lstsq(A, b, 1, method="direct", reg=lam_i or None, device=CPU).x
        x = out["x"][i, :n]
        assert float(torch.linalg.norm(x - x_ref)) <= 1e-10 * max(1.0, float(torch.linalg.norm(x_ref)))
        # padded coordinates are exactly decoupled -> driven to zero
        assert float(out["x"][i, n:].abs().max()) <= 1e-12
        assert float(out["error_bound"][i]) < 1e-10
    plain = solve_bucket(A_stack, b_stack, lam)
    assert torch.equal(plain["x"], out["x"]) and torch.isnan(plain["error_bound"]).all()
    # lam=None means every problem is plain least squares
    zero = solve_bucket(A_stack, b_stack)
    x0 = _direct(*problems[0][:2], 0.0)
    assert float(torch.linalg.norm(zero["x"][0, :5] - x0)) <= 1e-12 * float(torch.linalg.norm(x0))


def test_padded_batch_matches_unbatched():
    """The padded batch the service's bucket path solves: every answer
    within 1e-8 of its own unbatched direct solve, the padding columns
    driven to zero."""
    problems = _mixed_problems(2, ridge=False)
    m_pad, n_pad = bucket_shape(40 + 7 * 3, 5)
    A_stack, b_stack, lam = _stack_padded(problems, m_pad, n_pad)
    out = solve_bucket(A_stack, b_stack, lam, certify=True)
    for i, (A, b, _) in enumerate(problems):
        x_ref = _direct(A, b, 0.0)
        n = A.shape[1]
        rel = float(torch.linalg.norm(out["x"][i, :n] - x_ref)) / max(1.0, float(torch.linalg.norm(x_ref)))
        assert rel <= 1e-8
        assert float(out["x"][i, n:].abs().max()) <= 1e-8


def _reference_inner_sketch(A_pad, b_pad, key, kind, reg):
    """The S over the data rows that the reference's
    ``lstsq(..., method="saa", sketch=kind, reg=reg)`` draws from ``key``
    (``saa_sas`` splits its key and builds the factor from the first part)."""
    A_op = jlinop.as_operator(A_pad)
    if reg is not None:
        A_op = jlinop.TikhonovAugmented.wrap(A_op, reg)
    _, op = JFactor.build(A_op, jax.random.split(key, 3)[0], sketch=kind)
    return op.inner if reg is not None else op


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
        S = None if op.S is None else np.asarray(op.S)
        return convert.gaussian_from_reference(np.asarray(jax.random.key_data(op.key)), op.d, op.m, S, device=CPU)
    if name == "UniformDenseSketch":
        return convert.uniform_dense_from_reference(np.asarray(op.S), device=CPU)
    raise TypeError(name)


@pytest.mark.parametrize("kind", SKETCH_KINDS)
def test_padded_ridge_solve_matches_unbatched(kind):
    """Padding exactness survives λ > 0 through the sketched path — the
    √λI tail rides the structured AugmentedSketch, never the random block
    — on the reference's S, as the reference's test draws it."""
    problems = _mixed_problems(5)
    m_pad, n_pad = bucket_shape(40 + 7 * 3, 5)
    A_stack, b_stack, lam = _stack_padded(problems, m_pad, n_pad)
    key = jax.random.PRNGKey(6)
    for i, (A, b, _) in enumerate(problems):
        reg = float(lam[i]) or None
        jA, jb = jnp.asarray(A_stack[i].numpy()), jnp.asarray(b_stack[i].numpy())
        S = _convert(_reference_inner_sketch(jA, jb, key, kind, reg))
        x_pad = lstsq(A_stack[i], b_stack[i], 0, method="saa", sketch=S, reg=reg,
                      iter_lim=80, device=CPU).x
        x_ref = _direct(A, b, reg or 0.0)
        x_jax = torch.as_tensor(np.array(
            jlstsq(jA, jb, key, method="saa", sketch=kind, reg=reg, iter_lim=80).x))
        n = A.shape[1]
        scale = max(1.0, float(torch.linalg.norm(x_ref)))
        assert float(torch.linalg.norm(x_pad[:n] - x_ref)) / scale <= 1e-8, kind
        assert float(torch.linalg.norm(x_pad - x_jax)) / scale <= 1e-8, kind
        assert float(x_pad[n:].abs().max()) <= 1e-8


def test_solve_bucket_matches_the_reference():
    problems = _mixed_problems(7, k=6)
    m_pad, n_pad = bucket_shape(40 + 7 * 5, 5)
    A_stack, b_stack, lam = _stack_padded(problems, m_pad, n_pad)
    ours = solve_bucket(A_stack, b_stack, lam, certify=True)
    ref = jserve.solve_bucket(jnp.asarray(A_stack.numpy()), jnp.asarray(b_stack.numpy()),
                              jnp.asarray(lam.numpy()), certify=True)
    x, x_ref = ours["x"].numpy(), np.asarray(ref["x"])
    xn = np.linalg.norm(x_ref, axis=1)
    assert (np.linalg.norm(x - x_ref, axis=1) <= 1e-12 * xn).all()
    for name in ("cond", "smax", "rnorm"):
        got, want = ours[name].numpy(), np.asarray(ref[name])
        assert (np.abs(got - want) <= 1e-8 * np.abs(want)).all(), name
    # The bound and ‖Yᵀr̂‖ sit at the rounding floor (~1e-15 here), where
    # the two libraries' residuals differ in their last bits: they are
    # bounds on ‖x − x⋆‖, so their agreement is measured against ‖x‖.
    for name in ("error_bound", "whitened_arnorm"):
        got, want = ours[name].numpy(), np.asarray(ref[name])
        assert (np.abs(got - want) <= 1e-8 * xn).all(), name
        assert (got < 1e-12 * xn).all(), name


def test_solve_bucket_validates_shapes():
    with pytest.raises(ValueError, match="A_stack"):
        solve_bucket(torch.zeros((2, 8, 4)), torch.zeros((2, 7)))
