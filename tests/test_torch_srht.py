"""Port parity: kernel B8's plain versions (the Walsh–Hadamard transform and
the SRHT apply), the SRHT operator, and SAA-SAS / ``lstsq`` with it,
against the JAX reference on the same inputs.

The inputs are made with numpy from a seed and handed to both packages; the
reference draws the SRHT operator and ``repro_torch.convert`` carries its
signs and rows across.

Tolerances:
- the plain versions against the reference's plain ``hadamard_ref`` /
  ``srht_ref`` and its ``fwht``: **bitwise** in f64 (the same stages in the
  same order: highest bit first, a + b then a − b, and the same division
  by √d);
- against the reference's interpret-mode Pallas ``srht_apply``: relative
  1e-13 of max|value| in f64 — its two Kronecker ±1 matmuls sum each
  output in another order (8e-15 apart at m = 4096, n = 37, d = 300);
- ``precision="mixed"``: bitwise the reference's *reference-backend* route
  (A rounded to bf16, upcast to f32, transformed in f32), never its bf16
  kernel, which returns bf16 where the port returns f32 (ROADMAP C);
- ``sketch_qr`` in full precision: B within 1e-13 and R within 1e-10
  relative (the reference's fused route runs its interpret-mode kernel),
  ‖QR − B‖/‖B‖ < 1e-12; under ``mixed`` the reference's fused route rounds
  B to bf16 in its kernel, so B and R only within 1e-2 of it, and B
  bitwise the port's own unfused route;
- solves: x within 1e-5 of x_true for both packages and of each other, at
  κ = 10 and at κ = 1e10 (the bound of the reference's ``tests/test_saa.py``).
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
from repro.core.precond import _sketch_apply as j_sketch_apply  # noqa: E402
from repro.core.precond import default_sketch_size  # noqa: E402
from repro.kernels import srht as jsrht  # noqa: E402
from repro_torch.convert import problem_from_reference, srht_from_reference  # noqa: E402
from repro_torch.core import SketchedFactor, SRHTSketch, lstsq, saa_sas, sample_sketch  # noqa: E402
from repro_torch.core.sketch import fwht  # noqa: E402
from repro_torch.kernels import hadamard_matrix, hadamard_transform, srht_apply  # noqa: E402

ttsqr = importlib.import_module("repro_torch.kernels.tsqr")
jtsqr = importlib.import_module("repro.kernels.tsqr")

CPU = "cpu"


def _rel(x, y):
    x, y = np.asarray(x), np.asarray(y)
    return float(np.linalg.norm(x - y) / np.linalg.norm(y))


def _inputs(m, n, d, seed, replace=False):
    rng = np.random.default_rng(seed)
    m_pad = 1 << max(0, (m - 1).bit_length())
    A = rng.standard_normal((m, n) if n else (m,))
    signs = rng.choice([-1.0, 1.0], m_pad)
    rows = rng.choice(m_pad, d, replace=replace)
    return A, signs, rows


def _j(x, dtype=None):
    return jnp.asarray(x, dtype)


@pytest.mark.parametrize("n", [0, 1, 5, 130])
@pytest.mark.parametrize("m", [8, 1024, 4096])
def test_plain_hadamard_is_bitwise_the_reference(m, n):
    x = np.random.default_rng(m + n).standard_normal((m, n) if n else (m,))
    want = np.asarray(jsrht.hadamard_ref(_j(x)))
    got = hadamard_transform(torch.as_tensor(x))
    assert got.dtype == torch.float64 and got.shape == want.shape
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(fwht(torch.as_tensor(x)).numpy(), want)


@pytest.mark.parametrize("n", [0, 1, 5, 130])
@pytest.mark.parametrize("m", [8, 1000, 4096])
def test_plain_srht_is_bitwise_the_reference(m, n):
    d = min(m, 300)
    A, signs, rows = _inputs(m, n, d, seed=m + n)
    want = np.asarray(jsrht.srht_ref(_j(A), _j(signs), _j(rows, jnp.int32), d))
    got = srht_apply(torch.as_tensor(A), torch.as_tensor(signs), torch.as_tensor(rows), d)
    assert got.dtype == torch.float64 and got.shape == want.shape
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("m,n,d", [(8, 1, 4), (1000, 5, 300), (3000, 37, 300)])
def test_plain_srht_matches_the_interpret_mode_kernel(m, n, d):
    A, signs, rows = _inputs(m, n, d, seed=1)
    want = np.asarray(
        jsrht.srht_apply(_j(A), _j(signs), _j(rows, jnp.int32), d, interpret=True)
    )
    got = srht_apply(torch.as_tensor(A), torch.as_tensor(signs), torch.as_tensor(rows), d).numpy()
    assert np.abs(got - want).max() <= 1e-13 * np.abs(want).max()


def test_hadamard_transform_is_the_sylvester_matrix():
    for k in (1, 2, 16, 128):
        H = hadamard_matrix(k)
        assert torch.equal(H, torch.as_tensor(np.array(jsrht.hadamard_matrix(k, jnp.float64))))
        assert torch.equal(hadamard_transform(torch.eye(k, dtype=torch.float64)), H)


def test_srht_with_replacement_and_half_inputs():
    """d > m_pad draws rows with replacement; half inputs give f32, the
    same numbers as the f32 transform of the rounded data."""
    A, signs, rows = _inputs(100, 3, 300, seed=2, replace=True)
    At, st, rt = map(torch.as_tensor, (A, signs, rows))
    want = np.asarray(jsrht.srht_ref(_j(A), _j(signs), _j(rows, jnp.int32), 300))
    assert np.array_equal(srht_apply(At, st, rt, 300).numpy(), want)
    for half in (torch.bfloat16, torch.float16):
        got = srht_apply(At.to(half), st, rt, 300)
        assert got.dtype == torch.float32
        assert torch.equal(got, srht_apply(At.to(half).float(), st, rt, 300))
        assert got.dtype == hadamard_transform(At[:64].to(half)).dtype


def test_wrappers_check_their_inputs():
    A = torch.zeros(10, 2, dtype=torch.float64)
    with pytest.raises(ValueError, match="power of two"):
        hadamard_transform(A)
    with pytest.raises(ValueError, match="power-of-two length"):
        srht_apply(A, torch.ones(12, dtype=torch.float64), torch.zeros(3, dtype=torch.int64), 3)
    with pytest.raises(ValueError, match="power-of-two length"):
        srht_apply(A, torch.ones(8, dtype=torch.float64), torch.zeros(3, dtype=torch.int64), 3)
    with pytest.raises(ValueError, match="rows must be"):
        srht_apply(A, torch.ones(16, dtype=torch.float64), torch.zeros(4, dtype=torch.int64), 3)
    with pytest.raises(TypeError):
        srht_apply(np.zeros((10, 2)), torch.ones(16), torch.zeros(3), 3)


@pytest.mark.parametrize("bad", [16, -1])
def test_srht_apply_rejects_rows_out_of_range_on_the_cpu(bad):
    # on the card the same rows give NaN output rows instead of a host check
    A = torch.ones(10, 2, dtype=torch.float64)
    rows = torch.tensor([0, bad, 3])
    with pytest.raises(ValueError, match="rows must lie in"):
        srht_apply(A, torch.ones(16, dtype=torch.float64), rows, 3)


def _convert(op_j):
    return srht_from_reference(np.asarray(op_j.signs), np.asarray(op_j.rows), op_j.d, op_j.m, device=CPU)


@pytest.mark.parametrize("backend", ["auto", "reference"])
@pytest.mark.parametrize("tail", [(9,), ()])
def test_srht_operator_matches_reference(tail, backend):
    d, m = 48, 700
    op_j = jsketch.sample("srht", jax.random.key(2), d, m, dtype=jnp.float64)
    op = _convert(op_j)
    assert (op.d, op.m, op.m_pad) == (op_j.d, op_j.m, op_j.m_pad) == (48, 700, 1024)
    A = np.random.default_rng(0).standard_normal((m,) + tail)
    want = np.asarray(op_j.apply(_j(A), backend="reference"))
    got = op.apply(torch.as_tensor(A), backend=backend)
    assert got.dtype == torch.float64 and np.array_equal(got.numpy(), want)
    tile = A[200:350]
    assert np.array_equal(
        op.apply_rows(torch.as_tensor(tile), 200).numpy(), np.asarray(op_j.apply_rows(_j(tile), 200))
    )
    assert op.stream_semantics == op_j.stream_semantics == "place"
    assert op.restrict_cols(slice(0, 10)) is None


def test_srht_dense_forms_match_reference():
    op_j = jsketch.sample("srht", jax.random.key(3), 40, 300, dtype=jnp.float64)
    op = _convert(op_j)
    S = op.as_dense()
    assert np.array_equal(S.numpy(), np.asarray(op_j.as_dense()))
    # as_dense_t runs the transform through B8's wrapper: every entry is
    # ±1/√d exactly, so it is bitwise the transpose
    assert torch.equal(op.as_dense_t(), S.T)
    assert np.array_equal(op.as_dense_t().numpy(), np.asarray(op_j.as_dense_t()))


def test_srht_draws_follow_the_reference_conventions():
    op = SRHTSketch.sample(7, 300, 3000, device=CPU)
    assert op.m_pad == 4096 and op.signs.shape == (4096,) and op.rows.shape == (300,)
    assert set(op.signs.unique().tolist()) == {-1.0, 1.0}
    assert op.rows.unique().numel() == 300 and int(op.rows.max()) < 4096  # without replacement
    over = sample_sketch("srht", 7, 5000, 3000, device=CPU)
    assert over.rows.shape == (5000,) and int(over.rows.max()) < 4096  # with replacement
    assert torch.equal(op.rows, SRHTSketch.sample(7, 300, 3000, device=CPU).rows)
    assert SRHTSketch.sample(7, 30, 300, torch.float32, device=CPU).signs.dtype == torch.float32
    with pytest.raises(ValueError, match="signs must be"):
        srht_from_reference(np.ones(300), np.zeros(3, np.int32), 3, 300, device=CPU)
    with pytest.raises(ValueError, match="rows must be"):
        srht_from_reference(np.ones(512), np.array([0, 512, 1]), 3, 300, device=CPU)


def test_mixed_srht_is_the_reference_backend_route():
    m, n, d = 2048, 16, 96
    A = np.random.default_rng(4).standard_normal((m, n))
    op_j = jsketch.sample("srht", jax.random.key(4), d, m, dtype=jnp.float64)
    op = _convert(op_j)
    want = np.asarray(j_sketch_apply(op_j, _j(A), backend="reference", precision="mixed"))
    _, _, B = SketchedFactor.build_full(A, 0, sketch=op, precision="mixed", device=CPU)
    assert B.dtype == torch.float64 and np.array_equal(B.numpy(), want)
    assert op.apply(torch.as_tensor(A).to(torch.bfloat16)).dtype == torch.float32


@pytest.mark.parametrize("backend", ["auto", "reference"])
@pytest.mark.parametrize("precision", ["full", "mixed"])
def test_sketch_qr_srht_matches_reference(backend, precision):
    """``auto`` is the fused branch (B8's plain version, then B2's) in the
    port and the Pallas branch in interpret mode in the reference."""
    m, n, d = 4096, 48, 192
    U, _ = np.linalg.qr(np.random.default_rng(7).standard_normal((m, n)))
    A = U * np.logspace(0, -6, n)
    op_j = jsketch.sample("srht", jax.random.key(8), d, m, dtype=jnp.float64)
    Q, R, B = ttsqr.sketch_qr(_convert(op_j), A, backend=backend, precision=precision, device=CPU)
    j_backend = "pallas" if backend == "auto" else "reference"
    Q_j, R_j, B_j = jtsqr.sketch_qr(op_j, _j(A), backend=j_backend, precision=precision)
    assert Q.dtype == R.dtype == B.dtype == torch.float64
    if precision == "mixed":
        # the reference's fused route rounds B to bf16 in its kernel
        assert _rel(B.numpy(), B_j) < 1e-2 and _rel(R.numpy(), R_j) < 1e-2
        _, _, B_ref = ttsqr.sketch_qr(_convert(op_j), A, backend="reference", precision="mixed", device=CPU)
        assert torch.equal(B, B_ref)
    else:
        assert _rel(B.numpy(), B_j) < 1e-13
        assert _rel(R.numpy(), R_j) < 1e-10
    assert float(torch.linalg.norm(Q @ R - B) / torch.linalg.norm(B)) < 1e-12


M, N = 4000, 64


@pytest.fixture(scope="module", params=[10.0, 1e10], ids=["cond10", "cond1e10"])
def prob(request):
    p = j_generate(jax.random.key(0), M, N, cond=request.param, beta=1e-10)
    arrays = [np.asarray(a) for a in (p.A, p.b, p.x_true, p.r_true)]
    return p, problem_from_reference(*arrays, p.cond, p.beta, device=CPU)


@pytest.mark.parametrize("fused", [False, True])
def test_lstsq_srht_matches_reference(prob, fused):
    pj, pt = prob
    key = jax.random.key(1)
    ref = j_lstsq(pj.A, pj.b, key, method="saa", sketch="srht", fused=fused)
    # the reference's saa_sas draws S from the first of three split keys
    k_sketch = jax.random.split(key, 3)[0]
    op_j = jsketch.sample("srht", k_sketch, default_sketch_size(N, M), M, dtype=jnp.float64)
    res = lstsq(pt.A, pt.b, 0, method="saa", sketch=_convert(op_j), fused=fused, device=CPU)
    assert res.method == ref.method == "saa"
    assert not bool(res.used_fallback) and not bool(ref.used_fallback)
    assert _rel(res.x, pt.x_true) < 1e-5 and _rel(ref.x, pt.x_true) < 1e-5
    assert _rel(res.x, ref.x) < 1e-5


def test_srht_fallback_and_draw(prob):
    _, pt = prob
    res = saa_sas(pt.A, pt.b, 4, sketch="srht", iter_lim=1, device=CPU)
    assert bool(res.used_fallback) and _rel(res.x, pt.x_true) < 1.0
    _, op = SketchedFactor.build(pt.A, torch.Generator().manual_seed(5), sketch="srht", device=CPU)
    assert isinstance(op, SRHTSketch) and (op.d, op.m, op.m_pad) == (default_sketch_size(N, M), M, 4096)
