"""Port parity: the Gaussian and uniform-dense sketch operators, the fused
sketch→QR on them, and SAA-SAS / ``lstsq`` with them, against the JAX
reference on the same S.

The reference draws S; ``repro_torch.convert`` carries it across (the
Gaussian as its two key words, with or without the stored matrix) and the
port receives the operator as ``sketch=``.  On the kernel route the port
regenerates the Gaussian S from the key, so its entries may differ from
the reference's by ULP_BOUND = 3 f32 ulps (``test_torch_sketch_matmul.py``).

Tolerances:
- applies: each output within ``2·γ_m·(|S||A|)`` (γ_k = k·u/(1 − k·u),
  u the unit roundoff of the accumulation dtype), plus ``3·2^-23·(|S||A|)``
  where the port regenerates the Gaussian S;
- ``apply_rows`` and ``restrict_cols``: bitwise slices of ``as_dense``;
- ``sketch_qr``: B within rtol 1e-13 (full) or 1e-5 (mixed; both packages
  round A, and on the fused route S, to bf16) relative in Frobenius norm,
  R within 1e-10 (full) or 1e-4 (mixed), ‖QR − B‖/‖B‖ < 1e-12 — the
  bounds of ``test_torch_tsqr.py``; where the port regenerates the
  Gaussian S in full precision, B elementwise as for the applies and R
  within 1e-6 (the ulp slack, 3.6e-7, times κ(S·U) of a few units);
- solves at κ = 1e10: x within 1e-5 of x_true for both packages and of
  each other, the bound of the reference's own ``tests/test_saa.py``.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import generate_problem as j_generate  # noqa: E402
from repro.core import lstsq as j_lstsq  # noqa: E402
from repro.core import saa_sas as j_saa  # noqa: E402
from repro.core import sketch as jsketch  # noqa: E402
from repro.core.precond import default_sketch_size  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    gaussian_from_reference,
    problem_from_reference,
    uniform_dense_from_reference,
)
from repro_torch.core import (  # noqa: E402
    SKETCH_KINDS,
    GaussianSketch,
    SketchedFactor,
    UniformDenseSketch,
    lstsq,
    saa_sas,
    sample_sketch,
)

jtsqr = importlib.import_module("repro.kernels.tsqr")
ttsqr = importlib.import_module("repro_torch.kernels.tsqr")

CPU = "cpu"
M, N = 4000, 64
ULP_SLACK = 3 * 2.0**-23


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


def _magnitude(S, A):
    S, A = np.abs(np.asarray(S, np.float64)), np.abs(np.asarray(A, np.float64))
    return S @ A


def _convert(op_j, kind, stored=True):
    if kind == "gaussian":
        key_data = np.asarray(jax.random.key_data(op_j.key))
        S = np.asarray(op_j.S) if stored else None
        return gaussian_from_reference(key_data, op_j.d, op_j.m, S, device=CPU)
    return uniform_dense_from_reference(np.asarray(op_j.S), device=CPU)


def test_dense_kinds_registered_and_later_kinds_raise():
    """The dense kinds are registered; the kinds of the later slice now are
    too (every name of the reference's SKETCH_KINDS draws), and only an
    unknown name raises."""
    assert SKETCH_KINDS["gaussian"] is GaussianSketch
    assert SKETCH_KINDS["uniform_dense"] is UniformDenseSketch
    assert set(SKETCH_KINDS) == set(jsketch.SKETCH_KINDS)
    for kind in ("srht", "sparse_sign", "uniform_sparse"):
        op = sample_sketch(kind, 0, 8, 64, device=CPU)
        assert type(op).__name__ == jsketch.SKETCH_KINDS[kind].__name__
        assert (op.d, op.m) == (8, 64)
    with pytest.raises(ValueError, match="unknown sketch kind"):
        sample_sketch("hadamard", 0, 8, 64, device=CPU)


@pytest.mark.parametrize("backend", ["auto", "reference"])
@pytest.mark.parametrize("stored", [True, False])
@pytest.mark.parametrize("tail", [(9,), ()])
def test_gaussian_apply_matches_reference(tail, stored, backend):
    d, m = 48, 700
    op_j = jsketch.sample("gaussian", jax.random.key(2), d, m, dtype=jnp.float64)
    A = np.random.default_rng(0).standard_normal((m,) + tail)
    want = np.asarray(op_j.apply(jnp.asarray(A), backend="reference"))
    op = _convert(op_j, "gaussian", stored)
    got = op.apply(torch.as_tensor(A), backend=backend)
    assert got.dtype == torch.float64 and got.shape == want.shape
    M_ = _magnitude(op_j.S, A)
    # the same stored S with the plain product: only the order of the sums
    slack = 0.0 if (stored and backend == "reference") else ULP_SLACK
    assert np.all(np.abs(got.numpy() - want) <= (2 * _gamma(m) + slack) * M_)


@pytest.mark.parametrize("backend", ["auto", "reference"])
@pytest.mark.parametrize("tail", [(9,), ()])
def test_uniform_dense_apply_matches_reference(tail, backend):
    d, m = 48, 700
    op_j = jsketch.sample("uniform_dense", jax.random.key(4), d, m, dtype=jnp.float64)
    A = np.random.default_rng(1).standard_normal((m,) + tail)
    want = np.asarray(op_j.apply(jnp.asarray(A), backend="reference"))
    got = _convert(op_j, "uniform_dense").apply(torch.as_tensor(A), backend=backend)
    assert got.dtype == torch.float64 and got.shape == want.shape
    assert np.all(np.abs(got.numpy() - want) <= 2 * _gamma(m) * _magnitude(op_j.S, A))


def test_port_draws_follow_the_reference_conventions():
    """The port's own draws: the Gaussian S is its counter stream scaled by
    1/√d in f32, stored or not; the uniform S lies in ±√(3/d) with variance
    1/d; both come from the generator alone."""
    d, m = 64, 4096
    g = GaussianSketch.sample(7, d, m, device=CPU)
    lazy = GaussianSketch.sample(7, d, m, materialize=False, device=CPU)
    assert lazy.S is None and lazy.key == g.key and lazy.device == g.device
    assert torch.equal(lazy.as_dense(), g.S)
    assert abs(float(g.S.mean())) < 0.01 / np.sqrt(d)
    assert abs(float(g.S.std()) * np.sqrt(d) - 1) < 0.01
    u = UniformDenseSketch.sample(7, d, m, device=CPU)
    assert torch.equal(u.S, UniformDenseSketch.sample(7, d, m, device=CPU).S)
    assert float(u.S.abs().max()) <= np.sqrt(3 / d)
    assert abs(float(u.S.var()) * d - 1) < 0.01
    assert u.S.dtype == g.S.dtype == torch.float64
    assert UniformDenseSketch.sample(7, d, m, torch.float32, device=CPU).S.dtype == torch.float32


@pytest.mark.parametrize(
    "make",
    [
        lambda: GaussianSketch.sample(3, 40, 600, device=CPU),
        lambda: GaussianSketch.sample(3, 40, 600, materialize=False, device=CPU),
        lambda: UniformDenseSketch.sample(3, 40, 600, device=CPU),
    ],
    ids=["gaussian", "gaussian_lazy", "uniform_dense"],
)
def test_apply_rows_and_restrict_cols_are_slices_of_as_dense(make):
    op = make()
    S = op.as_dense()
    tile = torch.as_tensor(np.random.default_rng(2).standard_normal((150, 5)))
    assert torch.equal(op.apply_rows(tile, 200), S[:, 200:350] @ tile)
    assert torch.equal(op.apply_rows(tile[:, 0], 200), S[:, 200:350] @ tile[:, :1])
    f32 = tile.to(torch.float32)
    assert torch.equal(op.apply_rows(f32, 450), S[:, 450:600].to(torch.float32) @ f32)
    idx = torch.tensor([5, 599, 0, 5])
    sub = op.restrict_cols(idx)
    assert isinstance(sub, UniformDenseSketch) and (sub.d, sub.m) == (40, 4)
    assert torch.equal(sub.as_dense(), S[:, idx])
    assert torch.equal(op.restrict_cols(slice(100, 110)).as_dense(), S[:, 100:110])


def test_restrict_cols_matches_reference():
    op_j = jsketch.sample("gaussian", jax.random.key(6), 32, 300, dtype=jnp.float64)
    idx = np.array([3, 299, 17])
    want = np.asarray(op_j.restrict_cols(jnp.asarray(idx)).S)
    stored = _convert(op_j, "gaussian").restrict_cols(torch.as_tensor(idx)).S.numpy()
    lazy = _convert(op_j, "gaussian", stored=False).restrict_cols(torch.as_tensor(idx)).S.numpy()
    assert np.array_equal(stored, want)
    # the Gaussians' ulp slack, plus one f32 ulp for rounding each product
    # with the scale
    assert np.all(np.abs(lazy - want) <= ULP_SLACK * 4 / 3 * np.abs(want))


@pytest.mark.parametrize("kind", ["gaussian", "uniform_dense"])
@pytest.mark.parametrize("backend", ["auto", "reference"])
@pytest.mark.parametrize("precision", ["full", "mixed"])
def test_sketch_qr_matches_reference(kind, backend, precision):
    """``auto`` on a CPU tensor takes the fused branch with the plain
    versions of B5/B7 (the structure of the card's path); the reference
    runs its Pallas branch in interpret mode.  ``reference`` is the
    unfused branch in both packages."""
    m, n, d = 4096, 48, 192
    U, _ = np.linalg.qr(np.random.default_rng(7).standard_normal((m, n)))
    A = U * np.logspace(0, -6, n)
    op_j = jsketch.sample(kind, jax.random.key(8), d, m, dtype=jnp.float64)
    op_t = _convert(op_j, kind)
    Q, R, B = ttsqr.sketch_qr(op_t, A, backend=backend, precision=precision, device=CPU)
    j_backend = "pallas" if backend == "auto" else "reference"
    Q_j, R_j, B_j = jtsqr.sketch_qr(op_j, jnp.asarray(A), backend=j_backend, precision=precision)
    assert Q.dtype == R.dtype == B.dtype == torch.float64
    if precision == "mixed":
        assert _rel(B.numpy(), B_j) < 1e-5
        assert _rel(R.numpy(), R_j) < 1e-4
    elif kind == "gaussian" and backend == "auto":
        # S regenerated from the key: B elementwise within the products'
        # bound plus the Gaussians' ulp slack; R = R(S·U)·Σ moves by that
        # slack times κ(S·U), a few units for an embedding of U's range
        M_ = _magnitude(op_j.S, A)
        assert np.all(np.abs(B.numpy() - np.asarray(B_j)) <= (2 * _gamma(m) + ULP_SLACK) * M_)
        assert _rel(R.numpy(), R_j) < 1e-6
    else:
        assert _rel(B.numpy(), B_j) < 1e-13
        assert _rel(R.numpy(), R_j) < 1e-10
    assert float(torch.linalg.norm(Q @ R - B) / torch.linalg.norm(B)) < 1e-12


def test_mixed_unfused_uniform_dense_rounds_S_like_the_fused_route():
    """The port's kernel route rounds S to bf16 with bf16 A on both routes;
    the reference's unfused route keeps S in f64.  The two B differ by at
    most the bf16 rounding of S: 2^-8·(|S||A|) plus the f32 sums."""
    m, d = 2048, 64
    A = np.random.default_rng(9).standard_normal((m, 16))
    op_j = jsketch.sample("uniform_dense", jax.random.key(9), d, m, dtype=jnp.float64)
    A_lp = torch.as_tensor(A).to(torch.bfloat16)
    port = _convert(op_j, "uniform_dense").apply(A_lp)
    ref = np.asarray(
        jax.jit(lambda S, X: jnp.dot(S, X, preferred_element_type=jnp.float32))(
            op_j.S, jnp.asarray(A_lp.float().numpy(), jnp.bfloat16)
        )
    )
    _, _, B_fused = ttsqr.sketch_qr(_convert(op_j, "uniform_dense"), A, precision="mixed", device=CPU)
    assert port.dtype == torch.float32
    M_ = _magnitude(op_j.S, A_lp.float().numpy())
    assert np.all(np.abs(port.numpy() - ref) <= (2.0**-8 + 2 * _gamma(m, torch.float32)) * M_)
    # the unfused kernel route and the fused route sketch the same bf16 S
    assert torch.equal(port.to(torch.float64), B_fused)


@pytest.fixture(scope="module")
def prob():
    p = j_generate(jax.random.key(0), M, N, cond=1e10, beta=1e-10)
    arrays = [np.asarray(a) for a in (p.A, p.b, p.x_true, p.r_true)]
    return p, problem_from_reference(*arrays, p.cond, p.beta, device=CPU)


@pytest.mark.parametrize("kind", ["gaussian", "uniform_dense"])
@pytest.mark.parametrize("fused", [False, True])
def test_lstsq_dense_sketch_matches_reference(prob, kind, fused):
    pj, pt = prob
    key = jax.random.key(1)
    ref = j_lstsq(pj.A, pj.b, key, method="saa", sketch=kind, fused=fused)
    # the reference's saa_sas draws S from the first of three split keys
    k_sketch = jax.random.split(key, 3)[0]
    op_j = jsketch.sample(kind, k_sketch, default_sketch_size(N, M), M, dtype=jnp.float64)
    res = lstsq(pt.A, pt.b, 0, method="saa", sketch=_convert(op_j, kind), fused=fused, device=CPU)
    assert res.method == ref.method == "saa"
    assert not bool(res.used_fallback) and not bool(ref.used_fallback)
    assert _rel(res.x, pt.x_true) < 1e-5 and _rel(ref.x, pt.x_true) < 1e-5
    assert _rel(res.x, ref.x) < 1e-5


@pytest.mark.parametrize("kind", ["gaussian", "uniform_dense"])
def test_saa_fallback_resketches_with_the_same_dense_S(prob, kind):
    """``iter_lim=1`` takes the perturbation branch, which re-sketches Ã with
    the same S; held to ground truth (the perturbation's Gaussian comes from
    another generator than the reference's)."""
    pj, pt = prob
    op_j = jsketch.sample(kind, jax.random.key(3), default_sketch_size(N, M), M, dtype=jnp.float64)
    op = _convert(op_j, kind)
    res = saa_sas(pt.A, pt.b, 4, sketch=op, iter_lim=1, device=CPU)
    ref = j_saa(pj.A, pj.b, jax.random.key(4), sketch=kind, iter_lim=1)
    assert bool(res.used_fallback) and bool(ref.used_fallback)
    assert np.isfinite(_rel(res.x, pt.x_true)) and _rel(res.x, pt.x_true) < 1.0
    # the factor of the first pass is the one a direct build gives
    factor, op2 = SketchedFactor.build(pt.A, 0, sketch=op, device=CPU)
    assert op2 is op and factor.R.shape == (N, N)


def test_build_draws_dense_kinds_from_the_generator(prob):
    _, pt = prob
    for kind, cls in (("gaussian", GaussianSketch), ("uniform_dense", UniformDenseSketch)):
        _, op = SketchedFactor.build(pt.A, torch.Generator().manual_seed(5), sketch=kind, device=CPU)
        assert isinstance(op, cls) and (op.d, op.m) == (default_sketch_size(N, M), M)
        assert op.S is not None  # on the CPU the Gaussian is stored, as the reference's default
