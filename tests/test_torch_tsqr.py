"""Port parity: TSQR, the panel Gram (kernel B2's plain version) and the
fused CountSketch-Gram (kernel B3's plain version) against the JAX
reference.

Tolerances:
- Gram: elementwise |ΔG| ≤ 2·γ_s·(|B|ᵀ|B|), γ_s = s·u/(1 − s·u) with u the
  unit roundoff of the accumulation dtype — the classical bound of each of
  the two computed inner-product sums, added;
- fused (B, G): B within rtol·M of the reference (rtol 1e-13 in f64, 1e-5 in
  f32; M = |S||A|, since the reference's one-hot matmul sums in another
  order) and G within (2·γ_d + 2·rtol)·(MᵀM);
- QR factors at κ = 1e10: R within 1e-10 (relative, Frobenius) of the
  reference's, ‖QᵀQ − I‖ < 1e-12 and ‖QR − B‖/‖B‖ < 1e-12 — the bounds of
  the reference's own tests.  diag(R) ≥ 0 in both packages makes R
  comparable.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import sketch as jsketch  # noqa: E402
from repro_torch.convert import countsketch_from_reference  # noqa: E402

# The packages' ``kernels.tsqr`` attribute is the tsqr function; take the
# subpackages from the import system.
jtsqr = importlib.import_module("repro.kernels.tsqr")
ttsqr = importlib.import_module("repro_torch.kernels.tsqr")

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small tensors, the module's fixtures
    included: the suite runs several test workers at once, and more threads
    only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gamma(k, dtype):
    u = torch.finfo(dtype).eps / 2
    return k * u / (1 - k * u)


def _conditioned(seed, m, n, cond):
    """Random (m, n) matrix with 2-norm condition number ``cond`` (numpy)."""
    rng = np.random.default_rng(seed)
    U, _ = np.linalg.qr(rng.standard_normal((m, n)))
    V, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return (U * np.logspace(0, -np.log10(cond), n)) @ V.T


def _relR(R, R_ref):
    return float(np.linalg.norm(R - R_ref) / np.linalg.norm(R_ref))


@pytest.mark.parametrize(
    "s,n,dtype",
    [(700, 48, torch.float32), (2048, 40, torch.float64), (333, 1, torch.float64),
     (500, 130, torch.float64)],
)
def test_panel_gram_matches_reference(s, n, dtype):
    B = np.random.default_rng(0).standard_normal((s, n))
    B_t = torch.as_tensor(B).to(dtype)
    G = ttsqr.panel_gram(B_t)
    G_ref = np.asarray(jtsqr.panel_gram_ref(jnp.asarray(B_t.numpy())))
    assert G.dtype == dtype and G.shape == (n, n)
    absB = np.abs(B_t.numpy().astype(np.float64))
    assert np.all(np.abs(G.numpy() - G_ref) <= 2 * _gamma(s, dtype) * absB.T @ absB)


@pytest.mark.parametrize("half", [torch.bfloat16, torch.float16])
def test_panel_gram_half_input_gives_f32(half):
    B = torch.as_tensor(np.random.default_rng(1).standard_normal((256, 20))).to(half)
    G = ttsqr.panel_gram(B)
    assert G.dtype == torch.float32
    Bf = B.to(torch.float64)
    assert torch.all((G - Bf.T @ Bf).abs() <= 2 * _gamma(256, torch.float32) * Bf.abs().T @ Bf.abs())


@pytest.mark.parametrize("dtype,rtol", [(jnp.float64, 1e-13), (jnp.float32, 1e-5)])
@pytest.mark.parametrize("m,d,n", [(4096, 256, 64), (1000, 37, 1), (1500, 200, 130)])
def test_countsketch_gram_matches_reference_kernel(m, d, n, dtype, rtol):
    rng = np.random.default_rng(2)
    A = rng.standard_normal((m, n)).astype(dtype)
    op = jsketch.CountSketch.sample(jax.random.key(3), d, m, dtype=dtype)
    B_j, G_j = jtsqr.countsketch_gram(jnp.asarray(A), op.buckets, op.signs, d, interpret=True)
    B_t, G_t = ttsqr.countsketch_gram(
        torch.as_tensor(A), torch.as_tensor(np.array(op.buckets)),
        torch.as_tensor(np.array(op.signs)), d,
    )
    assert B_t.dtype == G_t.dtype == torch.as_tensor(A).dtype
    M = np.zeros((d, n))
    np.add.at(M, np.asarray(op.buckets), np.abs(A.astype(np.float64)))
    assert np.all(np.abs(B_t.numpy() - np.asarray(B_j)) <= rtol * M)
    tol = (2 * _gamma(d, B_t.dtype) + 2 * rtol) * M.T @ M
    assert np.all(np.abs(G_t.numpy() - np.asarray(G_j)) <= tol)


def test_countsketch_gram_half_input_gives_f32():
    A = torch.randn(512, 16, generator=torch.Generator().manual_seed(4)).to(torch.bfloat16)
    h = torch.randint(0, 64, (512,), generator=torch.Generator().manual_seed(5), dtype=torch.int32)
    s = torch.ones(512, dtype=torch.bfloat16)
    B, G = ttsqr.countsketch_gram(A, h, s, 64)
    assert B.dtype == G.dtype == torch.float32
    assert torch.equal(G, G.T)


@pytest.mark.parametrize("cond", [1e2, 1e10])
def test_cholqr_finish_matches_reference(cond):
    B = _conditioned(5, 1024, 32, cond)
    Q, R = ttsqr.cholqr_finish(torch.as_tensor(B), torch.as_tensor(B.T @ B))
    _, R_j = jtsqr.cholqr_finish(jnp.asarray(B), jnp.asarray(B.T @ B))
    assert _relR(R.numpy(), np.asarray(R_j)) < 1e-10
    assert float(torch.linalg.norm(Q.T @ Q - torch.eye(32, dtype=Q.dtype))) < 1e-12


@pytest.mark.parametrize("mode", ["tree", "cholqr"])
@pytest.mark.parametrize("cond", [1e2, 1e10])
def test_tsqr_matches_reference(mode, cond):
    B = _conditioned(6, 2048, 40, cond)
    Q, R = ttsqr.tsqr(B, mode=mode, device=CPU)
    _, R_j = jtsqr.tsqr(jnp.asarray(B), mode=mode, interpret=True)
    assert _relR(R.numpy(), np.asarray(R_j)) < 1e-10
    assert bool(torch.all(torch.diagonal(R) >= 0))
    B_t = torch.as_tensor(B)
    assert float(torch.linalg.norm(Q.T @ Q - torch.eye(40, dtype=Q.dtype))) < 1e-12
    assert float(torch.linalg.norm(Q @ R - B_t) / torch.linalg.norm(B_t)) < 1e-12
    _, R_h = ttsqr.tsqr_ref(B_t)
    assert _relR(R.numpy(), R_h.numpy()) < 1e-10


def test_tsqr_rejects_wide_and_unknown_mode():
    with pytest.raises(ValueError):
        ttsqr.tsqr(np.zeros((3, 5)), device=CPU)
    with pytest.raises(ValueError):
        ttsqr.tsqr(np.zeros((5, 3)), mode="svd", device=CPU)


@pytest.mark.parametrize("backend", ["auto", "reference"])
@pytest.mark.parametrize("precision", ["full", "mixed"])
def test_sketch_qr_matches_reference(backend, precision):
    """``auto`` on a CPU tensor takes the fused branch with the plain
    versions (the structure of the card's path); the reference runs its
    Pallas branch in interpret mode.  ``reference`` is the unfused branch
    in both packages."""
    m, n, d = 4096, 48, 192
    A = _conditioned(7, m, n, 1e6)
    op_j = jsketch.CountSketch.sample(jax.random.key(8), d, m, dtype=jnp.float64)
    op_t = countsketch_from_reference(op_j.buckets, op_j.signs, d, device=CPU)
    Q, R, B = ttsqr.sketch_qr(op_t, A, backend=backend, precision=precision, device=CPU)
    j_backend = "pallas" if backend == "auto" else "reference"
    Q_j, R_j, B_j = jtsqr.sketch_qr(op_j, jnp.asarray(A), backend=j_backend, precision=precision)
    assert Q.dtype == R.dtype == B.dtype == torch.float64
    rtol = 1e-13 if precision == "full" else 1e-5
    assert float(np.linalg.norm(B.numpy() - np.asarray(B_j)) / np.linalg.norm(B_j)) < rtol
    assert _relR(R.numpy(), np.asarray(R_j)) < (1e-10 if precision == "full" else 1e-4)
    assert float(torch.linalg.norm(Q @ R - B) / torch.linalg.norm(B)) < 1e-12


def test_max_fused_cols_routes_wide_inputs_unfused(monkeypatch):
    from repro_torch.core.sketch import sample
    from repro_torch.kernels.tsqr import fused

    def fused_called(*args, **kw):
        raise AssertionError("fused route taken")

    monkeypatch.setattr(fused, "MAX_FUSED_COLS", 8)
    monkeypatch.setattr(fused, "countsketch_gram", fused_called)
    op = sample("countsketch", 0, 64, 512, device=CPU)
    A = np.random.default_rng(9).standard_normal((512, 16))
    Q, R, B = fused.sketch_qr(op, A, device=CPU)  # 16 > 8 columns: unfused
    assert float(torch.linalg.norm(Q @ R - B) / torch.linalg.norm(B)) < 1e-12
    with pytest.raises(AssertionError, match="fused route"):
        fused.sketch_qr(op, A[:, :8], device=CPU)
