"""Port parity: the Gaussian stream and the dense-sketch kernels' plain
versions (B4–B7) against the JAX reference.

Tolerances:
- threefry bits: bitwise, against ``repro.kernels.common.threefry2x32``;
- Gaussians: at most ``ULP_BOUND = 3`` f32 ulps from the reference's
  ``gaussian_cols_ref`` (measured: 3 ulps at most over 12.6M values, 89%
  bitwise; the gap is the log, cos and sqrt of the two libraries);
- products against the reference's Pallas kernels in interpret mode: each
  output within ``2·γ_m·(|S||A|)`` for the order of the sums, plus
  ``3·2^-23·(|S||A|)`` for B4/B5, whose S entries may differ by ULP_BOUND
  ulps (an f32 ulp of x is at most 2^-23·|x|); γ_k = k·u/(1 − k·u) with u
  the unit roundoff of the accumulation dtype;
- Grams: ``2·γ_d·(|B|ᵀ|B|)`` against the plain Gram of the port's own B
  (the two classical inner-product bounds added), and exactly symmetric;
  against the reference's G the products' bound, carried through BᵀB.

The CUDA kernels run only on the card: ``chip_smoke.py`` holds them against
these plain versions there.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import common as jcommon  # noqa: E402
from repro.kernels.sketch_matmul import fused_gaussian_sketch as j_fused  # noqa: E402
from repro.kernels.sketch_matmul import gaussian_cols_ref as j_cols  # noqa: E402
from repro.kernels.sketch_matmul import gaussian_matrix_ref as j_matrix  # noqa: E402
from repro.kernels.sketch_matmul import sketch_matmul as j_matmul  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    KERNELS,
    bits_to_gaussian,
    countsketch_coo_apply,
    fused_gaussian_ref,
    fused_gaussian_sketch,
    gaussian_cols_ref,
    gaussian_gram,
    gaussian_matrix_ref,
    hadamard_transform,
    key_to_u32,
    matmul_gram,
    panel_gram_ref,
    reset_launches,
    sketch_matmul,
    sketch_matmul_ref,
    srht_apply,
    threefry2x32,
)

jfused = importlib.import_module("repro.kernels.tsqr.fused")

ULP_BOUND = 3
F32_REL_ULP = 2.0**-23


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


def _ordered(x):
    """f32 values as integers in the order of the floats (1 step = 1 ulp)."""
    i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
    return np.where(i < 0, -(2**31) - i, i)


def _ulps(x, y):
    return np.abs(_ordered(x) - _ordered(y))


def _words(seed):
    key = jax.random.key(seed)
    return key, key_to_u32(np.asarray(jax.random.key_data(key)))


@pytest.mark.parametrize("seed,shape", [(3, (64, 4096)), (0, (7, 33)), (11, (1, 1))])
def test_threefry_bitwise_equals_reference(seed, shape):
    rng = np.random.default_rng(seed)
    x0 = rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)
    x1 = rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)
    key, (k0, k1) = _words(seed)
    jk0, jk1 = jcommon.key_to_u32(key)
    r0, r1 = jcommon.threefry2x32(jk0, jk1, jnp.asarray(x0), jnp.asarray(x1))
    b0, b1 = threefry2x32(
        k0, k1, torch.as_tensor(x0.astype(np.int64)), torch.as_tensor(x1.astype(np.int64))
    )
    assert np.array_equal(b0.numpy(), np.asarray(r0).astype(np.int64))
    assert np.array_equal(b1.numpy(), np.asarray(r1).astype(np.int64))


def test_bits_to_gaussian_matches_reference_box_muller():
    rng = np.random.default_rng(1)
    b0 = rng.integers(0, 2**32, 100_000, dtype=np.uint64).astype(np.uint32)
    b1 = rng.integers(0, 2**32, 100_000, dtype=np.uint64).astype(np.uint32)
    # the extremes of the uniforms: u1 = 2^-25 and u1 → 1, u2 = 0
    b0[:3] = [0, 2**32 - 1, 255]
    b1[:3] = [0, 2**32 - 1, 0]
    want = np.asarray(jcommon.bits_to_gaussian(jnp.asarray(b0), jnp.asarray(b1)))
    got = bits_to_gaussian(
        torch.as_tensor(b0.astype(np.int64)), torch.as_tensor(b1.astype(np.int64))
    )
    assert got.dtype == torch.float32
    assert _ulps(got.numpy(), want).max() <= ULP_BOUND


@pytest.mark.parametrize("col_offset", [0, 1000, 2**31 + 5])
def test_gaussian_matrix_within_ulp_bound_of_reference(col_offset):
    key, (k0, k1) = _words(3)
    want = np.asarray(j_matrix(key, 64, 1024, jnp.float32, col_offset=col_offset))
    got = gaussian_matrix_ref(k0, k1, 64, 1024, col_offset=col_offset)
    assert got.shape == (64, 1024) and got.dtype == torch.float32
    assert _ulps(got.numpy(), want).max() <= ULP_BOUND
    # a column offset is bitwise a slice of the wider matrix
    if col_offset < 2**20:
        wide = gaussian_matrix_ref(k0, k1, 64, col_offset + 1024)
        assert torch.equal(wide[:, col_offset:], got)


def test_gaussian_cols_any_subset_and_chunking(monkeypatch):
    key, (k0, k1) = _words(5)
    cols = np.array([7, 3, 4000, 3, 2**32 - 1], dtype=np.uint32)
    want = np.asarray(j_cols(key, 33, jnp.asarray(cols), jnp.float32))
    got = gaussian_cols_ref(k0, k1, 33, torch.as_tensor(cols.astype(np.int64)))
    assert _ulps(got.numpy(), want).max() <= ULP_BOUND
    # the column chunking does not change a bit
    from repro_torch.kernels.sketch_matmul import ref

    monkeypatch.setattr(ref, "_CHUNK_ELEMS", 40)
    assert torch.equal(gaussian_cols_ref(k0, k1, 33, torch.as_tensor(cols.astype(np.int64))), got)


def test_key_to_u32_forms():
    key, words = _words(9)
    assert words == tuple(int(w) for w in np.asarray(jax.random.key_data(key)))
    gen = torch.Generator().manual_seed(4)
    a = key_to_u32(gen)
    assert all(0 <= w < 2**32 for w in a)
    assert key_to_u32(4) == key_to_u32(torch.Generator().manual_seed(4)) == a
    assert key_to_u32(gen) != a  # a generator advances
    with pytest.raises(ValueError):
        key_to_u32(np.zeros(3, np.uint32))


def _magnitude(S, A):
    """|S||A| in f64 — the scale of each output's rounding error."""
    S64 = torch.as_tensor(np.abs(np.asarray(S, np.float64)))
    A64 = torch.as_tensor(np.abs(np.asarray(A, np.float64)))
    return (S64 @ (A64[:, None] if A64.ndim == 1 else A64)).numpy().reshape(
        (S64.shape[0],) + A64.shape[1:]
    )


DTYPES = {np.float64: torch.float64, np.float32: torch.float32}
SHAPES = [(64, 500, 33), (33, 100, 1), (100, 1000, 20), (40, 300, None)]  # None: A is (m,)


@pytest.mark.parametrize("np_dtype", [np.float64, np.float32])
@pytest.mark.parametrize("d,m,n", SHAPES)
def test_fused_gaussian_plain_matches_reference_kernel(d, m, n, np_dtype):
    key, words = _words(42)
    rng = np.random.default_rng(0)
    A = rng.standard_normal((m,) if n is None else (m, n)).astype(np_dtype)
    want = np.asarray(j_fused(jnp.asarray(A), key, d, interpret=True))
    got = fused_gaussian_sketch(torch.as_tensor(A), words, d)
    assert got.dtype == DTYPES[np_dtype] and got.shape == want.shape
    S = gaussian_matrix_ref(*words, d, m).mul_(np.float32(1 / np.sqrt(d)))
    tol = (2 * _gamma(m, got.dtype) + ULP_BOUND * F32_REL_ULP) * _magnitude(S, A)
    assert np.all(np.abs(got.numpy() - want) <= tol)


def test_fused_gaussian_scales_in_f32_then_casts():
    """f64 A: S is the f32 Gaussian times the f32 scale, then cast — the
    kernel's order, not the reference oracle's (cast, then scale in f64)."""
    _, words = _words(7)
    A = torch.eye(50, dtype=torch.float64)
    got = fused_gaussian_ref(A, words, 20)
    G = gaussian_matrix_ref(*words, 20, 50)
    assert torch.equal(got, (G * np.float32(1 / np.sqrt(20))).to(torch.float64))
    assert torch.equal(fused_gaussian_ref(A, words, 20, scale=1.0), G.to(torch.float64))


@pytest.mark.parametrize("np_dtype", [np.float64, np.float32])
@pytest.mark.parametrize("d,m,n", SHAPES)
def test_sketch_matmul_plain_matches_reference_kernel(d, m, n, np_dtype):
    rng = np.random.default_rng(1)
    S = rng.standard_normal((d, m)).astype(np_dtype)
    A = rng.standard_normal((m,) if n is None else (m, n)).astype(np_dtype)
    want = np.asarray(j_matmul(jnp.asarray(S), jnp.asarray(A), interpret=True))
    got = sketch_matmul(torch.as_tensor(S), torch.as_tensor(A))
    assert got.dtype == DTYPES[np_dtype] and got.shape == want.shape
    assert np.all(np.abs(got.numpy() - want) <= 2 * _gamma(m, got.dtype) * _magnitude(S, A))


@pytest.mark.parametrize("half", [torch.bfloat16, torch.float16])
def test_half_inputs_give_f32_with_S_in_the_data_dtype(half):
    rng = np.random.default_rng(2)
    S = torch.as_tensor(rng.standard_normal((24, 256)))
    A = torch.as_tensor(rng.standard_normal((256, 9))).to(half)
    out = sketch_matmul(S, A)
    assert out.dtype == torch.float32
    assert torch.equal(out, S.to(half).float() @ A.float())
    _, words = _words(1)
    G = fused_gaussian_sketch(A, words, 24)
    assert G.dtype == torch.float32
    S_g = gaussian_matrix_ref(*words, 24, 256).mul_(np.float32(1 / np.sqrt(24)))
    assert torch.equal(G, S_g.to(half).float() @ A.float())


@pytest.mark.parametrize("np_dtype", [np.float64, np.float32])
@pytest.mark.parametrize("m,n,d", [(512, 32, 128), (300, 1, 40), (700, 130, 200)])
def test_dense_gram_plain_matches_reference_kernels(m, n, d, np_dtype):
    rng = np.random.default_rng(3)
    A = rng.standard_normal((m, n)).astype(np_dtype)
    S = rng.standard_normal((d, m)).astype(np_dtype)
    key, words = _words(5)
    dt = DTYPES[np_dtype]
    S_g = gaussian_matrix_ref(*words, d, m).mul_(np.float32(1 / np.sqrt(d))).to(dt)
    for (B, G), (B_j, G_j), S_used, slack in [
        (matmul_gram(torch.as_tensor(S), torch.as_tensor(A)),
         jfused.matmul_gram(jnp.asarray(S), jnp.asarray(A), interpret=True), S, 0.0),
        (gaussian_gram(torch.as_tensor(A), words, d),
         jfused.gaussian_gram(jnp.asarray(A), key, d, interpret=True), S_g.numpy(),
         ULP_BOUND * F32_REL_ULP),
    ]:
        assert B.dtype == G.dtype == dt and G.shape == (n, n)
        M = _magnitude(S_used, A)
        rtol = 2 * _gamma(m, dt) + slack
        assert np.all(np.abs(B.numpy() - np.asarray(B_j)) <= rtol * M)
        absB = np.abs(B.numpy().astype(np.float64))
        assert np.all(np.abs(G.numpy() - panel_gram_ref(B).numpy()) <= 2 * _gamma(d, dt) * absB.T @ absB)
        assert torch.equal(G, G.T)
        tol = (2 * _gamma(d, dt) + 2 * rtol + rtol**2) * M.T @ M
        assert np.all(np.abs(G.numpy() - np.asarray(G_j)) <= tol)
        # B is the unfused apply's output, bitwise
        unfused = sketch_matmul(torch.as_tensor(S), torch.as_tensor(A)) if slack == 0 else \
            fused_gaussian_sketch(torch.as_tensor(A), words, d)
        assert torch.equal(B, unfused)


def test_plain_versions_do_not_count_launches():
    reset_launches()
    A = torch.randn(64, 3, dtype=torch.float64)
    sketch_matmul(torch.randn(8, 64, dtype=torch.float64), A)
    fused_gaussian_sketch(A, (1, 2), 8)
    gaussian_gram(A, (1, 2), 8)
    matmul_gram(torch.randn(8, 64, dtype=torch.float64), A)
    hadamard_transform(A)
    srht_apply(A, torch.ones(64, dtype=torch.float64), torch.arange(8), 8)
    rows = torch.arange(64)
    countsketch_coo_apply(rows, rows % 3, A[:, 0], (64, 3), torch.zeros(64, dtype=torch.int32),
                          torch.ones(64, dtype=torch.float64), 8)
    assert [f.launches for f in KERNELS] == [0] * len(KERNELS) == [0] * 10


def test_wrappers_check_their_inputs():
    A = torch.zeros(10, 2, dtype=torch.float64)
    with pytest.raises(ValueError):
        sketch_matmul(torch.zeros(3, 9, dtype=torch.float64), A)
    with pytest.raises(ValueError):
        matmul_gram(torch.zeros(3, 10, dtype=torch.float64), A[:, 0])
    with pytest.raises(ValueError):
        fused_gaussian_sketch(A, (2**32, 0), 3)
    with pytest.raises(TypeError):
        gaussian_gram(np.zeros((10, 2)), (0, 0), 3)
    assert sketch_matmul_ref(torch.zeros(3, 10), A).dtype == torch.float64


class _RecordingLib:
    """A kernel library that records each C entry's arguments."""

    def __init__(self):
        self.calls = {}

    def __getattr__(self, name):
        if not name.startswith("repro_"):
            raise AttributeError(name)

        def record(*args):
            self.calls[name] = args
            return 0

        return record


@pytest.mark.parametrize("half", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d,m,n,sms", [(300, 2048, 300, 132), (300, 2048, 300, 1), (1000, 1000, 2, 132),
                                       (37, 100, 3, 132)])
def test_half_route_hands_b6_and_b7_the_half_split(monkeypatch, half, d, m, n, sms):
    """The CUDA branches of B6 and B7 on half inputs, run on CPU tensors
    against a recording library: both pass the half engine's split of the
    sum over m (``sketch_split`` at the half dtype), with scratch for its
    f32 partials exactly when it splits, and its operands on 16-byte row
    pitches (a padded copy where m or n is not a multiple of 8)."""
    import contextlib

    from repro_torch.kernels import _build
    from repro_torch.kernels.common import sketch_split
    from repro_torch.kernels.sketch_matmul import ops as sm_ops
    from repro_torch.kernels.tsqr import fused

    lib = _RecordingLib()
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    launched = lambda name, A, ndims: (_build.dtype_code(A.dtype), A.contiguous())  # noqa: E731
    for mod in (sm_ops, fused):
        monkeypatch.setattr(mod, "sm_count", lambda device: sms)
    monkeypatch.setattr(sm_ops, "_prepare", launched)
    monkeypatch.setattr(fused, "_prepare_dense", launched)
    S = torch.randn(d, m, dtype=torch.float64)
    A = torch.randn(m, n, dtype=torch.float64).to(half)
    split = sketch_split(half, d, m, n, sms)
    out = sm_ops.sketch_matmul(S, A)
    B, G = fused.matmul_gram(S, A)
    assert out.dtype == B.dtype == G.dtype == torch.float32
    b6, b7 = lib.calls["repro_sketch_matmul"], lib.calls["repro_matmul_gram"]
    assert b6[0] == b7[0] == _build.dtype_code(half)
    assert b6[5:10] == (d, m, n, split.slab, split.parts) == b7[6:11]
    assert (b6[4] is not None) == (split.parts > 1) == (b7[5] is not None)
    assert split.parts > 1 or split.slab >= m
    pitch = lambda k: -(-k // 8) * 8  # noqa: E731
    assert b6[10:12] == (pitch(m), pitch(n)) == b7[13:15]
    # a padded operand holds the matrix in its first columns
    S_t, lds = sm_ops.pitched(S.to(half).contiguous())
    assert lds == pitch(m) and torch.equal(S_t[:, :m], S.to(half))
    f64 = torch.randn(m, n, dtype=torch.float64)
    assert sm_ops.engine_operands(S, f64)[2:] == (m, n)  # the other routes: contiguous, unpadded
