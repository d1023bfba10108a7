"""Port parity: CountSketch apply (kernel B1's plain version) against the
JAX reference.

Tolerances:
- against the reference's ``countsketch_ref`` (``segment_sum``): bitwise in
  f64 and f32 — s = ±1 makes every product exact, and both sum each
  bucket's rows in ascending row order;
- against the reference's Pallas kernel (``interpret=True``): its one-hot
  matmul sums in another order, so rtol 1e-13 (f64) and 1e-5 (f32) of the
  magnitude sum |S||A| (``countsketch_ref(|A|, buckets, 1)``);
- bf16/f16 inputs return f32 in both packages; values within 1e-5 of
  |S||A| (the products are exact in f32, only the order of the sums
  differs).

The CUDA kernel itself runs only on the card: ``chip_smoke.py`` holds it
bitwise against this plain version run on the CPU.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import sketch as jsketch  # noqa: E402
from repro.kernels.countsketch import countsketch_apply as j_apply  # noqa: E402
from repro.kernels.countsketch import countsketch_ref as j_ref  # noqa: E402
from repro_torch.convert import countsketch_from_reference  # noqa: E402
from repro_torch.core.sketch import sample  # noqa: E402
from repro_torch.kernels.countsketch import (  # noqa: E402
    countsketch_apply,
    countsketch_csr,
    countsketch_ref,
)

CPU = "cpu"
NP_DTYPES = {torch.float64: np.float64, torch.float32: np.float32}


def _draw(seed, m, d, shape_tail, dtype=np.float64):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m,) + shape_tail).astype(dtype)
    buckets = rng.integers(0, d, m).astype(np.int32)
    signs = (rng.integers(0, 2, m) * 2 - 1).astype(dtype)
    return A, buckets, signs


def _port(A, buckets, signs, d, dtype):
    return countsketch_ref(
        torch.as_tensor(A).to(dtype),
        torch.as_tensor(buckets),
        torch.as_tensor(signs).to(dtype),
        d,
    )


def _magnitude(A, buckets, d):
    """|S||A| — the scale of each output's rounding error."""
    return countsketch_ref(
        torch.as_tensor(np.abs(A)).to(torch.float64),
        torch.as_tensor(buckets),
        torch.ones(len(buckets), dtype=torch.float64),
        d,
    ).numpy()


CASES = [
    (4096, 256, (64,)),  # the reference tests' size
    (4096, 256, ()),  # vector input (b)
    (1000, 37, (5,)),  # ragged m, d and n
    (777, 300, (1,)),  # n = 1 as a matrix, some empty buckets
]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("m,d,tail", CASES)
def test_plain_bitwise_equals_reference_segment_sum(m, d, tail, dtype):
    A, h, s = _draw(0, m, d, tail, NP_DTYPES[dtype])
    got = _port(A, h, s, d, dtype).numpy()
    want = np.asarray(j_ref(jnp.asarray(A), jnp.asarray(h), jnp.asarray(s), d))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-13), (torch.float32, 1e-5)])
@pytest.mark.parametrize("m,d,tail", CASES)
def test_plain_matches_reference_pallas_kernel(m, d, tail, dtype, rtol):
    A, h, s = _draw(1, m, d, tail, NP_DTYPES[dtype])
    got = _port(A, h, s, d, dtype).numpy()
    want = np.asarray(
        j_apply(jnp.asarray(A), jnp.asarray(h), jnp.asarray(s), d, interpret=True)
    )
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.all(np.abs(got - want) <= rtol * _magnitude(A, h, d))


@pytest.mark.parametrize("half", [torch.bfloat16, torch.float16])
def test_half_inputs_return_f32(half):
    m, d = 2048, 128
    A, h, s = _draw(2, m, d, (24,), np.float32)
    A_half = torch.as_tensor(A).to(half)
    got = countsketch_apply(
        A_half, torch.as_tensor(h), torch.as_tensor(s).to(half), d
    )
    assert got.dtype == torch.float32
    jdt = jnp.bfloat16 if half == torch.bfloat16 else jnp.float16
    A_j = jnp.asarray(A_half.to(torch.float32).numpy()).astype(jdt)
    want = j_apply(A_j, jnp.asarray(h), jnp.asarray(s).astype(jdt), d, interpret=True)
    assert want.dtype == jnp.float32
    mag = _magnitude(A_half.to(torch.float64).numpy(), h, d)
    assert np.all(np.abs(got.numpy() - np.asarray(want)) <= 1e-5 * mag)


def test_csr_order_reproduces_plain_bitwise():
    """The kernel's algorithm — each bucket summed over its CSR rows in
    order, starting from 0 — emulated on the CPU, equals index_add_."""
    m, d = 3000, 50
    A, h, s = _draw(3, m, d, (7,))
    A_t, h_t, s_t = map(torch.as_tensor, (A, h, s))
    csr = countsketch_csr(h_t, s_t, d, torch.float64)
    assert csr.rows.dtype == torch.int32 and csr.offsets[-1] == m
    counts = csr.offsets[1:] - csr.offsets[:-1]
    acc = torch.zeros((d, A.shape[1]), dtype=torch.float64)
    for k in range(int(counts.max())):
        live = counts > k
        j = csr.offsets[:-1][live] + k
        rows = csr.rows[j].long()
        acc[live] = acc[live] + csr.signs[j][:, None] * A_t[rows]
    for b in range(d):  # rows ascend inside every bucket
        seg = csr.rows[csr.offsets[b]: csr.offsets[b + 1]]
        assert torch.all(seg[1:] > seg[:-1])
    assert torch.equal(acc, countsketch_ref(A_t, h_t, s_t, d))


def _operators(m, d, seed=4):
    op_j = jsketch.CountSketch.sample(
        jax.random.key(seed), d, m, dtype=jnp.float64
    )
    op_t = countsketch_from_reference(
        np.asarray(op_j.buckets), np.asarray(op_j.signs), d, device=CPU
    )
    return op_j, op_t


@pytest.mark.parametrize("backend", ["auto", "reference"])
def test_operator_apply_matches_reference_operator(backend):
    m, d = 2000, 96
    op_j, op_t = _operators(m, d)
    A = np.random.default_rng(5).standard_normal((m, 12))
    np.testing.assert_array_equal(
        op_t.apply_op(torch.as_tensor(A), backend=backend).numpy(),
        np.asarray(op_j.apply_op(jnp.asarray(A), backend="reference")),
    )
    np.testing.assert_array_equal(
        op_t.apply(torch.as_tensor(A[:, 0]), backend=backend).numpy(),
        np.asarray(op_j.apply(jnp.asarray(A[:, 0]), backend="reference")),
    )


def test_apply_rows_and_restrict_cols():
    m, d = 1500, 64
    op_j, op_t = _operators(m, d, seed=6)
    A = np.random.default_rng(7).standard_normal((m, 9))
    full = op_t.apply(torch.as_tensor(A)).numpy()
    tiles = [(0, 400), (400, 1100), (1100, m)]
    parts = [op_t.apply_rows(torch.as_tensor(A[a:b]), a).numpy() for a, b in tiles]
    for (a, b), part in zip(tiles, parts):
        want = np.asarray(op_j.apply_rows(jnp.asarray(A[a:b]), a))
        np.testing.assert_array_equal(part, want)
    np.testing.assert_allclose(sum(parts), full, rtol=0, atol=1e-13 * np.abs(A).sum())
    idx = np.array([3, 17, 900, 1499, 5])
    sub_t = op_t.restrict_cols(torch.as_tensor(idx))
    sub_j = op_j.restrict_cols(jnp.asarray(idx))
    np.testing.assert_array_equal(sub_t.buckets.numpy(), np.asarray(sub_j.buckets))
    np.testing.assert_array_equal(
        sub_t.apply(torch.as_tensor(A[idx])).numpy(),
        np.asarray(sub_j.apply(jnp.asarray(A[idx]))),
    )
    np.testing.assert_array_equal(op_t.as_dense().numpy(), np.asarray(op_j.as_dense()))


def test_sampled_operator_is_valid():
    op = _port_sample(4096, 300)
    assert op.buckets.dtype == torch.int32
    assert int(op.buckets.min()) >= 0 and int(op.buckets.max()) < 300
    assert set(op.signs.unique().tolist()) == {-1.0, 1.0}
    # E[SᵀS] = I: ‖Sx‖² ≈ ‖x‖² on average over draws
    x = torch.randn(4096, dtype=torch.float64, generator=torch.Generator().manual_seed(0))
    ratios = [
        float(_port_sample(4096, 300, seed).apply(x).norm() ** 2 / x.norm() ** 2)
        for seed in range(20)
    ]
    assert abs(np.mean(ratios) - 1) < 0.05


def _port_sample(m, d, seed=0):
    return sample("clarkson_woodruff", seed, d, m, device=CPU)


def test_wrapper_rejects_bad_inputs():
    A = torch.zeros(10, 3)
    h = torch.zeros(10, dtype=torch.int32)
    s = torch.ones(10)
    with pytest.raises(ValueError):
        countsketch_apply(A, h[:5], s, 4)
    with pytest.raises(ValueError):
        countsketch_apply(torch.zeros(2, 2, 2), h, s, 4)
    with pytest.raises(TypeError):
        countsketch_apply(A.numpy(), h, s, 4)
    with pytest.raises(ValueError):
        countsketch_apply(A.to("meta"), h.to("meta"), s.to("meta"), 4)
