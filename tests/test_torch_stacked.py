"""Port parity: sketch escalation — ``extend_rows``, ``StackedSketch`` and
its ``extend_sketch`` — for every kind, against the JAX reference.

The reference escalates its own operator; ``repro_torch.convert`` carries
both blocks across, and the port stacks them with the same weights.

Tolerances:
- the weights: equal to the reference's (√(d/(d+e)), √(e/(d+e)));
- ``extend_sketch(B_top, A)``: **bitwise** ``apply_op(A)`` of the stacked
  operator from scratch, on both backends (every apply is deterministic);
- the stacked apply against the reference's, on the reference backend:
  bitwise for the kinds whose apply is (CountSketch, uniform-sparse,
  sparse-sign, SRHT: each block's values times a weight, in the same
  order), within ``2·γ_m·(|S||A|)`` for the dense kinds (XLA's and the CPU
  BLAS's products of the same S sum in another order);
- ``as_dense``/``apply_rows``/``restrict_cols``: bitwise compositions of
  the blocks' own.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import sketch as jsketch  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import SketchedFactor, StackedSketch, sample_sketch  # noqa: E402

CPU = "cpu"
KINDS = [
    "gaussian", "uniform_dense", "srht", "countsketch", "sparse_sign", "uniform_sparse",
]


def _gamma(k, dtype=torch.float64):
    u = torch.finfo(dtype).eps / 2
    return k * u / (1 - k * u)


def _convert(op_j):
    """The port's operator for a reference operator of any kind."""
    if isinstance(op_j, jsketch.StackedSketch):
        return StackedSketch(
            top=_convert(op_j.top), bottom=_convert(op_j.bottom),
            w_top=op_j.w_top, w_bottom=op_j.w_bottom,
        )
    if isinstance(op_j, jsketch.GaussianSketch):
        key = np.asarray(jax.random.key_data(op_j.key))
        return convert.gaussian_from_reference(key, op_j.d, op_j.m, np.asarray(op_j.S), device=CPU)
    if isinstance(op_j, jsketch.UniformDenseSketch):
        return convert.uniform_dense_from_reference(np.asarray(op_j.S), device=CPU)
    if isinstance(op_j, jsketch.SRHTSketch):
        return convert.srht_from_reference(
            np.asarray(op_j.signs), np.asarray(op_j.rows), op_j.d, op_j.m, device=CPU
        )
    if isinstance(op_j, jsketch.SparseSignSketch):
        return convert.sparse_sign_from_reference(
            np.asarray(op_j.buckets), np.asarray(op_j.signs), op_j.d, op_j.k, device=CPU
        )
    if isinstance(op_j, jsketch.UniformSparseSketch):
        return convert.uniform_sparse_from_reference(
            np.asarray(op_j.buckets), np.asarray(op_j.values), op_j.d, device=CPU
        )
    return convert.countsketch_from_reference(
        np.asarray(op_j.buckets), np.asarray(op_j.signs), op_j.d, device=CPU
    )


@pytest.mark.parametrize("kind", KINDS)
def test_extend_rows_weights_and_blocks(kind):
    d, e, m = 24, 8, 300
    op = sample_sketch(kind, 1, d, m, device=CPU)
    st = op.extend_rows(2, e)
    assert isinstance(st, StackedSketch) and st.top is op
    assert type(st.bottom) is type(op) and (st.bottom.d, st.bottom.m) == (e, m)
    assert (st.d, st.m, st.device) == (d + e, m, op.device)
    assert st.w_top == math.sqrt(d / (d + e)) and st.w_bottom == math.sqrt(e / (d + e))
    op_j = jsketch.sample(kind, jax.random.key(0), d, m, dtype=jnp.float64)
    st_j = op_j.extend_rows(jax.random.key(1), e)
    assert (st.w_top, st.w_bottom) == (st_j.w_top, st_j.w_bottom)
    # nested escalation keeps drawing the original kind
    st2 = st.extend_rows(3, 4)
    assert type(st2.bottom) is type(op) and st2.d == d + e + 4 and st2.top is st
    assert st2.w_top == math.sqrt((d + e) / (d + e + 4))
    with pytest.raises(ValueError, match="positive"):
        op.extend_rows(2, 0)


@pytest.mark.parametrize("backend", ["auto", "reference"])
@pytest.mark.parametrize("kind", KINDS)
def test_extend_sketch_is_bitwise_a_fresh_apply(kind, backend):
    m, n = 400, 7
    A = torch.as_tensor(np.random.default_rng(4).standard_normal((m, n)))
    op = sample_sketch(kind, 5, 32, m, device=CPU)
    st = op.extend_rows(6, 16).extend_rows(7, 8)
    B_top = st.top.apply_op(A, backend=backend)
    assert torch.equal(st.extend_sketch(B_top, A, backend=backend), st.apply_op(A, backend=backend))
    assert torch.equal(st.apply(A, backend=backend), st.apply_op(A, backend=backend))
    with pytest.raises(ValueError, match="B_top has"):
        st.extend_sketch(B_top[:-1], A)


@pytest.mark.parametrize("kind", KINDS)
def test_stacked_apply_matches_reference(kind):
    d, e, m = 40, 12, 500
    op_j = jsketch.sample(kind, jax.random.key(2), d, m, dtype=jnp.float64)
    st_j = op_j.extend_rows(jax.random.key(3), e)
    st = _convert(st_j)
    A = np.random.default_rng(5).standard_normal((m, 6))
    want = np.asarray(st_j.apply(jnp.asarray(A), backend="reference"))
    got = st.apply(torch.as_tensor(A), backend="reference").numpy()
    if kind in ("gaussian", "uniform_dense"):
        mag = np.abs(np.asarray(st_j.as_dense())) @ np.abs(A)
        assert np.all(np.abs(got - want) <= 2 * _gamma(m) * mag)
    else:
        assert np.array_equal(got, want)
    B_top = np.array(st_j.top.apply(jnp.asarray(A), backend="reference"))
    ext_j = np.asarray(st_j.extend_sketch(jnp.asarray(B_top), jnp.asarray(A), backend="reference"))
    ext = st.extend_sketch(torch.as_tensor(B_top), torch.as_tensor(A), backend="reference").numpy()
    assert np.array_equal(ext[:d], ext_j[:d])  # the stored rows, reweighted
    if kind not in ("gaussian", "uniform_dense"):
        assert np.array_equal(ext, ext_j)
    assert np.array_equal(st.as_dense().numpy(), np.asarray(st_j.as_dense()))


@pytest.mark.parametrize("kind", KINDS)
def test_stacked_streaming_and_restriction(kind):
    m = 300
    op = sample_sketch(kind, 8, 20, m, device=CPU)
    st = op.extend_rows(9, 10)
    tile = torch.as_tensor(np.random.default_rng(6).standard_normal((50, 4)))
    if kind == "srht":
        assert st.stream_semantics == "place" and st.restrict_cols(slice(0, 5)) is None
        with pytest.raises(NotImplementedError, match="placement"):
            st.apply_rows(tile, 100)
        return
    assert st.stream_semantics == "add"
    want = torch.cat([st.w_top * op.apply_rows(tile, 100), st.w_bottom * st.bottom.apply_rows(tile, 100)])
    assert torch.equal(st.apply_rows(tile, 100), want)
    sub = st.restrict_cols(slice(100, 150))
    assert isinstance(sub, StackedSketch) and (sub.d, sub.m) == (30, 50)
    assert torch.equal(sub.as_dense(), st.as_dense()[:, 100:150])


def test_stacked_operator_drives_the_factor():
    """A stacked operator is accepted as ``sketch=`` and gives the factor of
    its own apply."""
    m, n = 2000, 10
    A = torch.as_tensor(np.random.default_rng(7).standard_normal((m, n)))
    st = sample_sketch("countsketch", 1, 60, m, device=CPU).extend_rows(2, 40)
    _, op, B = SketchedFactor.build_full(A, 0, sketch=st, device=CPU)
    assert op is st and torch.equal(B, st.apply(A))
    _, _, B_fused = SketchedFactor.build_full(A, 0, sketch=st, fused=True, device=CPU)
    assert torch.equal(B_fused, B)
