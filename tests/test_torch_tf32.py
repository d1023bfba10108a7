"""The f32 engines of kernels B6 and B2 (``csrc/tf32_mma.cuh``, split TF32),
checked without a card.

- ``kernels.common.tf32_split`` (the plain version of the kernels' splits
  of each factor into two TF32 parts) against an independent numpy
  emulation on the words, ``rna_tf32(x) = (bits + 0x1000) & 0xFFFFE000``:
  both parts keep 13 zero low bits; rounded (A and the Gram's factors),
  big + small is x within 2^-22·|x| and ±inf and NaN split to (0, x), so
  an inf or NaN in A gives the plain product's; truncated (S, whose big
  part is its own word as the tensor cores read it), within 2^-21·|x|,
  and ±inf and NaN split to (x, 0) (2^-137 more below f32's normal range,
  where the small part is subnormal);
- the exact probes of ``chip_smoke.py`` phase 2, emulated: with one ±1 a
  row of S, the three-product route reproduces ±rows of A within
  2^-20·|A|, and with one ±1 a column of A, ±columns of S within
  2^-20·|S|; one TF32 product of the rounded inputs reads past both;
- the Gram's exact three-part split and six products: a one-row B's G
  within 2·γ_1·|B|ᵀ|B| of the plain version's;
- the emulated three-product route against the reference's Pallas
  ``sketch_matmul`` (interpret mode) within 2·γ_m·|S||A|, and against the
  f64 product within 5·2^-22·|S||A| (the splits' own error);
- the f32 plans of ``sketch_split`` / ``gram_split``: slabs that cover the
  reduction once, in order, at the engines' stages, with f32 partials, and
  B6's scratch holding A^T's two parts after them;
- the f32 route's C arguments (B6, B7): S on 16-byte row pitches (A is
  read by the split kernel, unpadded), the f32 plans and their scratch,
  the engines' shapes as the CUDA sources set them;
- the bound: an f32 launch of B6 counts three TF32 products (3.18 ms at
  d = 4000, m = 2^16, n = 1000), the f32 Gram six (0.049 ms).
"""
import contextlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

import jax.numpy as jnp  # noqa: E402
from repro.kernels.sketch_matmul import sketch_matmul as j_matmul  # noqa: E402
from repro_torch.kernels import _build, autotune  # noqa: E402
from repro_torch.kernels.common import (  # noqa: E402
    GRAM_MMA_TILE,
    TF32_ALIGN,
    TF32_GRAM_STEP,
    TF32_MMA_COLS,
    TF32_MMA_ROWS,
    TF32_MMA_STEP,
    cdiv,
    gram_split,
    sketch_split,
    split_plan,
    tf32_split,
)

U = 2.0**-24  # f32's unit roundoff


def _np_rna(bits):
    return (bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)


def _np_split(x, truncated=False):
    """The splits on uint32 words, written apart from the port's."""
    x = np.asarray(x, np.float32)
    bits = x.view(np.uint32)
    expo = bits & np.uint32(0x7F800000)
    finite = expo != np.uint32(0x7F800000)
    if truncated:
        big = np.where(finite, bits & np.uint32(0xFFFFE000), bits).astype(np.uint32)
    else:
        with np.errstate(over="ignore"):
            big = _np_rna(bits)
        over = (big & np.uint32(0x7F800000)) == np.uint32(0x7F800000)
        big = np.where(over, bits & np.uint32(0xFFFFE000), big)
        big = np.where(finite, big, np.uint32(0)).astype(np.uint32)
    with np.errstate(invalid="ignore"):
        rest = np.where(finite, x - big.view(np.float32), np.float32(0)).astype(np.float32)
    nan_bit = np.where(bits & np.uint32(0x007FFFFF), np.uint32(0x00400000), np.uint32(0))
    rest_small = _np_rna(rest.view(np.uint32))
    small = np.where(finite, rest_small, np.uint32(0) if truncated else (bits | nan_bit) & np.uint32(0xFFFFE000))
    return big.view(np.float32), small.astype(np.uint32).view(np.float32)


def _rna1(x):
    """One TF32 rounding (the 1×TF32 shortcut's operands)."""
    return _np_rna(np.asarray(x, np.float32).view(np.uint32)).view(np.float32)


@pytest.mark.parametrize("truncated", [False, True])
@settings(max_examples=300, deadline=None)
@given(st.lists(st.floats(width=32, allow_nan=True, allow_infinity=True), min_size=1, max_size=64))
def test_split_matches_the_word_emulation(truncated, values):
    x = np.asarray(values, np.float32)
    big, small = tf32_split(torch.from_numpy(x.copy()), truncated)
    want_big, want_small = _np_split(x, truncated)
    assert np.array_equal(big.numpy().view(np.uint32), want_big.view(np.uint32))
    assert np.array_equal(small.numpy().view(np.uint32), want_small.view(np.uint32))


@pytest.mark.parametrize("truncated", [False, True])
@settings(max_examples=300, deadline=None)
@given(st.lists(st.floats(width=32, allow_nan=False, allow_infinity=False), min_size=1, max_size=64))
def test_split_reconstructs_finite_values(truncated, values):
    """Rounded: within 2^-22·|x|, the small part within 2^-11·|x|; truncated
    (and a rounded x at the top of f32's range, whose rounding overflows),
    2^-21·|x| and 2^-10·|x|."""
    x = np.asarray(values, np.float32)
    big, small = (t.numpy() for t in tf32_split(torch.from_numpy(x.copy()), truncated))
    assert not np.any(big.view(np.uint32) & np.uint32(0x1FFF))
    assert not np.any(small.view(np.uint32) & np.uint32(0x1FFF))
    with np.errstate(over="ignore"):
        overflows = (_np_rna(x.view(np.uint32)) & np.uint32(0x7F800000)) == np.uint32(0x7F800000)
    cut = overflows | truncated
    ax = np.abs(x.astype(np.float64))
    err = np.abs(big.astype(np.float64) + small.astype(np.float64) - x.astype(np.float64))
    assert np.all(err <= np.maximum(np.where(cut, 2.0**-21, 2.0**-22) * ax, 2.0**-137))
    # below f32's normal range the small part is a multiple of 2^-136
    assert np.all(np.abs(small.astype(np.float64)) <= np.where(cut, 2.0**-10, 2.0**-11) * ax + 2.0**-136)


@pytest.mark.parametrize("x", [np.inf, -np.inf, np.nan, -np.nan])
def test_non_finite_values_split_to_zero_and_themselves(x):
    """Rounded, (0, x): the inf or NaN meets only the other factor's big
    part, which has that factor's sign (with (x, 0) it would meet the
    other's small part too, of its own sign, and inf − inf would give NaN).
    Truncated (S), (x, 0): its big part is its own word."""
    big, small = tf32_split(torch.tensor([x], dtype=torch.float32))
    assert big.item() == 0.0
    assert (np.isnan(small.item()) and np.isnan(x)) or small.item() == x
    big, small = tf32_split(torch.tensor([x], dtype=torch.float32), truncated=True)
    assert small.item() == 0.0
    assert (np.isnan(big.item()) and np.isnan(x)) or big.item() == x


def test_an_inf_in_a_gives_the_plain_product():
    rng = np.random.default_rng(5)
    S = rng.standard_normal((16, 40)).astype(np.float32)
    A = rng.standard_normal((40, 6)).astype(np.float32)
    A[7, 3], A[9, 4] = np.inf, np.nan
    with np.errstate(invalid="ignore"):
        want = S.astype(np.float64) @ A.astype(np.float64)
        got = _three(S, A)
    assert np.array_equal(np.isnan(got), np.isnan(want)) and np.array_equal(got[np.isinf(want)], want[np.isinf(want)])
    assert np.isinf(got[:, 3]).all() and np.isnan(got[:, 4]).all()


def test_rounding_past_the_largest_f32_truncates():
    x = np.float32(np.finfo(np.float32).max)
    big, small = tf32_split(torch.tensor([x, -x]))
    assert torch.isfinite(big).all() and torch.equal(big, -big.flip(0))
    assert abs(float(big[0]) + float(small[0]) - float(x)) <= 2.0**-22 * float(x)


def _three(S, A):
    """B6's three products (big·small + small·big + big·big; S split
    truncated, A rounded), summed in f64: the splits' error alone."""
    (Sb, Ss), (Ab, As) = _np_split(S, truncated=True), _np_split(A)
    f = lambda t: t.astype(np.float64)  # noqa: E731
    with np.errstate(invalid="ignore"):
        return f(Sb) @ f(As) + f(Ss) @ f(Ab) + f(Sb) @ f(Ab)


def _np_split3(x):
    """The Gram's three parts: the rounded split's two, then the rest."""
    x0, x1 = _np_split(x)
    rest = (np.asarray(x, np.float32) - x0) - x1
    finite = np.isfinite(np.asarray(x, np.float32))
    x2 = np.where(finite, _np_rna(rest.view(np.uint32)), np.uint32(0)).astype(np.uint32).view(np.float32)
    return x0, x1, x2


def _gram6(B):
    """The Gram's six products (x0·y0 on its own, the five corrections
    beside it), each sum in f64, then added in f32: B2's f32 engine with
    exact sums."""
    x0, x1, x2 = (p.astype(np.float64) for p in _np_split3(B))
    main = x0.T @ x0
    cor = x2.T @ x0 + x0.T @ x2 + x1.T @ x1 + x1.T @ x0 + x0.T @ x1
    return main.astype(np.float32) + cor.astype(np.float32)


@settings(max_examples=300, deadline=None)
@given(st.lists(st.floats(width=32, allow_nan=False, allow_infinity=False, allow_subnormal=False,
                          min_value=-2.0**127, max_value=2.0**127), min_size=1, max_size=64))
def test_three_part_split_is_exact(values):
    """The Gram's split: x = x0 + x1 + x2 exactly in f32's normal range, each
    part with 13 zero low bits (so the tensor cores read it exactly)."""
    x = np.asarray(values, np.float32)
    x = x[np.abs(x) >= 2.0**-100]  # parts of far smaller values fall below the normal range
    parts = _np_split3(x)
    assert all(not np.any(p.view(np.uint32) & np.uint32(0x1FFF)) for p in parts)
    assert np.array_equal(sum(p.astype(np.float64) for p in parts), x.astype(np.float64))


@pytest.mark.parametrize("n", [2, 7, 40])
def test_gram_of_one_row_keeps_the_plain_bound(n):
    """d = 1: G = bᵀb with one product a sum, where 2·γ_1·|b|ᵀ|b| leaves
    about one ulp; the six products keep it, where three (the two-part
    split's 2^-21) would not."""
    rng = np.random.default_rng(12)
    for _ in range(50):
        B = rng.standard_normal((1, n)).astype(np.float32)
        plain = (B.T @ B).astype(np.float64)  # each entry one rounded product
        mag = np.abs(B.T.astype(np.float64)) @ np.abs(B.astype(np.float64))
        gamma = U / (1 - U)
        assert np.all(np.abs(_gram6(B).astype(np.float64) - plain) <= 2 * gamma * mag)


@pytest.mark.parametrize("d,m,n", [(64, 4096, 48), (300, 777, 5)])
def test_selection_probe_separates_three_products_from_one(d, m, n):
    rng = np.random.default_rng(7)
    A = rng.standard_normal((m, n)).astype(np.float32)  # full 24-bit significands
    rows = rng.integers(0, m, d)
    sign = rng.choice(np.float32([-1, 1]), d)
    S = np.zeros((d, m), np.float32)
    S[np.arange(d), rows] = sign
    want = sign[:, None].astype(np.float64) * A[rows].astype(np.float64)
    scale = np.abs(A[rows]).astype(np.float64)
    three = np.max(np.abs(_three(S, A) - want) / scale)
    one = np.max(np.abs(_rna1(S).astype(np.float64) @ _rna1(A).astype(np.float64) - want) / scale)
    assert three <= 2.0**-22 < 2.0**-20 < one


@pytest.mark.parametrize("d,m,n", [(48, 4096, 64), (5, 777, 300)])
def test_column_probe_separates_three_products_from_one(d, m, n):
    """The probe of S's (truncated) split: one ±1 a column of A gives ±columns
    of S, within 2^-21·|S| on three products; one TF32 product reads past
    2^-20."""
    rng = np.random.default_rng(8)
    S = rng.standard_normal((d, m)).astype(np.float32)
    cols = rng.integers(0, m, n)
    sign = rng.choice(np.float32([-1, 1]), n)
    A = np.zeros((m, n), np.float32)
    A[cols, np.arange(n)] = sign
    want = S[:, cols].astype(np.float64) * sign[None, :]
    scale = np.abs(S[:, cols]).astype(np.float64)
    three = np.max(np.abs(_three(S, A) - want) / scale)
    one = np.max(np.abs(_rna1(S).astype(np.float64) @ _rna1(A).astype(np.float64) - want) / scale)
    assert three <= 2.0**-21 < 2.0**-20 < one


def test_gram_probe_reads_exact_off_diagonals():
    """The Gram probe of chip_smoke.py phase 2: one full-mantissa nonzero a
    row of B, so G's off-diagonal is exactly 0 and its diagonal each
    column's sum of squares; the six products within 2^-20, one past it."""
    rng = np.random.default_rng(3)
    s, n = 2000, 40
    B = np.zeros((s, n), np.float32)
    cols = rng.integers(0, n, s)
    B[np.arange(s), cols] = rng.standard_normal(s).astype(np.float32)
    want = np.zeros(n)
    np.add.at(want, cols, B[np.arange(s), cols].astype(np.float64) ** 2)
    G6 = _gram6(B).astype(np.float64)
    G1 = _rna1(B.T).astype(np.float64) @ _rna1(B).astype(np.float64)
    assert np.all(G6[~np.eye(n, dtype=bool)] == 0)
    assert np.max(np.abs(np.diag(G6) - want) / want) <= 2.0**-20 < np.max(np.abs(np.diag(G1) - want) / want)


@pytest.mark.parametrize("d,m,n", [(24, 40, 7), (37, 300, 3), (8, 1024, 33)])
def test_three_products_hold_the_f32_bound_of_the_reference(d, m, n):
    rng = np.random.default_rng(11)
    S = rng.standard_normal((d, m)).astype(np.float32)
    A = rng.standard_normal((m, n)).astype(np.float32)
    mag = np.abs(S).astype(np.float64) @ np.abs(A).astype(np.float64)
    exact = S.astype(np.float64) @ A.astype(np.float64)
    got = _three(S, A)
    assert np.all(np.abs(got - exact) <= 5 * 2.0**-22 * mag)
    want = np.asarray(j_matmul(jnp.asarray(S), jnp.asarray(A), interpret=True))
    gamma = m * U / (1 - m * U)
    assert np.all(np.abs(got.astype(np.float32) - want) <= 2 * gamma * mag)


def _slabs(length, slab, parts):
    return [(p * slab, min((p + 1) * slab, length)) for p in range(parts)]


@pytest.mark.parametrize("d,m,n", [(4000, 2**16, 1000), (4000, 2**16, 2), (300, 1007, 130), (37, 20, 3),
                                   (1, 300, 2), (129, 4096, 257), (7, 0, 9)])
def test_f32_sketch_split_covers_m_once_in_order(d, m, n):
    split = sketch_split(torch.float32, d, m, n, 132)
    tiles = cdiv(d, TF32_MMA_ROWS) * cdiv(n, TF32_MMA_COLS)
    assert (split.slab, split.parts) == split_plan(m, tiles, 132, TF32_MMA_STEP)
    assert split.slab % TF32_MMA_STEP == 0 and split.slab >= TF32_MMA_STEP
    covered = [k for lo, hi in _slabs(m, split.slab, split.parts) for k in range(lo, hi)]
    assert covered == list(range(m))
    section = lambda k: cdiv(k, TF32_ALIGN) * TF32_ALIGN  # noqa: E731
    partials = section(split.parts * tiles * TF32_MMA_ROWS * TF32_MMA_COLS) if split.parts > 1 else 0
    # f32 partial tiles, then A^T's two parts on rows of a multiple of 4; two to an f64 word
    assert split.scratch == cdiv(partials + 2 * section(n * cdiv(m, 4) * 4), 2)


@pytest.mark.parametrize("s,n", [(4000, 1000), (4000, 130), (1007, 777), (3, 5), (333, 1), (0, 4)])
def test_f32_gram_split_covers_s_once_in_order(s, n):
    split = gram_split(torch.float32, s, n, 132)
    t = cdiv(n, GRAM_MMA_TILE)
    tiles = t * (t + 1) // 2
    assert (split.slab, split.parts) == split_plan(s, tiles, 132, TF32_GRAM_STEP)
    assert split.slab % TF32_GRAM_STEP == 0
    covered = [k for lo, hi in _slabs(s, split.slab, split.parts) for k in range(lo, hi)]
    assert covered == list(range(s))
    assert split.scratch == (cdiv(split.parts * tiles * GRAM_MMA_TILE**2, 2) if split.parts > 1 else 0)


def test_f32_gram_fills_the_card_at_the_main_shape():
    # 136 upper tiles on 132 SMs: one slab would leave the card half idle in a second wave
    assert gram_split(torch.float32, 4000, 1000, 132).parts > 1


def _constexpr(name, text):
    found = re.search(rf"constexpr int {name} = (\w+);", text)
    assert found, name
    return found.group(1)


def test_engine_shapes_match_the_cuda_source():
    text = (_build.CSRC / "tf32_mma.cuh").read_text()
    assert int(_constexpr("kTfBK", text)) == TF32_MMA_STEP
    assert int(_constexpr("kTfGramK", text)) == TF32_GRAM_STEP
    assert (int(_constexpr("kTfBD", text)), int(_constexpr("kTfBN", text))) == (TF32_MMA_ROWS, TF32_MMA_COLS)
    assert int(_constexpr("kTfGramTile", text)) == GRAM_MMA_TILE
    assert int(_constexpr("kTfAlign", text)) == TF32_ALIGN


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


@pytest.mark.parametrize("d,m,n,sms", [(300, 2048, 300, 132), (300, 2046, 301, 1), (1000, 1001, 2, 132),
                                       (37, 20, 3, 132)])
def test_f32_route_hands_b6_and_b7_the_engine_plans(monkeypatch, d, m, n, sms):
    """The CUDA branches of B6 and B7 in f32, run on CPU tensors against a
    recording library: the f32 engine's split of the sum over m, its
    scratch (A^T's parts, and the f32 partials when it splits) always
    given, B7's Gram the f32 Gram's split, S on 16-byte row pitches (a
    padded copy where m is not a multiple of 4) and A unpadded."""
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
    A = torch.randn(m, n, dtype=torch.float32)
    split, split_g = sketch_split(torch.float32, d, m, n, sms), gram_split(torch.float32, d, n, sms)
    out = sm_ops.sketch_matmul(S, A)
    B, G = fused.matmul_gram(S, A)
    assert out.dtype == B.dtype == G.dtype == torch.float32
    b6, b7 = lib.calls["repro_sketch_matmul"], lib.calls["repro_matmul_gram"]
    assert len(b6) == len(_build._SIGNATURES["repro_sketch_matmul"])
    assert len(b7) == len(_build._SIGNATURES["repro_matmul_gram"])
    assert b6[0] == b7[0] == _build.dtype_code(torch.float32)
    assert b6[5:10] == (d, m, n, split.slab, split.parts) == b7[6:11]
    assert b7[11:13] == (split_g.slab, split_g.parts)
    assert b6[4] is not None and b7[5] is not None
    assert split.scratch >= split_g.scratch or split_g.parts > 1
    pitch = lambda k: -(-k // 4) * 4  # noqa: E731
    assert b6[10:12] == (pitch(m), n) == b7[13:15]
    S_t, lds = sm_ops.pitched(S.to(torch.float32).contiguous())
    assert lds == pitch(m) and torch.equal(S_t[:, :m], S.to(torch.float32))
    b = torch.randn(m, dtype=torch.float32)
    assert sm_ops.engine_operands(S.float(), b[:, None])[2:] == (m, 1)  # b: the vector kernel, unpadded


def test_f32_launches_count_three_tf32_products():
    D, M, N = 4000, 2**16, 1000
    ops, nbytes = autotune.work("sketch_matmul", M, N, D, torch.float32)
    assert ops == 3 * 2 * D * M * N and nbytes == (D * M + M * N + D * N) * 4
    assert autotune.peak("sketch_matmul", torch.float32) == autotune.peak("tsqr", torch.float32) == "tf32"
    assert autotune.PEAK_FLOPS["tf32"] == 495e12
    assert autotune.predict_cost("sketch_matmul", M, N, D, torch.float32) * 1e3 == pytest.approx(3.18, rel=5e-3)
    # the Gram: six TF32 products (three parts a value, exact)
    assert autotune.work("tsqr", M, N, D, torch.float32)[0] == 6 * D * N * (N + 1)
    assert autotune.predict_cost("tsqr", M, N, D, torch.float32) * 1e3 == pytest.approx(0.0485, rel=5e-3)
    # B4 in f32 stays on the FMA pipes: one product at 67 TFLOP/s
    assert autotune.peak("gaussian", torch.float32) == "float32"
    assert autotune.predict_cost("gaussian", M, N, D, torch.float32) * 1e3 == pytest.approx(7.825, rel=5e-3)
