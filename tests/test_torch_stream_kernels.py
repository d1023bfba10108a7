"""Kernel B1's fold mode (``countsketch_apply(..., out=)``) and kernel B4's
column offset (``fused_gaussian_sketch(..., col0=)``), checked without a
card.

- Their CUDA branches, run on CPU tensors against a library that records
  each C call (as ``test_torch_gaussian_plan.py`` and
  ``test_torch_sparse_input.py`` do): ``out=`` launches
  ``repro_countsketch_fold`` with the state as its output and otherwise the
  arguments of ``repro_countsketch_apply``; ``col0`` launches
  ``repro_fused_gaussian_cols`` with col0 after the key words and otherwise
  the arguments of ``repro_fused_gaussian``; without them every existing
  argument list is unchanged.  Each argument list has its C entry's length.
- The streaming accumulators reach those entries: a bucket-kind tile folds
  into the state through ``repro_countsketch_fold``, a Gaussian tile runs
  ``repro_fused_gaussian_cols`` with col0 = the tile's row offset.
- Their plain versions: a tile-by-tile fold is bitwise the one-call apply
  for any tiling (the state's ``index_add_``, each product rounded on its
  own); the kernel's order — each bucket summed over its CSR segment,
  starting from the state — emulated on the CPU is bitwise the plain fold,
  on the sparse-sign sketch's k·d-bucket CSR too; the column-offset
  Gaussian is bitwise the product with the slice of the whole S.
"""
import contextlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro_torch.core import sketch as tsketch  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.countsketch import (  # noqa: E402
    countsketch_apply,
    countsketch_csr,
    countsketch_fold_ref,
    countsketch_ref,
)
from repro_torch.kernels.countsketch import ops as cs_ops  # noqa: E402
from repro_torch.kernels.sketch_matmul import (  # noqa: E402
    default_scale,
    fused_gaussian_ref,
    fused_gaussian_sketch,
    gaussian_matrix_ref,
)
from repro_torch.kernels.sketch_matmul import ops as sm_ops  # noqa: E402
from repro_torch.streaming import ArraySource, accumulate_source, make_accumulator  # noqa: E402

CPU = "cpu"


class _Lib:
    """A stand-in for the kernel library that records every C call."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("repro_"):
            raise AttributeError(name)

        def record(*args):
            self.calls.append((name, args))
            return 0

        return record

    def entries(self):
        return [name for name, _ in self.calls]


def _c_params(src, name):
    text = (_build.CSRC / src).read_text()
    match = re.search(rf'extern "C" int {name}\(([^)]*)\)', text)
    return [" ".join(a.split()) for a in match.group(1).split(",")]


@pytest.fixture
def wired(monkeypatch):
    """Run the CUDA branches of B1's and B4's wrappers on CPU tensors."""
    lib = _Lib()

    def cs_prepare(name, A, buckets, signs, d, csr, ndims):
        A2 = (A[:, None] if A.ndim == 1 else A).contiguous()
        if csr is None:
            csr = countsketch_csr(buckets, signs, d, A.dtype)
        cs_ops._check_csr(csr, A2, buckets.numel(), d)
        return _build.dtype_code(A.dtype), A2, csr

    def sm_prepare(name, A, ndims):
        return _build.dtype_code(A.dtype), (A[:, None] if A.ndim == 1 else A).contiguous()

    monkeypatch.setattr(cs_ops, "_prepare", cs_prepare)
    monkeypatch.setattr(sm_ops, "_prepare", sm_prepare)
    monkeypatch.setattr(sm_ops, "sm_count", lambda device: 132)
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    return lib


def _bucket_draw(seed, m, d, n, k=None, dtype=torch.float64):
    g = torch.Generator().manual_seed(seed)
    shape = (m,) if k is None else (k, m)
    h = torch.randint(0, d, shape, generator=g, dtype=torch.int32)
    s = (torch.randint(0, 2, shape, generator=g) * 2 - 1).to(dtype)
    A = torch.randn((m, n) if n else (m,), generator=g, dtype=torch.float64).to(dtype)
    return A, h, s


# ---------------------------------------------------------------------------
# B1: the fold mode's C arguments
# ---------------------------------------------------------------------------


def test_fold_entry_is_declared_like_the_apply_entry():
    apply = _c_params("countsketch.cu", "repro_countsketch_apply")
    fold = _c_params("countsketch.cu", "repro_countsketch_fold")
    assert fold == apply
    assert _build._SIGNATURES["repro_countsketch_fold"] == _build._SIGNATURES["repro_countsketch_apply"]


@pytest.mark.parametrize("n", [0, 1, 7])
@pytest.mark.parametrize("k", [None, 3])
def test_fold_hands_the_state_to_its_entry(wired, n, k):
    lib = wired
    m, d = 500, 40
    A, h, s = _bucket_draw(1, m, d, n, k)
    csr = countsketch_csr(h, s, d, A.dtype)
    before = countsketch_apply.launches
    countsketch_apply(A, h, s, d, csr=csr)
    (name, plain_args), = lib.calls
    assert name == "repro_countsketch_apply"
    A2 = A[:, None] if A.ndim == 1 else A
    head = (_build.dtype_code(A.dtype), A2.data_ptr(), csr.rows.data_ptr(), csr.signs.data_ptr(),
            csr.offsets.data_ptr())
    cols = max(n, 1)
    assert plain_args[:5] == head and plain_args[6:] == (d, cols, 0)
    state = torch.zeros((d, cols) if n else (d,), dtype=torch.float64)
    got = countsketch_apply(A, h, s, d, csr=csr, out=state)
    name, fold_args = lib.calls[1]
    assert name == "repro_countsketch_fold" and got is state
    assert fold_args[:5] == head and fold_args[5] == state.data_ptr() and fold_args[6:] == (d, cols, 0)
    assert len(fold_args) == len(_build._SIGNATURES[name]) == len(plain_args)
    assert countsketch_apply.launches == before + 2  # one per launch, fold or not


def test_fold_checks_its_state():
    A, h, s = _bucket_draw(2, 100, 10, 4)
    for bad in (torch.zeros((10, 3), dtype=torch.float64),   # wrong shape
                torch.zeros((10, 4), dtype=torch.float32),   # wrong dtype
                torch.zeros((4, 10), dtype=torch.float64).T,  # not contiguous
                np.zeros((10, 4))):                          # not a tensor
        with pytest.raises(ValueError, match="out must be"):
            countsketch_apply(A, h, s, 10, out=bad)
    half, h2, s2 = _bucket_draw(2, 100, 10, 4, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="float32"):
        countsketch_apply(half, h2, s2, 10, out=torch.zeros((10, 4), dtype=torch.bfloat16))


@pytest.mark.parametrize("kind", ["countsketch", "uniform_sparse", "sparse_sign"])
def test_accumulator_folds_through_the_fold_entry(wired, kind):
    """Each tile of a bucket kind is one B1 fold launch into the state (the
    sparse-sign sketch's over k·d buckets); nothing else is launched."""
    lib = wired
    m, n, d = 1000, 5, 30
    op = tsketch.sample(kind, torch.Generator().manual_seed(3), d, m, device=CPU)
    A = torch.randn((m, n), generator=torch.Generator().manual_seed(4), dtype=torch.float64)
    acc = make_accumulator(op, n)
    for o in range(0, m, 300):
        acc.update(A[o : o + 300], o)
    assert lib.entries() == ["repro_countsketch_fold"] * 4
    rows = op.k * d if kind == "sparse_sign" else d
    for name, args in lib.calls:
        assert args[5] == acc.state.data_ptr() and args[6:8] == (rows, n)


# ---------------------------------------------------------------------------
# B1: the fold mode's plain version and the kernel's order
# ---------------------------------------------------------------------------


@settings(max_examples=25, deadline=None)
@given(
    m=st.integers(1, 300),
    cuts=st.lists(st.integers(1, 299), max_size=8),
    k=st.sampled_from([None, 1, 4]),
    n=st.integers(0, 4),
    dtype=st.sampled_from([torch.float64, torch.float32]),
    seed=st.integers(0, 2**20),
)
def test_tile_fold_is_bitwise_the_apply(m, cuts, k, n, dtype, seed):
    d = 1 + seed % 13
    A, h, s = _bucket_draw(seed, m, d, n, k, dtype)
    if k is not None:
        # the accumulator's layout: block j's buckets are j·d + h_j (with k
        # blocks in one bucket space a bucket's blocks would interleave
        # across tiles, another order than the one-call apply's)
        h, d = h + torch.arange(k, dtype=torch.int32)[:, None] * d, k * d
    cuts = sorted({c for c in cuts if c < m} | {0, m})
    state = torch.zeros((d, n) if n else (d,), dtype=dtype)
    for a, b in zip(cuts[:-1], cuts[1:]):
        countsketch_apply(A[a:b], h[..., a:b], s[..., a:b], d, out=state)
    assert torch.equal(state, countsketch_ref(A, h, s, d))


@pytest.mark.parametrize("half", [torch.bfloat16, torch.float16])
def test_half_tiles_fold_into_an_f32_state(half):
    A, h, s = _bucket_draw(5, 400, 20, 6, dtype=half)
    state = torch.zeros((20, 6), dtype=torch.float32)
    for o in range(0, 400, 128):
        countsketch_apply(A[o : o + 128], h[o : o + 128], s[o : o + 128], 20, out=state)
    assert torch.equal(state, countsketch_ref(A, h, s, 20))


def _kernel_fold(state, csr, A):
    """The fold kernel's order on the CPU: each bucket starts from its
    state and adds its CSR segment's products, each rounded on its own."""
    out = state.clone()
    counts = csr.offsets[1:] - csr.offsets[:-1]
    for j in range(int(counts.max()) if counts.numel() else 0):
        live = counts > j
        e = csr.offsets[:-1][live] + j
        out[live] = out[live] + csr.signs[e][:, None] * A[csr.rows[e].long()]
    return out


@pytest.mark.parametrize("k", [None, 4])
def test_kernel_order_fold_is_bitwise_the_plain_fold(k):
    """A CSR of the tile (for sparse-sign over bucket ids j·d + h_j, the
    accumulator's k·d partial sums) walked from the state, as the fold
    kernel walks it, gives the plain fold's bits."""
    m, d, n = 700, 25, 6
    A, h, s = _bucket_draw(6, m, d, n, k)
    if k is not None:
        h = h + torch.arange(k, dtype=torch.int32)[:, None] * d
    rows = d if k is None else k * d
    state = torch.zeros((rows, n), dtype=torch.float64)
    for o in range(0, m, 256):
        t = min(256, m - o)
        hh, ss = h[..., o : o + t], s[..., o : o + t]
        csr = countsketch_csr(hh, ss, rows, torch.float64)
        emulated = _kernel_fold(state, csr, A[o : o + t])
        countsketch_fold_ref(state, A[o : o + t], hh, ss)
        assert torch.equal(emulated, state)


# ---------------------------------------------------------------------------
# B4: the column offset's C arguments
# ---------------------------------------------------------------------------


def test_cols_entry_is_declared_with_col0_after_the_key():
    whole = _c_params("fused_gaussian.cu", "repro_fused_gaussian")
    cols = _c_params("fused_gaussian.cu", "repro_fused_gaussian_cols")
    assert cols == whole[:3] + ["uint32_t col0"] + whole[3:]
    sig = _build._SIGNATURES
    assert sig["repro_fused_gaussian_cols"] == sig["repro_fused_gaussian"][:3] + [_build.ctypes.c_uint32] + \
        sig["repro_fused_gaussian"][3:]


_POINTERS = (5, 6)  # out and scratch: fresh buffers on every call


def _without_pointers(args):
    return tuple(a for i, a in enumerate(args) if i not in _POINTERS)


@pytest.mark.parametrize("shape", [(4096, 300), (1007, 9), (2048,)])
def test_col0_hands_its_entry_the_whole_entry_arguments(wired, shape):
    lib = wired
    d = 257
    A = torch.randn(shape, generator=torch.Generator().manual_seed(7), dtype=torch.float64)
    before = fused_gaussian_sketch.launches
    fused_gaussian_sketch(A, (3, 4), d)
    (name, whole), = lib.calls
    assert name == "repro_fused_gaussian" and len(whole) == len(_build._SIGNATURES[name])
    assert whole[:5] == (_build.dtype_code(A.dtype), 3, 4, default_scale(d), A.data_ptr())
    for col0 in (0, 8192, 2**32 - shape[0]):
        fused_gaussian_sketch(A, (3, 4), d, col0=col0)
        name, args = lib.calls[-1]
        assert name == "repro_fused_gaussian_cols" and len(args) == len(_build._SIGNATURES[name])
        assert args[3] == col0
        assert _without_pointers(args[:3] + args[4:]) == _without_pointers(whole)
    assert fused_gaussian_sketch.launches == before + 4


def test_col0_range_is_checked():
    A = torch.zeros((100, 2), dtype=torch.float64)
    for col0 in (-1, 2**32 - 99):
        with pytest.raises(ValueError, match="col0"):
            fused_gaussian_sketch(A, (3, 4), 10, col0=col0)


def test_gaussian_apply_rows_and_accumulator_reach_the_cols_entry(wired):
    """A Gaussian row tile is one B4 launch with col0 = its row offset,
    from ``apply_rows`` and from the accumulator alike."""
    lib = wired
    m, n, d = 1000, 4, 30
    op = tsketch.sample("gaussian", torch.Generator().manual_seed(8), d, m, materialize=False,
                        device=CPU)
    A = torch.randn((m, n), generator=torch.Generator().manual_seed(9), dtype=torch.float64)
    op.apply_rows(A[300:700], 300)
    acc = make_accumulator(op, n)
    for o in range(0, m, 400):
        acc.update(A[o : o + 400], o)
    assert lib.entries() == ["repro_fused_gaussian_cols"] * 4
    assert [args[3] for _, args in lib.calls] == [300, 0, 400, 800]
    assert all(args[1:3] == op.key for _, args in lib.calls)


# ---------------------------------------------------------------------------
# B4: the column offset's plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_col0_plain_is_the_slice_of_the_whole_s(dtype):
    m, d, n, o, t = 900, 40, 5, 300, 250
    key = (12345, 678)
    A = torch.randn((t, n), generator=torch.Generator().manual_seed(10), dtype=torch.float64).to(dtype)
    S = gaussian_matrix_ref(*key, d, m)
    S.mul_(default_scale(d))
    want = S[:, o : o + t].to(dtype) @ A
    assert torch.equal(fused_gaussian_sketch(A, key, d, col0=o), want)
    assert torch.equal(fused_gaussian_ref(A, key, d, col0=o), want)
    # col0 = 0 and no col0 are one computation
    assert torch.equal(fused_gaussian_sketch(A, key, d, col0=0), fused_gaussian_sketch(A, key, d))


def test_streamed_gaussian_matches_the_whole_apply():
    m, n, d = 1500, 6, 48
    op = tsketch.sample("gaussian", torch.Generator().manual_seed(11), d, m, materialize=False,
                        device=CPU)
    A = torch.randn((m, n), generator=torch.Generator().manual_seed(12), dtype=torch.float64)
    B = accumulate_source(op, ArraySource(A, boundaries=[1, 500, 501, 1400])).finalize()
    whole = op.apply(A)
    assert float((B - whole).abs().max()) <= 1e-13 * float(whole.abs().max())
    S = op.as_dense()
    for o, t in ((0, 1), (1, 499), (501, 899)):
        assert torch.equal(op.apply_rows(A[o : o + t], o), S[:, o : o + t] @ A[o : o + t])
