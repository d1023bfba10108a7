"""The schedule of kernel B8 (``csrc/hadamard.cuh``), checked without a card.

- ``hadamard_passes``: the p = log2(m_pad) bits split into the fewest passes
  of at most HAD_MAX_BITS bits, highest first, as evenly as they go: the
  split of the earlier two-launch B8 (copied below as ``_old_passes``) and
  of the C plan;
- ``hadamard_panel``: a power of two ≥ 1, the widest whose row segment of A
  fits HAD_SEGMENT_BYTES, whatever m_pad; the panels of w columns cover
  [0, n) exactly and in order;
- ``sign_mask`` and ``gather_list`` against plain Python loops: the sign
  bits in the first pass's order, the stable sort of the rows with their
  output rows, the offsets per last-pass group, duplicates, and the bucket
  of rows out of range;
- the wrappers' checks of ``plan``, and the C arguments ``srht_apply`` /
  ``hadamard_transform`` hand a recording stand-in library: the panel width
  (set by the input's dtype, or by a patched ``hadamard_panel``), the panel
  buffer, the plan's pointers;
- ``SRHTSketch`` builds its plan once.
"""
import contextlib
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro_torch.core import SRHTSketch  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.common import (  # noqa: E402
    HAD_MAX_BITS,
    HAD_SEGMENT_BYTES,
    cdiv,
    hadamard_panel,
    hadamard_passes,
)
from repro_torch.kernels.srht import (  # noqa: E402
    SRHTPlan,
    gather_list,
    hadamard_transform,
    sign_mask,
    srht_apply,
    srht_plan,
)
from repro_torch.kernels.srht import ops as srht_ops  # noqa: E402

CSRC = Path(_build.CSRC)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small tensors, the module's fixtures
    included: the suite runs several test workers at once, and more threads
    only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _old_passes(m_pad):
    """The pass split of the two-launch B8 (csrc/hadamard.cuh:hadamard_passes
    before the panel schedule)."""
    p = 0
    while (1 << p) < m_pad:
        p += 1
    passes = max(cdiv(p, 10), 1)
    left, out = p, []
    for i in range(passes):
        g = cdiv(left, passes - i)
        left -= g
        out.append(g)
    return tuple(out)


@pytest.mark.parametrize("p", range(0, 41))
def test_pass_split_is_the_earlier_one(p):
    bits = hadamard_passes(1 << p)
    assert bits == _old_passes(1 << p)
    assert sum(bits) == p and all(0 <= g <= HAD_MAX_BITS for g in bits)
    assert len(bits) == max(cdiv(p, HAD_MAX_BITS), 1)  # the fewest passes
    assert max(bits) - min(bits) <= 1 and list(bits) == sorted(bits, reverse=True)


@pytest.mark.parametrize("m_pad", [0, 3, 12, -4])
def test_pass_split_rejects_other_lengths(m_pad):
    with pytest.raises(ValueError):
        hadamard_passes(m_pad)


@settings(max_examples=300, deadline=None)
@given(p=st.integers(0, 34), in_bytes=st.sampled_from([1, 2, 4, 8]), n=st.integers(1, 5000))
def test_panel_is_the_widest_power_of_two_in_the_budget(p, in_bytes, n):
    m_pad, acc = 1 << p, max(in_bytes, 4)
    w = hadamard_panel(in_bytes)
    assert w >= 1 and w & (w - 1) == 0
    assert w * in_bytes <= HAD_SEGMENT_BYTES  # A's row segment fits the budget
    assert 2 * w * in_bytes > HAD_SEGMENT_BYTES  # and w is the widest that fits
    # the panel buffer the wrapper makes: at most 64 bytes a row per input
    # byte of acc, and never more than an (m_pad, n) buffer
    scratch = m_pad * min(w, n) * acc
    assert scratch <= m_pad * HAD_SEGMENT_BYTES * acc // in_bytes and scratch <= m_pad * n * acc
    assert hadamard_panel(in_bytes) == w  # no state between calls


@settings(max_examples=200, deadline=None)
@given(in_bytes=st.sampled_from([1, 2, 4, 8]), n=st.integers(1, 5000))
def test_panels_cover_the_columns_in_order(in_bytes, n):
    w = min(hadamard_panel(in_bytes), n)
    panels = [(i * w, min((i + 1) * w, n)) for i in range(cdiv(n, w))]
    assert panels[0][0] == 0 and panels[-1][1] == n
    assert all(a1 == b0 for (_, a1), (b0, _) in zip(panels, panels[1:]))
    assert all(b > a for a, b in panels)


def test_main_shape_plan():
    # f64 at m_pad = 2^20: 8 columns (64-byte segments), a 67 MB buffer
    assert hadamard_panel(8) == 8 and 2**20 * 8 * 8 < 100e6
    assert hadamard_panel(4) == 16 and hadamard_panel(2) == 32
    assert hadamard_passes(2**20) == (10, 10) and hadamard_passes(2**21) == (7, 7, 7)


@pytest.mark.parametrize("in_bytes", [0, -8, 3, 128])
def test_panel_rejects_bad_arguments(in_bytes):
    with pytest.raises(ValueError):
        hadamard_panel(in_bytes)


def test_plan_constants_match_the_cuda_source():
    text = (CSRC / "hadamard.cuh").read_text()
    found = re.search(r"constexpr int kHadMaxBits = (\d+);", text)
    assert found and int(found.group(1)) == HAD_MAX_BITS
    # the C plan splits the bits as hadamard_passes does
    assert "int passes = (int)cdiv(p, kHadMaxBits);" in text
    assert "a.G[i] = (int)cdiv(left, passes - i);" in text
    assert "a.panels = cdiv(n, a.w);" in text


def _mask_bits(words, m_pad):
    u = [w & 0xFFFFFFFF for w in words.tolist()]
    return [(u[b >> 5] >> (b & 31)) & 1 for b in range(m_pad)]


@pytest.mark.parametrize("p", [0, 1, 3, 5, 6, 10, 11, 13, 21])
def test_sign_mask_is_in_the_first_pass_order(p):
    m_pad = 1 << p
    rng = np.random.default_rng(p)
    signs = torch.as_tensor(rng.choice([-1.0, 1.0], m_pad))
    words = sign_mask(signs)
    assert words.dtype == torch.int32 and words.shape == (cdiv(m_pad, 32),)
    bits = _mask_bits(words, m_pad)
    g0 = hadamard_passes(m_pad)[0]
    lo, q1, q2 = p - g0, (g0 + 1) // 2, g0 // 2
    rows = range(m_pad) if m_pad <= 2**13 else rng.choice(m_pad, 4096, replace=False)
    for r in rows:
        r = int(r)
        g, k = r & ((1 << lo) - 1), r >> lo
        j, y = k >> q2, k & ((1 << q2) - 1)
        assert bits[(g << g0) | (y << q1) | j] == int(signs[r] < 0)
    assert sum(bits) == int((signs < 0).sum())  # each row once, padding clear


def _gather_loop(rows, m_pad):
    g_last = hadamard_passes(m_pad)[-1]
    groups = m_pad >> g_last
    entries = [(r if 0 <= r < m_pad else m_pad, i) for i, r in enumerate(rows)]
    entries.sort(key=lambda e: e[0])  # stable: equal rows keep output order
    offsets = [0] * (groups + 2)
    for key, _ in entries:
        offsets[(key >> g_last) + 1] += 1
    for i in range(1, groups + 2):
        offsets[i] += offsets[i - 1]
    return [e[0] for e in entries], [e[1] for e in entries], offsets


@pytest.mark.parametrize("m_pad,d,seed", [
    (1, 3, 0), (8, 20, 1), (1024, 300, 2), (2048, 5000, 3), (2**20, 4000, 4), (2**21, 37, 5),
])
def test_gather_list_against_a_loop(m_pad, d, seed):
    rng = np.random.default_rng(seed)
    rows = rng.integers(-3, m_pad + 3, d)  # duplicates and rows out of range
    got = gather_list(torch.as_tensor(rows), m_pad)
    want = _gather_loop(rows.tolist(), m_pad)
    for t, w in zip(got, want):
        assert t.dtype == torch.int64 and t.tolist() == w


def test_gather_list_of_in_range_rows_has_an_empty_last_bucket():
    rows = torch.tensor([5, 1, 5, 0, 7])
    sorted_rows, index, offsets = gather_list(rows, 8)
    assert sorted_rows.tolist() == [0, 1, 5, 5, 7]
    assert index.tolist() == [3, 1, 0, 2, 4]  # the two 5s in output order
    assert offsets.tolist() == [0, 5, 5]  # one group of 8 rows, no bad rows


def test_srht_plan_bundles_mask_and_gather():
    signs = torch.tensor([1.0, -1.0] * 8)
    rows = torch.tensor([3, 15, 3])
    plan = srht_plan(signs, rows)
    assert isinstance(plan, SRHTPlan)
    assert torch.equal(plan.mask, sign_mask(signs))
    for t, w in zip(plan[1:], gather_list(rows, 16)):
        assert torch.equal(t, w)


def _args(m=10, m_pad=16, d=3):
    A = torch.zeros(m, 2, dtype=torch.float64)
    signs = torch.ones(m_pad, dtype=torch.float64)
    rows = torch.tensor([0, 4, 9])[:d]
    return A, signs, rows


def test_srht_apply_checks_its_plan():
    A, signs, rows = _args()
    good = srht_plan(signs, rows)
    srht_apply(A, signs, rows, 3, plan=good)  # accepted (the CPU runs the plain version)
    with pytest.raises(TypeError, match="SRHTPlan"):
        srht_apply(A, signs, rows, 3, plan=tuple(good))
    bad = [
        good._replace(mask=good.mask[:0]),
        good._replace(mask=good.mask.to(torch.int64)),
        good._replace(rows=good.rows[:2]),
        good._replace(index=good.index.to(torch.int32)),
        good._replace(offsets=good.offsets[:-1]),
        good._replace(rows=torch.stack([good.rows, good.rows], 1)[:, 0]),  # not contiguous
    ]
    for plan in bad:
        with pytest.raises(ValueError, match="plan"):
            srht_apply(A, signs, rows, 3, plan=plan)
    # a plan for other signs' length
    with pytest.raises(ValueError, match="plan"):
        srht_apply(A, signs, rows, 3, plan=srht_plan(torch.ones(2**12), rows))


def _panels_of(monkeypatch, w):
    """Make the wrappers take panels of w columns (None: the plan's)."""
    if w is not None:
        monkeypatch.setattr(srht_ops, "hadamard_panel", lambda in_bytes: w)


def test_panel_cols_do_not_change_the_plain_result(monkeypatch):
    rng = np.random.default_rng(7)
    A = torch.as_tensor(rng.standard_normal((50, 6)))
    signs = torch.as_tensor(rng.choice([-1.0, 1.0], 64))
    rows = torch.as_tensor(rng.choice(64, 9, replace=False))
    want = srht_apply(A, signs, rows, 9)
    _panels_of(monkeypatch, 2)
    assert torch.equal(srht_apply(A, signs, rows, 9), want)


class _Lib:
    """A stand-in for the kernel library that records each C call."""

    def __init__(self):
        self.calls = {}

    def __getattr__(self, name):
        if not name.startswith("repro_"):
            raise AttributeError(name)

        def record(*args):
            self.calls[name] = args
            return 0

        return record


@pytest.fixture
def wired(monkeypatch):
    """Run the CUDA branch of the B8 wrappers on CPU tensors, against _Lib."""
    lib = _Lib()
    allocated = []
    panel_buffer = srht_ops._panel_buffer

    def record_buffer(m_pad, w, acc, device):
        buf = panel_buffer(m_pad, w, acc, device)
        allocated.append(None if buf is None else tuple(buf.shape))
        return buf

    def prepare(name, x):
        return _build.dtype_code(x.dtype), (x[:, None] if x.ndim == 1 else x).contiguous()

    monkeypatch.setattr(srht_ops, "_prepare", prepare)
    monkeypatch.setattr(srht_ops, "_panel_buffer", record_buffer)
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    return lib, allocated


_SRHT_NAMES = ["dtype", "A", "mask", "g_rows", "g_index", "g_offsets", "buf", "out",
               "m", "m_pad", "n", "d", "w", "scale", "stream"]


@pytest.mark.parametrize("m,n,d,dtype,panel_cols", [
    (2**20, 1000, 4000, torch.float64, None), (2**20, 1000, 4000, torch.float32, None),
    (2**20, 5, 4000, torch.float64, None), (2**20, 1, 4000, torch.float64, None),
    (3000, 37, 300, torch.float64, None), (1000, 7, 20, torch.float64, None),
    (2**21, 37, 100, torch.float64, None), (2**20, 1000, 4000, torch.float64, 4),
    (2**20, 3, 4000, torch.bfloat16, 2),
])
def test_srht_apply_hands_its_schedule_to_the_c_entry(wired, monkeypatch, m, n, d, dtype, panel_cols):
    lib, allocated = wired
    _panels_of(monkeypatch, panel_cols)
    m_pad = 1 << max(0, (m - 1).bit_length())
    A = torch.zeros((m, n) if n > 1 else (m,), dtype=dtype)
    signs = torch.ones(m_pad, dtype=torch.float64)
    rows = torch.arange(d) % m_pad
    plan = srht_plan(signs, rows)
    calls = srht_apply.launches
    out = srht_apply(A, signs, rows, d, plan=plan)
    args = dict(zip(_SRHT_NAMES, lib.calls["repro_srht_apply"]))
    assert len(lib.calls["repro_srht_apply"]) == len(_build._SIGNATURES["repro_srht_apply"])
    w = min(panel_cols or HAD_SEGMENT_BYTES // A.element_size(), n)
    passes = len(hadamard_passes(m_pad))
    assert (args["m"], args["m_pad"], args["n"], args["d"], args["w"]) == (m, m_pad, n, d, w)
    assert args["scale"] == pytest.approx(d**0.5, rel=0, abs=0)
    assert allocated == [(m_pad, w) if passes > 1 else None]
    assert (args["buf"] is None) == (passes == 1)
    assert args["mask"] == plan.mask.data_ptr() and args["g_rows"] == plan.rows.data_ptr()
    assert args["g_index"] == plan.index.data_ptr() and args["g_offsets"] == plan.offsets.data_ptr()
    assert args["out"] == out.data_ptr() and out.shape == ((d, n) if n > 1 else (d,))
    assert srht_apply.launches == calls + 1


@pytest.mark.parametrize("dtype,w", [
    (torch.float64, 8), (torch.float32, 16), (torch.bfloat16, 32), (torch.float16, 32),
])
@pytest.mark.parametrize("m", [3000, 2**20, 2**23])
def test_srht_apply_panel_width_follows_the_input_dtype(wired, dtype, w, m):
    # 64-byte row segments of A whatever m_pad: no narrower panels at large m
    lib, allocated = wired
    m_pad = 1 << (m - 1).bit_length()
    srht_apply(torch.zeros(m, 100, dtype=dtype), torch.ones(m_pad), torch.arange(4), 4)
    args = dict(zip(_SRHT_NAMES, lib.calls["repro_srht_apply"]))
    assert args["w"] == w and allocated == [(m_pad, w)]


def test_srht_apply_builds_a_plan_when_none_is_given(wired):
    lib, _ = wired
    signs = torch.ones(64, dtype=torch.float64)
    srht_apply(torch.zeros(64, 3, dtype=torch.float64), signs, torch.tensor([1, 2]), 2)
    assert lib.calls["repro_srht_apply"][2] is not None  # the mask pointer


def test_srht_apply_launches_nothing_for_empty_outputs(wired):
    lib, _ = wired
    calls = srht_apply.launches
    out = srht_apply(torch.zeros(64, 3, dtype=torch.float64), torch.ones(64), torch.zeros(0, dtype=torch.int64), 0)
    assert out.shape == (0, 3) and "repro_srht_apply" not in lib.calls
    assert srht_apply.launches == calls


@pytest.mark.parametrize("m,n", [(2**20, 1000), (1024, 5), (2**21, 3), (8, 1)])
def test_hadamard_transform_runs_through_its_output(wired, m, n):
    lib, allocated = wired
    calls = hadamard_transform.launches
    out = hadamard_transform(torch.zeros(m, n, dtype=torch.float64))
    dtype, x, out_ptr, m_arg, n_arg, stream = lib.calls["repro_hadamard"]
    assert len(lib.calls["repro_hadamard"]) == len(_build._SIGNATURES["repro_hadamard"])
    assert (m_arg, n_arg, out_ptr) == (m, n, out.data_ptr())
    assert allocated == []  # one panel, no buffer of its own
    assert hadamard_transform.launches == calls + 1


def test_srht_sketch_builds_its_plan_once():
    op = SRHTSketch.sample(3, 40, 1000, device="cpu")
    plan = op.plan()
    assert op.plan() is plan
    want = srht_plan(op.signs, op.rows)
    assert all(torch.equal(a, b) for a, b in zip(plan, want))
    other = SRHTSketch.sample(4, 40, 1000, device="cpu")
    assert other.plan() is not plan
