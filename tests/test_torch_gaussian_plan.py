"""The plan of kernel B4's f64 engine (the generating producer of
``csrc/dense_mma.cuh``), checked without a card.

- ``gen_cluster`` / ``gen_grid``: the thread-block cluster C of the blocks
  that share a row tile of S divides the padded grid, has at most
  GEN_CLUSTER_MAX blocks, covers every n-tile once, pads by fewer than one
  block a cluster, and is a function of n alone;
- ``gaussian_split``: the split of B4's sum over m counts the padded grid
  on the SMs whole clusters fill, sizes its scratch for the real tiles'
  partials, and leaves every route but f64 with n ≥ 2 unsplit;
- the wrappers ``fused_gaussian_sketch`` (B4) and ``gaussian_gram`` (B5)
  hand their C entries that plan, in the order of ``_build._SIGNATURES``,
  with one scratch buffer sized for both of B5's plans;
- the constants and the cluster rule in the CUDA sources are the Python
  twins'.
"""
import contextlib
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import common  # noqa: E402
from repro_torch.kernels.common import (  # noqa: E402
    GAUSS_MMA_ROWS,
    GEN_CLUSTER_MAX,
    MMA_STEP,
    SKETCH_MMA_TILE,
    Split,
    cdiv,
    gaussian_split,
    gen_cluster,
    gen_grid,
    gram_split,
    split_plan,
)

CSRC = Path(_build.CSRC)
T = SKETCH_MMA_TILE


@settings(max_examples=300, deadline=None)
@given(n=st.integers(1, 2**17))
def test_clusters_cover_every_n_tile_once(n):
    c, gx = gen_grid(n)
    tiles = cdiv(n, T)
    assert c == gen_cluster(n)
    assert 1 <= c <= GEN_CLUSTER_MAX
    assert gx % c == 0  # whole clusters along n
    assert tiles <= gx < tiles + c  # padded by fewer than one block a cluster
    clusters = gx // c
    assert clusters == cdiv(tiles, GEN_CLUSTER_MAX)  # the fewest clusters
    owner = [x // c for x in range(tiles)]
    assert sorted(set(owner)) == list(range(clusters))  # no cluster of padding alone
    assert len(owner) == tiles and all(x < gx for x in range(tiles))
    assert gen_grid(n) == (c, gx)  # no state carried between calls


@pytest.mark.parametrize("n,c,gx", [
    (2, 1, 1), (128, 1, 1), (129, 2, 2), (130, 2, 2), (257, 3, 3), (1000, 8, 8),
    (1024, 8, 8), (1025, 5, 10), (1152, 5, 10), (2048, 8, 16), (2049, 6, 18),
])
def test_cluster_sizes(n, c, gx):
    assert gen_grid(n) == (c, gx)


@settings(max_examples=200, deadline=None)
@given(
    d=st.integers(1, 20000),
    m=st.integers(0, 2**21),
    n=st.integers(2, 4096),
    sms=st.integers(1, 264),
)
def test_gaussian_split_is_a_function_of_its_arguments(d, m, n, sms):
    first = gaussian_split(torch.float64, d, m, n, sms)
    gaussian_split(torch.float64, d + 1, m + 1, n + 1, sms)
    assert gaussian_split(torch.float64, d, m, n, sms) == first
    assert first.slab % MMA_STEP == 0 and first.slab >= MMA_STEP
    assert first.parts == (cdiv(m, first.slab) if m else 1)  # what the C entry checks


@pytest.mark.parametrize("d,m,n", [
    (4000, 2**16, 1000), (300, 1007, 130), (37, 5, 3), (129, 4096, 257), (256, 4096, 1152),
    (300, 700, 700), (4000, 2**16, 2048), (100, 300, 2),
])
@pytest.mark.parametrize("sms", [132, 66])
def test_gaussian_split_counts_the_padded_grid(d, m, n, sms):
    split = gaussian_split(torch.float64, d, m, n, sms)
    c, gx = gen_grid(n)
    rows = cdiv(d, GAUSS_MMA_ROWS)
    assert (split.slab, split.parts) == split_plan(m, rows * gx, (sms // c) * c)
    want = split.parts * rows * cdiv(n, T) * GAUSS_MMA_ROWS * T if split.parts > 1 else 0
    assert split.scratch == want  # padded blocks store no partial


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_only_f64_runs_the_engine(dtype):
    assert gaussian_split(dtype, 4000, 2**16, 1000, 132) == Split(MMA_STEP, 1, 0)


def test_vectors_and_empty_outputs_are_not_split():
    # n = 1 runs the vector kernel, d = 0 launches nothing
    assert gaussian_split(torch.float64, 4000, 2**16, 1, 132) == Split(MMA_STEP, 1, 0)
    assert gaussian_split(torch.float64, 0, 2**16, 8, 132) == Split(MMA_STEP, 1, 0)


def test_main_dense_shape_is_planned_for_whole_clusters():
    # A (2^16, 1000), d = 4000: 42 x 8 tiles in clusters of 8 on 128 SMs
    assert gen_grid(1000) == (8, 8)
    split = gaussian_split(torch.float64, 4000, 2**16, 1000, 132)
    assert (split.slab, split.parts) == split_plan(2**16, 42 * 8, 128)


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
    """Run the CUDA branch of the wrappers on CPU tensors, against _Lib."""
    from repro_torch.kernels.sketch_matmul import ops as sm_ops
    from repro_torch.kernels.tsqr import fused as ts_fused

    lib = _Lib()
    allocated = []

    def scratch_for(splits, device):
        buf = common.scratch_for(splits, device)
        allocated.append(0 if buf is None else buf.numel())
        return buf

    def prepare(name, A, ndims):
        return _build.dtype_code(A.dtype), (A[:, None] if A.ndim == 1 else A).contiguous()

    for module in (sm_ops, ts_fused):
        monkeypatch.setattr(module, "scratch_for", scratch_for)
        monkeypatch.setattr(module, "sm_count", lambda device: 132)
    monkeypatch.setattr(sm_ops, "_prepare", prepare)
    monkeypatch.setattr(ts_fused, "_prepare_dense", prepare)
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    return lib, allocated


@pytest.mark.parametrize("m,n,d", [(2**16, 1000, 4000), (1007, 130, 300), (4096, 257, 129)])
def test_fused_gaussian_hands_its_plan_to_the_c_entry(wired, m, n, d):
    from repro_torch.kernels.sketch_matmul import fused_gaussian_sketch

    lib, allocated = wired
    A = torch.zeros((m, n), dtype=torch.float64)
    calls = fused_gaussian_sketch.launches
    fused_gaussian_sketch(A, (3, 4), d)
    args = lib.calls["repro_fused_gaussian"]
    assert len(args) == len(_build._SIGNATURES["repro_fused_gaussian"])
    split = gaussian_split(torch.float64, d, m, n, 132)
    assert args[7:12] == (d, m, n, split.slab, split.parts)
    assert allocated == [split.scratch]
    assert (args[6] is None) == (split.scratch == 0)
    assert fused_gaussian_sketch.launches == calls + 1  # one per wrapper call


@pytest.mark.parametrize("m,n,d", [(2**16, 1000, 4000), (1007, 130, 300), (8192, 2048, 2500)])
def test_gaussian_gram_shares_one_scratch_between_its_plans(wired, m, n, d):
    from repro_torch.kernels.tsqr import gaussian_gram

    lib, allocated = wired
    A = torch.zeros((m, n), dtype=torch.float64)
    calls = gaussian_gram.launches
    gaussian_gram(A, (3, 4), d)
    args = lib.calls["repro_gaussian_gram"]
    assert len(args) == len(_build._SIGNATURES["repro_gaussian_gram"])
    split_b = gaussian_split(torch.float64, d, m, n, 132)
    split_g = gram_split(torch.float64, d, n, 132)
    assert args[8:15] == (d, m, n, split_b.slab, split_b.parts, split_g.slab, split_g.parts)
    assert allocated == [max(split_b.scratch, split_g.scratch)]
    assert gaussian_gram.launches == calls + 1


def test_vector_b_passes_no_split(wired):
    from repro_torch.kernels.sketch_matmul import fused_gaussian_sketch

    lib, allocated = wired
    fused_gaussian_sketch(torch.zeros(2**16, dtype=torch.float64), (3, 4), 4000)
    args = lib.calls["repro_fused_gaussian"]
    assert args[9:12] == (1, MMA_STEP, 1) and args[6] is None and allocated == [0]


def _constexpr(name, text):
    found = re.search(rf"constexpr int {name} = (\w+);", text)
    assert found, name
    return found.group(1)


def test_cluster_rule_matches_the_cuda_sources():
    mma = (CSRC / "dense_mma.cuh").read_text()
    assert int(_constexpr("kGenClusterMax", mma)) == GEN_CLUSTER_MAX
    sketch_h = (CSRC / "dense_sketch.cuh").read_text()
    assert int(_constexpr("kGaussMmaRows", sketch_h)) == GAUSS_MMA_ROWS
    assert "MmaShape<kGaussMmaRows, kSketchMmaTile," in sketch_h
    # the same rule as gen_cluster: the fewest groups, as even as possible
    assert "return (int)cdiv(tiles, cdiv(tiles, kGenClusterMax));" in mma
    sketch = (CSRC / "dense_sketch.cuh").read_text()
    # B4's f64 engine: n-tiles of SKETCH_MMA_TILE columns, clustered by that rule
    assert "launch_dmma_gen_sketch<GaussianMma>(" in sketch
    assert "gen_cluster(n, kSketchMmaTile)" in sketch


@pytest.mark.parametrize("name", ["gaussian_engine", "gaussian_clusters"])
def test_engine_checks_read_the_card_only(name):
    # the check entries of B4's engine have no plain version: a CPU call raises
    from repro_torch.kernels.sketch_matmul import gaussian_clusters, gaussian_engine

    with pytest.raises(ValueError):
        if name == "gaussian_engine":
            gaussian_engine(torch.zeros((8, 3), dtype=torch.float64), (0, 0), 4, 1)
        else:
            gaussian_clusters(8, "cpu")
