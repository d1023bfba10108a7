"""Port parity: ``repro_torch.streaming`` (row sources, accumulators,
``stream_lstsq``, ``StreamingSolver``) against the JAX reference's
``repro.streaming``, on the same numpy inputs and the same S.

The reference draws each operator from its key; the port gets it converted
(``repro_torch.convert``), and the reference's row sources become the
port's with the same tiles (``convert.source_from_reference``).  Everything
runs in f64 on the CPU, where the port's kernel wrappers run their plain
versions.

Tolerances:
- the streamed B of the CountSketch, uniform-sparse, sparse-sign and SRHT
  sketches: **bitwise** the reference's streamed B and the port's own
  monolithic apply (for sparse-sign its ``backend="reference"`` route: the
  k partial sums added in block order, the reference's order), over the
  default tiling, an uneven ``boundaries=`` tiling, single-row tiles and a
  hypothesis-drawn tiling;
- the Gaussian and uniform-dense B (block products added in tile order):
  within 1e-12 relative of the port's monolithic apply; the uniform-dense
  one within 1e-12 of the reference's streamed B, the Gaussian within
  3e-7, since the port regenerates S from the key within 3 f32 ulps of
  the reference's Gaussians (``tests/test_torch_dense_sketch.py``);
- solves on a (2000, 24) Gaussian A (κ ≈ 1.4, inside the κ ≤ 10 regime
  where converged LSQR runs of the two libraries agree, ROADMAP §C): x
  within 1e-10 relative of the reference's, the same itn (±1 where both
  stop on the step floor, istop 8: the floor reads rounding-level steps),
  and within the reference's own bounds against ``qr_solve``
  (``tests/test_streaming.py``); certificates field by field within 1e-9
  relative, ``passed`` equal, on the reference's probe matrix W.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
hypothesis = pytest.importorskip("hypothesis")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

import repro.streaming as jst  # noqa: E402
from repro.core import lstsq as jlstsq  # noqa: E402
from repro.core import sample_sketch as jsample  # noqa: E402
from repro.core.precond import SketchedFactor as JFactor  # noqa: E402
from repro.obs import trace as jtrace  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import streaming as tst  # noqa: E402
from repro_torch.core import SketchedFactor, lstsq, qr_solve  # noqa: E402
from repro_torch.core import certify as tcert  # noqa: E402
from repro_torch.core import sketch as tsketch  # noqa: E402
from repro_torch.obs import trace as ttrace  # noqa: E402

CPU = "cpu"
M_ROWS, N_COLS = 2000, 24
EXACT_KINDS = ("countsketch", "uniform_sparse", "sparse_sign", "srht")
DENSE_KINDS = ("gaussian", "uniform_dense")
ALL_KINDS = EXACT_KINDS + DENSE_KINDS
DENSE_REF_TOL = {"gaussian": 3e-7, "uniform_dense": 1e-12}
# The solves' sketch rows: 8n, where the heavy ball's (α, β) for ε = √(n/s)
# contract on this A with every kind (at the default 4n = 96 rows a
# CountSketch draw's distortion can exceed ε and both packages' iterative
# sketching diverge alike).
S_ROWS = 8 * N_COLS


@pytest.fixture(scope="module")
def prob():
    rng = np.random.default_rng(0)
    A = rng.standard_normal((M_ROWS, N_COLS))
    b = rng.standard_normal(M_ROWS)
    return A, b


def _t(a):
    return torch.as_tensor(np.array(a))


def _rel(x, ref):
    x, ref = np.asarray(x), np.asarray(ref)
    return float(np.linalg.norm(x - ref) / np.linalg.norm(ref))


def _relgap(a, b):
    a, b = float(a), float(b)
    if math.isnan(a) and math.isnan(b):
        return 0.0
    return abs(a - b) / max(abs(b), 1e-300)


def _convert(op):
    """The port's operator for a reference sketch operator."""
    name = type(op).__name__
    if name == "CountSketch":
        return convert.countsketch_from_reference(op.buckets, op.signs, op.d, device=CPU)
    if name == "SparseSignSketch":
        return convert.sparse_sign_from_reference(op.buckets, op.signs, op.d, op.k, device=CPU)
    if name == "UniformSparseSketch":
        return convert.uniform_sparse_from_reference(op.buckets, op.values, op.d, device=CPU)
    if name == "SRHTSketch":
        return convert.srht_from_reference(op.signs, op.rows, op.d, op.m, device=CPU)
    if name == "GaussianSketch":
        S = None if op.S is None else np.asarray(op.S)
        key_data = np.asarray(jax.random.key_data(op.key))
        return convert.gaussian_from_reference(key_data, op.d, op.m, S, device=CPU)
    if name == "UniformDenseSketch":
        return convert.uniform_dense_from_reference(np.asarray(op.S), device=CPU)
    raise TypeError(name)


def _draw(kind, seed, d, m):
    """A reference operator (the Gaussian unmaterialized, as the streaming
    drivers draw it) and the port's on the same S."""
    kw = {"materialize": False} if kind == "gaussian" else {}
    jop = jsample(kind, jax.random.key(seed), d, m, **kw)
    return jop, _convert(jop)


def _monolithic(op, A):
    backend = "reference" if isinstance(op, tsketch.SparseSignSketch) else "auto"
    return op.apply(_t(A), backend=backend)


def _both_streamed(jop, op, jsrc):
    """(reference streamed B, port streamed B) over the same tiles."""
    B_ref = np.asarray(jst.accumulate_source(jop, jsrc).finalize())
    src = convert.source_from_reference(jsrc, device=CPU)
    return B_ref, tst.accumulate_source(op, src).finalize()


def _check_kind(kind, A, jsrc, seed=1, d=None):
    d = d or 3 * A.shape[1]
    jop, op = _draw(kind, seed, d, A.shape[0])
    B_ref, B = _both_streamed(jop, op, jsrc)
    mono = _monolithic(op, A)
    if kind in EXACT_KINDS:
        assert torch.equal(B, _t(B_ref)), kind
        assert torch.equal(B, mono), kind
    else:
        scale = float(mono.norm())
        assert float((B - mono).norm()) <= 1e-12 * scale, kind
        assert float((B - _t(B_ref)).norm()) <= DENSE_REF_TOL[kind] * scale, kind


# ---------------------------------------------------------------------------
# accumulators
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ALL_KINDS)
@pytest.mark.parametrize("tiling", ["default", "boundaries"])
def test_streamed_b_matches_reference_and_monolithic(prob, kind, tiling):
    A, _ = prob
    if tiling == "default":
        jsrc = jst.ArraySource(jnp.asarray(A), tile_rows=500)
    else:
        jsrc = jst.ArraySource(jnp.asarray(A), boundaries=[1, 2, 311, 900, 901, 1999])
    _check_kind(kind, A, jsrc)


@pytest.mark.parametrize("kind", ALL_KINDS)
def test_single_row_tiles(kind):
    rng = np.random.default_rng(3)
    A = rng.standard_normal((90, 3))
    jsrc = jst.ArraySource(jnp.asarray(A), boundaries=list(range(1, 90)))
    assert jsrc.tile_rows == 1
    _check_kind(kind, A, jsrc, seed=4, d=7)


@st.composite
def _tilings(draw):
    m = draw(st.integers(min_value=5, max_value=160))
    cuts = draw(st.lists(st.integers(min_value=1, max_value=m - 1), max_size=8))
    return m, sorted(set(cuts))


@settings(max_examples=8, deadline=None)
@given(st.sampled_from(ALL_KINDS), _tilings(), st.integers(0, 2**30))
def test_streamed_b_any_tiling(kind, m_cuts, seed):
    m, cuts = m_cuts
    n, d = 1 + seed % 5, 2 + seed % 17
    A = np.random.default_rng(seed).standard_normal((m, n))
    _check_kind(kind, A, jst.ArraySource(jnp.asarray(A), boundaries=cuts), seed=seed, d=d)


def test_gaussian_streams_unmaterialized(prob):
    """The streaming draw stores no S; each tile's block comes from B4's
    counter stream with the tile's column offset, bitwise the stored S's
    block product (the plain version on the CPU)."""
    A, _ = prob
    gen = torch.Generator().manual_seed(6)
    _, op, _ = tst.stream_sketch(tst.ArraySource(_t(A), tile_rows=256), gen, sketch="gaussian",
                                 device=CPU)
    assert op.S is None
    stored = tsketch.GaussianSketch(S=op.as_dense(), key=op.key, d=op.d, m=op.m, dev=op.dev)
    tile = _t(A[300:700])
    assert torch.equal(op.apply_rows(tile, 300), stored.S[:, 300:700] @ tile)
    assert torch.equal(op.apply_rows(tile, 300), stored.apply_rows(tile, 300, backend="reference"))


@pytest.mark.parametrize("kind", ALL_KINDS)
def test_merge_of_disjoint_partials(prob, kind):
    """Partials over disjoint row ranges merge to the reference's merged
    sketch (bitwise for the exact kinds: the same state sums) and to the
    monolithic apply within rounding."""
    A, _ = prob
    jop, op = _draw(kind, 2, 3 * N_COLS, M_ROWS)
    cuts = [0, 311, 900, 901, M_ROWS]
    jaccs, accs = [], []
    for a, b_ in zip(cuts[:-1], cuts[1:]):
        jaccs.append(jst.make_accumulator(jop, N_COLS).update(jnp.asarray(A[a:b_]), a))
        accs.append(tst.make_accumulator(op, N_COLS).update(_t(A[a:b_]), a))
    merged = tst.merge_all(accs)
    assert merged.rows_seen == M_ROWS and merged.tiles_seen == 4
    B, B_ref = merged.finalize(), _t(jst.merge_all(jaccs).finalize())
    if kind in EXACT_KINDS:
        assert torch.equal(B, B_ref)
    else:
        assert float((B - B_ref).norm()) <= DENSE_REF_TOL[kind] * float(B_ref.norm())
    mono = _monolithic(op, A)
    assert float((B - mono).abs().max()) <= 1e-12 * float(mono.abs().max())


def test_finalize_refuses_partial_coverage(prob):
    A, _ = prob
    _, op = _draw("countsketch", 3, 64, M_ROWS)
    acc = tst.make_accumulator(op, N_COLS)
    acc.update(_t(A[:100]), 0)
    with pytest.raises(ValueError, match="covered 100 of"):
        acc.finalize()
    with pytest.raises(ValueError, match="outside"):
        acc.update(_t(A[:100]), M_ROWS - 50)
    with pytest.raises(ValueError, match="columns"):
        acc.update(_t(A[:100, :3]), 0)


@pytest.mark.parametrize("kind", ["countsketch", "sparse_sign", "gaussian", "srht"])
def test_merge_rejects_a_different_draw(prob, kind):
    A, _ = prob
    x = tsketch.sample(kind, torch.Generator().manual_seed(5), 64, M_ROWS, device=CPU)
    y = tsketch.sample(kind, torch.Generator().manual_seed(6), 64, M_ROWS, device=CPU)
    with pytest.raises(ValueError, match="same operator draw"):
        tst.make_accumulator(x, N_COLS).merge(tst.make_accumulator(y, N_COLS))
    other = tsketch.sample("uniform_dense", torch.Generator().manual_seed(5), 64, M_ROWS, device=CPU)
    with pytest.raises(ValueError, match="same operator draw"):
        tst.make_accumulator(x, N_COLS).merge(tst.make_accumulator(other, N_COLS))
    # an equal draw held by a distinct object merges
    z = tsketch.sample(kind, torch.Generator().manual_seed(5), 64, M_ROWS, device=CPU)
    ax = tst.make_accumulator(x, N_COLS).update(_t(A[:900]), 0)
    az = tst.make_accumulator(z, N_COLS).update(_t(A[900:]), 900)
    mono = _monolithic(x, A)
    assert float((ax.merge(az).finalize() - mono).abs().max()) <= 1e-12 * float(mono.abs().max())


def test_sharded_source_partials_merge(prob):
    A, _ = prob
    _, op = _draw("countsketch", 7, 64, M_ROWS)
    sh = tst.ShardedSource([tst.ArraySource(_t(A[:700]), tile_rows=499),
                            tst.ArraySource(A[700:], tile_rows=499)])
    assert sh.shape == (M_ROWS, N_COLS) and sh.shard_offsets == [0, 700]
    ref = tst.accumulate_source(op, tst.ArraySource(_t(A), tile_rows=499)).finalize()
    parts = [tst.accumulate_source(op, s, base_offset=o) for s, o in zip(sh.shards, sh.shard_offsets)]
    assert float((tst.merge_all(parts).finalize() - ref).abs().max()) <= 1e-12 * float(ref.abs().max())


def test_bucket_tile_plans_are_cached(prob):
    """The tile's (buckets, weights, CSR) is built once per (offset, rows,
    dtype) and reused by the next pass (a re-stream of b)."""
    A, _ = prob
    _, op = _draw("sparse_sign", 8, 40, M_ROWS)
    src = tst.ArraySource(_t(A), tile_rows=600)
    B1 = tst.accumulate_source(op, src).finalize()
    plans = {k: v for k, v in op._csr.items() if k[0] == "stream"}
    assert sorted(k[1:3] for k in plans) == [(0, 600), (600, 600), (1200, 600), (1800, 200)]
    h, w, d, csr = plans[("stream", 600, 600, torch.float64, "auto")]
    assert d == op.k * op.d and csr is None  # no CSR on the CPU: the plain fold reads none
    shift = torch.arange(op.k, dtype=torch.int32)[:, None] * op.d
    assert torch.equal(h, op.buckets[:, 600:1200] + shift) and torch.equal(w, op.signs[:, 600:1200])
    B2 = tst.accumulate_source(op, src).finalize()
    assert torch.equal(B1, B2)
    assert all(op._csr[k] is plans[k] for k in plans)


@pytest.fixture
def world_of_one(tmp_path):
    """A gloo group of one rank in this process, for the collective form of
    the merge; destroyed after the test."""
    import datetime

    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("kind", ("countsketch", "uniform_sparse", "sparse_sign") + DENSE_KINDS)
def test_sharded_sketch_matches_the_references(prob, kind, world_of_one):
    """``sharded_sketch`` on one rank against the reference's on a (1,) mesh
    (built with ``Auto`` axes) on the same S: bitwise for the bucket kinds
    (the sparse-sign sketch through its ``backend="reference"`` route, the
    reference's order), the dense kinds within their streaming tolerances;
    and within 1e-12 of the port's monolithic apply.  The SRHT raises in
    both."""
    from jax.sharding import AxisType, Mesh

    A, _ = prob
    jop, op = _draw(kind, 9, 64, M_ROWS)
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",), axis_types=(AxisType.Auto,))
    B_ref = np.asarray(jst.sharded_sketch(jnp.asarray(A), jop, mesh=mesh))
    backend = "reference" if kind == "sparse_sign" else "auto"
    B = tst.sharded_sketch(_t(A), op, backend=backend)
    if kind in EXACT_KINDS:
        assert torch.equal(B, _t(B_ref))
        assert torch.equal(B, _monolithic(op, A))
    else:
        assert _rel(B, B_ref) < DENSE_REF_TOL[kind]
        assert _rel(B, _monolithic(op, A)) < 1e-12
    jop, op = _draw("srht", 9, 64, M_ROWS)
    with pytest.raises(ValueError, match="stream_semantics"):
        jst.sharded_sketch(jnp.asarray(A), jop, mesh=mesh)
    with pytest.raises(ValueError, match="stream_semantics"):
        tst.sharded_sketch(_t(A), op)


# ---------------------------------------------------------------------------
# sources
# ---------------------------------------------------------------------------


def _tiles(src):
    return [(int(o), np.asarray(t.cpu() if isinstance(t, torch.Tensor) else t)) for o, t in src.tiles()]


def _same_tiles(src, jsrc):
    mine, theirs = _tiles(src), _tiles(jsrc)
    assert [o for o, _ in mine] == [o for o, _ in theirs]
    assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(mine, theirs))
    assert src.shape == tuple(jsrc.shape) and src.tile_rows == jsrc.tile_rows
    assert src.num_tiles == jsrc.num_tiles


def test_sources_give_the_reference_tiles(prob, tmp_path):
    A, _ = prob
    jA = jnp.asarray(A)
    _same_tiles(tst.ArraySource(_t(A), tile_rows=499), jst.ArraySource(jA, tile_rows=499))
    _same_tiles(tst.ArraySource(A, boundaries=[5, 600, 601]),
                jst.ArraySource(jA, boundaries=[5, 600, 601]))
    path = tmp_path / "a.npy"
    np.save(path, A)
    mm = tst.MemmapSource(path, tile_rows=499)
    assert mm.shape == (M_ROWS, N_COLS) and mm.dtype == torch.float64
    _same_tiles(mm, jst.MemmapSource(path, tile_rows=499))
    assert np.array_equal(mm.read_rows(10, 5), A[10:15])
    _same_tiles(tst.CallbackSource(lambda o, t: A[o : o + t], A.shape, A.dtype, tile_rows=499),
                jst.CallbackSource(lambda o, t: jA[o : o + t], A.shape, A.dtype, tile_rows=499))
    gen = tst.GeneratorSource(lambda: (A[o : o + 499] for o in range(0, M_ROWS, 499)),
                              A.shape, A.dtype)
    jgen = jst.GeneratorSource(lambda: (A[o : o + 499] for o in range(0, M_ROWS, 499)),
                               A.shape, A.dtype)
    _same_tiles(gen, jgen)
    _same_tiles(gen, jgen)  # re-streamable: the two-pass solvers rely on it
    sh = tst.ShardedSource([tst.ArraySource(_t(A[:700]), tile_rows=499), tst.ArraySource(A[700:], tile_rows=499)])
    jsh = jst.ShardedSource([jst.ArraySource(jA[:700], tile_rows=499), jst.ArraySource(jA[700:], tile_rows=499)])
    _same_tiles(sh, jsh)
    assert np.array_equal(np.asarray(sh.read_rows(690, 20)), A[690:710])
    # the converter maps each reference source onto the same tiles
    for jsrc in (jst.ArraySource(jA, tile_rows=333), jst.ArraySource(jA, boundaries=[7, 8, 1500]),
                 jst.MemmapSource(path, tile_rows=640), jsh):
        _same_tiles(convert.source_from_reference(jsrc, device=CPU), jsrc)


def test_device_tiles_on_the_cpu(prob, tmp_path):
    """``device_tiles`` gives the tiles as tensors on the device: a tensor
    already there as itself (a view, no copy), host tiles converted."""
    A, _ = prob
    At = _t(A)
    got = list(tst.device_tiles(tst.ArraySource(At, tile_rows=700), CPU))
    assert [o for o, _ in got] == [0, 700, 1400]
    assert all(t.data_ptr() == At[o:].data_ptr() for o, t in got)
    path = tmp_path / "a.npy"
    np.save(path, A)
    for src in (tst.ArraySource(A, tile_rows=700), tst.MemmapSource(path, tile_rows=700)):
        tiles = list(tst.device_tiles(src, CPU))
        assert all(isinstance(t, torch.Tensor) for _, t in tiles)
        assert torch.equal(torch.cat([t for _, t in tiles]), At)


def test_generator_source_validates_coverage(prob):
    A, _ = prob
    _, op = _draw("countsketch", 8, 64, M_ROWS)
    for factory, match in (
        (lambda: iter([A[:100]]), "covered 100 of m"),
        (lambda: iter([A, A[:1]]), "more than m"),
        (lambda: iter([A[:, :3]]), "expected"),
    ):
        src = tst.GeneratorSource(factory, A.shape, A.dtype)
        jsrc = jst.GeneratorSource(factory, A.shape, A.dtype)
        with pytest.raises(ValueError, match=match):
            tst.accumulate_source(op, src)
        with pytest.raises(ValueError, match=match):
            list(jsrc.tiles())


def test_as_source_coercion(prob, tmp_path):
    A, _ = prob
    src = tst.as_source(_t(A), tile_rows=256)
    assert isinstance(src, tst.ArraySource) and src.tile_rows == 256
    assert isinstance(tst.as_source(A), tst.ArraySource)
    assert tst.as_source(A).tile_rows == tst.DEFAULT_TILE_ROWS == jst.sources.DEFAULT_TILE_ROWS
    path = tmp_path / "a.npy"
    np.save(path, A)
    assert isinstance(tst.as_source(str(path)), tst.MemmapSource)
    assert isinstance(tst.as_source(path), tst.MemmapSource)
    assert tst.as_source(src) is src
    with pytest.raises(ValueError, match="tile_rows cannot override"):
        tst.as_source(src, tile_rows=128)
    with pytest.raises(TypeError, match="cannot make a RowSource"):
        tst.as_source(object())
    with pytest.raises(ValueError, match="tile_rows must be"):
        tst.ArraySource(A, tile_rows=0)
    with pytest.raises(ValueError, match="2-D"):
        tst.ArraySource(A[:, 0])


# ---------------------------------------------------------------------------
# two-pass solvers
# ---------------------------------------------------------------------------


def _solve_pair(A, b, kind="countsketch", seed=9, tile_rows=431, **kw):
    """The reference's stream_lstsq and the port's on its S and tiles."""
    key = jax.random.key(seed)
    jsrc = jst.ArraySource(jnp.asarray(A), tile_rows=tile_rows)
    s = kw.pop("sketch_size", S_ROWS)
    r_ref = jst.stream_lstsq(jsrc, jnp.asarray(b), key, sketch=kind, sketch_size=s, **kw)
    kw_ref = {"materialize": False} if kind == "gaussian" else {}
    op = _convert(jsample(kind, key, s, A.shape[0], **kw_ref))
    res = tst.stream_lstsq(convert.source_from_reference(jsrc, device=CPU), b, None, sketch=op,
                           device=CPU, **kw)
    return r_ref, res


def _same_itn(res, r_ref):
    gap = abs(int(res.itn) - int(r_ref.itn))
    assert gap == 0 or (gap == 1 and int(res.istop) == int(r_ref.istop) == 8), (res.itn, r_ref.itn)
    assert int(res.istop) == int(r_ref.istop)


@pytest.mark.parametrize("kind", ALL_KINDS)
def test_stream_saa_matches_reference(prob, kind):
    A, b = prob
    r_ref, res = _solve_pair(A, b, kind, method="saa")
    x_qr = qr_solve(A, b, device=CPU)
    assert res.method == r_ref.method == "stream_saa"
    _same_itn(res, r_ref)
    assert _rel(res.x, r_ref.x) < 1e-10
    assert _rel(res.x, x_qr) < 1e-10
    assert _relgap(res.rnorm, r_ref.rnorm) < 1e-10


def test_stream_iterative_matches_reference(prob):
    A, b = prob
    r_ref, res = _solve_pair(A, b, method="iterative", history=True, tile_rows=500)
    assert res.method == "stream_iterative"
    _same_itn(res, r_ref)
    assert _rel(res.x, r_ref.x) < 1e-10
    assert _rel(res.x, qr_solve(A, b, device=CPU)) < 1e-10
    assert res.history.shape[0] == int(res.itn)
    r = _t(b) - _t(A) @ res.x
    assert _relgap(res.rnorm, r.norm()) < 1e-9
    assert _relgap(res.rnorm, r_ref.rnorm) < 1e-10


def test_stream_sketch_and_solve_matches_reference(prob):
    A, b = prob
    r_ref, res = _solve_pair(A, b, method="sketch_and_solve", tile_rows=300)
    assert int(res.itn) == 0 and int(res.istop) == 1
    assert math.isnan(float(res.rnorm)) and math.isnan(float(res.arnorm))
    assert _rel(res.x, r_ref.x) < 1e-12
    # the monolithic sketch-and-solve on the same S, bitwise B
    op = tsketch.sample("countsketch", torch.Generator().manual_seed(11), 96, M_ROWS, device=CPU)
    factor, _ = SketchedFactor.build(A, 0, sketch=op, device=CPU)
    x_mono = factor.sketch_and_solve(op.apply(_t(b)))
    x = tst.stream_lstsq(A, b, None, sketch=op, method="sketch", tile_rows=300, device=CPU).x
    assert _rel(x, x_mono) < 1e-12


@pytest.mark.parametrize("method", ["saa", "iterative"])
def test_stream_ridge_matches_reference(prob, method):
    A, b = prob
    lam = 0.7
    x_ridge = np.linalg.solve(A.T @ A + lam * np.eye(N_COLS), A.T @ b)
    r_ref, res = _solve_pair(A, b, method=method, reg=lam, tile_rows=512)
    _same_itn(res, r_ref)
    assert _rel(res.x, r_ref.x) < 1e-10
    assert _rel(res.x, x_ridge) < 1e-8
    # diagnostics of the ORIGINAL ridge problem, as lstsq(reg=...) reports
    r = b - A @ np.asarray(res.x)
    g = A.T @ r - lam * np.asarray(res.x)
    assert _relgap(res.rnorm, np.linalg.norm(r)) < 1e-9
    assert abs(float(res.arnorm) - np.linalg.norm(g)) <= 1e-6 * np.linalg.norm(g) + 1e-12


def _ref_probes(seed, n_probes=8):
    key = jax.random.fold_in(jax.random.key(seed), 0xCE27)
    return _t(jax.random.normal(key, (N_COLS, n_probes), jnp.float64))


@pytest.mark.parametrize("method,reg", [("sketch_and_solve", None), ("sketch_and_solve", 0.3),
                                        ("saa", None)])
def test_stream_certify_matches_reference(prob, monkeypatch, method, reg):
    """The streamed certificate on the reference's probe W: a sloppy x̂
    (sketch-and-solve) field by field; a converged one by the fields that
    are not rounding noise (ROADMAP §C)."""
    A, b = prob
    monkeypatch.setattr(tcert, "_draw_probes", lambda factor, key, n: _ref_probes(9, n))
    r_ref, res = _solve_pair_certified(A, b, method, reg)
    c, c_ref = res.certificate, r_ref.certificate
    assert bool(c.passed) == bool(c_ref.passed)
    assert c.sketch_rows == c_ref.sketch_rows
    fields = ("distortion", "cond_R", "rnorm", "target")
    if method == "sketch_and_solve":
        fields += ("whitened_arnorm", "error_bound", "rel_error_bound")
    for f in fields:
        assert _relgap(getattr(c, f), getattr(c_ref, f)) < 1e-9, f
    assert _relgap(res.rnorm, r_ref.rnorm) < 1e-9
    assert _rel(res.x, r_ref.x) < 1e-10


def _solve_pair_certified(A, b, method, reg):
    """The certified pair: the port takes its key (a generator) only for
    the probes, which the test feeds from the reference's draw."""
    key = jax.random.key(9)
    s = S_ROWS
    jsrc = jst.ArraySource(jnp.asarray(A), tile_rows=431)
    r_ref = jst.stream_lstsq(jsrc, jnp.asarray(b), key, method=method, sketch_size=s, reg=reg,
                             certify=True)
    op = _convert(jsample("clarkson_woodruff", key, s, M_ROWS))
    res = tst.stream_lstsq(convert.source_from_reference(jsrc, device=CPU), b, 0, sketch=op,
                           method=method, reg=reg, certify=True, device=CPU)
    return r_ref, res


def test_lstsq_delegates_row_sources(prob):
    A, b = prob
    x_qr = qr_solve(A, b, device=CPU)
    src = tst.ArraySource(A, tile_rows=600)
    res = lstsq(src, b, torch.Generator().manual_seed(13), device=CPU)
    assert res.method == "stream_iterative"
    assert _rel(res.x, x_qr) < 1e-10
    direct = tst.stream_lstsq(src, b, torch.Generator().manual_seed(13), device=CPU)
    assert torch.equal(res.x, direct.x)
    cert = lstsq(src, b, torch.Generator().manual_seed(13), accuracy="certified", device=CPU)
    assert cert.method == "stream_saa" and bool(cert.certificate.passed)
    with pytest.raises(ValueError, match="unknown streaming method"):
        lstsq(src, b, torch.Generator().manual_seed(13), method="direct", device=CPU)
    import importlib

    lstsq_mod = importlib.import_module("repro_torch.core.lstsq")
    assert lstsq_mod.stream_lstsq is tst.stream_lstsq
    assert jlstsq(jst.ArraySource(jnp.asarray(A), tile_rows=600), jnp.asarray(b),
                  jax.random.key(13)).method == res.method


def test_same_seed_same_s_as_in_memory(prob):
    """Draws in the in-memory lstsq's order: the same seed gives the same
    S, so the streamed and in-memory answers agree."""
    A, b = prob
    for kind in ("countsketch", "gaussian", "srht"):
        _, op_st = SketchedFactor.build_streaming(tst.ArraySource(A, tile_rows=700), 14, sketch=kind,
                                                  device=CPU)
        _, op_mem = SketchedFactor.build(A, 14, sketch=kind, device=CPU)
        assert tst.accumulate.SketchAccumulator(op_st, 1).op is op_st
        assert tst.accumulate._same_draw(
            op_st if kind != "gaussian" else tsketch.GaussianSketch(S=op_st.as_dense(), key=op_st.key,
                                                                    d=op_st.d, m=op_st.m, dev=op_st.dev),
            op_mem,
        ), kind
    rs = tst.stream_lstsq(A, b, 15, method="saa", tile_rows=500, device=CPU)
    rm = lstsq(A, b, 15, method="saa", device=CPU)
    assert _rel(rs.x, rm.x) < 1e-12


def test_stream_lstsq_validation(prob):
    A, b = prob
    with pytest.raises(ValueError, match="needs a key"):
        tst.stream_lstsq(A, b, tile_rows=500, device=CPU)
    with pytest.raises(ValueError, match="b must have shape"):
        tst.stream_lstsq(A, b[:-1], 0, tile_rows=500, device=CPU)
    with pytest.raises(ValueError, match="unknown streaming method"):
        tst.stream_lstsq(A, b, 0, method="fossils", device=CPU)


def test_build_streaming_factor_parity(prob):
    """build_streaming == build on the same S (bitwise B, the same QR), and
    the reference's build_streaming on its S within rounding."""
    A, _ = prob
    f_st, op_st = SketchedFactor.build_streaming(tst.ArraySource(A, tile_rows=700), 14, device=CPU)
    f_mono, op_mono = SketchedFactor.build(A, 14, device=CPU)
    assert torch.equal(op_st.buckets, op_mono.buckets)
    assert torch.equal(f_st.R, f_mono.R)
    jf, jop = JFactor.build_streaming(jst.ArraySource(jnp.asarray(A), tile_rows=700), jax.random.key(14))
    f, _ = SketchedFactor.build_streaming(tst.ArraySource(A, tile_rows=700), None, sketch=_convert(jop),
                                          device=CPU)
    assert _rel(f.R.abs(), np.abs(np.asarray(jf.R))) < 1e-12


def test_cluster_routes_every_stream_through_an_engine(prob, monkeypatch):
    """cluster= (which raised before the cluster slice was ported):
    ``stream_lstsq`` builds a ClusterEngine and closes it before returning,
    ``StreamingSolver`` closes the one it built in ``close()``, and a
    source's ``cluster_sketch``/``matvec``/``rmatvec``/``residual_grad``
    hooks answer pass 1 and every pass-2 product (x within 1e-12 of the
    serial stream: only the grouping of the range sums differs)."""
    from repro_torch.cluster import ClusterEngine, ClusterSpec

    A, b = prob
    calls = []
    for hook in ("cluster_sketch", "matvec", "rmatvec", "residual_grad", "close"):
        real = getattr(ClusterEngine, hook)

        def recorded(self, *a, _real=real, _hook=hook, **kw):
            calls.append(_hook)
            return _real(self, *a, **kw)

        monkeypatch.setattr(ClusterEngine, hook, recorded)
    spec = ClusterSpec(num_workers=3, checkpoint_every=2)
    for method, hooks in (("saa", {"cluster_sketch", "matvec", "rmatvec"}),
                          ("iterative", {"cluster_sketch", "residual_grad"})):
        calls.clear()
        res = tst.stream_lstsq(A, b, 0, method=method, tile_rows=500, device=CPU, cluster=spec)
        serial = tst.stream_lstsq(A, b, 0, method=method, tile_rows=500, device=CPU)
        assert set(calls) == hooks | {"close"} and calls.count("cluster_sketch") == 1 and calls[-1] == "close"
        assert _rel(res.x, serial.x) < 1e-12 and res.method == f"stream_{method}"
    calls.clear()
    with tst.StreamingSolver(A, 0, tile_rows=500, cluster=spec, device=CPU) as session:
        x = session.solve(b).x
        assert "close" not in calls and calls.count("cluster_sketch") == 1
        assert session.stats["passes"] > 1 and session.stats["tiles"] == 4 * session.stats["passes"]
    assert calls[-1] == "close" and calls.count("close") == 1
    assert _rel(x, tst.StreamingSolver(A, 0, tile_rows=500, device=CPU).solve(b).x) < 1e-12
    with pytest.raises(TypeError, match="ClusterSpec"):
        tst.stream_lstsq(A, b, 0, cluster=object(), device=CPU)


def test_stream_spans_match_reference(prob):
    """A traced stream_lstsq records the reference's span names."""
    A, b = prob
    res = tst.stream_lstsq(A, b, 0, method="saa", tile_rows=700, trace=True, device=CPU)
    r_ref = jst.stream_lstsq(jnp.asarray(A), jnp.asarray(b), jax.random.key(0), method="saa",
                             tile_rows=700, trace=True)
    names, ref_names = set(res.timeline.names()), set(r_ref.timeline.names())
    assert {"stream_lstsq", "stream.pass1", "stream.tile", "factor.qr", "stream.solve",
            "stream.iter", "stream.pass2"} <= names
    assert names == ref_names
    assert ttrace.current() is None and jtrace.current() is None


# ---------------------------------------------------------------------------
# session
# ---------------------------------------------------------------------------


def _session_pair(A, seed=15, tile_rows=600, **kw):
    key = jax.random.key(seed)
    jsrc = jst.ArraySource(jnp.asarray(A), tile_rows=tile_rows)
    ref = jst.StreamingSolver(jsrc, key, sketch_size=S_ROWS, **kw)
    ours = tst.StreamingSolver(convert.source_from_reference(jsrc, device=CPU), None,
                               sketch=_convert(ref._sketch_op), device=CPU, **kw)
    return ref, ours


def test_streaming_solver_matches_reference(prob):
    A, b = prob
    ref, ours = _session_pair(A)
    x_qr = qr_solve(A, b, device=CPU)
    assert ours.stats == {"sketches": 1, "qr_factorizations": 1, "solves": 0, "passes": 1, "tiles": 4}
    assert dict(ours.stats) == dict(ref.stats)
    for method in ("saa", "iterative", "sketch_and_solve"):
        res, r_ref = ours.solve(b, method=method), ref.solve(jnp.asarray(b), method=method)
        assert res.method == r_ref.method == f"stream_{method}"
        _same_itn(res, r_ref)
        assert _rel(res.x, r_ref.x) < 1e-10, method
        if method != "sketch_and_solve":
            assert _rel(res.x, x_qr) < 1e-10, method
            assert _relgap(res.rnorm, r_ref.rnorm) < 1e-10
    assert dict(ours.stats) == dict(ref.stats)
    assert ours.stats["sketches"] == 1 and ours.stats["qr_factorizations"] == 1
    with ours as same:
        assert same is ours


@pytest.mark.parametrize("method", ["saa", "iterative"])
def test_streaming_solver_solve_many(prob, method):
    A, b = prob
    ref, ours = _session_pair(A, seed=16)
    B = np.stack([b, -0.5 * b, b + 0.1], axis=1)
    passes = ours.stats["passes"]
    res, r_ref = ours.solve_many(B, method=method), ref.solve_many(jnp.asarray(B), method=method)
    assert res.x.shape == (N_COLS, 3)
    assert int(res.itn) == int(r_ref.itn) and np.array_equal(np.asarray(res.istop), np.asarray(r_ref.istop))
    for j in range(3):
        assert _rel(res.x[:, j], r_ref.x[:, j]) < 1e-10, j
        assert _rel(res.x[:, j], qr_solve(A, B[:, j], device=CPU)) < 1e-9, j
    assert ours.stats["solves"] == 3 and dict(ours.stats) == dict(ref.stats)
    assert ours.stats["passes"] - passes <= 2 * int(res.itn) + 4
    with pytest.raises(ValueError, match="solve_many needs B"):
        ours.solve_many(b)


def test_streaming_solver_ridge(prob):
    A, b = prob
    lam = 0.4
    x_ridge = np.linalg.solve(A.T @ A + lam * np.eye(N_COLS), A.T @ b)
    ref, ours = _session_pair(A, seed=17, tile_rows=512, reg=lam)
    for method in ("saa", "iterative"):
        res, r_ref = ours.solve(b, method=method), ref.solve(jnp.asarray(b), method=method)
        assert _rel(res.x, x_ridge) < 1e-8, method
        assert _rel(res.x, r_ref.x) < 1e-10, method
        # at the ridge optimum the gradient is rounding noise, ~1e-12
        assert abs(float(res.arnorm) - float(r_ref.arnorm)) <= 1e-10 * np.linalg.norm(b)
    assert dict(ours.stats) == dict(ref.stats)


def test_streaming_solver_stats_in_registry(prob):
    from repro_torch.obs import REGISTRY

    A, b = prob
    REGISTRY.reset()
    s = tst.StreamingSolver(A, 1, tile_rows=1000, device=CPU)
    s.solve(b)
    snap = REGISTRY.snapshot()
    assert snap["counters"]["streaming.solves"] == 1
    assert snap["counters"]["streaming.passes"] == s.stats["passes"]
    assert snap["counters"]["streaming.tiles"] == s.stats["tiles"]
