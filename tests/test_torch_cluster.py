"""Port parity: ``repro_torch.cluster`` (sharding, fault injection, the
``ClusterEngine``) against the JAX reference's ``repro.cluster``, on the
same numpy inputs and the same S.

Every test of ``tests/test_cluster.py`` has a counterpart here, at its
sizes (M = 600, N = 12, tiles of 50; the acceptance demo at m = 12000,
n = 40, tiles of 250).  Where the reference computes the same thing, both
packages get the same inputs: the sharding arithmetic and ``RowRangeSource``
windows are held equal to the reference's, the cluster B to the
reference's cluster B on the reference's draw (``repro_torch.convert``):

- bitwise for the CountSketch, uniform-sparse, sparse-sign and SRHT
  sketches (the kinds whose serial streamed B is bitwise the reference's,
  ``tests/test_torch_streaming.py``); the dense kinds within that file's
  ``DENSE_REF_TOL`` (Gaussian 3e-7: the port regenerates S within 3 f32
  ulps of the reference's; uniform-dense 1e-12);
- a kill-and-resume cluster sketch bitwise the clean cluster run's for
  every kind; a solve that lost a worker bitwise the clean solve (the
  port cuts a pass into ``num_workers`` ranges whatever the live count);
- ``stream_lstsq(cluster=...)`` x within 1e-9 of the reference's on the
  same S.

Clock-dependent tests give every stall at least 4× its
``heartbeat_timeout`` and no test a time budget.  The lock-order watchdog
(``repro_torch.obs.lockcheck``) is armed for every test of the file, as the
reference's CI runs its cluster tests with ``REPRO_LOCKCHECK=1``.
"""
import os
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.cluster as jcl  # noqa: E402
import repro.streaming as jst  # noqa: E402
from repro.core import sample_sketch as jsample  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.cluster import (  # noqa: E402
    ClusterEngine,
    ClusterFailure,
    ClusterSpec,
    DelayWorker,
    DuplicateMerge,
    FaultPlan,
    KillWorker,
    OwnershipMap,
    RowRange,
    RowRangeSource,
    partition_rows,
    split_range,
)
from repro_torch.core import generate_problem, lstsq, qr_solve  # noqa: E402
from repro_torch.obs import lockcheck  # noqa: E402
from repro_torch.streaming import (  # noqa: E402
    ArraySource,
    GeneratorSource,
    MemmapSource,
    StreamingSolver,
    stream_lstsq,
    stream_sketch,
)

CPU = "cpu"
ROOT = Path(__file__).resolve().parents[1]
M, N = 600, 12
TILE = 50
S_ROWS = 128
EXACT_KINDS = ("countsketch", "uniform_sparse", "sparse_sign", "srht")
DENSE_KINDS = ("gaussian", "uniform_dense")
ALL_KINDS = EXACT_KINDS + DENSE_KINDS
DENSE_REF_TOL = {"gaussian": 3e-7, "uniform_dense": 1e-12}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small tensors, the module's fixtures
    included: the suite runs several test workers at once, and more threads
    only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _lock_watchdog():
    """Every lock the engine, its fault plan and the store build is an
    ordered lock here: an inverted acquisition order raises."""
    forced = lockcheck._forced
    lockcheck.enable()
    yield
    lockcheck._forced = forced


@pytest.fixture(scope="module")
def prob():
    rng = np.random.default_rng(0)
    return rng.standard_normal((M, N)), rng.standard_normal(M)


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
        return convert.gaussian_from_reference(np.asarray(jax.random.key_data(op.key)), op.d, op.m, S,
                                               device=CPU)
    if name == "UniformDenseSketch":
        return convert.uniform_dense_from_reference(np.asarray(op.S), device=CPU)
    raise TypeError(name)


def _draw(kind, seed=7, d=S_ROWS, m=M):
    """A reference operator (the Gaussian unmaterialized, as the streaming
    drivers draw it) and the port's on the same S."""
    kw = {"materialize": False} if kind == "gaussian" else {}
    jop = jsample(kind, jax.random.key(seed), d, m, **kw)
    return jop, _convert(jop)


def make_engine(A, *, workers=3, faults=None, ckpt_dir=None, checkpoint_every=1, **kw):
    spec = ClusterSpec(num_workers=workers, faults=faults, ckpt_dir=ckpt_dir,
                       checkpoint_every=checkpoint_every, **kw)
    return ClusterEngine(ArraySource(A, tile_rows=TILE), spec, device=CPU)


def _sketch(source, op, b):
    B, _, c = stream_sketch(source, op=op, rhs=torch.as_tensor(b), device=CPU)
    return B, c


def _cluster_sketch(A, b, tmp, *, kind="countsketch", faults=None, workers=3, checkpoint_every=1, **kw):
    eng = make_engine(A, workers=workers, faults=faults, ckpt_dir=tmp, checkpoint_every=checkpoint_every, **kw)
    try:
        B, c = _sketch(eng, _draw(kind)[1], b)
    finally:
        eng.close()
    return B, c, eng.stats


def _cluster_threads(before=()):
    return [t for t in threading.enumerate()
            if t.name.startswith("repro-cluster-w") and t.is_alive() and t not in before]


# ---------------------------------------------------------------------------
# sharding arithmetic, against the reference's
# ---------------------------------------------------------------------------


def _pairs(ranges):
    return [(r.start, r.stop) for r in ranges]


@pytest.mark.parametrize("m,workers,tile", [(1000, 3, 128), (100, 4, 64), (600, 3, 50), (601, 5, 50),
                                            (7, 7, 1), (1, 3, 8), (0, 2, 4), (8192 * 128, 4, 8192)])
def test_partition_rows_tile_aligned_and_balanced(m, workers, tile):
    ranges = partition_rows(m, workers, tile)
    assert _pairs(ranges) == _pairs(jcl.partition_rows(m, workers, tile))
    assert len(ranges) == workers and ranges[0].start == 0 and ranges[-1].stop == m
    for a, b in zip(ranges[:-1], ranges[1:]):
        assert a.stop == b.start and (a.stop % tile == 0 or a.stop == m)
    assert [r.tiles(tile) for r in ranges] == [jr.tiles(tile) for jr in jcl.partition_rows(m, workers, tile)]
    with pytest.raises(ValueError, match="need >= 1 worker"):
        partition_rows(m, 0, tile)


@pytest.mark.parametrize("start,stop,ways,tile", [(128, 1000, 2, 128), (5, 5, 3, 2), (0, 100, 8, 50),
                                                  (75, 300, 3, 50), (1, 1000, 7, 64), (0, 601, 1, 50)])
def test_split_range_reassignment_arithmetic(start, stop, ways, tile):
    parts = split_range(RowRange(start, stop), ways, tile)
    assert _pairs(parts) == _pairs(jcl.split_range(jcl.RowRange(start, stop), ways, tile))
    if parts:
        assert parts[0].start == start and parts[-1].stop == stop
        assert sum(p.tiles(tile) for p in parts) == RowRange(start, stop).tiles(tile)
        assert len(parts) <= min(ways, RowRange(start, stop).tiles(tile))
    with pytest.raises(ValueError, match="need >= 1 way"):
        split_range(RowRange(start, stop), 0, tile)


@pytest.mark.parametrize("m,workers,tile,deaths", [(1000, 3, 128, (0,)), (1000, 4, 100, (2, 0)),
                                                   (600, 5, 50, (4, 1, 3))])
def test_ownership_reassign_least_loaded_deterministic(m, workers, tile, deaths):
    own = OwnershipMap.initial(m, range(workers), tile)
    jown = jcl.OwnershipMap.initial(m, range(workers), tile)
    live = list(range(workers))
    for dead in deaths:
        live.remove(dead)
        moved, jmoved = own.reassign(dead, live), jown.reassign(dead, live)
        assert [(w, (r.start, r.stop)) for w, r in moved] == [(w, (r.start, r.stop)) for w, r in jmoved]
        assert dead not in own.assignments
        for w in live:
            assert own.remaining_tiles(w) == jown.remaining_tiles(w)
            for r in own.assignments[w]:
                assert own.owner_of(r) == w
    with pytest.raises(RuntimeError, match="no live workers"):
        own.reassign(live[0], [])


def _windows(sub):
    return [(o, np.asarray(t)) for o, t in sub.tiles()]


def _same_windows(ours, ref):
    assert [o for o, _ in ours] == [o for o, _ in ref]
    for (_, t), (_, jt) in zip(ours, ref):
        assert t.dtype == jt.dtype and np.array_equal(t, jt) and t.tobytes() == jt.tobytes()


@pytest.mark.parametrize("window", [(75, 300), (0, M), (50, 100), (599, 600), (120, 120)])
def test_row_range_source_random_access(prob, tmp_path, window):
    A, _ = prob
    path = tmp_path / "a.npy"
    np.save(path, A)
    lo, hi = window
    for parent, jparent in ((MemmapSource(path, tile_rows=TILE), jst.MemmapSource(path, tile_rows=TILE)),
                            (ArraySource(torch.as_tensor(A), tile_rows=TILE), jst.ArraySource(A, tile_rows=TILE))):
        sub = RowRangeSource(parent, lo, hi, tile_rows=TILE)
        jsub = jcl.RowRangeSource(jparent, lo, hi, tile_rows=TILE)
        assert sub.shape == jsub.shape == (hi - lo, N) and sub.num_tiles == jsub.num_tiles
        _same_windows(_windows(sub), _windows(jsub))
        if hi - lo >= 15:
            assert np.array_equal(np.asarray(sub.read_rows(10, 5)), np.asarray(jsub.read_rows(10, 5)))
            with pytest.raises(ValueError, match="outside"):
                sub.read_rows(hi - lo - 5, 10)
    with pytest.raises(ValueError, match="outside the parent"):
        RowRangeSource(MemmapSource(path, tile_rows=TILE), 100, M + 1)
    if window == (75, 300):
        # windows follow the PARENT grid: a partial tile up to the next
        # edge, then whole tiles, offsets relative to start = 75
        assert [o for o, _ in _windows(RowRangeSource(MemmapSource(path, tile_rows=TILE), 75, 300))] == \
            [0, 25, 75, 125, 175]


def test_row_range_source_sequential_fallback(prob):
    A, _ = prob

    def factory():
        return (A[o : o + TILE] for o in range(0, M, TILE))

    parent = GeneratorSource(factory, A.shape, A.dtype, tile_rows=TILE)
    jparent = jst.GeneratorSource(factory, A.shape, A.dtype, tile_rows=TILE)
    assert not parent.supports_random_access
    sub = RowRangeSource(parent, 75, 300, tile_rows=TILE)
    _same_windows(_windows(sub), _windows(jcl.RowRangeSource(jparent, 75, 300, tile_rows=TILE)))
    assert [o for o, _ in _windows(sub)] == [0, 25, 75, 125, 175]
    assert np.array_equal(np.concatenate([t for _, t in _windows(sub)]), A[75:300])
    with pytest.raises(TypeError, match="random access"):
        sub.read_rows(0, 5)
    # a CUDA-style tile (a tensor) is clipped by its own shape
    tparent = GeneratorSource(lambda: (torch.as_tensor(A[o : o + TILE]) for o in range(0, M, TILE)),
                              A.shape, torch.float64, tile_rows=TILE)
    _same_windows(_windows(RowRangeSource(tparent, 75, 300)), _windows(sub))


# ---------------------------------------------------------------------------
# fault plans
# ---------------------------------------------------------------------------


def test_fault_plan_take_is_thread_safe():
    """A fire-once event polled concurrently from many worker threads
    fires exactly once (the check-then-append is locked)."""
    plan = FaultPlan(DuplicateMerge(worker=0))
    n_threads = 8
    barrier = threading.Barrier(n_threads)
    results = []

    def poll():
        barrier.wait()
        results.append(plan.duplicate_submission(0))

    threads = [threading.Thread(target=poll) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sum(results) == 1
    assert len(plan.fired) == 1


def test_fault_plan_fire_once_bookkeeping():
    plan = FaultPlan(KillWorker(worker=1, at_tile=2), DuplicateMerge(worker=0))
    plan.before_tile(1, "sketch", 0)  # no trigger
    plan.before_tile(1, "matvec", 2)  # wrong phase
    assert plan.fired == []
    with pytest.raises(Exception, match="injected kill"):
        plan.before_tile(1, "sketch", 2)
    plan.before_tile(1, "sketch", 2)  # fire-once: second call is a no-op
    assert plan.duplicate_submission(0) is True
    assert plan.duplicate_submission(0) is False
    assert len(plan.fired) == 2
    assert repr(plan) == repr(jcl.FaultPlan(jcl.KillWorker(worker=1, at_tile=2), jcl.DuplicateMerge(worker=0)))


# ---------------------------------------------------------------------------
# engine parity (no faults)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ALL_KINDS)
def test_cluster_sketch_matches_single_stream(prob, tmp_path, kind):
    """The port's cluster B against the reference's cluster B on the same
    draw, and against the port's serial streamed B."""
    A, b = prob
    jop, op = _draw(kind)
    jeng = jcl.ClusterEngine(jst.ArraySource(A, tile_rows=TILE),
                             jcl.ClusterSpec(num_workers=3, ckpt_dir=str(tmp_path / "ref")))
    jB, _, jc = jst.stream_sketch(jeng, op=jop, rhs=jnp.asarray(b))
    jeng.close()
    eng = make_engine(A, ckpt_dir=str(tmp_path / "port"))
    B, c = _sketch(eng, op, b)
    eng.close()
    if kind in EXACT_KINDS:
        assert torch.equal(B, torch.as_tensor(np.array(jB))) and torch.equal(c, torch.as_tensor(np.array(jc)))
    else:
        tol = DENSE_REF_TOL[kind]
        for ours, ref in ((B, np.asarray(jB)), (c, np.asarray(jc))):
            assert np.linalg.norm(ours.numpy() - ref) <= tol * np.linalg.norm(ref)
    B0, c0 = _sketch(ArraySource(A, tile_rows=TILE), op, b)
    if kind == "srht":
        # placement: ranges write disjoint buffer rows, the merge adds
        # exact zeros — bitwise even across the fan-out
        assert torch.equal(B0, B) and torch.equal(c0, c)
    else:
        assert torch.allclose(B0, B, rtol=0, atol=1e-12) and torch.allclose(c0, c, rtol=0, atol=1e-12)
    assert eng.stats["passes"] == 1 and eng.stats["tiles"] == M // TILE
    assert dict(eng.stats) == dict(jeng.stats)


def test_cluster_pass2_products_match_dense(prob):
    A, b = prob
    eng = make_engine(A, checkpoint_every=0)
    jeng = jcl.ClusterEngine(jst.ArraySource(A, tile_rows=TILE), jcl.ClusterSpec(num_workers=3, checkpoint_every=0))
    x, u = np.linspace(0.0, 1.0, N), np.linspace(0.0, 1.0, M)
    X = np.stack([x, -x], axis=1)
    tA, tb = torch.as_tensor(A), torch.as_tensor(b)
    for v, mv in ((x, eng.matvec(torch.as_tensor(x))), (X, eng.matvec(torch.as_tensor(X)))):
        assert torch.allclose(mv, tA @ torch.as_tensor(v), rtol=0, atol=1e-12)
        # per-tile placement: the serial stream's product, bitwise
        assert torch.equal(mv, torch.cat([tA[o : o + TILE] @ torch.as_tensor(v) for o in range(0, M, TILE)]))
    assert np.allclose(eng.matvec(torch.as_tensor(x)).numpy(), np.asarray(jeng.matvec(jnp.asarray(x))),
                       rtol=0, atol=1e-12)
    g = eng.rmatvec(torch.as_tensor(u))
    assert torch.allclose(g, tA.T @ torch.as_tensor(u), rtol=0, atol=1e-12)
    assert np.allclose(g.numpy(), np.asarray(jeng.rmatvec(jnp.asarray(u))), rtol=0, atol=1e-12)
    rn2, grad = eng.residual_grad(tb, torch.as_tensor(x))
    r = tb - tA @ torch.as_tensor(x)
    assert torch.allclose(torch.sqrt(rn2), torch.linalg.norm(r), rtol=1e-12)
    assert torch.allclose(grad, tA.T @ r, rtol=0, atol=1e-10)
    jrn2, jg = jeng.residual_grad(jnp.asarray(b), jnp.asarray(x))
    assert np.allclose(rn2.numpy(), np.asarray(jrn2), rtol=1e-12) and np.allclose(grad.numpy(), np.asarray(jg),
                                                                                  rtol=0, atol=1e-10)
    assert eng.stats["passes"] == 5 and eng.stats["tiles"] == 5 * (M // TILE)
    eng.close()
    jeng.close()


# ---------------------------------------------------------------------------
# fault tolerance
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ALL_KINDS)
def test_kill_recovers_from_checkpoint_bit_equal(prob, tmp_path, kind):
    """A worker killed mid-pass: its range resumes from the accumulator
    checkpoint on a surviving worker and the merged sketch is BITWISE the
    unfaulted cluster run's (resume adds no arithmetic), for every kind."""
    A, b = prob
    B0, c0, _ = _cluster_sketch(A, b, str(tmp_path / "clean"), kind=kind)
    plan = FaultPlan(KillWorker(worker=1, at_tile=2))
    B1, c1, st1 = _cluster_sketch(A, b, str(tmp_path / "kill"), kind=kind, faults=plan)
    assert plan.fired, "the kill must actually have triggered"
    assert st1["recoveries"] == 1 and st1["reassignments"] == 1
    assert st1["restores"] == 1, "recovery must resume from the checkpoint"
    assert torch.equal(B0, B1) and torch.equal(c0, c1)


def test_kill_without_checkpoints_restarts_range(prob, tmp_path):
    A, b = prob
    B0, c0, _ = _cluster_sketch(A, b, str(tmp_path / "clean"), checkpoint_every=0)
    B1, c1, st = _cluster_sketch(A, b, str(tmp_path / "kill"), checkpoint_every=0,
                                 faults=[KillWorker(worker=0, at_tile=1)])
    assert st["recoveries"] == 1 and st["restores"] == 0 and st["checkpoints"] == 0
    assert st["tiles"] == M // TILE + 1  # the killed range's first tile, again
    assert torch.equal(B0, B1) and torch.equal(c0, c1)


def test_duplicate_submission_deduped(prob, tmp_path):
    A, b = prob
    B0, c0, _ = _cluster_sketch(A, b, str(tmp_path / "clean"))
    B1, c1, st = _cluster_sketch(A, b, str(tmp_path / "dup"), faults=[DuplicateMerge(worker=0)])
    assert st["duplicates_dropped"] == 1
    assert torch.equal(B0, B1) and torch.equal(c0, c1)


def test_heartbeat_eviction_of_stalled_worker(prob, tmp_path):
    """A stalled (not dead) worker goes heartbeat-stale, is evicted, and its
    range is recomputed elsewhere; the zombie's eventual submission does not
    reach the merge.  The stall is 4× the timeout."""
    A, b = prob
    B0, c0, _ = _cluster_sketch(A, b, str(tmp_path / "clean"))
    before = set(threading.enumerate())
    B1, c1, st = _cluster_sketch(A, b, str(tmp_path / "slow"),
                                 faults=[DelayWorker(worker=2, seconds=2.0, at_tile=1)],
                                 heartbeat_timeout=0.5, poll_interval=0.02)
    assert st["heartbeat_evictions"] >= 1 and st["recoveries"] >= 1
    assert torch.equal(B0, B1) and torch.equal(c0, c1)
    # the zombie wakes into a closed engine and stops at its next tile
    for t in _cluster_threads(before):
        t.join(timeout=30)
    assert _cluster_threads(before) == []


def test_zombie_writes_no_checkpoint_after_close(prob):
    """A zombie that wakes after ``close()`` writes nothing into the engine's
    checkpoint dir (an owned temp dir stays removed)."""
    A, b = prob
    before = set(threading.enumerate())
    eng = make_engine(A, faults=[DelayWorker(worker=2, seconds=2.0, at_tile=1)], heartbeat_timeout=0.5,
                      poll_interval=0.02)
    ckpt = eng.ckpt_dir
    _sketch(eng, _draw("countsketch")[1], b)
    eng.close()
    assert not os.path.exists(ckpt)
    for t in _cluster_threads(before):
        t.join(timeout=30)
    assert _cluster_threads(before) == [] and not os.path.exists(ckpt)


def test_recovery_budget_enforced(prob, tmp_path):
    A, b = prob
    eng = make_engine(A, workers=2, ckpt_dir=str(tmp_path), faults=[KillWorker(worker=0, at_tile=0)],
                      max_recoveries=0)
    with pytest.raises(ClusterFailure, match="recovery budget"):
        _sketch(eng, _draw("countsketch")[1], b)
    eng.close()


def test_all_workers_dead_respawns(prob, tmp_path):
    """Killing every pool member forces a respawned replacement worker."""
    A, b = prob
    B0, c0, _ = _cluster_sketch(A, b, str(tmp_path / "clean"), workers=2)
    B1, c1, st = _cluster_sketch(A, b, str(tmp_path / "wipe"), workers=2,
                                 faults=[KillWorker(worker=0, at_tile=1), KillWorker(worker=1, at_tile=1)],
                                 max_recoveries=4)
    assert st["recoveries"] == 2 and st["respawns"] >= 1
    assert torch.equal(B0, B1) and torch.equal(c0, c1)


def test_idle_pool_is_not_heartbeat_evicted(prob, tmp_path):
    """A healthy pool idle longer than heartbeat_timeout, before its first
    pass and between passes, is NOT evicted: staleness is measured from
    task dispatch, not pool construction."""
    A, b = prob
    op = _draw("countsketch")[1]
    eng = make_engine(A, ckpt_dir=str(tmp_path), heartbeat_timeout=0.5, poll_interval=0.02)
    time.sleep(1.0)  # idle before the first pass
    B1, c1 = _sketch(eng, op, b)
    time.sleep(1.0)  # idle between passes (a session between solves)
    x = torch.as_tensor(np.linspace(0.0, 1.0, N))
    y = eng.matvec(x)
    eng.close()
    assert eng.stats["heartbeat_evictions"] == 0 and eng.stats["recoveries"] == 0
    B0, c0 = _sketch(ArraySource(A, tile_rows=TILE), op, b)
    assert torch.allclose(B0, B1, rtol=0, atol=1e-12) and torch.allclose(c0, c1, rtol=0, atol=1e-12)
    assert torch.allclose(y, torch.as_tensor(A) @ x, rtol=0, atol=1e-12)


def test_recovery_budget_is_per_pass(prob, tmp_path):
    """One death per pass across two passes fits max_recoveries=1: the
    budget guards a single fan-out, not the engine's lifetime."""
    A, b = prob
    op = _draw("countsketch")[1]
    eng = make_engine(A, ckpt_dir=str(tmp_path), max_recoveries=1,
                      faults=[KillWorker(worker=0, at_tile=1, phase="sketch"),
                              KillWorker(worker=1, at_tile=0, phase="matvec")])
    B1, c1 = _sketch(eng, op, b)
    x = torch.as_tensor(np.linspace(0.0, 1.0, N))
    y = eng.matvec(x)  # the second pass, the second (budgeted-apart) death
    eng.close()
    assert eng.stats["recoveries"] == 2  # the lifetime stat still accumulates
    B0, c0 = _sketch(ArraySource(A, tile_rows=TILE), op, b)
    assert torch.allclose(B0, B1, rtol=0, atol=1e-12) and torch.allclose(c0, c1, rtol=0, atol=1e-12)
    assert torch.equal(y, torch.cat([torch.as_tensor(A[o : o + TILE]) @ x for o in range(0, M, TILE)]))


def test_stale_checkpoints_never_poison_a_new_run(prob, tmp_path):
    """Leftover checkpoints in a persistent ckpt_dir: a rerun with the SAME
    draw resumes from them; a rerun with a DIFFERENT draw starts fresh (a
    different namespace); a successful pass clears its own namespace."""
    A, b = prob
    ckpt = str(tmp_path)
    op7, op8 = _draw("countsketch", seed=7)[1], _draw("countsketch", seed=8)[1]
    serial = ArraySource(A, tile_rows=TILE)

    eng = make_engine(A, ckpt_dir=ckpt, max_recoveries=0, faults=[KillWorker(worker=0, at_tile=2)])
    with pytest.raises(ClusterFailure):
        _sketch(eng, op7, b)
    eng.close()
    assert any(d.startswith("pass1-") for d in os.listdir(ckpt))

    eng = make_engine(A, ckpt_dir=ckpt)
    B1, c1 = _sketch(eng, op7, b)
    eng.close()
    assert eng.stats["restores"] >= 1
    B0, c0 = _sketch(serial, op7, b)
    assert torch.allclose(B0, B1, rtol=0, atol=1e-12) and torch.allclose(c0, c1, rtol=0, atol=1e-12)

    eng = make_engine(A, ckpt_dir=ckpt)
    B2, c2 = _sketch(eng, op8, b)
    eng.close()
    assert eng.stats["restores"] == 0
    B0b, c0b = _sketch(serial, op8, b)
    assert torch.allclose(B0b, B2, rtol=0, atol=1e-12) and torch.allclose(c0b, c2, rtol=0, atol=1e-12)
    assert not any(d.startswith("pass1-") for d in os.listdir(ckpt))


def test_engine_rejects_a_foreign_spec_and_device(prob):
    A, _ = prob
    with pytest.raises(TypeError, match="ClusterSpec"):
        ClusterEngine(ArraySource(A), object(), device=CPU)
    with pytest.raises(ValueError, match="need >= 1 worker"):
        ClusterSpec(num_workers=0)
    if not torch.cuda.is_available():  # the engine runs on the card unless told otherwise
        with pytest.raises(RuntimeError, match="CUDA"):
            ClusterEngine(ArraySource(A), ClusterSpec())


# ---------------------------------------------------------------------------
# routing: stream_lstsq / StreamingSolver / lstsq
# ---------------------------------------------------------------------------


def test_stream_lstsq_cluster_matches_serial(prob, tmp_path):
    """x within 1e-9 of the port's serial stream and of the reference's
    cluster solve on the same S; a solve that lost a worker bitwise the
    clean cluster solve."""
    A, b = prob
    jop, op = _draw("countsketch", seed=3)
    res0 = stream_lstsq(ArraySource(A, tile_rows=TILE), b, None, sketch=op, method="saa", device=CPU)
    clean = stream_lstsq(ArraySource(A, tile_rows=TILE), b, None, sketch=op, method="saa", device=CPU,
                         cluster=ClusterSpec(num_workers=3, ckpt_dir=str(tmp_path / "clean")))
    spec = ClusterSpec(num_workers=3, ckpt_dir=str(tmp_path / "kill"), faults=[KillWorker(worker=0, at_tile=1)])
    res1 = stream_lstsq(ArraySource(A, tile_rows=TILE), b, None, sketch=op, method="saa", device=CPU, cluster=spec)
    # the reference draws its S from the key: the same draw as jop
    jres = jst.stream_lstsq(jst.ArraySource(A, tile_rows=TILE), jnp.asarray(b), jax.random.key(3),
                            sketch="countsketch", sketch_size=S_ROWS, method="saa",
                            cluster=jcl.ClusterSpec(num_workers=3, ckpt_dir=str(tmp_path / "ref")))
    assert torch.allclose(res0.x, res1.x, rtol=0, atol=1e-9)
    assert np.allclose(res1.x.numpy(), np.asarray(jres.x), rtol=0, atol=1e-9)
    assert torch.equal(clean.x, res1.x) and int(clean.itn) == int(res1.itn)
    assert res1.method == jres.method == "stream_saa"


@pytest.mark.parametrize("method", ["saa", "iterative"])
def test_lstsq_cluster_coerces_plain_arrays(prob, method):
    A, b = prob
    x_qr = qr_solve(A, b, device=CPU)
    res = lstsq(A, b, 3, method=method, sketch_size=S_ROWS, device=CPU,
                cluster=ClusterSpec(num_workers=2, checkpoint_every=0))
    assert res.method == f"stream_{method}"
    assert float((res.x - x_qr).norm() / x_qr.norm()) < 1e-8


def test_streaming_solver_cluster_session(prob, tmp_path):
    A, b = prob
    jop, op = _draw("countsketch", seed=3)
    spec = ClusterSpec(num_workers=2, ckpt_dir=str(tmp_path), checkpoint_every=2)
    solver = StreamingSolver(ArraySource(A, tile_rows=TILE), None, sketch=op, cluster=spec, device=CPU)
    serial = StreamingSolver(ArraySource(A, tile_rows=TILE), None, sketch=op, device=CPU)
    ref = jst.StreamingSolver(jst.ArraySource(A, tile_rows=TILE), jax.random.key(3), sketch="countsketch",
                              sketch_size=S_ROWS,
                              cluster=jcl.ClusterSpec(num_workers=2, ckpt_dir=str(tmp_path / "ref"),
                                                      checkpoint_every=2))
    assert np.array_equal(np.asarray(ref._sketch_op.buckets), np.asarray(jop.buckets))
    r0, r1, jr = serial.solve(b), solver.solve(b), ref.solve(jnp.asarray(b))
    assert torch.allclose(r0.x, r1.x, rtol=0, atol=1e-9)
    assert np.allclose(r1.x.numpy(), np.asarray(jr.x), rtol=0, atol=1e-9)
    # the engine's counters hook feeds the session's cost model: the sketch
    # pass, then 3 + 2·itn streams of the solve (LSQR's 2 + 2·itn, the
    # final residual/gradient pass)
    itn = int(r1.itn)
    assert solver.stats["passes"] == 1 + 3 + 2 * itn
    assert solver.stats["tiles"] == solver.stats["passes"] * (M // TILE)
    assert solver.stats["solves"] == 1 and solver.stats["sketches"] == 1
    many = solver.solve_many(np.stack([b, -0.5 * b], axis=1))
    assert solver.stats["passes"] == 1 + 3 + 2 * itn + 3 + 2 * int(many.itn) and solver.stats["solves"] == 3
    assert torch.allclose(many.x[:, 0], r1.x, rtol=0, atol=1e-9)
    solver.close()
    ref.close()


def test_stream_lstsq_closes_engines_it_built(prob, monkeypatch):
    """An engine built internally from a ClusterSpec is torn down when the
    solve returns: no leaked worker threads, no leaked temp ckpt dir."""
    A, b = prob
    made = []
    real_mkdtemp = tempfile.mkdtemp

    def recording_mkdtemp(*a, **kw):
        d = real_mkdtemp(*a, **kw)
        made.append(d)
        return d

    monkeypatch.setattr(tempfile, "mkdtemp", recording_mkdtemp)
    before = set(threading.enumerate())
    res = stream_lstsq(ArraySource(A, tile_rows=TILE), b, 3, method="saa", sketch_size=S_ROWS, device=CPU,
                       cluster=ClusterSpec(num_workers=2, checkpoint_every=2))
    assert res.method == "stream_saa"
    assert _cluster_threads(before) == []
    assert made, "the spec path should have made a temp ckpt dir"
    assert not any(os.path.exists(d) for d in made)


def test_stream_lstsq_keeps_caller_engine_open(prob, tmp_path):
    """A prebuilt engine passed as cluster= survives the solve for reuse;
    its caller-provided ckpt_dir survives its own close()."""
    A, b = prob
    before = set(threading.enumerate())
    eng = make_engine(A, workers=2, ckpt_dir=str(tmp_path), checkpoint_every=0)
    src = ArraySource(A, tile_rows=TILE)
    r1 = stream_lstsq(src, b, 3, method="saa", sketch_size=S_ROWS, cluster=eng, device=CPU)
    r2 = stream_lstsq(src, b, 3, method="saa", sketch_size=S_ROWS, cluster=eng, device=CPU)
    assert torch.equal(r1.x, r2.x)
    eng.close()
    eng.close()  # idempotent
    assert os.path.isdir(str(tmp_path))
    assert _cluster_threads(before) == []


def test_streaming_solver_close_releases_owned_engine(prob):
    A, b = prob
    before = set(threading.enumerate())
    with StreamingSolver(ArraySource(A, tile_rows=TILE), 3, sketch_size=S_ROWS, device=CPU,
                         cluster=ClusterSpec(num_workers=2, checkpoint_every=0)) as solver:
        res = solver.solve(b)
        assert torch.isfinite(res.rnorm)
    solver.close()  # a second close is a no-op
    assert _cluster_threads(before) == []


# ---------------------------------------------------------------------------
# the acceptance demo: out-of-core memmap, a kill mid-pass, certified answers
# ---------------------------------------------------------------------------


def test_kill_and_resume_certified_memmap_solve(tmp_path):
    """A memmapped problem across 4 workers with a worker killed mid-pass 1:
    the engine restores the dead worker's accumulator checkpoint and
    reassigns the rest of its range, the merged sketch is bitwise the
    uninterrupted cluster run's, both certified answers pass and agree."""
    m, n, tile = 12000, 40, 250
    p = generate_problem(torch.Generator().manual_seed(11), m, n, cond=1e6, beta=1e-4, device=CPU)
    path = tmp_path / "A.npy"
    np.save(path, p.A.numpy())

    def solve(ckpt, faults):
        eng = ClusterEngine(MemmapSource(path, tile_rows=tile),
                            ClusterSpec(num_workers=4, ckpt_dir=str(ckpt), faults=faults, checkpoint_every=3),
                            device=CPU)
        # sketch first: the injected kill fires HERE, so the compared sketch
        # is the one that went through kill-and-resume
        B, _, c = stream_sketch(eng, 5, sketch_size=8 * n, rhs=p.b, device=CPU)
        res = lstsq(eng, p.b, 5, accuracy="certified", sketch_size=8 * n, device=CPU)
        eng.close()
        return res, B, c, eng.stats

    res0, B0, c0, _ = solve(tmp_path / "clean", None)
    plan = FaultPlan(KillWorker(worker=2, at_tile=5))
    res1, B1, c1, st1 = solve(tmp_path / "faulted", plan)
    assert m // tile > 4
    assert plan.fired and st1["recoveries"] == 1 and st1["restores"] == 1
    assert torch.equal(B0, B1) and torch.equal(c0, c1)
    assert bool(res0.certificate.passed) and bool(res1.certificate.passed)
    assert torch.allclose(res0.x, res1.x, rtol=0, atol=1e-9)
    err = float((res1.x - p.x_true).norm() / p.x_true.norm())
    assert err < max(float(res1.certificate.rel_error_bound), 1e-6)


# ---------------------------------------------------------------------------
# the port's locking classes under the repo's analyser
# ---------------------------------------------------------------------------


def test_port_passes_lock_and_thread_rules():
    """``python -m repro.analysis src/repro_torch --rules R1,R3
    --no-baseline``: 0 findings, with the cluster's and the store's locking
    classes annotated."""
    from repro_torch.cluster.coordinator import ClusterEngine as Engine
    from repro_torch.cluster.faults import FaultPlan as Plan
    from repro_torch.train.checkpoint import AsyncCheckpointer

    assert {"stats", "_tile_counts", "_submissions", "_sketch_seq"} <= set(Engine.GUARDED_BY)
    assert Plan.GUARDED_BY == {"fired": "_lock"} and AsyncCheckpointer.GUARDED_BY == {"_err": "_lock"}
    out = subprocess.run(
        [sys.executable, "-m", "repro.analysis", "src/repro_torch", "--rules", "R1,R3", "--no-baseline"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), capture_output=True, text=True,
        timeout=300,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert "0 finding(s)" in out.stdout
