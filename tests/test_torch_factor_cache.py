"""Port parity: ``FactorCache`` (``repro_torch/serve/cache.py``) against
the reference's ``repro.serve.cache``.

Every contract of ``tests/test_factor_cache.py`` (LRU + byte budget,
counters, invalidation, drift-aware re-keying, the owned-bytes count) on
(400, 12) f64 problems made from a numpy seed, plus:

- ``session_nbytes`` equals the reference's on the same problem and the
  same S (``convert.countsketch_from_reference``), and counts B, Q, R and
  Y only — never A, not even the session's own copy after ``update_rows``;
- an ``auto_recertify`` session whose drifted embedding cannot be
  recertified is dropped by ``update_rows`` (``None``, counted as an
  eviction);
- an entry whose session holds data written in place since it was keyed
  (a dense A, or a sparse A's values) is stale: a lookup drops it (an
  eviction, kind ``stale``) and is a miss, ``get_or_build`` rebuilds from
  the builder, and ``update_rows`` raises ``KeyError``; the session's own
  copy after ``update_rows`` is watched in place of the caller's;
- the registry's ``cache.*`` metric names equal the reference's after the
  same traffic, and a budget eviction leaves a ``cache.eviction`` instant
  (kind ``budget``) beside the ``cache.build`` spans.

Solutions are held to numpy's least squares within 1e-6 relative, as the
reference's test holds them to ``jnp.linalg.lstsq``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import serve as jserve  # noqa: E402
from repro.core.session import SketchedSolver as JSolver  # noqa: E402
from repro.obs import REGISTRY as JREGISTRY  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core import SketchedSolver, linop  # noqa: E402
from repro_torch.core import certify as tcert  # noqa: E402
from repro_torch.obs import REGISTRY  # noqa: E402
from repro_torch.serve import FactorCache, fingerprint, session_nbytes  # noqa: E402

M, N = 400, 12
CPU = "cpu"


def _problem(seed=0, m=M, n=N):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.standard_normal((m, n))), torch.as_tensor(rng.standard_normal(m))


def _build(A, seed=0, **kw):
    return lambda: SketchedSolver(A, 100 + seed, device=CPU, **kw)


def _lstsq(A, b):
    return torch.as_tensor(np.linalg.lstsq(A.numpy(), b.numpy(), rcond=None)[0])


def test_hit_miss_counters_and_lru():
    cache = FactorCache()
    A, _ = _problem()
    fp = fingerprint(A)
    assert cache.get(fp) is None
    s1, hit = cache.get_or_build(fp, _build(A))
    assert not hit
    s2, hit = cache.get_or_build(fp, _build(A))
    assert hit and s2 is s1
    st = cache.stats()
    assert st["hits"] == 1 and st["misses"] == 2
    assert st["hit_rate"] == pytest.approx(1 / 3)
    assert st["entries"] == 1
    assert st["per_entry"][fp.short()]["hits"] == 1


def test_byte_budget_evicts_lru():
    A0, _ = _problem(0)
    one_session = _build(A0)()
    budget = int(session_nbytes(one_session) * 2.5)  # fits 2, not 3
    cache = FactorCache(max_bytes=budget)
    fps = []
    for seed in range(3):
        A, _ = _problem(seed)
        fp = fingerprint(A)
        fps.append(fp)
        cache.get_or_build(fp, _build(A, seed))
    assert len(cache) == 2
    assert fps[0] not in cache  # LRU evicted
    assert fps[2] in cache
    assert cache.evictions == 1
    assert cache.bytes <= budget


def test_recency_decides_the_victim():
    A0, _ = _problem(0)
    budget = int(session_nbytes(_build(A0)()) * 2.5)
    cache = FactorCache(max_bytes=budget)
    fps = [fingerprint(_problem(s)[0]) for s in range(3)]
    cache.get_or_build(fps[0], _build(_problem(0)[0], 0))
    cache.get_or_build(fps[1], _build(_problem(1)[0], 1))
    assert cache.get(fps[0]) is not None  # 0 is now the most recent
    cache.get_or_build(fps[2], _build(_problem(2)[0], 2))
    assert fps[0] in cache and fps[1] not in cache


def test_oversized_entry_still_admitted():
    A, _ = _problem()
    cache = FactorCache(max_bytes=1)  # everything is oversized
    fp = fingerprint(A)
    cache.get_or_build(fp, _build(A))
    assert fp in cache and len(cache) == 1
    A2, _ = _problem(1)
    fp2 = fingerprint(A2)
    cache.get_or_build(fp2, _build(A2, 1))
    assert fp2 in cache and fp not in cache and len(cache) == 1  # cache-of-one


def test_invalidate_and_clear():
    cache = FactorCache()
    A, _ = _problem()
    fp = fingerprint(A)
    cache.get_or_build(fp, _build(A))
    assert cache.invalidate(fp)
    assert not cache.invalidate(fp)
    assert cache.bytes == 0 and len(cache) == 0
    cache.get_or_build(fp, _build(A))
    cache.clear()
    assert cache.bytes == 0 and len(cache) == 0 and cache.evictions == 2


def test_first_put_wins():
    """A build that lands after another build of the same key is dropped:
    the live session already in the cache is returned as a hit."""
    cache = FactorCache()
    A, _ = _problem()
    fp = fingerprint(A)
    first = _build(A)()

    def racing_builder():
        cache.put(fp, first)  # another thread's build lands meanwhile
        return _build(A, 1)()

    got, hit = cache.get_or_build(fp, racing_builder)
    assert got is first and hit
    assert len(cache) == 1 and cache.bytes == session_nbytes(first)


def test_update_rows_rekeys_under_new_fingerprint():
    cache = FactorCache()
    A, b = _problem()
    fp = fingerprint(A)
    solver, _ = cache.get_or_build(fp, _build(A))
    x_before = solver.solve(b).x

    idx = torch.arange(5)
    rows = torch.as_tensor(np.random.default_rng(9).standard_normal((5, N)))
    new_fp = cache.update_rows(fp, idx, rows)
    assert new_fp is not None and new_fp != fp
    assert fp not in cache and new_fp in cache
    # the re-key is what a fresh fingerprint of the new data gives
    assert new_fp == fingerprint(solver.A.A)
    A_new = A.clone()
    A_new[idx] = rows
    assert new_fp == fingerprint(A_new)
    # and the cached session actually solves the UPDATED problem
    x_after = cache.get(new_fp).solve(b).x
    x_ref = _lstsq(A_new, b)
    assert float(torch.linalg.norm(x_after - x_ref)) <= 1e-6 * float(torch.linalg.norm(x_ref))
    assert float(torch.linalg.norm(x_after - x_before)) > 1e-8
    # the session's own copy of A is not charged
    assert cache.bytes == session_nbytes(solver)


def test_update_rows_missing_entry_raises():
    cache = FactorCache()
    A, _ = _problem()
    with pytest.raises(KeyError):
        cache.update_rows(fingerprint(A), torch.arange(2), torch.zeros((2, N)))


def test_update_rows_drops_an_unrecertifiable_session(monkeypatch):
    cache = FactorCache()
    A, _ = _problem()
    fp = fingerprint(A)
    solver, _ = cache.get_or_build(fp, _build(A, auto_recertify=True))
    # every probe reports a broken embedding: escalation runs out of rows
    monkeypatch.setattr(
        tcert, "_probe_distortion_w",
        lambda A, factor, W: torch.tensor(0.99, dtype=torch.float64),
    )
    assert cache.update_rows(fp, torch.arange(3), torch.zeros((3, N))) is None
    assert fp not in cache and len(cache) == 0 and cache.evictions == 1
    assert not bool(solver.certificate.passed)


@pytest.mark.parametrize("form", ["dense", "sparse"])
def test_written_data_makes_the_entry_stale(form):
    A, b = _problem()
    A0 = A.clone()
    if form == "dense":
        data, write = A, lambda: A.__setitem__((0, 0), A[0, 0] + 1.0)
    else:
        data = linop.SparseOperator.from_tensor(A.to_sparse(), device=CPU)
        write = lambda: data.vals.__setitem__(0, data.vals[0] + 1.0)  # noqa: E731
    cache = FactorCache()
    fp = fingerprint(A0)
    solver, hit = cache.get_or_build(fp, _build(data))
    assert not hit and cache.get(fp) is solver  # unwritten: a hit
    write()  # in place, through torch
    with obs.tracing() as tr:
        assert cache.get(fp) is None
    assert fp not in cache and cache.evictions == 1 and cache.misses == 2
    assert cache.bytes == 0 and len(cache) == 0
    assert [(e["name"], e.get("args", {}).get("kind")) for e in tr.events
            if e["name"].startswith("cache.")] == [("cache.eviction", "stale")]
    fresh, hit = cache.get_or_build(fp, _build(A0))
    assert not hit and fresh is not solver
    x_ref = _lstsq(A0, b)
    assert float(torch.linalg.norm(fresh.solve(b).x - x_ref)) <= 1e-6 * float(torch.linalg.norm(x_ref))
    # put keys the session on its data as it is now; a later write makes
    # the entry stale again, and a stale entry cannot be updated
    cache.put(fp, solver)
    assert cache.get(fp) is solver
    write()
    with pytest.raises(KeyError):
        cache.update_rows(fp, torch.arange(2), torch.zeros((2, N)))


def test_update_rows_watches_the_sessions_own_copy():
    A, b = _problem()
    cache = FactorCache()
    solver, _ = cache.get_or_build(fingerprint(A), _build(A))
    new_fp = cache.update_rows(fingerprint(A), torch.arange(3), torch.ones((3, N)))
    A[:3] = 1.0  # the caller's copy takes the same update: no longer the session's
    assert solver.A.A is not A
    assert cache.get(new_fp) is solver
    solver.A.A[5, 0] += 1.0  # a write to the data the session now holds
    assert cache.get(new_fp) is None


def test_session_nbytes_counts_owned_artifacts():
    A, _ = _problem()
    solver = _build(A)()

    def nbytes(t):
        return t.numel() * t.element_size()

    # exactly the session-owned artifacts: B, the QR factor, Y — never A
    expected = (
        nbytes(solver._B) + nbytes(solver.factor.Q) + nbytes(solver.factor.R)
        + nbytes(solver._Y)
    )
    assert session_nbytes(solver) == expected
    op_session = _build(A, materialize_y=False)()
    assert session_nbytes(op_session) == expected - nbytes(solver._Y)


# ------------------------------------------------- parity with the reference


def test_session_nbytes_equals_the_references():
    A, _ = _problem()
    ref = JSolver(jnp.asarray(A.numpy()), jax.random.key(3), sketch_size=8 * N)
    op = convert.countsketch_from_reference(
        ref._sketch_op.buckets, ref._sketch_op.signs, ref._sketch_op.d, device=CPU
    )
    ours = SketchedSolver(A, 0, sketch=op, device=CPU)
    assert session_nbytes(ours) == jserve.session_nbytes(ref)
    assert ours._B.shape == tuple(ref._B.shape)


def _traffic(FC, fp_of, build_of, A, A2, budget):
    cache = FC(max_bytes=budget)
    fp, fp2 = fp_of(A), fp_of(A2)
    cache.get_or_build(fp, build_of(A))
    cache.get_or_build(fp, build_of(A))
    cache.get_or_build(fp2, build_of(A2))  # evicts the first
    cache.invalidate(fp2)
    return cache


def test_metric_and_span_names_equal_the_references():
    A, _ = _problem()
    A2, _ = _problem(1)
    budget = session_nbytes(_build(A)()) + 1
    REGISTRY.reset()
    JREGISTRY.reset()
    from repro import obs as jobs

    with obs.tracing() as tr:
        _traffic(FactorCache, fingerprint, _build, A, A2, budget)
    with jobs.tracing() as jtr:
        _traffic(
            jserve.FactorCache, jserve.fingerprint,
            lambda X: (lambda: JSolver(X, jax.random.key(0), sketch_size=8 * N)),
            jnp.asarray(A.numpy()), jnp.asarray(A2.numpy()), budget,
        )

    def names(snap):
        return {kind: sorted(n for n in snap[kind] if n.startswith("cache."))
                for kind in ("counters", "gauges", "histograms")}

    assert names(REGISTRY.snapshot()) == names(JREGISTRY.snapshot())
    ours = [(e["name"], e.get("args", {}).get("kind")) for e in tr.events
            if e["name"].startswith("cache.")]
    ref = [(e["name"], e.get("args", {}).get("kind")) for e in jtr.events
           if e["name"].startswith("cache.")]
    assert ours == ref
    assert ("cache.eviction", "budget") in ours and ("cache.eviction", "explicit") in ours
