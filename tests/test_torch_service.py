"""Port parity: ``SolveService`` (``repro_torch/serve/service.py``) against
the reference's ``repro.serve.service``.

Every contract of ``tests/test_service.py`` (routing, coalescing, SLOs,
rejections, the pump thread, stats) at its size — one (600, 12) f64 tenant
with 8 right-hand sides made from a numpy seed, and (50 + i, 7) bucket
problems — with ``device="cpu"``, plus:

- the session path on the reference's S and probe block: the port's
  ``_build_session`` is overridden to build on the reference session's S
  (``convert.countsketch_from_reference``) and the embedding certificate's
  probe matrix W is the reference's draw.  Each column's x agrees within
  1e-8 relative of the reference service's, iteration counts within one
  (ROADMAP §C, "LSQR parity"), the certificates' pass/fail agree, for
  batches of 1, 3 (padded to 4) and 8;
- after the same traffic, the registry's ``serve.*``/``cache.*`` metric
  names and the ``serve.*``/``cache.*`` spans and instants of a traced
  run equal the reference's;
- seeding: each build draws from a generator derived from (seed,
  counter), so two services with one seed build the same S, and a
  ``torch.Generator`` given as the key is read, never drawn from;
- submit reads shape and dtype from the caller's object and never
  converts A (``linop.as_operator`` is not reached at submit);
- one caller's in-place write to a cached A is never served to another
  caller whose A still holds the old content: with sessions aliasing A
  (the card's policy, driven on the CPU by adding ``"cpu"`` to
  ``_MEMO_DEVICE_TYPES``) the entry is stale and rebuilt; with the host
  policy the session owns a copy.  Either way the answer is the QR
  solution of the request's own A, on the session path and on the slow
  path, which solves the request's own A.

Every wait carries a timeout and every ``start()`` its ``stop()`` in a
``finally``.
"""
import importlib
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import obs as jobs  # noqa: E402
from repro import serve as jserve  # noqa: E402
from repro.obs import REGISTRY as JREGISTRY  # noqa: E402
from repro_torch import convert, obs  # noqa: E402
from repro_torch.core import CustomOperator, SketchedSolver, linop  # noqa: E402
from repro_torch.core import certify as tcert  # noqa: E402
from repro_torch.obs import REGISTRY  # noqa: E402
from repro_torch.serve import SolveService  # noqa: E402
from repro_torch.serve.service import derive_generator  # noqa: E402

M, N = 600, 12
CPU = "cpu"
WAIT_S = 60.0


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small tensors, the module's fixtures
    included: the suite runs several test workers at once, and more threads
    only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tenant():
    rng = np.random.default_rng(0)
    A = rng.standard_normal((M, N))
    X = rng.standard_normal((N, 8))
    X = X / np.linalg.norm(X, axis=0)
    B = A @ X + 1e-8 * rng.standard_normal((M, 8))
    return torch.as_tensor(A), torch.as_tensor(B)


def _service(**kw):
    kw.setdefault("max_delay_s", 0.001)
    kw.setdefault("device", CPU)
    return SolveService(42, **kw)


def _lstsq(A, B):
    return torch.as_tensor(np.linalg.lstsq(np.asarray(A), np.asarray(B), rcond=None)[0])


def _rel(x, ref):
    return float(torch.linalg.norm(x - ref) / torch.linalg.norm(ref))


def _op(A):
    return CustomOperator(
        matvec_fn=lambda x: A @ x, rmatvec_fn=lambda y: A.T @ y,
        op_shape=tuple(A.shape), op_dtype=A.dtype, op_device=CPU,
    )


# ------------------------------------------------ the reference's contracts


def test_coalesced_batch_all_certified(tenant):
    A, B = tenant
    svc = _service()
    futs = [svc.submit(A, B[:, j], certified_rtol=1e-6, mode="session") for j in range(8)]
    assert svc.stats()["pending"] == 8
    svc.flush()
    x_ref = _lstsq(A, B)
    for j, f in enumerate(futs):
        r = f.result(timeout=0)
        assert r.ok and r.path == "session" and r.batch_size == 8
        assert bool(r.certificate.passed)
        assert float(r.certificate.target) == 1e-6
        assert r.x.device.type == "cpu" and r.x.shape == (N,)
        assert _rel(r.x, x_ref[:, j]) <= 1e-6
        assert torch.equal(r.result.x, r.x) and r.result.method == "session"
    c = svc.counters
    assert c["session_batches"] == 1 and c["ok"] == 8 and c["rejected"] == 0


def test_cache_hit_on_second_wave(tenant):
    A, B = tenant
    svc = _service()
    first = svc.solve(A, B[:, 0], mode="session")
    r = svc.solve(A, B[:, 1], mode="session")
    assert not first.cache_hit and r.cache_hit
    assert svc.stats()["cache"]["entries"] == 1


def test_tenants_do_not_share_sessions(tenant):
    A, B = tenant
    A2 = A + 1.0
    svc = _service()
    svc.solve(A, B[:, 0], mode="session")
    svc.solve(A2, B[:, 0], mode="session")
    assert svc.stats()["cache"]["entries"] == 2


def test_default_rtol_is_the_service_slo(tenant):
    A, B = tenant
    svc = _service(default_rtol=1e-5)
    r = svc.solve(A, B[:, 0], mode="session")
    assert r.ok and float(r.certificate.target) == 1e-5


def test_expired_deadline_rejected(tenant):
    A, B = tenant
    svc = _service()
    fut = svc.submit(A, B[:, 0], mode="session", deadline_s=-1.0)
    svc.flush()
    r = fut.result(timeout=0)
    assert not r.ok and r.reason == "deadline expired while queued"
    assert r.x is None and r.certificate is None
    assert svc.counters["rejected"] == 1
    assert svc.stats()["cache"]["entries"] == 0  # nothing was built for it


def test_unattainable_rtol_rejected_with_reason(tenant):
    A, B = tenant
    svc = _service()
    r = svc.solve(A, B[:, 0], certified_rtol=1e-308, mode="session")
    assert not r.ok and r.path == "slow"
    assert "unattainable" in r.reason
    assert svc.counters["slow_path"] == 1


def test_slow_path_answers_what_the_session_cannot(tenant, monkeypatch):
    """A fast-path certificate that fails, with room for the slow path:
    the per-request certified lstsq answers and passes."""
    A, B = tenant
    svc = _service()
    real = svc._certify_columns

    def failing(session, Bm, X, rtols):
        return [c._replace(passed=torch.tensor(False)) for c in real(session, Bm, X, rtols)]

    monkeypatch.setattr(svc, "_certify_columns", failing)
    r = svc.solve(A, B[:, 0], certified_rtol=1e-6, mode="session")
    assert r.ok and r.path == "slow" and bool(r.certificate.passed)
    assert r.x.device.type == "cpu"
    assert _rel(r.x, _lstsq(A, B[:, 0])) <= 1e-6
    assert svc.counters["slow_path"] == 1


def _failing_fast_path(svc, monkeypatch):
    real = svc._certify_columns

    def failing(session, Bm, X, rtols):
        return [c._replace(passed=torch.tensor(False)) for c in real(session, Bm, X, rtols)]

    monkeypatch.setattr(svc, "_certify_columns", failing)


def test_slow_path_solves_the_requests_own_a(tenant, monkeypatch):
    service_mod = importlib.import_module("repro_torch.serve.service")

    A, B = tenant
    svc = _service()
    _failing_fast_path(svc, monkeypatch)
    seen = []
    real = service_mod.lstsq
    monkeypatch.setattr(service_mod, "lstsq", lambda A_, *a, **kw: (seen.append(A_), real(A_, *a, **kw))[1])
    mine = A.clone()
    r = svc.solve(mine, B[:, 0], mode="session")
    assert r.ok and r.path == "slow" and len(seen) == 1 and seen[0] is mine


@pytest.mark.parametrize("policy", ["aliased", "copied"])
@pytest.mark.parametrize("path", ["session", "slow"])
def test_inplace_write_to_a_cached_a_is_not_served(tenant, monkeypatch, policy, path):
    """Tenant 1 caches A, then writes it in place; tenant 2 submits its
    own copy of the old content.  Tenant 2 gets the QR answer of its own A."""
    fp_mod = importlib.import_module("repro_torch.serve.fingerprint")

    A, B = tenant
    if policy == "aliased":
        monkeypatch.setattr(fp_mod, "_MEMO_DEVICE_TYPES", frozenset({"cpu", "cuda"}))
    svc = _service()
    if path == "slow":
        _failing_fast_path(svc, monkeypatch)
    mine = A.clone()
    assert svc.solve(mine, B[:, 0], mode="session").ok
    (entry,) = svc.cache._entries.values()
    assert (entry.solver.A.A is mine) == (policy == "aliased")
    mine[:, 0] *= 2.0  # tenant 1's in-place write, through torch
    theirs = A.clone()  # tenant 2: the old content, another object
    r = svc.solve(theirs, B[:, 1], mode="session")
    assert r.ok and r.path == path
    assert _rel(r.x, _lstsq(theirs, B[:, 1])) <= 1e-6
    st = svc.stats()["cache"]
    if policy == "aliased":  # the stale entry was dropped and rebuilt
        assert not r.cache_hit and st["evictions"] == 1 and st["misses"] == 2
    else:  # the session's own copy still holds the old content
        assert r.cache_hit and st["evictions"] == 0 and st["misses"] == 1


def test_auto_routing_by_problem_size(tenant):
    A, B = tenant  # 600 x 12 -> m n^2 tiny -> bucket
    svc = _service()
    r = svc.solve(A, B[:, 0])
    assert r.path == "bucket"
    big = torch.as_tensor(np.random.default_rng(1).standard_normal((9000, 90)))
    r2 = svc.solve(big, big @ torch.ones(90, dtype=big.dtype))
    assert r2.path == "session"


def test_bucket_coalesces_shapes_into_buckets():
    svc = _service()
    futs = []
    for i in range(4):
        rng = np.random.default_rng(10 + i)
        A = rng.standard_normal((50 + i, 7))
        b = rng.standard_normal(50 + i)
        futs.append(svc.submit(A, b, certified_rtol=1e-8, reg=0.25 if i % 2 else None))
    svc.flush()
    for i, f in enumerate(futs):
        r = f.result(timeout=0)
        assert r.ok and r.path == "bucket" and bool(r.certificate.passed)
        assert r.x.shape == (7,) and r.result.method == "bucket_direct"
        assert float(r.certificate.distortion) == 0.0
    # 50..53 rows with n_pad=8 all land in the (64, 8) bucket: ONE batch
    assert svc.stats()["bucket_executables"] == 1
    assert svc.counters["bucket_batches"] == 1


def test_bucket_rejects_below_attainable_accuracy():
    rng = np.random.default_rng(3)
    A = rng.standard_normal((50, 7))
    svc = _service()
    r = svc.solve(A, rng.standard_normal(50), certified_rtol=1e-30)
    assert not r.ok and r.path == "bucket" and "direct-QR attainable" in r.reason


def test_bucket_rejects_matrix_free(tenant):
    A, B = tenant
    op = _op(A)
    svc = _service()
    with pytest.raises(ValueError, match="bucket"):
        svc.submit(op, B[:, 0], mode="bucket", token="t")
    # session mode works, with the mandatory token
    r = svc.solve(op, B[:, 0], mode="session", token="tenant-op-v1")
    assert r.ok and r.path == "session"


def test_submit_validates_rhs_and_mode(tenant):
    A, B = tenant
    svc = _service()
    with pytest.raises(ValueError, match="right-hand side"):
        svc.submit(A, B)  # 2-D b
    with pytest.raises(ValueError, match="mode"):
        svc.submit(A, B[:, 0], mode="warp")


def test_submit_rejects_promoting_rhs_dtype(tenant):
    """A promoting b (f64 against an f32 session) must fail AT SUBMIT, in
    the caller's thread — not blow up mid-dispatch inside a shared batch."""
    A, B = tenant
    with pytest.raises(TypeError, match="dtype"):
        _service().submit(A.to(torch.float32), B[:, 0], mode="session")
    # a safely-representable RHS is cast, solved and certified normally
    svc = _service()
    r = svc.solve(A, B[:, 0].to(torch.float32), mode="session")
    assert r.ok and r.x.dtype == A.dtype


def test_submit_never_converts_a(tenant, monkeypatch):
    A, B = tenant
    svc = _service()

    def boom(*a, **kw):
        raise AssertionError("submit converted A")

    monkeypatch.setattr(linop, "as_operator", boom)
    fut = svc.submit(A.numpy(), B[:, 0].numpy(), mode="session")
    fut2 = svc.submit(A, B[:, 1])  # bucket route: also converted only at dispatch
    (req,) = [r for q in svc.sessions._queues.values() for r in q.items]
    assert req.A is not None and req.b.device.type == "cpu"
    monkeypatch.undo()
    svc.flush()
    assert fut.result(timeout=0).ok and fut2.result(timeout=0).ok


def test_dispatch_exception_rejects_batch_not_service(tenant, monkeypatch):
    """An internal dispatch failure must resolve THAT batch's futures with
    a reasoned rejection and leave the pump thread serving everyone else."""
    A, B = tenant
    svc = _service()
    calls = {"n": 0}
    orig = svc.cache.get_or_build

    def flaky(fp, builder):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("kaboom")
        return orig(fp, builder)

    monkeypatch.setattr(svc.cache, "get_or_build", flaky)
    svc.start(poll_s=1e-4)
    try:
        r1 = svc.submit(A, B[:, 0], mode="session").result(timeout=WAIT_S)
        r2 = svc.submit(A, B[:, 1], mode="session").result(timeout=WAIT_S)
    finally:
        svc.stop()
    assert not r1.ok and "internal error" in r1.reason and "kaboom" in r1.reason
    assert r2.ok and bool(r2.certificate.passed)
    assert svc.counters["rejected"] == 1 and svc.counters["ok"] == 1


def test_queued_vs_compute_breakdown(tenant):
    """queued_s is submit → dispatch; the solve itself must land in
    latency_s − queued_s, not be double-counted as queueing."""
    A, B = tenant
    svc = _service()
    fut = svc.submit(A, B[:, 0], mode="session")
    time.sleep(0.05)  # request sits in the queue
    svc.flush()
    r = fut.result(timeout=0)
    assert r.ok
    assert 0.04 <= r.queued_s <= r.latency_s
    assert r.latency_s - r.queued_s > 0.0


def test_submit_does_not_block_during_dispatch(tenant, monkeypatch):
    """Clients must keep enqueueing while the pump computes a batch."""
    A, B = tenant
    svc = _service()
    entered, release = threading.Event(), threading.Event()
    orig = svc._dispatch_session

    def slow(fp, reqs):
        entered.set()
        release.wait(timeout=30.0)
        return orig(fp, reqs)

    monkeypatch.setattr(svc, "_dispatch_session", slow)
    svc.start(poll_s=1e-4)
    try:
        f1 = svc.submit(A, B[:, 0], mode="session")
        assert entered.wait(timeout=30.0)
        t0 = time.monotonic()
        f2 = svc.submit(A, B[:, 1], mode="session")
        dt = time.monotonic() - t0
        release.set()
        assert f1.result(timeout=WAIT_S).ok and f2.result(timeout=WAIT_S).ok
    finally:
        release.set()
        svc.stop()
    assert dt < 0.2, f"submit blocked {dt:.3f}s behind an in-flight dispatch"


def test_tenant_scoped_tokens_do_not_collide(tenant):
    A, B = tenant
    A2 = A + 1.0
    svc = _service()
    r1 = svc.solve(A, B[:, 0], mode="session", token="v1", tenant="alice")
    r2 = svc.solve(A2, B[:, 0], mode="session", token="v1", tenant="bob")
    assert r1.ok and r2.ok
    assert svc.stats()["cache"]["entries"] == 2
    assert _rel(r1.x, _lstsq(A, B[:, 0])) <= 1e-6
    assert _rel(r2.x, _lstsq(A2, B[:, 0])) <= 1e-6


def test_prewarm_makes_first_request_a_hit(tenant):
    A, B = tenant
    svc = _service(max_batch=8)
    svc.prewarm(A)
    r = svc.solve(A, B[:, 0], mode="session")
    assert r.ok and r.cache_hit
    svc.prewarm(A, token="v1", tenant="t2")  # a second session, by token
    assert svc.solve(A, B[:, 1], mode="session", token="v1", tenant="t2").cache_hit
    assert svc.stats()["cache"]["entries"] == 2


def test_background_pump_thread(tenant):
    A, B = tenant
    svc = _service()
    svc.start(poll_s=1e-4)
    try:
        futs = [svc.submit(A, B[:, j], mode="session") for j in range(4)]
        resps = [f.result(timeout=WAIT_S) for f in futs]
    finally:
        svc.stop()
    assert svc._thread is None
    assert all(r.ok for r in resps)
    assert all(r.latency_s >= 0 for r in resps)


def test_batch_padding_keeps_answers_exact(tenant):
    """3 requests pad to the 4-wide ladder rung; answers stay per-request."""
    A, B = tenant
    svc = _service()
    futs = [svc.submit(A, B[:, j], certified_rtol=1e-6, mode="session") for j in range(3)]
    svc.flush()
    x_ref = _lstsq(A, B[:, :3])
    for j, f in enumerate(futs):
        r = f.result(timeout=0)
        assert r.ok and r.batch_size == 3
        assert _rel(r.x, x_ref[:, j]) <= 1e-6


def test_stats_shape(tenant):
    A, B = tenant
    svc = _service()
    svc.solve(A, B[:, 0], mode="session")
    st = svc.stats()
    for key in ("requests", "ok", "rejected", "slow_path", "pending",
                "session_occupancy", "bucket_occupancy", "cache"):
        assert key in st
    assert st["cache"]["entries"] == 1
    assert 0.0 < st["session_occupancy"] <= 1.0


# ------------------------------------------------------------------ seeding


def test_sessions_draw_from_derived_generators(tenant):
    A, B = tenant
    gen = torch.Generator().manual_seed(42)
    state = gen.get_state()
    s1, s2 = SolveService(gen, device=CPU), _service()
    assert torch.equal(gen.get_state(), state)  # read, never drawn from
    s1.solve(A, B[:, 0], mode="session")
    s2.solve(A, B[:, 0], mode="session")
    (e1,), (e2,) = s1.cache._entries.values(), s2.cache._entries.values()
    assert torch.equal(e1.solver._sketch_op.buckets, e2.solver._sketch_op.buckets)
    assert torch.equal(e1.solver._B, e2.solver._B)
    # the first build draws generator number 1 of seed 42
    direct = SketchedSolver(A, derive_generator(42, 1, CPU), sketch_size=8 * N, device=CPU)
    assert torch.equal(direct._B, e1.solver._B)
    assert not torch.equal(derive_generator(42, 2, CPU).get_state(),
                           derive_generator(42, 1, CPU).get_state())
    with pytest.raises(TypeError, match="key"):
        SolveService("42", device=CPU)


# ------------------------------------------------- parity with the reference


def _reference_build(ref_svc, A, b):
    """Run one request through the reference service; return its session."""
    ref_svc.solve(jnp.asarray(A.numpy()), jnp.asarray(b.numpy()), mode="session")
    (entry,) = ref_svc.cache._entries.values()
    return entry.solver


@pytest.mark.parametrize("k", [1, 3, 8])
def test_session_path_matches_the_reference(tenant, monkeypatch, k):
    A, B = tenant
    jsvc = jserve.SolveService(jax.random.PRNGKey(42), max_delay_s=0.001)
    ref_session = _reference_build(jsvc, A, B[:, 0])
    JB = jnp.asarray(B.numpy())
    jfuts = [jsvc.submit(jnp.asarray(A.numpy()), JB[:, j], mode="session") for j in range(k)]
    jsvc.flush()
    want = [f.result(timeout=0) for f in jfuts]

    # the reference's embedding probe: call 1 of its session's certify key
    W = jax.random.normal(jax.random.fold_in(ref_session._certify_key, 1), (N, 8), jnp.float64)
    monkeypatch.setattr(tcert, "_draw_probes", lambda factor, key, n_probes: torch.as_tensor(np.array(W)))
    op = ref_session._sketch_op
    S = convert.countsketch_from_reference(op.buckets, op.signs, op.d, device=CPU)
    svc = _service()
    monkeypatch.setattr(svc, "_build_session", lambda A_, fp: SketchedSolver(
        A_, 0, sketch=S, atol=svc.session_tol, btol=svc.session_tol,
        iter_lim=svc.iter_lim, max_distortion=svc.max_distortion, device=CPU))
    futs = [svc.submit(A, B[:, j], mode="session") for j in range(k)]
    svc.flush()
    got = [f.result(timeout=0) for f in futs]
    (entry,) = svc.cache._entries.values()
    assert torch.equal(entry.solver._B, torch.as_tensor(np.asarray(ref_session._B)))
    for ours, ref in zip(got, want):
        assert ours.ok and ref.ok and ours.batch_size == ref.batch_size == k
        x_ref = torch.as_tensor(np.array(ref.x))
        assert _rel(ours.x, x_ref) <= 1e-8
        assert abs(int(ours.result.itn) - int(ref.result.itn)) <= 1
        assert bool(ours.certificate.passed) == bool(ref.certificate.passed)
        assert float(ours.certificate.distortion) == pytest.approx(float(ref.certificate.distortion), rel=1e-12)
        assert float(ours.certificate.cond_R) == pytest.approx(float(ref.certificate.cond_R), rel=1e-10)


def _traffic(svc, A, B, bucket_As):
    svc.solve(A, B[:, 0], mode="session")
    futs = [svc.submit(A, B[:, j], mode="session") for j in range(3)]
    futs += [svc.submit(Ai, bi) for Ai, bi in bucket_As]
    futs.append(svc.submit(A, B[:, 0], mode="session", deadline_s=-1.0))
    svc.flush()
    for f in futs:
        f.result(timeout=0)
    return svc.stats()


def test_metric_and_span_names_equal_the_references(tenant):
    A, B = tenant
    rng = np.random.default_rng(5)
    small = [(rng.standard_normal((50 + i, 7)), rng.standard_normal(50 + i)) for i in range(3)]
    REGISTRY.reset()
    JREGISTRY.reset()
    with obs.tracing() as tr:
        st = _traffic(_service(), A, B, small)
    JA, JB = jnp.asarray(A.numpy()), jnp.asarray(B.numpy())
    with jobs.tracing() as jtr:
        jst = _traffic(jserve.SolveService(jax.random.PRNGKey(42), max_delay_s=0.001), JA, JB,
                       [(jnp.asarray(a), jnp.asarray(b)) for a, b in small])

    def names(snap):
        return {kind: sorted(n for n in snap[kind] if n.startswith(("serve.", "cache.")))
                for kind in ("counters", "gauges", "histograms")}

    assert names(REGISTRY.snapshot()) == names(JREGISTRY.snapshot())

    def spans(tracer):
        return [(e["name"], e["ph"]) for e in tracer.chrome_trace()["traceEvents"]
                if e.get("name", "").startswith(("serve.", "cache."))]

    assert spans(tr) == spans(jtr)
    seen = {name for name, _ in spans(tr)}
    assert {"serve.submit", "serve.dispatch.session", "serve.dispatch.bucket", "serve.solve",
            "serve.certify", "serve.reject", "cache.build"} <= seen
    assert {k: v for k, v in st.items() if k != "cache"} == \
        {k: v for k, v in jst.items() if k != "cache"}
