"""Port parity: ``repro_torch.obs`` (the metrics registry, the span tracer,
the exporters, the lock-order watchdog) and ``lstsq(..., trace=True)``,
against the JAX reference ``repro.obs``.

- the unit tests of ``tests/test_obs.py`` (metrics, trace core,
  exporters, the disabled-span overhead contract), run on the port's obs;
- the same sequence of ``inc``/``set``/``observe`` fed into both
  registries renders identical ``prometheus_text()`` strings and equal
  ``json_snapshot()`` dicts (timestamps aside), and a Chrome-trace event of
  the port has the reference's keys;
- ``lstsq(..., trace=True)`` for the default call, ``method="saa"`` and
  ``accuracy="certified"`` on the same (20000, 64) f64 problem, made from a
  numpy seed: the reference's span names, in order, are a subsequence of
  the port's, and the extra names the port records are listed per case;
- the two packages' tracers stay apart, and ``stripped()`` reaches every
  call site of the port.

The timings in the overhead test are host-clock bounds (the reference's
own, ``tests/test_obs.py:456``), not device metrics.
"""
import json
import os
import pickle
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core.lstsq import lstsq as j_lstsq  # noqa: E402
from repro.obs import trace as j_trace  # noqa: E402
from repro.obs.export import json_snapshot as j_json_snapshot  # noqa: E402
from repro.obs.export import prometheus_text as j_prometheus_text  # noqa: E402
from repro.obs.metrics import MetricsRegistry as JRegistry  # noqa: E402
from repro_torch.core import lstsq  # noqa: E402
from repro_torch.obs import lockcheck  # noqa: E402
from repro_torch.obs import trace as obs_trace  # noqa: E402
from repro_torch.obs.export import (  # noqa: E402
    json_snapshot,
    prometheus_text,
    save_chrome_trace,
    torch_profile,
)
from repro_torch.obs.metrics import MetricsRegistry  # noqa: E402

CPU = "cpu"
ROOT = Path(__file__).resolve().parents[1]


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
def _no_tracer_leak():
    """Every test starts and ends with both packages' tracing off."""
    obs_trace.disable()
    j_trace.disable()
    yield
    obs_trace.disable()
    j_trace.disable()


@pytest.fixture(scope="module")
def problem():
    """A (20000, 64) problem (m·n² above the direct-method cutoff, so the
    default call sketches), from a numpy seed."""
    rng = np.random.default_rng(0)
    A = rng.standard_normal((20000, 64))
    b = rng.standard_normal(20000)
    return A, b


# ---------------------------------------------------------------------------
# metrics (tests/test_obs.py:58–134)


def test_counter_gauge_histogram():
    reg = MetricsRegistry(enabled=True)
    c = reg.counter("t.c")
    c.inc()
    c.inc(4)
    assert c.value == 5
    with pytest.raises(ValueError):
        c.inc(-1)
    g = reg.gauge("t.g")
    g.set(7)
    g.inc(-2)
    assert g.value == 5
    h = reg.histogram("t.h")
    h.observe(2e-4)   # second bucket (3e-4)
    h.observe(1e9)    # +inf overflow
    snap = h.snapshot()
    assert snap["count"] == 2
    assert snap["counts"][1] == 1
    assert snap["counts"][-1] == 1
    assert snap["sum"] == pytest.approx(2e-4 + 1e9)


def test_registry_get_or_create_is_stable():
    reg = MetricsRegistry(enabled=True)
    assert reg.counter("x") is reg.counter("x")
    assert reg.gauge("y") is reg.gauge("y")
    snap = reg.snapshot()
    assert "x" in snap["counters"] and "y" in snap["gauges"]


def test_disabled_registry_hands_out_nulls():
    reg = MetricsRegistry(enabled=False)
    c = reg.counter("nope")
    c.inc(10)
    assert c.value == 0
    assert reg.snapshot() == {"counters": {}, "gauges": {}, "histograms": {}}


def test_metrics_env_flag_disables_registry(monkeypatch):
    monkeypatch.setenv("REPRO_METRICS", "0")
    assert not MetricsRegistry().enabled
    monkeypatch.setenv("REPRO_METRICS", "1")
    assert MetricsRegistry().enabled


def test_stats_dict_is_a_plain_dict_to_tests():
    reg = MetricsRegistry(enabled=True)
    d = reg.stats_dict("ns", {"a": 0, "b": 0})
    d["a"] += 3
    d["b"] = 2
    assert d == {"a": 3, "b": 2}          # exact-equality pins keep working
    assert sorted(d) == ["a", "b"]
    assert reg.counter("ns.a").value == 3
    assert reg.gauge("ns.a.last").value == 3
    # two instances aggregate into the SAME registry counter
    d2 = reg.stats_dict("ns", {"a": 0})
    d2["a"] += 1
    assert reg.counter("ns.a").value == 4
    # pickles as a plain dict
    back = pickle.loads(pickle.dumps(d))
    assert type(back) is dict and back == {"a": 3, "b": 2}


def test_metrics_thread_safety():
    reg = MetricsRegistry(enabled=True)
    c = reg.counter("mt.c")
    d = reg.stats_dict("mt", {"hits": 0})
    lock = threading.Lock()

    def work():
        for _ in range(1000):
            c.inc()
            with lock:  # dict += is not atomic; the registry mirror is
                d["hits"] += 1

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert c.value == 8000
    assert d["hits"] == 8000
    assert reg.counter("mt.hits").value == 8000


def test_reset_drops_instruments_and_stats_dicts_recreate_them():
    reg = MetricsRegistry(enabled=True)
    d = reg.stats_dict("ns", {"a": 0})
    d["a"] += 2
    reg.reset()
    assert reg.snapshot() == {"counters": {}, "gauges": {}, "histograms": {}}
    d["a"] += 1
    assert reg.counter("ns.a").value == 1 and d == {"a": 3}


def _feed(reg):
    """One sequence of writes, for both packages' registries."""
    reg.counter("unit.requests").inc(3)
    reg.counter("unit.requests").inc()
    reg.gauge("unit.depth").set(2)
    reg.gauge("unit.depth").inc(-5)
    reg.gauge("unit.ratio").set(0.125)
    h = reg.histogram("unit.lat_s")
    for v in (2e-4, 5e-3, 0.3, 99.0, 1e-6):
        h.observe(v)
    reg.histogram("unit.custom", buckets=(1.0, 0.5, 2.0)).observe(0.75)
    s = reg.stats_dict("session", {"sketches": 0, "qr_factorizations": 0, "solves": 0})
    s["sketches"] += 1
    s["qr_factorizations"] += 2
    s["solves"] += 16


def test_registries_render_identically_to_reference():
    ours, ref = MetricsRegistry(enabled=True), JRegistry(enabled=True)
    _feed(ours)
    _feed(ref)
    assert prometheus_text(ours) == j_prometheus_text(ref)
    a, b = json_snapshot(ours), j_json_snapshot(ref)
    a.pop("ts_unix"), b.pop("ts_unix")
    assert json.loads(json.dumps(a)) == json.loads(json.dumps(b))
    assert ours.snapshot() == ref.snapshot()


# ---------------------------------------------------------------------------
# trace core (tests/test_obs.py:141–256)


def test_span_is_noop_when_disabled():
    assert not obs_trace.enabled()
    sp = obs_trace.span("anything", a=1)
    assert not sp  # falsy → call sites skip attr extraction
    with sp as s:
        s.set(b=2)  # must not raise
    obs_trace.instant("nothing")  # must not raise
    assert obs_trace.current() is None


def test_span_nesting_depth_and_order():
    with obs_trace.tracing() as tr:
        with obs_trace.span("outer", k=1) as outer:
            with obs_trace.span("inner"):
                obs_trace.instant("tick", v=2)
            outer.set(done=True)
    spans = {e["name"]: e for e in tr.events if e.get("ph") == "X"}
    assert spans["outer"]["depth"] == 0
    assert spans["inner"]["depth"] == 1
    assert spans["outer"]["args"] == {"k": 1, "done": True}
    # inner is contained in outer's [ts, ts+dur] window
    o, i = spans["outer"], spans["inner"]
    assert o["ts"] <= i["ts"]
    assert i["ts"] + i["dur"] <= o["ts"] + o["dur"] + 1e-3
    (tick,) = [e for e in tr.events if e.get("ph") == "i"]
    assert tick["name"] == "tick" and tick["depth"] == 2
    assert not obs_trace.enabled()  # tracing() deactivated on exit


def test_tracing_joins_active_tracer():
    with obs_trace.tracing() as tr1:
        with obs_trace.tracing() as tr2:
            assert tr2 is tr1
        assert obs_trace.enabled()  # inner exit must not deactivate
    assert not obs_trace.enabled()


def test_enable_is_idempotent_and_disable_returns_the_tracer():
    t = obs_trace.enable()
    assert obs_trace.enable() is t and obs_trace.current() is t
    assert obs_trace.disable() is t
    assert obs_trace.disable() is None


def test_chrome_trace_json_is_valid():
    with obs_trace.tracing() as tr:
        with obs_trace.span("a", shape=(3, 4)):
            obs_trace.instant("b")
    obj = tr.chrome_trace()
    text = json.dumps(obj)  # must be serializable (tuples etc. included)
    parsed = json.loads(text)
    assert parsed["displayTimeUnit"] == "ms"
    events = parsed["traceEvents"]
    assert any(e["ph"] == "M" for e in events)  # thread_name metadata
    for e in events:
        assert {"name", "ph", "pid", "tid"} <= set(e)
        if e["ph"] == "X":
            assert e["dur"] >= 0 and e["ts"] >= 0


def _events_of(trace_mod):
    with trace_mod.tracing() as tr:
        with trace_mod.span("a", k=1):
            trace_mod.instant("b", v=2)
    return {e["ph"]: e for e in tr.chrome_trace()["traceEvents"]}


def test_chrome_trace_events_have_reference_keys():
    ours, ref = _events_of(obs_trace), _events_of(j_trace)
    assert set(ours) == set(ref) == {"M", "X", "i"}
    for ph in ours:
        assert set(ours[ph]) == set(ref[ph]), ph
        for key in ("name", "ph", "cat", "pid", "tid", "depth", "args", "s"):
            if key in ref[ph]:
                assert ours[ph][key] == ref[ph][key], (ph, key)
    assert set(_events_of(obs_trace)) == set(_events_of(j_trace))


def test_solve_scope_semantics():
    # flag=True owns and deactivates
    sc = obs_trace.solve_scope(True)
    with sc:
        assert obs_trace.enabled()
        with obs_trace.span("s"):
            pass
    assert not obs_trace.enabled()
    # flag=None observes an enclosing tracer without owning it
    with obs_trace.tracing():
        with obs_trace.solve_scope(None) as sc2:
            with obs_trace.span("t"):
                pass
        assert obs_trace.enabled()
        res = sc2.attach(_FakeRes())
        assert res.timeline is not None
        assert "t" in res.timeline.names()
    # flag=None with nothing active: attach is a no-op
    with obs_trace.solve_scope(None) as sc3:
        pass
    r = _FakeRes()
    assert sc3.attach(r) is r


class _FakeRes:
    timeline = None

    def _replace(self, **kw):
        out = _FakeRes()
        out.timeline = kw.get("timeline")
        return out


def test_stripped_swaps_and_restores():
    real_span = obs_trace.span
    with obs_trace.stripped():
        assert obs_trace.span is not real_span
        with obs_trace.tracing() as tr:
            with obs_trace.span("invisible"):
                pass
        assert tr.events == [] or all(
            e["ph"] == "M" for e in tr.events
        )
    assert obs_trace.span is real_span


def test_threads_get_distinct_tids():
    with obs_trace.tracing() as tr:
        def work():
            with obs_trace.span("child_thread"):
                pass
        t = threading.Thread(target=work, name="obs-test-worker")
        t.start()
        t.join(timeout=60)
        assert not t.is_alive()
        with obs_trace.span("main_thread"):
            pass
    spans = {e["name"]: e for e in tr.events if e.get("ph") == "X"}
    assert spans["child_thread"]["tid"] != spans["main_thread"]["tid"]
    names = {
        e["args"]["name"] for e in tr.events if e.get("ph") == "M"
    }
    assert "obs-test-worker" in names


def test_timeline_render_and_save(tmp_path):
    with obs_trace.tracing() as tr:
        with obs_trace.span("root", k=1):
            with obs_trace.span("child"):
                obs_trace.instant("mark", v=3)
    tl = tr.timeline()
    assert tl.names() == ["mark", "child", "root"]
    assert [s["name"] for s in tl.spans()] == ["child", "root"]
    assert [e["name"] for e in tl.instants()] == ["mark"]
    lines = str(tl).splitlines()
    assert lines[0].startswith("root  ") and "[k=1]" in lines[0]
    assert lines[1].startswith("  child  ") and lines[2].startswith("    · mark @ ")
    assert repr(tl) == "Timeline(2 spans, 1 events)"
    path = tmp_path / "tl.json"
    tl.save(str(path))
    assert json.loads(path.read_text()) == json.loads(json.dumps(tl.chrome_trace()))


class _OnCard(torch.Tensor):
    """A CPU tensor that reports a CUDA device (no card is needed)."""

    @property
    def device(self):
        return torch.device("cuda", 1)


def test_maybe_block_waits_only_while_tracing(monkeypatch):
    """maybe_block synchronizes the device of each CUDA tensor it is given
    only while a tracer is active; CPU tensors and everything else pass
    through, and a failed synchronize raises."""
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda dev=None: calls.append(dev))
    on_card = torch.Tensor._make_subclass(_OnCard, torch.ones(2))
    x = (torch.ones(3), {"a": [torch.zeros(2), on_card]}, "text", None)
    assert obs_trace.maybe_block(x) is x
    assert calls == []  # no tracer: the card's queue is untouched
    with obs_trace.tracing():
        assert obs_trace.maybe_block(torch.ones(3)) is not None
        assert calls == []  # CPU tensors need no wait
        assert obs_trace.maybe_block(x) is x
        assert calls == [torch.device("cuda", 1)]

        def fault(dev=None):
            raise RuntimeError("device fault")

        monkeypatch.setattr(torch.cuda, "synchronize", fault)
        with pytest.raises(RuntimeError, match="device fault"):
            obs_trace.maybe_block(x)


def test_stripped_reaches_every_call_site_of_the_port(problem):
    """Inside stripped(), a traced solve records no span at all: every
    call site resolves obs_trace.span through the module."""
    A, b = problem
    with obs_trace.stripped():
        res = lstsq(A, b, 1, trace=True, device=CPU)
    assert res.timeline is not None and res.timeline.names() == []
    res = lstsq(A, b, 1, trace=True, device=CPU)
    assert "lstsq" in res.timeline.names()


# ---------------------------------------------------------------------------
# two tracers in one process


def test_two_packages_keep_separate_tracers():
    with obs_trace.tracing() as ours:
        assert not j_trace.enabled()
        with j_trace.tracing() as ref:
            with obs_trace.span("port_span"):
                pass
            with j_trace.span("reference_span"):
                pass
    assert not obs_trace.enabled() and not j_trace.enabled()
    assert [e["name"] for e in ours.events if e["ph"] == "X"] == ["port_span"]
    assert [e["name"] for e in ref.events if e["ph"] == "X"] == ["reference_span"]


def test_env_flag_enables_both_tracers_apart():
    code = (
        "from repro.obs import trace as j\n"
        "from repro_torch.obs import trace as t\n"
        "assert j.enabled() and t.enabled() and j.current() is not t.current()\n"
        "with t.span('port'):\n"
        "    pass\n"
        "with j.span('reference'):\n"
        "    pass\n"
        "names = lambda tr: [e['name'] for e in tr.events if e['ph'] == 'X']\n"
        "assert names(t.current()) == ['port'] and names(j.current()) == ['reference']\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), REPRO_TRACE="1", JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


# ---------------------------------------------------------------------------
# lock-order watchdog (the port's own copy)


class TestLockWatchdog:
    @pytest.fixture(autouse=True)
    def _clean(self):
        lockcheck.enable()
        lockcheck.reset_observations()
        yield
        lockcheck.disable()
        lockcheck.reset_observations()

    def test_disabled_returns_plain_locks(self):
        lockcheck.disable()
        assert not isinstance(lockcheck.make_lock("X"), lockcheck.OrderedLock)
        assert not isinstance(lockcheck.make_rlock("Y"), lockcheck.OrderedLock)

    def test_env_flag_enables(self, monkeypatch):
        lockcheck._forced = None
        monkeypatch.setenv("REPRO_LOCKCHECK", "1")
        assert lockcheck.enabled() and lockcheck.lockcheck_enabled()
        monkeypatch.setenv("REPRO_LOCKCHECK", "0")
        assert not lockcheck.enabled()

    def test_inversion_raises_on_second_ordering(self):
        a = lockcheck.make_lock("A")
        b = lockcheck.make_lock("B")
        with a:
            with b:
                pass
        with pytest.raises(lockcheck.LockOrderError, match="inversion"):
            with b:
                with a:
                    pass

    def test_transitive_inversion_detected(self):
        a, b, c = (lockcheck.make_lock(n) for n in "ABC")
        with a:
            with b:
                pass
        with b:
            with c:
                pass
        with pytest.raises(lockcheck.LockOrderError):
            with c:
                with a:
                    pass

    def test_rlock_reentry_and_same_name_pairs(self):
        r = lockcheck.make_rlock("R")
        with r:
            with r:
                pass  # no self-edge, no error
        m1, m2 = lockcheck.make_lock("M._mu"), lockcheck.make_lock("M._mu")
        with m1:
            with m2:
                pass
        with m2:
            with m1:
                pass  # two instances of one class: never ordered
        assert lockcheck.observed_edges() == {}

    def test_port_edges_do_not_reach_the_reference_watchdog(self):
        from repro.obs import lockcheck as j_lockcheck

        j_lockcheck.reset_observations()
        a, b = lockcheck.make_lock("A"), lockcheck.make_lock("B")
        with a:
            with b:
                pass
        assert "B" in lockcheck.observed_edges()["A"]
        assert j_lockcheck.observed_edges() == {}


# ---------------------------------------------------------------------------
# integration: lstsq(trace=True), against the reference's timeline


def test_lstsq_untraced_has_no_timeline(problem):
    A, b = problem
    res = lstsq(A, b, 0, device=CPU)
    assert res.timeline is None
    assert not obs_trace.enabled()


def test_lstsq_traced_attaches_nested_timeline(problem):
    A, b = problem
    res = lstsq(A, b, 0, trace=True, device=CPU)
    tl = res.timeline
    assert isinstance(tl, obs_trace.Timeline)
    names = tl.names()
    assert names[-1] == "lstsq"  # complete events close outermost-last
    assert "lstsq.select" in names and "lstsq.solve" in names
    root = [s for s in tl.spans() if s["name"] == "lstsq"][0]
    assert root["depth"] == 0 and root["args"]["method"] == res.method
    solve = [s for s in tl.spans() if s["name"] == "lstsq.solve"][0]
    assert solve["depth"] == 1 and "itn" in solve["args"]
    json.loads(json.dumps(tl.chrome_trace()))  # valid chrome trace
    assert "lstsq" in str(tl)  # renders
    assert not obs_trace.enabled()  # per-call scope released the tracer


def test_certified_trace_shows_rungs_and_probes():
    rng = np.random.default_rng(1)
    A, b = rng.standard_normal((512, 8)), rng.standard_normal(512)
    res = lstsq(A, b, 0, accuracy="certified", trace=True, device=CPU)
    names = res.timeline.names()
    assert "certified.rung" in names
    assert "certify.probe" in names
    assert "factor.build" in names
    rungs = [s for s in res.timeline.spans() if s["name"] == "certified.rung"]
    assert all("passed" in r["args"] for r in rungs)
    assert rungs[-1]["args"]["passed"] is True


def test_traced_escalations_show_their_spans():
    """From n + 2 rows the ladder escalates: a certified.escalate span
    holding factor.extend and its factor.qr; under precision='mixed' a
    failing rung first escalates precision."""
    from repro_torch.core import generate_problem

    p = generate_problem(3, 4096, 24, cond=1e8, beta=1e-10, device=CPU)
    res = lstsq(p.A, p.b, 1, accuracy="certified", sketch_size=26, trace=True, device=CPU)
    spans = res.timeline.spans()
    esc = [s for s in spans if s["name"] == "certified.escalate"]
    assert len(esc) == res.certificate.escalations >= 1
    ext = [s for s in spans if s["name"] == "factor.extend"]
    assert len(ext) == len(esc) and all(e["depth"] == esc[0]["depth"] + 1 for e in ext)
    rungs = [s for s in spans if s["name"] == "certified.rung"]
    assert [r["args"]["attempt"] for r in rungs] == list(range(len(rungs)))
    assert rungs[-1]["args"]["passed"] is True and not any(r["args"]["passed"] for r in rungs[:-1])


def _subsequence_extras(ref, ours):
    """The names of ``ours`` left over once ``ref`` is matched in order as a
    subsequence; None when ``ref`` is not a subsequence of ``ours``."""
    extras, i = [], 0
    for name in ours:
        if i < len(ref) and name == ref[i]:
            i += 1
        else:
            extras.append(name)
    return extras if i == len(ref) else None


@pytest.mark.parametrize(
    "kw,extras",
    [
        # The port runs eagerly, as the reference's lstsq does at this
        # size: the same spans, in the same order, and nothing more.
        (dict(), []),
        (dict(method="saa"), []),
        (dict(accuracy="certified"), []),
    ],
)
def test_trace_names_follow_reference(problem, kw, extras):
    A, b = problem
    ref = j_lstsq(jax.numpy.asarray(A), jax.numpy.asarray(b), jax.random.key(1), trace=True, **kw)
    res = lstsq(A, b, 1, trace=True, device=CPU, **kw)
    assert res.method == ref.method
    ref_names, names = ref.timeline.names(), res.timeline.names()
    assert _subsequence_extras(ref_names, names) == extras, (ref_names, names)
    depth = lambda tl: {s["name"]: s["depth"] for s in tl.spans()}  # noqa: E731
    assert depth(res.timeline) == depth(ref.timeline)
    args = lambda tl, name: sorted(  # noqa: E731
        next(s for s in tl.spans() if s["name"] == name)["args"])
    for name in set(ref_names):
        assert args(res.timeline, name) == args(ref.timeline, name), name
    # every child lies within its parent's window
    spans = sorted(res.timeline.spans(), key=lambda s: (s["ts"], s["depth"]))
    for parent in spans:
        for child in spans:
            if child["depth"] == parent["depth"] + 1 and parent["ts"] <= child["ts"] <= parent["ts"] + parent["dur"]:
                assert child["dur"] <= parent["dur"] + 1e-3


# ---------------------------------------------------------------------------
# exporters (tests/test_obs.py:419–449)


def test_prometheus_text_format():
    reg = MetricsRegistry(enabled=True)
    reg.counter("unit.requests").inc(3)
    reg.gauge("unit.depth").set(2)
    h = reg.histogram("unit.lat_s")
    for v in (2e-4, 5e-3, 99.0):
        h.observe(v)
    txt = prometheus_text(reg)
    lines = txt.strip().splitlines()
    assert "# TYPE repro_unit_requests counter" in lines
    assert "repro_unit_requests 3" in lines
    assert "repro_unit_depth 2" in lines
    # cumulative buckets end at the total count, +Inf line included
    assert 'repro_unit_lat_s_bucket{le="+Inf"} 3' in lines
    cums = [int(ln.rsplit(" ", 1)[1]) for ln in lines
            if ln.startswith("repro_unit_lat_s_bucket")]
    assert cums == sorted(cums)
    assert "repro_unit_lat_s_count 3" in lines


def test_json_snapshot_and_save_chrome_trace(tmp_path):
    reg = MetricsRegistry(enabled=True)
    reg.counter("snap.n").inc()
    snap = json_snapshot(reg)
    assert snap["counters"]["snap.n"] == 1 and "ts_unix" in snap
    with obs_trace.tracing() as tr:
        with obs_trace.span("saved"):
            pass
    p = save_chrome_trace(tr, str(tmp_path / "trace.json"))
    loaded = json.load(open(p))
    assert any(e["name"] == "saved" for e in loaded["traceEvents"])


def test_torch_profile_writes_trace_inside_a_span(tmp_path):
    logdir = tmp_path / "prof"
    with obs_trace.tracing() as tr:
        with torch_profile(str(logdir)) as prof:
            torch.ones(64, 64) @ torch.ones(64, 64)
    spans = [e for e in tr.events if e.get("ph") == "X"]
    assert [s["name"] for s in spans] == ["torch_profile"]
    assert spans[0]["args"] == {"logdir": str(logdir)}
    assert prof.key_averages() is not None
    events = json.loads((logdir / "torch_profile.json").read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


# ---------------------------------------------------------------------------
# overhead contract (tests/test_obs.py:456–486)


def test_disabled_span_overhead_same_order():
    """The disabled path (global check + shared no-op) must stay within
    small constant factors of a fully stripped build, and under 2 µs a
    call (host clock)."""
    N = 50_000

    def disabled_loop():
        t0 = time.perf_counter()
        for _ in range(N):
            with obs_trace.span("x", a=1):
                pass
        return time.perf_counter() - t0

    def stripped_loop():
        with obs_trace.stripped():
            t0 = time.perf_counter()
            for _ in range(N):
                with obs_trace.span("x", a=1):
                    pass
            return time.perf_counter() - t0

    disabled = min(disabled_loop() for _ in range(3))
    stripped_t = min(stripped_loop() for _ in range(3))
    per_call_ns = (disabled / N) * 1e9
    assert per_call_ns < 2000, f"disabled span costs {per_call_ns:.0f}ns/call"
    assert disabled < max(stripped_t * 10, 0.05), (
        f"disabled={disabled:.4f}s stripped={stripped_t:.4f}s"
    )
