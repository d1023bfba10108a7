"""Process-wide metrics registry: counters, gauges, bounded histograms.

Port of ``repro/obs/metrics.py`` (the port keeps its own copy).  One
registry (:data:`REGISTRY`) serves the whole port; it is not the
reference package's registry, so the two never mix their numbers.  Three
design constraints drive the implementation:

- **Thread-safe.**  Every instrument guards its state with its own small
  lock; the registry lock only covers name → instrument lookup.
- **Near-zero cost when disabled.**  ``REPRO_METRICS=0`` swaps every
  instrument for a shared null object whose methods are no-op one-liners:
  a disabled ``counter.inc()`` is one attribute call, no lock, no dict.
- **Plain dicts for stats.**  The ``stats`` of the session (and of the
  later streaming, cluster and serve slices) are *real dicts* that tests
  pin by equality; :meth:`MetricsRegistry.stats_dict` returns a ``dict``
  subclass that mirrors every write into registry counters/gauges, so the
  dicts keep their exact keys and values while the registry aggregates
  the same numbers across all instances under ``namespace.key`` names.

Histograms use fixed log-spaced latency buckets (seconds) — bounded
memory regardless of observation count, exported in Prometheus's
cumulative-bucket convention by :mod:`repro_torch.obs.export`.
"""
from __future__ import annotations

import os

from .lockcheck import make_lock

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "REGISTRY",
    "DEFAULT_BUCKETS",
]

# Log-spaced seconds: 100 µs … 30 s, plus +inf implicitly (the overflow
# count lives in ``counts[-1]``).
DEFAULT_BUCKETS = (
    1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 1e-1, 3e-1, 1.0, 3.0, 10.0, 30.0,
)


class Counter:
    """Monotone counter.  ``inc`` only; negative increments are rejected."""

    __slots__ = ("name", "_mu", "_value")
    GUARDED_BY = {"_value": "_mu"}

    def __init__(self, name: str):
        self.name = name
        self._mu = make_lock("Counter._mu")
        self._value = 0

    def inc(self, n: int | float = 1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name}: negative increment {n}")
        with self._mu:
            self._value += n

    @property
    def value(self):
        with self._mu:
            return self._value


class Gauge:
    """Point-in-time value: ``set`` or ``inc`` (either sign)."""

    __slots__ = ("name", "_mu", "_value")
    GUARDED_BY = {"_value": "_mu"}

    def __init__(self, name: str):
        self.name = name
        self._mu = make_lock("Gauge._mu")
        self._value = 0

    def set(self, v) -> None:
        with self._mu:
            self._value = v

    def inc(self, n=1) -> None:
        with self._mu:
            self._value += n

    @property
    def value(self):
        with self._mu:
            return self._value


class Histogram:
    """Bounded-bucket histogram: fixed upper bounds, O(#buckets) memory.

    ``counts[i]`` counts observations ≤ ``buckets[i]`` (non-cumulative in
    storage; the exporter accumulates); ``counts[-1]`` is the +inf
    overflow bucket.  Tracks ``sum``/``count`` for mean latency.
    """

    __slots__ = ("name", "buckets", "_mu", "_counts", "_sum", "_count")
    GUARDED_BY = {"_counts": "_mu", "_sum": "_mu", "_count": "_mu"}

    def __init__(self, name: str, buckets=DEFAULT_BUCKETS):
        self.name = name
        self.buckets = tuple(sorted(float(b) for b in buckets))
        self._mu = make_lock("Histogram._mu")
        self._counts = [0] * (len(self.buckets) + 1)
        self._sum = 0.0
        self._count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        i = 0
        for b in self.buckets:
            if v <= b:
                break
            i += 1
        with self._mu:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    def snapshot(self) -> dict:
        with self._mu:
            return {
                "buckets": self.buckets,
                "counts": tuple(self._counts),
                "sum": self._sum,
                "count": self._count,
            }


class _Null:
    """Shared no-op instrument — what a disabled registry hands out."""

    __slots__ = ()
    name = "null"
    value = 0
    buckets = ()

    def inc(self, n=1):
        pass

    def set(self, v):
        pass

    def observe(self, v):
        pass

    def snapshot(self):
        return {"buckets": (), "counts": (), "sum": 0.0, "count": 0}


_NULL = _Null()


class StatsDict(dict):
    """A plain dict that mirrors writes into the registry.

    Reads, equality, iteration — everything tests pin — behave exactly
    like the dict it replaces.  Each ``d[k] = v`` additionally feeds the
    registry: positive deltas go to a shared counter ``namespace.key``
    (aggregating across instances — many sessions, one metric), and the
    latest value to a gauge ``namespace.key.last``.
    """

    __slots__ = ("_registry", "_ns")

    def __init__(self, registry: "MetricsRegistry", namespace: str, initial):
        super().__init__(initial)
        self._registry = registry
        self._ns = namespace
        for k, v in initial.items():
            if v:
                self._mirror(k, 0, v)

    def _mirror(self, k, old, new) -> None:
        name = f"{self._ns}.{k}"
        delta = new - old
        if delta > 0:
            self._registry.counter(name).inc(delta)
        self._registry.gauge(name + ".last").set(new)

    def __setitem__(self, k, v):
        old = dict.get(self, k, 0)
        dict.__setitem__(self, k, v)
        self._mirror(k, old, v)

    def __reduce__(self):  # pickle as a plain dict (checkpoints)
        return (dict, (dict(self),))


class MetricsRegistry:
    """Name → instrument map with get-or-create semantics.

    Disabled (``enabled=False`` or ``REPRO_METRICS=0``) the registry
    hands out a shared null instrument and records nothing.
    """

    # The name tables are created once here and only ever mutated under
    # _mu — note the one deliberate blind spot: _get() writes through its
    # `table` alias, which a lexical checker cannot tie back to these
    # attrs.  The alias write is inside `with self._mu:` all the same.
    GUARDED_BY = {
        "_counters": "_mu",
        "_gauges": "_mu",
        "_histograms": "_mu",
    }

    def __init__(self, enabled: bool | None = None):
        if enabled is None:
            enabled = os.environ.get("REPRO_METRICS", "1") != "0"
        self.enabled = bool(enabled)
        self._mu = make_lock("MetricsRegistry._mu")
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}

    def _get(self, table, name, factory):
        inst = table.get(name)
        if inst is None:
            with self._mu:
                inst = table.get(name)
                if inst is None:
                    inst = table[name] = factory()
        return inst

    def counter(self, name: str) -> Counter:
        if not self.enabled:
            return _NULL
        return self._get(self._counters, name, lambda: Counter(name))

    def gauge(self, name: str) -> Gauge:
        if not self.enabled:
            return _NULL
        return self._get(self._gauges, name, lambda: Gauge(name))

    def histogram(self, name: str, buckets=DEFAULT_BUCKETS) -> Histogram:
        if not self.enabled:
            return _NULL
        return self._get(
            self._histograms, name, lambda: Histogram(name, buckets)
        )

    def stats_dict(self, namespace: str, initial: dict) -> StatsDict:
        """A dict-compatible stats object mirrored into this registry."""
        return StatsDict(self, namespace, initial)

    # ------------------------------------------------------------- export
    def snapshot(self) -> dict:
        """Consistent-enough point-in-time copy of every instrument.

        Each instrument is read under its own lock; the registry lock
        covers the name tables, so no instrument is lost or torn mid-read
        (cross-instrument skew is inherent to any live snapshot).
        """
        with self._mu:
            counters = list(self._counters.values())
            gauges = list(self._gauges.values())
            histograms = list(self._histograms.values())
        return {
            "counters": {c.name: c.value for c in counters},
            "gauges": {g.name: g.value for g in gauges},
            "histograms": {h.name: h.snapshot() for h in histograms},
        }

    def reset(self) -> None:
        """Drop every instrument (tests; the stats dicts keep working —
        their next write re-creates the mirrored instruments)."""
        with self._mu:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()


REGISTRY = MetricsRegistry()
