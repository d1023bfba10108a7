"""repro_torch.obs — tracing, metrics and export for the port.

Port of ``repro.obs``, one substrate in three layers:

- :mod:`repro_torch.obs.metrics` — the process-wide
  :data:`~repro_torch.obs.metrics.REGISTRY` of counters / gauges / bounded
  histograms that the session's ``stats`` feed (the dicts are unchanged;
  the registry aggregates the same numbers across instances).
- :mod:`repro_torch.obs.trace` — nested wall-clock spans across method
  selection, sketch/QR, certification rungs and the session; opt-in via
  ``lstsq(..., trace=True)``, ``REPRO_TRACE=1`` or ``with obs.tracing():``,
  exported as Chrome-trace JSON and attached to ``SolveResult.timeline``.
  While tracing, each span waits for the card (``torch.cuda.synchronize``)
  so its duration is device wall time.
- :mod:`repro_torch.obs.export` — Prometheus text exposition, JSON
  snapshots and a ``torch.profiler`` hook (:func:`torch_profile`).

Two tracers in one process: this package and the reference ``repro.obs``
each keep their own module-global active tracer and their own registry.
``REPRO_TRACE=1`` enables both, but a span of one never lands in the
other's trace, and the metric names of one never reach the other's
registry.
"""
from .lockcheck import (
    LockOrderError,
    make_lock,
    make_rlock,
    lockcheck_enabled,
)
from .metrics import REGISTRY, MetricsRegistry, DEFAULT_BUCKETS
from .trace import (
    Timeline,
    Tracer,
    enabled,
    enable,
    disable,
    instant,
    maybe_block,
    span,
    tracing,
)
from .export import json_snapshot, prometheus_text, save_chrome_trace, torch_profile

__all__ = [
    "LockOrderError",
    "make_lock",
    "make_rlock",
    "lockcheck_enabled",
    "REGISTRY",
    "MetricsRegistry",
    "DEFAULT_BUCKETS",
    "Timeline",
    "Tracer",
    "enabled",
    "enable",
    "disable",
    "instant",
    "maybe_block",
    "span",
    "tracing",
    "json_snapshot",
    "prometheus_text",
    "save_chrome_trace",
    "torch_profile",
]
