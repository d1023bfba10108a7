"""Exporters: Prometheus text exposition, JSON snapshots, profiler hook.

Port of ``repro/obs/export.py``, with the same text format and names.
Everything here is pull-based: :func:`prometheus_text` renders the
registry in the text exposition format (scrape it from any HTTP handler
the embedding app already has), :func:`json_snapshot` is the same data as
a plain dict for logs/tests, and :func:`torch_profile` wraps a traced
region with ``torch.profiler`` so a repro span timeline and a kernel-level
profile are captured in one shot.
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import time

import torch

from .metrics import REGISTRY, MetricsRegistry
from . import trace as trace_lib

__all__ = [
    "prometheus_text",
    "json_snapshot",
    "save_chrome_trace",
    "torch_profile",
]

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    return _NAME_RE.sub("_", f"repro_{name}")


def prometheus_text(registry: MetricsRegistry = REGISTRY) -> str:
    """Render the registry in Prometheus text exposition format 0.0.4."""
    snap = registry.snapshot()
    out: list[str] = []
    for name, value in sorted(snap["counters"].items()):
        p = _prom_name(name)
        out.append(f"# TYPE {p} counter")
        out.append(f"{p} {value}")
    for name, value in sorted(snap["gauges"].items()):
        p = _prom_name(name)
        out.append(f"# TYPE {p} gauge")
        out.append(f"{p} {value}")
    for name, h in sorted(snap["histograms"].items()):
        p = _prom_name(name)
        out.append(f"# TYPE {p} histogram")
        cum = 0
        for bound, count in zip(h["buckets"], h["counts"]):
            cum += count
            out.append(f'{p}_bucket{{le="{bound}"}} {cum}')
        cum += h["counts"][-1] if h["counts"] else 0
        out.append(f'{p}_bucket{{le="+Inf"}} {cum}')
        out.append(f"{p}_sum {h['sum']}")
        out.append(f"{p}_count {h['count']}")
    return "\n".join(out) + "\n"


def json_snapshot(registry: MetricsRegistry = REGISTRY) -> dict:
    """Registry snapshot as a JSON-serializable dict (with a timestamp)."""
    snap = registry.snapshot()
    snap["ts_unix"] = time.time()
    json.dumps(snap)  # guarantee serializability at the source
    return snap


def save_chrome_trace(obj, path: str) -> str:
    """Write a :class:`Tracer` or :class:`Timeline` as Chrome-trace JSON."""
    with open(path, "w") as f:
        json.dump(obj.chrome_trace(), f)
    return path


@contextlib.contextmanager
def torch_profile(logdir: str):
    """Capture a ``torch.profiler`` trace around a repro-traced region.

    The region runs inside a span named ``torch_profile`` under a
    ``torch.profiler.profile`` of CPU activity, and of CUDA activity when
    the process sees a card; the profiler is yielded (``key_averages()``
    reads device time by kernel).  On exit its Chrome trace is written to
    ``logdir/torch_profile.json``.
    """
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with trace_lib.span("torch_profile", logdir=logdir):
        with profile(activities=activities) as prof:
            yield prof
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "torch_profile.json"))
