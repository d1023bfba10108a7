"""Span tracing: nested wall-clock timelines across the port.

Port of ``repro/obs/trace.py``.  The instrumentation contract is one idiom
at every site::

    from ..obs import trace as obs_trace
    with obs_trace.span("sketch.apply", kind=sketch, shape=(m, n)):
        B = ...
        obs_trace.maybe_block(B)

Call sites resolve ``span``/``instant``/``maybe_block`` through this
module (``obs_trace.span``), never through a ``from .trace import span``:
:class:`stripped` swaps the module's globals, and a name bound at import
would escape it.

- **Disabled is the default and costs almost nothing**: ``span()`` reads
  one module global, sees no active tracer, and returns a shared no-op
  context manager.  No locks, no allocation beyond the call's kwargs, no
  device synchronization.
- **Enabled** (``REPRO_TRACE=1``, :func:`tracing`, or per-call
  ``lstsq(..., trace=True)``) every span records a Chrome-trace complete
  event — start, duration (µs), thread, nesting depth, attributes — into
  one process-global :class:`Tracer`.  A *module-global* active tracer
  (not a contextvar) is deliberate: worker threads must land their spans
  in the same trace as the caller.
- ``maybe_block`` calls ``torch.cuda.synchronize`` on the device of each
  CUDA tensor it is given, *only while tracing*, so span durations are
  device wall time; with tracing off the card's queue is untouched.  A
  failed synchronize is a device fault and raises.
- Spans opened while ``torch.compile`` traces a function (no real work)
  are suppressed.

:class:`Timeline` is the export surface: ``str(tl)`` renders an indented
per-solve tree, ``tl.chrome_trace()`` / ``tl.save(path)`` produce JSON
loadable in ``chrome://tracing`` or Perfetto.
"""
from __future__ import annotations

import json
import os
import threading
import time

import torch

from .lockcheck import make_lock

__all__ = [
    "Tracer",
    "Timeline",
    "span",
    "instant",
    "maybe_block",
    "enabled",
    "enable",
    "disable",
    "tracing",
    "stripped",
    "solve_scope",
    "current",
]

_ENV_FLAG = "REPRO_TRACE"

_active: "Tracer | None" = None
_active_mu = threading.Lock()
_tls = threading.local()


def _live() -> bool:
    """False while ``torch.compile`` traces (abstract, zero-work calls)."""
    return not torch.compiler.is_compiling()


def _depth() -> int:
    return getattr(_tls, "depth", 0)


class Tracer:
    """Event sink: an append-only list of Chrome-trace event dicts.

    All event appends and snapshot reads go through ``self._mu``: a reader
    iterating ``events`` concurrently with an append must not observe a
    resize mid-copy.  One short lock per recorded event is noise next to
    the ``perf_counter`` calls either side of it.
    """

    GUARDED_BY = {"events": "_mu", "_tids": "_mu"}
    GUARDED_READS = frozenset({"events"})

    def __init__(self):
        self.t0 = time.perf_counter()
        self.events: list[dict] = []
        self._mu = make_lock("Tracer._mu")
        self._tids: dict[int, int] = {}

    def now_us(self) -> float:
        return (time.perf_counter() - self.t0) * 1e6

    def record(self, ev: dict) -> None:
        """Append one Chrome-trace event dict (thread-safe)."""
        with self._mu:
            self.events.append(ev)

    def tid(self) -> int:
        ident = threading.get_ident()
        t = self._tids.get(ident)  # racy fast path, settled under _mu below
        if t is None:
            with self._mu:
                t = self._tids.get(ident)
                if t is None:
                    t = len(self._tids)
                    self._tids[ident] = t
                    self.events.append({
                        "name": "thread_name", "ph": "M", "pid": 1, "tid": t,
                        "args": {"name": threading.current_thread().name},
                    })
        return t

    def chrome_trace(self) -> dict:
        with self._mu:
            events = list(self.events)
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)

    def timeline(self, start: int = 0) -> "Timeline":
        with self._mu:
            return Timeline(list(self.events[start:]))


class Timeline:
    """A slice of trace events scoped to one solve.

    Attached to ``SolveResult.timeline``; renders as an indented tree
    (depth + start-time ordering reconstruct the nesting) and exports the
    same events as Chrome-trace JSON.
    """

    __slots__ = ("events",)

    def __init__(self, events: list[dict]):
        self.events = events

    def spans(self) -> list[dict]:
        return [e for e in self.events if e.get("ph") == "X"]

    def instants(self) -> list[dict]:
        return [e for e in self.events if e.get("ph") == "i"]

    def names(self) -> list[str]:
        return [e["name"] for e in self.events if e.get("ph") in ("X", "i")]

    def chrome_trace(self) -> dict:
        return {"traceEvents": list(self.events), "displayTimeUnit": "ms"}

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)

    def render(self) -> str:
        rows = [e for e in self.events if e.get("ph") in ("X", "i")]
        rows.sort(key=lambda e: (e["ts"], e.get("depth", 0)))
        lines = []
        for e in rows:
            pad = "  " * e.get("depth", 0)
            args = e.get("args") or {}
            attrs = " ".join(f"{k}={v}" for k, v in args.items())
            attrs = f"  [{attrs}]" if attrs else ""
            if e.get("ph") == "i":
                lines.append(
                    f"{pad}· {e['name']} @ {e['ts'] / 1e3:.3f} ms{attrs}"
                )
            else:
                lines.append(
                    f"{pad}{e['name']}  {e.get('dur', 0) / 1e3:.3f} ms{attrs}"
                )
        return "\n".join(lines)

    def __str__(self) -> str:
        return self.render()

    def __repr__(self) -> str:
        n = len(self.spans())
        return f"Timeline({n} spans, {len(self.instants())} events)"


# ---------------------------------------------------------------------------
# span recording


class _NoopSpan:
    """Shared do-nothing span: the tracing-disabled fast path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **kw):
        pass

    def __bool__(self):
        return False


_NOOP = _NoopSpan()


class _Span:
    __slots__ = ("_tracer", "_name", "_args", "_t0", "_depth")

    def __init__(self, tracer: Tracer, name: str, args: dict):
        self._tracer = tracer
        self._name = name
        self._args = args

    def set(self, **kw) -> None:
        """Attach attributes discovered mid-span (method picked, itn...)."""
        self._args.update(kw)

    def __bool__(self):
        return True

    def __enter__(self):
        self._depth = _depth()
        _tls.depth = self._depth + 1
        self._t0 = self._tracer.now_us()
        return self

    def __exit__(self, *exc):
        t1 = self._tracer.now_us()
        _tls.depth = self._depth
        self._tracer.record({
            "name": self._name, "cat": "repro", "ph": "X",
            "ts": self._t0, "dur": t1 - self._t0,
            "pid": 1, "tid": self._tracer.tid(),
            "depth": self._depth, "args": self._args,
        })
        return False


def span(name: str, **args):
    """Context manager timing a region; no-op unless tracing is active."""
    t = _active
    if t is None or not _live():
        return _NOOP
    return _Span(t, name, args)


def instant(name: str, **args) -> None:
    """Point event (eviction, restore, submit...); no-op when disabled."""
    t = _active
    if t is None or not _live():
        return
    t.record({
        "name": name, "cat": "repro", "ph": "i", "s": "t",
        "ts": t.now_us(), "pid": 1, "tid": t.tid(),
        "depth": _depth(), "args": args,
    })


def _cuda_devices(x, out: set) -> set:
    """The CUDA devices of the tensors in ``x`` (a tensor, or nested
    tuples, lists and dicts of them; anything else holds none)."""
    if isinstance(x, torch.Tensor):
        if x.device.type == "cuda":
            out.add(x.device)
    elif isinstance(x, (tuple, list)):
        for v in x:
            _cuda_devices(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            _cuda_devices(v, out)
    return out


def maybe_block(x):
    """Wait for the card — only while tracing.

    Synchronizes the device of each CUDA tensor in ``x``, so the device
    work a span launched is attributed to that span, without perturbing
    the untraced pipeline.  CPU tensors and non-tensors need no wait.
    """
    if _active is not None and _live():
        for dev in _cuda_devices(x, set()):
            torch.cuda.synchronize(dev)
    return x


# ---------------------------------------------------------------------------
# activation


def enabled() -> bool:
    return _active is not None


def current() -> Tracer | None:
    return _active


def enable() -> Tracer:
    """Activate a fresh process-global tracer (idempotent: returns the
    active one if tracing is already on)."""
    global _active
    with _active_mu:
        if _active is None:
            _active = Tracer()
        return _active


def disable() -> Tracer | None:
    """Deactivate and return the tracer that was collecting (if any)."""
    global _active
    with _active_mu:
        t, _active = _active, None
        return t


class tracing:
    """``with tracing() as tr:`` — enable tracing for a region.

    Joins an already-active tracer rather than stacking a new one; only
    the outermost ``tracing`` deactivates on exit.  The yielded value is
    the :class:`Tracer`; ``tr.timeline(mark)`` / ``tr.chrome_trace()``
    read the events afterwards.
    """

    def __init__(self):
        self._owned = False

    def __enter__(self) -> Tracer:
        global _active
        with _active_mu:
            if _active is None:
                _active = Tracer()
                self._owned = True
            return _active

    def __exit__(self, *exc):
        if self._owned:
            disable()
        return False


class solve_scope:
    """Per-call tracing scope for ``lstsq(..., trace=True)`` and friends.

    - ``flag=True``: ensure a tracer is active for the call (owning — and
      therefore deactivating — it only if none was active before).
    - ``flag=None``/``False``: never activates, but still *observes* an
      already-active tracer (env flag or enclosing :class:`tracing`).

    ``attach(res)`` replaces ``res.timeline`` with the :class:`Timeline`
    of events recorded since ``__enter__`` whenever a tracer was live.
    """

    __slots__ = ("_flag", "_owned", "_tracer", "_mark")

    def __init__(self, flag: bool | None):
        self._flag = flag
        self._owned = False
        self._tracer = None
        self._mark = 0

    def __enter__(self) -> "solve_scope":
        global _active
        with _active_mu:
            if _active is None and self._flag:
                _active = Tracer()
                self._owned = True
            self._tracer = _active
        if self._tracer is not None:
            self._mark = len(self._tracer.events)
        return self

    def __exit__(self, *exc):
        if self._owned:
            disable()
        return False

    def attach(self, res):
        if self._tracer is None:
            return res
        tl = self._tracer.timeline(self._mark)
        try:
            return res._replace(timeline=tl)
        except (AttributeError, ValueError):
            return res


# ---------------------------------------------------------------------------
# benchmark support


class stripped:
    """Replace the instrumentation entry points with bare no-ops.

    The honest baseline for the ≤ 1.05x tracing-disabled overhead gate:
    inside this context every ``obs_trace.span(...)`` call site resolves
    to a function that does *nothing at all*, so timing the same solve
    in and out of the context isolates the cost of the disabled-path
    machinery (global check, no-op context manager) that this module is
    contractually required to keep near zero.
    """

    def __enter__(self):
        g = globals()
        self._saved = (g["span"], g["instant"], g["maybe_block"])
        g["span"] = lambda name, **args: _NOOP
        g["instant"] = lambda name, **args: None
        g["maybe_block"] = lambda x: x
        return self

    def __exit__(self, *exc):
        g = globals()
        g["span"], g["instant"], g["maybe_block"] = self._saved
        return False


if os.environ.get(_ENV_FLAG, "") not in ("", "0"):
    enable()
