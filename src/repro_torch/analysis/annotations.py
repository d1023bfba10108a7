"""Runtime-side annotation vocabulary the lock-discipline checker reads.

Port of ``repro/analysis/annotations.py``.  Everything here is free at
run time — the annotations exist so the AST checker (rule R1 of
``python -m repro.analysis``) and readers can see the locking design in
the code itself:

- ``GUARDED_BY = {"attr": "_lock"}`` — class attribute mapping shared
  mutable attributes to the lock that must be held to write them.
- ``GUARDED_READS = frozenset({"attr"})`` — attrs whose *reads* must
  also hold the lock (state where a torn read matters, e.g. a list
  snapshotted while another thread appends).
- ``@guarded_by("_lock")`` — marks a helper method as "caller already
  holds ``self._lock``": writes inside it are considered guarded, and the
  checker instead checks that every call site of the method sits inside
  ``with self._lock:`` (or another method guarded by the same lock).  The
  checker finds the decorator by this name.

The decorator only stamps the function, so annotating a hot path costs
nothing.
"""
from __future__ import annotations

__all__ = ["guarded_by", "GUARDED_BY_ATTR"]

GUARDED_BY_ATTR = "__reprolint_guarded_by__"


def guarded_by(lock: str):
    """Declare that a method must only be called with ``self.<lock>`` held."""

    def mark(fn):
        setattr(fn, GUARDED_BY_ATTR, lock)
        return fn

    return mark
