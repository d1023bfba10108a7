"""Runtime lock-order watchdog (debug-only, ``REPRO_LOCKCHECK=1``).

Port of ``repro/obs/lockcheck.py``: the port keeps its own copy (it
imports nothing of the reference package), with the same names and the
same environment flag.  Every lock built through :func:`make_lock` /
:func:`make_rlock` becomes an :class:`OrderedLock` when the watchdog is
enabled, which:

- keeps a per-thread stack of held locks,
- records every ordered pair ``(outer.name, inner.name)`` into a
  process-global edge set, and
- raises :class:`LockOrderError` the moment a thread acquires ``A``
  while holding ``B`` when the reverse path ``A → … → B`` was already
  observed — the inversion is reported on the *second* ordering, with
  both witness stacks, before it can deadlock.

Rules of the game:

- re-entry on the same reentrant lock is ignored (legal);
- pairs of locks with the *same name* are never ordered against each
  other: instances of one class are indistinguishable by name and their
  count is unbounded, so ordering them would flag legitimate
  per-instance locking;
- disabled (the default) the factories return plain
  ``threading.Lock()`` / ``RLock()`` — zero overhead in production.

Enablement is evaluated per factory call: tests flip
:func:`enable` / :func:`disable` (or set ``REPRO_LOCKCHECK=1`` before
building objects) without reimporting anything.  The edge set is this
module's own: the reference package's watchdog keeps a separate one.
"""
from __future__ import annotations

import os
import threading

__all__ = [
    "LockOrderError",
    "OrderedLock",
    "enable",
    "disable",
    "enabled",
    "lockcheck_enabled",
    "make_lock",
    "make_rlock",
    "observed_edges",
    "reset_observations",
]


class LockOrderError(RuntimeError):
    """Two threads acquired the same pair of locks in opposite orders."""


_forced: bool | None = None
_edges: dict = {}  # name -> {name: witness str}
_edges_mu = threading.Lock()
_held = threading.local()


def enable() -> None:
    global _forced
    _forced = True


def disable() -> None:
    global _forced
    _forced = False


def enabled() -> bool:
    if _forced is not None:
        return _forced
    return os.environ.get("REPRO_LOCKCHECK", "") not in ("", "0", "false")


def reset_observations() -> None:
    with _edges_mu:
        _edges.clear()


def observed_edges() -> dict:
    with _edges_mu:
        return {a: dict(b) for a, b in _edges.items()}


def _stack() -> list:
    st = getattr(_held, "stack", None)
    if st is None:
        st = _held.stack = []
    return st


def _reachable(src: str, dst: str) -> list | None:
    """Path src → … → dst in the observed edge graph (caller holds
    ``_edges_mu``); None when unreachable."""
    seen, frontier = {src: None}, [src]
    while frontier:
        cur = frontier.pop()
        for nxt in _edges.get(cur, ()):
            if nxt in seen:
                continue
            seen[nxt] = cur
            if nxt == dst:
                path, at = [], dst
                while at is not None:
                    path.append(at)
                    at = seen[at]
                return path[::-1]
            frontier.append(nxt)
    return None


class OrderedLock:
    """A named lock that feeds the global acquisition-order graph."""

    def __init__(self, name: str, reentrant: bool):
        self.name = name
        self.reentrant = reentrant
        self._lock = threading.RLock() if reentrant else threading.Lock()

    # -- context manager / lock protocol ---------------------------------
    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        self._before_acquire()
        got = self._lock.acquire(blocking, timeout)
        if got:
            _stack().append(self)
        return got

    def release(self) -> None:
        st = _stack()
        for i in range(len(st) - 1, -1, -1):
            if st[i] is self:
                del st[i]
                break
        self._lock.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    # -- ordering --------------------------------------------------------
    def _before_acquire(self) -> None:
        st = _stack()
        if not st:
            return
        if self.reentrant and any(h is self for h in st):
            return  # legal re-entry; records no new ordering
        me = self.name
        holders = [h.name for h in st if h.name != me]
        if not holders:
            return
        tname = threading.current_thread().name
        with _edges_mu:
            for held_name in holders:
                inverted = _reachable(me, held_name)
                if inverted is not None:
                    order = " -> ".join(inverted)
                    raise LockOrderError(
                        f"lock-order inversion: thread '{tname}' acquires "
                        f"'{me}' while holding {holders}, but the order "
                        f"{order} was already observed "
                        f"({_edges.get(me, {}).get(inverted[1], '?')}); one "
                        "global order per lock pair, or this deadlocks "
                        "under contention"
                    )
            witness = f"thread '{tname}' held {holders} acquiring '{me}'"
            for h in holders:
                _edges.setdefault(h, {}).setdefault(me, witness)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"OrderedLock({self.name!r}, reentrant={self.reentrant})"


# Alias for package-level re-export: ``repro.obs.enabled`` already means
# "is tracing on", so the watchdog's probe ships under a distinct name.
def lockcheck_enabled() -> bool:
    return enabled()


def make_lock(name: str = "lock"):
    """A plain mutex — or an order-checked one when the watchdog is on."""
    if enabled():
        return OrderedLock(name, reentrant=False)
    return threading.Lock()


def make_rlock(name: str = "rlock"):
    """A reentrant mutex — order-checked when the watchdog is on."""
    if enabled():
        return OrderedLock(name, reentrant=True)
    return threading.RLock()
