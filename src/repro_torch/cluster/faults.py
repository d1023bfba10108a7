"""Deterministic fault injection for the cluster engine.

Port of ``repro/cluster/faults.py`` (the same events and semantics; the
lock comes from the port's ``obs.lockcheck``).

Real preemption is a race; tests need the same failure at the same point
every run.  A :class:`FaultPlan` is a list of trigger events keyed by
``(worker, phase, tile)`` — "kill worker 1 the moment it is about to
process its 3rd pass-1 tile" — that the worker loop consults before every
tile.  Each event fires at most once (``fired`` records what actually
triggered, so a test can assert its fault was exercised, not silently
skipped).

Events:

- :class:`KillWorker`     — raise :class:`WorkerKilled` inside the worker:
  the thread dies exactly like a preempted process (no cleanup, no final
  checkpoint, heartbeats stop).
- :class:`DelayWorker`    — sleep ``seconds`` before the tile: long enough
  and the coordinator's heartbeat monitor declares the worker dead while
  the thread still runs — the zombie double-completion path.
- :class:`DuplicateMerge` — after the worker finishes a sketch range, its
  partial accumulator is submitted to the coordinator TWICE; the
  coordinator's per-range dedup must drop the second copy.

``phase`` is ``"sketch"`` (pass 1) or ``"matvec"`` (pass-2 products);
``tile`` counts tiles THIS worker has started in that phase, from 0,
across resumes (a replacement worker gets a fresh count).
"""
from __future__ import annotations

import dataclasses
import time

from ..obs.lockcheck import make_lock

__all__ = [
    "WorkerKilled",
    "KillWorker",
    "DelayWorker",
    "DuplicateMerge",
    "FaultPlan",
    "as_plan",
]


class WorkerKilled(RuntimeError):
    """Injected preemption: the worker thread dies mid-pass."""


@dataclasses.dataclass(frozen=True)
class KillWorker:
    worker: int
    at_tile: int = 0
    phase: str = "sketch"


@dataclasses.dataclass(frozen=True)
class DelayWorker:
    worker: int
    seconds: float
    at_tile: int = 0
    phase: str = "sketch"


@dataclasses.dataclass(frozen=True)
class DuplicateMerge:
    worker: int


class FaultPlan:
    """An immutable event list with fire-once trigger bookkeeping."""

    # Checked by reprolint R1: ``fired`` is check-then-append state; unguarded,
    # two workers polling one fire-once event could both fire it.
    GUARDED_BY = {"fired": "_lock"}
    GUARDED_READS = frozenset({"fired"})

    def __init__(self, *events):
        self.events = tuple(events)
        self.fired: list = []
        self._lock = make_lock("FaultPlan._lock")  # every worker calls _take

    def __repr__(self):
        return f"FaultPlan({', '.join(map(repr, self.events))})"

    def _take(self, match) -> list:
        # check-then-append must be atomic: a fire-once event polled by
        # two worker threads at the same tile would otherwise fire twice
        with self._lock:
            out = []
            for ev in self.events:
                if ev in self.fired:
                    continue
                if match(ev):
                    self.fired.append(ev)
                    out.append(ev)
            return out

    def before_tile(self, worker: int, phase: str, tile: int) -> None:
        """Called by the worker loop before it starts a tile.  Applies
        delays first (a delayed worker can then be killed), then kills."""
        for ev in self._take(
            lambda e: isinstance(e, DelayWorker)
            and e.worker == worker and e.phase == phase and e.at_tile == tile
        ):
            time.sleep(ev.seconds)
        if self._take(
            lambda e: isinstance(e, KillWorker)
            and e.worker == worker and e.phase == phase and e.at_tile == tile
        ):
            raise WorkerKilled(
                f"injected kill: worker {worker} at {phase} tile {tile}"
            )

    def duplicate_submission(self, worker: int) -> bool:
        """True once per matching DuplicateMerge event: the worker should
        submit its finished partial a second time."""
        return bool(self._take(
            lambda e: isinstance(e, DuplicateMerge) and e.worker == worker
        ))


def as_plan(faults) -> FaultPlan:
    if faults is None:
        return FaultPlan()  # fresh: per-run fired bookkeeping
    if isinstance(faults, FaultPlan):
        return faults
    return FaultPlan(*faults)
