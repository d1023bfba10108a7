"""LRU factor cache — live ``SketchedSolver`` sessions under a byte budget.

Port of ``repro/serve/cache.py``.  The service's economics: a session
build costs one sketch + one QR (O(mn + sn²)) plus, for a dense A, the
whitened Y = A R⁻¹; a cached solve costs whitened LSQR iterations only.
The cache therefore holds *sessions*, not solutions.

Policy and accounting:

- **LRU by fingerprint.**  ``get_or_build(fp, builder)`` returns the live
  session on a hit (and refreshes recency), builds + inserts on a miss.
- **Byte budget.**  Each entry is charged the bytes of the artifacts the
  session *owns*: the stored sketch B, the QR factor (Q, R) and the
  whitened Y when kept.  The data matrix A is pinned by the session but
  owned by the caller; charging it would double-count every tenant's own
  data.  (After ``update_rows`` the session holds its own updated copy of
  A, which is not charged either, as in the reference.)  Inserting past
  ``max_bytes`` evicts LRU entries until the new entry fits; a single
  entry larger than the whole budget is still admitted and evicts
  everything else.
- **Counters.**  ``hits`` / ``misses`` / ``evictions`` / ``bytes`` are
  live attributes; ``stats()`` snapshots them plus per-entry hit counts.
- **Aliased data is watched.**  A session built on a card tensor holds
  that tensor itself, not a copy (``SolveService`` gives a session built
  on host memory a copy of its own).  Each entry keeps the version of
  every data tensor its session holds (the dense A; a sparse A's rows,
  cols and vals), and a hit on an entry whose data moved since is a
  miss: the entry is dropped (an eviction, ``kind="stale"``) and the
  session rebuilt from the request's A.  Otherwise an in-place write by
  one caller would leave the entry under the old digest with the factor
  of the old data and products with the new, and serve it to another
  caller whose A still has the old content.
- **Drift-aware invalidation.**  ``update_rows(fp, idx, rows)`` routes a
  data update *through* the cached session (O(|idx|·n) delta-sketch, no
  rebuild) and re-keys the entry under the updated matrix's fingerprint
  (one more full digest of the session's new A).  A session built with
  ``auto_recertify`` whose recertification exhausts its escalation room
  without a passing certificate is dropped.
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Callable

from ..analysis.annotations import guarded_by
from ..core import linop
from ..core.session import SketchedSolver
from ..obs import trace as obs_trace
from ..obs.lockcheck import make_rlock
from ..obs.metrics import REGISTRY
from .fingerprint import Fingerprint, fingerprint

__all__ = ["FactorCache", "CacheEntry", "session_nbytes"]


def session_nbytes(solver: SketchedSolver) -> int:
    """Bytes of the session-owned artifacts: B, the QR factor, Y."""
    owned = (solver._B, *solver.factor, solver._Y)
    return int(sum(t.numel() * t.element_size() for t in owned if t is not None))


def _data_versions(solver: SketchedSolver) -> tuple:
    """``(tensor, version)`` of each data tensor the session holds."""
    op = solver.A
    if isinstance(op, linop.DenseOperator):
        held = (op.A,)
    elif isinstance(op, linop.SparseOperator):
        held = (op.rows, op.cols, op.vals)
    else:
        held = ()  # matrix-free: the caller's token names the content
    return tuple((t, t._version) for t in held if not t.is_inference())


@dataclasses.dataclass
class CacheEntry:
    solver: SketchedSolver
    fp: Fingerprint
    nbytes: int
    hits: int = 0
    built_s: float = 0.0  # wall seconds the builder spent
    data_versions: tuple = ()  # _data_versions(solver) when (re)keyed

    @property
    def stale(self) -> bool:
        """Whether the session's data was written since it was keyed."""
        return any(t._version != v for t, v in self.data_versions)


class FactorCache:
    """LRU cache of live :class:`SketchedSolver` sessions, byte-budgeted.

    Thread-safe: every public method holds an internal lock, so the
    service's pump thread, a synchronous ``flush()`` caller and a
    ``stats()`` poller can touch the cache concurrently.  Session
    *builds* run outside the lock (they can take seconds); a racing
    build of the same fingerprint is resolved first-put-wins.
    """

    GUARDED_BY = {
        "_entries": "_mu",
        "bytes": "_mu",
        "hits": "_mu",
        "misses": "_mu",
        "evictions": "_mu",
    }
    GUARDED_READS = frozenset({"_entries"})

    def __init__(self, max_bytes: int = 256 * 1024 * 1024):
        self.max_bytes = int(max_bytes)
        self._entries: "OrderedDict[Fingerprint, CacheEntry]" = OrderedDict()
        self._mu = make_rlock("FactorCache._mu")
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.bytes = 0
        self._m_hits = REGISTRY.counter("cache.hits")
        self._m_misses = REGISTRY.counter("cache.misses")
        self._m_evictions = REGISTRY.counter("cache.evictions")
        self._m_bytes = REGISTRY.gauge("cache.bytes")
        self._m_entries = REGISTRY.gauge("cache.entries")
        self._m_build_s = REGISTRY.histogram("cache.build_s")

    @guarded_by("_mu")
    def _sync_gauges(self) -> None:
        self._m_bytes.set(self.bytes)
        self._m_entries.set(len(self._entries))

    # ------------------------------------------------------------- lookups
    def __len__(self) -> int:
        with self._mu:
            return len(self._entries)

    def __contains__(self, fp: Fingerprint) -> bool:
        with self._mu:
            return fp in self._entries

    def get(self, fp: Fingerprint) -> SketchedSolver | None:
        """Hit → the live session (recency refreshed); miss → None.  An
        entry whose data was written since it was keyed is dropped, and
        the lookup is a miss."""
        with self._mu:
            entry = self._live(fp)
            if entry is None:
                self.misses += 1
                self._m_misses.inc()
                return None
            self._entries.move_to_end(fp)
            entry.hits += 1
            self.hits += 1
            self._m_hits.inc()
            return entry.solver

    def get_or_build(
        self, fp: Fingerprint, builder: Callable[[], SketchedSolver]
    ) -> tuple[SketchedSolver, bool]:
        """``(session, was_hit)`` — the service's single entry point."""
        solver = self.get(fp)
        if solver is not None:
            return solver, True
        t0 = time.perf_counter()
        with obs_trace.span("cache.build", fp=fp.short()):
            solver = builder()  # outside the lock: builds can take seconds
        built_s = time.perf_counter() - t0
        self._m_build_s.observe(built_s)
        with self._mu:
            entry = self._live(fp)
            if entry is not None:
                # another thread's build landed first: use THAT live
                # session (it may already hold certificates / drift
                # state) and drop ours on the floor.
                self._entries.move_to_end(fp)
                entry.hits += 1
                self.hits += 1
                self._m_hits.inc()
                return entry.solver, True
            self.put(fp, solver, built_s=built_s)
        return solver, False

    # ------------------------------------------------------------- updates
    def put(
        self, fp: Fingerprint, solver: SketchedSolver, *, built_s: float = 0.0
    ) -> CacheEntry:
        with self._mu:
            if fp in self._entries:
                self._drop(fp)
            entry = CacheEntry(
                solver=solver, fp=fp, nbytes=session_nbytes(solver),
                built_s=built_s, data_versions=_data_versions(solver),
            )
            self._entries[fp] = entry
            self.bytes += entry.nbytes
            self._evict_to_budget(keep=fp)
            self._sync_gauges()
            return entry

    @guarded_by("_mu")
    def _live(self, fp: Fingerprint) -> CacheEntry | None:
        """The entry under ``fp``; a stale one is dropped (an eviction)."""
        entry = self._entries.get(fp)
        if entry is None or not entry.stale:
            return entry
        self._drop(fp)
        self.evictions += 1
        self._m_evictions.inc()
        obs_trace.instant("cache.eviction", fp=fp.short(), kind="stale")
        self._sync_gauges()
        return None

    @guarded_by("_mu")
    def _drop(self, fp: Fingerprint) -> CacheEntry | None:
        entry = self._entries.pop(fp, None)
        if entry is not None:
            self.bytes -= entry.nbytes
        return entry

    def invalidate(self, fp: Fingerprint) -> bool:
        """Explicitly drop an entry (counted as an eviction)."""
        with self._mu:
            if self._drop(fp) is None:
                return False
            self.evictions += 1
            self._m_evictions.inc()
            obs_trace.instant("cache.eviction", fp=fp.short(), kind="explicit")
            self._sync_gauges()
            return True

    def clear(self) -> None:
        with self._mu:
            dropped = len(self._entries)
            self.evictions += dropped
            self._m_evictions.inc(dropped)
            self._entries.clear()
            self.bytes = 0
            self._sync_gauges()

    @guarded_by("_mu")
    def _evict_to_budget(self, keep: Fingerprint) -> None:
        # Evict LRU-first until under budget; the just-touched entry is
        # exempt so one oversized tenant degrades to cache-of-one rather
        # than thrashing itself out.
        while self.bytes > self.max_bytes and len(self._entries) > 1:
            lru_fp = next(iter(self._entries))
            if lru_fp == keep:
                self._entries.move_to_end(lru_fp)
                lru_fp = next(iter(self._entries))
            self._drop(lru_fp)
            self.evictions += 1
            self._m_evictions.inc()
            obs_trace.instant("cache.eviction", fp=lru_fp.short(),
                              kind="budget")

    # ------------------------------------------------------ drift handling
    def update_rows(self, fp: Fingerprint, idx, rows) -> Fingerprint | None:
        """Apply ``A[idx] ← rows`` through the cached session and re-key.

        Returns the UPDATED matrix's fingerprint (the old key is dead),
        or ``None`` when the entry had to be dropped because the drifted
        embedding could not be recertified within the session's
        escalation room.  Cache misses (a stale entry included) raise
        ``KeyError``.
        """
        with self._mu:
            entry = self._live(fp)
            if entry is None:
                raise KeyError(f"no cached session for {fp.short()}")
            solver = entry.solver
            solver.update_rows(idx, rows)  # delta-sketch + small QR in-session
            if solver.auto_recertify and solver.certificate is not None:
                if not bool(solver.certificate.passed):
                    # escalation room exhausted without a passing
                    # certificate: this factor is KNOWN bad — drop it.
                    self.invalidate(fp)
                    return None
            new_fp = fingerprint(
                solver.A.A, reg=fp.reg, sketch=fp.sketch,
                sketch_size=fp.sketch_size,
            )
            self._drop(fp)
            entry.fp = new_fp
            entry.nbytes = session_nbytes(solver)  # escalation may have grown B
            entry.data_versions = _data_versions(solver)  # the session's own A now
            self._entries[new_fp] = entry
            self.bytes += entry.nbytes
            self._evict_to_budget(keep=new_fp)
            self._sync_gauges()
            return new_fp

    # ------------------------------------------------------------- reports
    def stats(self) -> dict:
        with self._mu:
            total = self.hits + self.misses
            return {
                "entries": len(self._entries),
                "bytes": self.bytes,
                "max_bytes": self.max_bytes,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "hit_rate": (self.hits / total) if total else 0.0,
                "per_entry": {
                    e.fp.short(): {"hits": e.hits, "nbytes": e.nbytes,
                                   "built_s": e.built_s}
                    for e in self._entries.values()
                },
            }
