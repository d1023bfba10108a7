"""Row-range sharding: who owns which rows of a streamed A.

Port of ``repro/cluster/shard.py`` (the same arithmetic; a tile of the
port's sources may be a CUDA tensor, so a window is clipped by
``tile.shape``, never through numpy).

The cluster engine partitions the row space of a :class:`RowSource` into
contiguous, tile-aligned ranges — one per worker — and tracks ownership
in an :class:`OwnershipMap` that survives worker loss: when a worker
dies, its *unfinished* sub-range is reassigned to a live worker without
touching any range another worker already owns.

Tile alignment is the load-bearing invariant: every range boundary sits
on the parent source's global tile grid, so the sequence of ``(offset,
tile)`` updates a range produces is IDENTICAL no matter which worker
processes it, how the worker set changes mid-pass, or whether the range
is resumed from a checkpoint watermark.  That is what makes kill-and-
resume bit-reproducible for the scatter-kind accumulators.

The balancing arithmetic follows the reference's
``repro.train.elastic.rebalance_microbatch``: hold the global work (tile
count) fixed and redistribute the per-worker share when the worker set
changes — ``split_range`` is the same divide-evenly-with-remainder
computation on tiles instead of microbatches.
"""
from __future__ import annotations

import dataclasses

from ..streaming.sources import RowSource, as_source

__all__ = [
    "RowRange",
    "OwnershipMap",
    "RowRangeSource",
    "partition_rows",
    "split_range",
]


@dataclasses.dataclass(frozen=True, order=True)
class RowRange:
    """Half-open global row interval [start, stop)."""

    start: int
    stop: int

    def __post_init__(self):
        if not (0 <= self.start <= self.stop):
            raise ValueError(f"bad row range [{self.start}, {self.stop})")

    @property
    def rows(self) -> int:
        return self.stop - self.start

    def tiles(self, tile_rows: int) -> int:
        """Number of global-grid tiles intersecting this range."""
        if self.rows == 0:
            return 0
        first = self.start // tile_rows
        last = (self.stop - 1) // tile_rows
        return last - first + 1

    def __repr__(self):
        return f"[{self.start}:{self.stop})"


def _grid_boundaries(m: int, tile_rows: int) -> list[int]:
    bounds = list(range(0, m, tile_rows))
    bounds.append(m)
    return bounds


def partition_rows(m: int, num_workers: int, tile_rows: int) -> list[RowRange]:
    """Deterministic initial ownership: ``num_workers`` contiguous,
    tile-aligned ranges with tile counts as equal as possible (the first
    ``n_tiles % num_workers`` workers carry one extra tile).

    Workers beyond the tile count get empty ranges — a 16-worker spec on
    a 4-tile problem is legal, 12 workers just idle.
    """
    if num_workers < 1:
        raise ValueError(f"need >= 1 worker, got {num_workers}")
    bounds = _grid_boundaries(m, tile_rows)
    n_tiles = len(bounds) - 1
    base, extra = divmod(n_tiles, num_workers)
    ranges = []
    t = 0
    for w in range(num_workers):
        take = base + (1 if w < extra else 0)
        ranges.append(RowRange(bounds[t], bounds[t + take]))
        t += take
    return ranges


def split_range(rng: RowRange, ways: int, tile_rows: int) -> list[RowRange]:
    """Split a range into ≤ ``ways`` tile-aligned sub-ranges of near-equal
    tile count (empty tails are dropped) — the reassignment arithmetic
    when a dead worker's remainder is spread over the survivors."""
    if ways < 1:
        raise ValueError(f"need >= 1 way, got {ways}")
    if rng.rows == 0:
        return []
    # boundaries of the global grid restricted to [start, stop)
    first_edge = -(-rng.start // tile_rows) * tile_rows
    bounds = [rng.start]
    bounds += [e for e in range(first_edge, rng.stop, tile_rows) if e > rng.start]
    bounds.append(rng.stop)
    n_tiles = len(bounds) - 1
    ways = min(ways, n_tiles)
    base, extra = divmod(n_tiles, ways)
    out, t = [], 0
    for w in range(ways):
        take = base + (1 if w < extra else 0)
        out.append(RowRange(bounds[t], bounds[t + take]))
        t += take
    return out


@dataclasses.dataclass
class OwnershipMap:
    """Mutable worker → row-range assignment for one pass.

    ``assignments`` maps worker id → list of ranges it must still
    complete; ``completed`` collects (range, accumulator-or-result) pairs
    as they finish.  ``reassign`` moves a dead worker's unfinished ranges
    (optionally truncated at a checkpoint watermark) onto the live
    workers with the least remaining work — deterministically, so two
    coordinators replaying the same failure make the same decision.
    """

    m: int
    tile_rows: int
    assignments: dict[int, list[RowRange]]

    @classmethod
    def initial(cls, m: int, workers, tile_rows: int) -> "OwnershipMap":
        workers = list(workers)
        ranges = partition_rows(m, len(workers), tile_rows)
        return cls(
            m=m,
            tile_rows=tile_rows,
            assignments={w: [r] for w, r in zip(workers, ranges)},
        )

    def owner_of(self, rng: RowRange) -> int | None:
        for w, rs in self.assignments.items():
            if rng in rs:
                return w
        return None

    def remaining_tiles(self, worker: int) -> int:
        return sum(r.tiles(self.tile_rows) for r in self.assignments.get(worker, ()))

    def reassign(self, dead: int, live: list[int]) -> list[tuple[int, RowRange]]:
        """Move every range still assigned to ``dead`` onto ``live``
        workers (least-loaded first, ties by worker id).  Returns the
        (new_owner, range) moves; the ranges themselves are unchanged —
        resume watermarks are the coordinator's business."""
        if not live:
            raise RuntimeError("no live workers left to reassign to")
        moves = []
        for rng in self.assignments.pop(dead, []):
            tgt = min(live, key=lambda w: (self.remaining_tiles(w), w))
            self.assignments.setdefault(tgt, []).append(rng)
            moves.append((tgt, rng))
        return moves


class RowRangeSource(RowSource):
    """A contiguous row window [start, stop) of a parent source, tiled on
    the PARENT's global tile grid.

    Local offsets are relative to ``start`` (the ``ShardedSource`` idiom);
    accumulate with ``base_offset=start`` to land in the global row space.
    Random-access parents (``read_rows``) are read window-by-window — a
    worker touches only its own rows; sequential parents fall back to
    filtering the parent stream (correct, but the parent is re-streamed).
    """

    def __init__(self, parent, start: int, stop: int,
                 tile_rows: int | None = None):
        parent = as_source(parent)
        m, n = parent.shape
        if not (0 <= start <= stop <= m):
            raise ValueError(
                f"range [{start}, {stop}) outside the parent's [0, {m})"
            )
        self.parent = parent
        self.start = int(start)
        self.stop = int(stop)
        self.shape = (self.stop - self.start, n)
        self.dtype = parent.dtype
        self._tile_rows = int(tile_rows or parent.tile_rows)

    @property
    def tile_rows(self) -> int:
        return self._tile_rows

    @property
    def num_tiles(self) -> int:
        return RowRange(self.start, self.stop).tiles(self._tile_rows)

    def _windows(self):
        """Global (offset, length) windows on the parent tile grid."""
        o = self.start
        while o < self.stop:
            edge = (o // self._tile_rows + 1) * self._tile_rows
            hi = min(edge, self.stop)
            yield o, hi - o
            o = hi

    def tiles(self):
        if self.parent.supports_random_access:
            for o, t in self._windows():
                yield o - self.start, self.parent.read_rows(o, t)
            return
        # sequential parent: stream it once, slice the overlap — tile
        # boundaries still follow the parent grid because the parent
        # emits grid-aligned tiles and we only ever clip at start/stop
        for o, tile in self.parent.tiles():
            lo = max(o, self.start)
            hi = min(o + tile.shape[0], self.stop)
            if lo < hi:
                yield lo - self.start, tile[lo - o : hi - o]

    def read_rows(self, offset: int, length: int):
        if not self.parent.supports_random_access:
            raise TypeError(
                f"{type(self.parent).__name__} does not support random access"
            )
        if offset < 0 or offset + length > self.shape[0]:
            raise ValueError(
                f"rows [{offset}, {offset + length}) outside [0, {self.shape[0]})"
            )
        return self.parent.read_rows(self.start + offset, length)
