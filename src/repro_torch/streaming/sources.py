"""Row sources — the input protocol of the streaming sketch engine.

Port of ``repro/streaming/sources.py``.  A :class:`RowSource` is a
*re-iterable* stream of ``(row_offset, tile)`` chunks that together cover
the rows of a conceptually (m, n) data matrix A that is never held in one
piece.  ``tiles()`` yields the tiles in ascending, contiguous,
non-overlapping row order (offset 0 first) and can be called any number of
times: the two-pass solvers of ``repro_torch.streaming.solve`` stream once
to build the sketch and then once or twice per iteration for the tiled
``A@v`` / ``Aᵀ@u`` products.

Concrete sources:

- :class:`ArraySource`    — a tensor (on any device) or a numpy array,
  sliced into row tiles.  A tensor on the solve's device yields row views
  and copies nothing.
- :class:`CallbackSource` — ``fn(offset, length) -> tile`` random access.
- :class:`GeneratorSource`— a zero-argument factory returning a fresh
  iterable of row tiles, re-invoked per pass.
- :class:`MemmapSource`   — a memory-mapped ``.npy`` file; each tile is a
  window of the map, so at most one tile of A is read at a time.
- :class:`ShardedSource`  — an ordered list of per-shard sources with
  global row offsets; shards accumulate independently and merge.

``as_source`` coerces ``RowSource | tensor | numpy array | .npy path`` into
the protocol.  A source's ``dtype`` is a ``torch.dtype``.

:func:`device_tiles` is how every consumer reads a source: it yields the
tiles as tensors on the solve's device.  A tile on the host (a numpy array,
a memmap window, a CPU tensor) reaches a CUDA device through two pinned
staging buffers and a side copy stream, so the copy of tile t + 1 overlaps
the work on tile t.  A staging buffer is refilled only after the event of
the copy that last read it has completed, and a device buffer only after
the work on the tile it held (a new one only after the work queued before
it was allocated, which may still use its memory), so no tile is
overwritten while in use; no call synchronizes the device.
"""
from __future__ import annotations

import os
import warnings
from typing import Callable, Iterable, Iterator, Sequence

import numpy as np
import torch

from ..core import backend as backend_lib
from ..core.linop import _torch_dtype

__all__ = [
    "RowSource",
    "ArraySource",
    "CallbackSource",
    "GeneratorSource",
    "MemmapSource",
    "ShardedSource",
    "as_source",
    "device_tiles",
    "solve_device",
    "DEFAULT_TILE_ROWS",
]

DEFAULT_TILE_ROWS = 8192


def solve_device(device=None) -> torch.device:
    """The streaming solve's device: ``None`` → ``"cuda"``, with a CUDA
    device's index made explicit, as a tensor reports its own (so a tile
    already there is recognized and not staged again)."""
    dev = backend_lib.resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _as_dtype(dtype) -> torch.dtype:
    return dtype if isinstance(dtype, torch.dtype) else _torch_dtype(dtype)


class RowSource:
    """Protocol base: a re-streamable row-tile view of an (m, n) matrix."""

    shape: tuple[int, int]
    dtype: torch.dtype

    def tiles(self) -> Iterator[tuple[int, object]]:
        """Yield ``(row_offset, tile)`` in ascending contiguous order,
        covering every row exactly once; ``tile`` is a ``(t, n)`` tensor or
        numpy array with 1 ≤ t ≤ ``tile_rows``."""
        raise NotImplementedError

    # Optional random access (Array/Memmap/Callback have it); ``None`` is
    # the "not supported" marker probed by ``supports_random_access``.
    read_rows = None

    @property
    def supports_random_access(self) -> bool:
        return callable(self.read_rows)

    @property
    def tile_rows(self) -> int:
        return DEFAULT_TILE_ROWS

    @property
    def num_tiles(self) -> int:
        return -(-self.shape[0] // self.tile_rows)

    def __repr__(self):
        m, n = self.shape
        return f"{type(self).__name__}(shape=({m}, {n}), tile_rows={self.tile_rows})"


def _check_tile_rows(tile_rows: int) -> int:
    tile_rows = int(tile_rows)
    if tile_rows < 1:
        raise ValueError(f"tile_rows must be >= 1, got {tile_rows}")
    return tile_rows


class ArraySource(RowSource):
    """Row tiles sliced from an (m, n) tensor or numpy array.

    ``boundaries=`` pins an explicit (uneven) tiling, as the equivalence
    tests use it.  The tiles are views of A.
    """

    def __init__(self, A, tile_rows: int = DEFAULT_TILE_ROWS, *,
                 boundaries: Sequence[int] | None = None):
        if A.ndim != 2:
            raise ValueError(f"need a 2-D matrix, got shape {tuple(A.shape)}")
        self.A = A
        self.shape = tuple(int(s) for s in A.shape)
        self.dtype = _as_dtype(A.dtype)
        self._tile_rows = _check_tile_rows(tile_rows)
        m = self.shape[0]
        if boundaries is not None:
            boundaries = sorted(set(int(b) for b in boundaries) | {0, m})
            if boundaries[0] < 0 or boundaries[-1] > m:
                raise ValueError(f"boundaries out of range: {boundaries}")
            self._offsets = boundaries
            self._tile_rows = max(b - a for a, b in zip(boundaries[:-1], boundaries[1:]))
        else:
            self._offsets = list(range(0, m, self._tile_rows))
            self._offsets.append(m)

    @property
    def tile_rows(self) -> int:
        return self._tile_rows

    @property
    def num_tiles(self) -> int:
        return len(self._offsets) - 1

    def tiles(self):
        for a, b in zip(self._offsets[:-1], self._offsets[1:]):
            yield a, self.A[a:b]

    def read_rows(self, offset: int, length: int):
        return self.A[offset : offset + length]


class CallbackSource(RowSource):
    """``fn(offset, length) -> (length, n) tile`` random-access producer."""

    def __init__(self, fn: Callable, shape: tuple[int, int], dtype,
                 tile_rows: int = DEFAULT_TILE_ROWS):
        self.fn = fn
        self.shape = (int(shape[0]), int(shape[1]))
        self.dtype = _as_dtype(dtype)
        self._tile_rows = _check_tile_rows(tile_rows)

    @property
    def tile_rows(self) -> int:
        return self._tile_rows

    def tiles(self):
        m = self.shape[0]
        for o in range(0, m, self._tile_rows):
            yield o, self.read_rows(o, min(self._tile_rows, m - o))

    def read_rows(self, offset: int, length: int):
        tile = self.fn(offset, length)
        if tuple(tile.shape) != (length, self.shape[1]):
            raise ValueError(
                f"callback returned shape {tuple(tile.shape)} for "
                f"(offset={offset}, length={length}); expected "
                f"({length}, {self.shape[1]})"
            )
        return tile


class GeneratorSource(RowSource):
    """A zero-arg ``factory()`` returning a fresh iterable of row tiles.

    Each pass calls ``factory()`` again, which makes a sequential producer
    usable by the two-pass solvers.  Offsets are the running row count,
    checked against ``shape`` as the stream is consumed.
    """

    def __init__(self, factory: Callable[[], Iterable], shape: tuple[int, int],
                 dtype, tile_rows: int = DEFAULT_TILE_ROWS):
        self.factory = factory
        self.shape = (int(shape[0]), int(shape[1]))
        self.dtype = _as_dtype(dtype)
        self._tile_rows = _check_tile_rows(tile_rows)

    @property
    def tile_rows(self) -> int:
        return self._tile_rows

    def tiles(self):
        m, n = self.shape
        off = 0
        for tile in self.factory():
            if tile.ndim != 2 or tile.shape[1] != n:
                raise ValueError(
                    f"generator tile has shape {tuple(tile.shape)}; expected (t, {n})"
                )
            if off + tile.shape[0] > m:
                raise ValueError(f"generator produced more than m={m} rows")
            yield off, tile
            off += tile.shape[0]
        if off != m:
            raise ValueError(f"generator covered {off} of m={m} rows")


class MemmapSource(RowSource):
    """Row tiles read through a memory-mapped ``.npy`` file.

    ``np.load(mmap_mode="r")`` keeps A on disk; each tile is a (tile_rows,
    n) window of the map, read when it is copied (into a pinned staging
    buffer on the way to the card), so at most one tile of A is resident.
    """

    def __init__(self, path, tile_rows: int = DEFAULT_TILE_ROWS):
        self.path = os.fspath(path)
        mm = np.load(self.path, mmap_mode="r")
        if mm.ndim != 2:
            raise ValueError(f"{self.path}: need a 2-D array, got {mm.shape}")
        self.shape = tuple(int(s) for s in mm.shape)
        self.dtype = _as_dtype(mm.dtype)
        self._tile_rows = _check_tile_rows(tile_rows)
        del mm  # keep no live map between passes

    @property
    def tile_rows(self) -> int:
        return self._tile_rows

    def tiles(self):
        mm = np.load(self.path, mmap_mode="r")
        m = self.shape[0]
        for o in range(0, m, self._tile_rows):
            yield o, mm[o : o + min(self._tile_rows, m - o)]

    def read_rows(self, offset: int, length: int):
        mm = np.load(self.path, mmap_mode="r")
        return np.array(mm[offset : offset + length])


class ShardedSource(RowSource):
    """Ordered concatenation of per-shard sources (multi-host ingest).

    ``tiles()`` walks the shards in row order with global offsets.  For
    parallel ingest, accumulate each ``shards[i]`` with ``base_offset=
    shard_offsets[i]`` and merge the partial accumulators.
    """

    def __init__(self, shards: Sequence[RowSource]):
        shards = [as_source(s) for s in shards]
        if not shards:
            raise ValueError("need at least one shard")
        n = shards[0].shape[1]
        if any(s.shape[1] != n for s in shards):
            raise ValueError(
                f"all shards need {n} columns, got {[s.shape for s in shards]}"
            )
        self.shards = shards
        self.shard_offsets = []
        m = 0
        for s in shards:
            self.shard_offsets.append(m)
            m += s.shape[0]
        self.shape = (m, n)
        self.dtype = shards[0].dtype

    @property
    def tile_rows(self) -> int:
        return max(s.tile_rows for s in self.shards)

    def tiles(self):
        for base, shard in zip(self.shard_offsets, self.shards):
            for o, tile in shard.tiles():
                yield base + o, tile

    @property
    def supports_random_access(self) -> bool:
        return all(s.supports_random_access for s in self.shards)

    def read_rows(self, offset: int, length: int):
        if not self.supports_random_access:
            raise TypeError(
                "ShardedSource.read_rows needs every shard to support random access"
            )
        pieces = []
        for base, shard in zip(self.shard_offsets, self.shards):
            lo = max(offset, base)
            hi = min(offset + length, base + shard.shape[0])
            if lo < hi:
                pieces.append(shard.read_rows(lo - base, hi - lo))
        if len(pieces) == 1:
            return pieces[0]
        if all(isinstance(p, torch.Tensor) for p in pieces):
            return torch.cat([p.to(pieces[0].device) for p in pieces])
        return np.concatenate([np.asarray(p.cpu() if isinstance(p, torch.Tensor) else p)
                               for p in pieces])


def as_source(A, tile_rows: int | None = None) -> RowSource:
    """Coerce ``RowSource | tensor | numpy array | .npy path`` into the
    protocol.

    Idempotent on sources (``tile_rows`` must then be None: a source owns
    its tiling).  Tensors and numpy arrays become :class:`ArraySource`,
    ``.npy`` paths :class:`MemmapSource`.
    """
    if isinstance(A, RowSource):
        if tile_rows is not None:
            raise ValueError(
                "tile_rows cannot override an existing RowSource's tiling; "
                "construct the source with the tiling you want"
            )
        return A
    tile_rows = DEFAULT_TILE_ROWS if tile_rows is None else tile_rows
    if isinstance(A, (str, os.PathLike)):
        return MemmapSource(A, tile_rows)
    if isinstance(A, (torch.Tensor, np.ndarray)):
        return ArraySource(A, tile_rows)
    raise TypeError(
        f"cannot make a RowSource from {type(A).__name__}; pass a RowSource, "
        "a 2-D tensor or array, or a path to a .npy file"
    )


# ---------------------------------------------------------------------------
# host → device staging


class _Slot:
    """One of the two staging slots: a pinned host buffer, a device buffer,
    and the events that guard them."""

    def __init__(self):
        self.host = self.dev = None
        self.copied = None  # the H2D copy that last read ``host`` (side stream)
        self.consumed = None  # the work on the tile ``dev`` last held (main stream)

    def buffers(self, shape, dtype, main):
        rows, n = shape
        if self.host is None or self.host.shape[0] < rows or self.host.shape[1:] != (n,) \
                or self.host.dtype != dtype:
            cap = max(rows, 0 if self.host is None else self.host.shape[0])
            self.host = torch.empty((cap, n), dtype=dtype, pin_memory=True)
            self.dev = torch.empty((cap, n), dtype=dtype, device=main.device)
            self.copied = None
            # The allocator hands the consumer's stream memory that its queued
            # work may still use; the side stream's first copy waits for it.
            self.consumed = torch.cuda.Event()
            self.consumed.record(main)
        return self.host[:rows], self.dev[:rows]


def _host_tensor(tile) -> torch.Tensor:
    """A CPU tensor over the tile's memory, not a copy of it (a memmap
    window is read when the staging copy reads it)."""
    if isinstance(tile, torch.Tensor):
        return tile
    arr = np.ascontiguousarray(tile)
    with warnings.catch_warnings():
        # a read-only memmap window: the tensor is only ever read
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(arr)


def device_tiles(source: RowSource, device) -> Iterator[tuple[int, torch.Tensor]]:
    """``source.tiles()`` as ``(offset, tensor)`` on ``device``.

    A tile already on ``device`` is yielded as it is (a row view of a
    device-resident ``ArraySource``: no copy).  On a CPU device host tiles
    become CPU tensors.  On a CUDA device each host tile is copied into one
    of two pinned buffers and from there, on a side stream, into a device
    buffer; the tile is yielded once the consumer's stream has been told to
    wait for that copy, and the next tile's copy is issued before this one
    is yielded, so it overlaps the consumer's work.  A yielded staged tile
    is valid until the next one is requested.
    """
    device = solve_device(device)
    if device.type != "cuda":
        for o, tile in source.tiles():
            yield o, backend_lib.as_tensor(tile, device)
        return
    main = torch.cuda.current_stream(device)
    side = None  # made at the first host tile: a device-resident pass needs none
    slots, turn = (_Slot(), _Slot()), 0
    pending = None  # (offset, device view, slot) issued but not yet yielded

    def issue(o, tile):
        nonlocal turn, side
        if side is None:
            side = torch.cuda.Stream(device)
        src = _host_tensor(tile)
        slot = slots[turn]
        turn ^= 1
        if slot.copied is not None:
            slot.copied.synchronize()  # the copy that last read this host buffer
        host, dev = slot.buffers(tuple(src.shape), src.dtype, main)
        host.copy_(src)
        with torch.cuda.stream(side):
            side.wait_event(slot.consumed)  # the work on this buffer's last tile
            dev.copy_(host, non_blocking=True)
            slot.copied = torch.cuda.Event()
            slot.copied.record(side)
        return o, dev, slot

    def emit(staged):
        o, dev, slot = staged
        main.wait_event(slot.copied)
        yield o, dev
        slot.consumed = torch.cuda.Event()
        slot.consumed.record(main)

    try:
        for o, tile in source.tiles():
            if isinstance(tile, torch.Tensor) and tile.device == device:
                if pending is not None:
                    yield from emit(pending)
                    pending = None
                yield o, tile
                continue
            staged = issue(o, tile)
            if pending is not None:
                yield from emit(pending)
            pending = staged
        if pending is not None:
            yield from emit(pending)
    finally:
        # a copy issued but never consumed must land before its buffer is freed
        if side is not None:
            main.wait_stream(side)
