"""Streaming sketch engine: out-of-core least squares, one row tile at a time.

Port of ``repro.streaming``.  The in-memory solvers of
``repro_torch.core`` need A on the card; this package streams it:

- ``sources``    — the :class:`RowSource` protocol (re-iterable
  ``(row_offset, tile)`` streams over tensors, numpy arrays, callbacks,
  generators, memory-mapped ``.npy`` files and shard lists) and
  ``device_tiles``, which brings host tiles to the card through pinned
  staging buffers on a side stream;
- ``accumulate`` — mergeable per-kind :class:`SketchAccumulator` partial
  sketches: the bucket kinds fold tiles into the sketch state with kernel
  B1's fold mode (bitwise the monolithic apply), the Gaussian takes kernel
  B4 with a column offset per tile, the SRHT places D-signed rows and runs
  kernel B8 once at ``finalize``;
- ``solve``      — the two-pass drivers (:func:`stream_lstsq`: ``saa``,
  ``iterative``, ``sketch_and_solve``, ``reg=``, ``certify=True``) and the
  amortizing session :class:`StreamingSolver`.

The same generator draws the same S as the in-memory solvers, so streamed
results match ``repro_torch.core.lstsq`` on the materialized A.
``cluster=`` runs the streams across ``repro_torch.cluster``'s worker
pool; ``sharded_sketch`` assembles S·A of a row-sharded A across the ranks
of a ``torch.distributed`` group in one all-reduce.
"""
from . import accumulate, solve, sources
from .accumulate import (
    SketchAccumulator,
    accumulate_source,
    make_accumulator,
    merge_all,
    sharded_sketch,
)
from .solve import STREAM_METHODS, StreamingSolver, stream_lstsq, stream_sketch
from .sources import (
    DEFAULT_TILE_ROWS,
    ArraySource,
    CallbackSource,
    GeneratorSource,
    MemmapSource,
    RowSource,
    ShardedSource,
    as_source,
    device_tiles,
)

__all__ = [
    "accumulate", "solve", "sources",
    "SketchAccumulator", "accumulate_source", "make_accumulator",
    "merge_all", "sharded_sketch",
    "STREAM_METHODS", "StreamingSolver", "stream_lstsq", "stream_sketch",
    "DEFAULT_TILE_ROWS", "ArraySource", "CallbackSource", "GeneratorSource",
    "MemmapSource", "RowSource", "ShardedSource", "as_source", "device_tiles",
]
