"""Mergeable partial-sketch accumulators — the heart of the streaming engine.

Port of ``repro/streaming/accumulate.py``.  Every sketch S of
``repro_torch.core.sketch`` is linear in the rows of A, so SA decomposes
over any row tiling and partial sketches of disjoint tiles add up:

    acc = make_accumulator(op, ncols)
    for offset, tile in device_tiles(source, op.device):
        acc.update(tile, offset)       # O(tile) work, O(state) memory
    B = acc.finalize()                 # == op.apply(A) for the full A

The state and its fold, per kind:

- **countsketch / uniform_sparse** — a (d, ncols) state.  Kernel B1's fold
  mode (``countsketch_apply(..., out=state)``) starts each (bucket,
  column) sum from the state and adds the tile's entries in row order, so
  the streamed B is bitwise the monolithic B1 apply and the reference's
  row-order ``.at[].add`` fold, for any tiling.  The tile's CSR (a stable
  argsort of its buckets) depends only on S and the tile's rows: it is
  cached on the operator by (offset, rows, dtype), so a re-stream of b
  builds it once.  The plain fold on the CPU is the state's
  ``index_add_``; on CUDA ``index_add_`` is atomic and never used.
- **sparse_sign** — a (k, d, ncols) state viewed as (k·d, ncols), folded
  by one B1 launch per tile on a CSR whose bucket ids are j·d + h_j(i).
  ``finalize`` adds the k partials one by one and divides by √k: the
  reference's order (k segment sums added in block order) and the port's
  ``backend="reference"`` route, bitwise.  It is not the order of the
  port's monolithic kernel route, which folds all k blocks of a bucket into
  one running sum; a stream cannot (a tile's block-1 entries would come
  before the next tile's block-0 ones), so the two agree to within
  2·γ_k·|S||A|.
- **srht** — a device (m_pad, ncols) placement buffer: each tile's
  D-signed rows (``apply_rows``) are written into their rows, and
  ``finalize`` runs kernel B8 (``srht_apply`` with a +1 sign vector, the
  operator's rows and a cached plan), bitwise the monolithic
  ``srht_apply``.  The reference keeps this buffer as host numpy for JAX's
  immutability; torch writes the device slice in place.  It is
  O(m_pad·ncols) (8.4 GB at m = 2^20, n = 1000): the SRHT streams compute,
  not memory.
- **gaussian** — kernel B4 with its column offset per tile
  (``GaussianSketch.apply_rows``), S never formed; **uniform_dense** — the
  tile's ``S[:, o:o+t] @ tile`` (``torch.matmul``: the reference's product
  is outside any Pallas kernel too).  Both add (d, ncols) block products
  in tile order, so they agree with one big product to accumulation-order
  rounding only.

``merge`` adds the states of accumulators over disjoint row ranges (the
additive kinds round as any regrouped sum does; the SRHT merges exactly)
after checking, with ``torch.equal`` on the operators' tensors, that both
sides hold the same draw.  ``sharded_sketch`` is the collective form of the
merge: one all-reduce of the ranks' restricted partials over a
``torch.distributed`` group.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import sharding
from ..core import backend as backend_lib
from ..core import sketch as sketch_lib
from ..kernels.common import sqrt_tensor
from ..kernels.countsketch import countsketch_apply, countsketch_csr, countsketch_fold_ref
from ..kernels.countsketch.ref import acc_dtype
from ..kernels.srht import srht_apply, srht_plan, srht_ref
from .sources import device_tiles

__all__ = [
    "SketchAccumulator",
    "make_accumulator",
    "accumulate_source",
    "merge_all",
    "sharded_sketch",
]


def _same_draw(a, b) -> bool:
    """True when two operators hold the same draw: the same kind, and equal
    fields, tensors compared with ``torch.equal``."""
    if type(a) is not type(b):
        return False
    if not dataclasses.is_dataclass(a):
        return a == b
    for f in dataclasses.fields(a):
        if not f.compare:
            continue
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, torch.Tensor) or isinstance(y, torch.Tensor):
            if not (isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor)
                    and x.shape == y.shape and x.device == y.device and torch.equal(x, y)):
                return False
        elif dataclasses.is_dataclass(x):
            if not _same_draw(x, y):
                return False
        elif x != y:
            return False
    return True


class SketchAccumulator:
    """Partial sketch of a row-streamed A: update / merge / finalize.

    ``ncols`` is the column count of the streamed tiles (n, or n + 1 when
    the right-hand side rides along as an extra column).  ``rows_seen``
    tracks coverage; ``finalize`` refuses to produce a sketch from a stream
    that missed rows (merge first, then finalize).  The state lives on the
    operator's device, in the tiles' accumulation dtype.
    """

    def __init__(self, op, ncols: int, dtype=torch.float64, backend="auto"):
        self.op = op
        self.ncols = int(ncols)
        self.dtype = dtype
        self.backend = backend_lib.check_backend(backend)
        self.rows_seen = 0
        self.tiles_seen = 0
        self.state = self._init_state()

    # ---------------------------------------------------- per-kind state
    def _init_state(self):
        op, acc = self.op, acc_dtype(self.dtype)
        rows = op.d
        if isinstance(op, sketch_lib.SRHTSketch):
            rows = op.m_pad  # the placement buffer
        elif isinstance(op, sketch_lib.SparseSignSketch):
            rows = op.k * op.d  # the k partial sums, (k, d, ncols) as (k·d, ncols)
        return torch.zeros((rows, self.ncols), dtype=acc, device=op.device)

    def _tile_fold(self, sl: slice, t: int, dtype):
        """(buckets, weights, CSR) of the tile's rows: bucket ids j·d + h_j
        for the sparse-sign sketch's k·d partial sums.  Cached on the
        operator by (offset, rows, dtype); the CSR only where B1 reads it
        (a CUDA operator, the kernel backend)."""
        op = self.op
        key = ("stream", sl.start, t, dtype, self.backend)
        if key not in op._csr:
            if isinstance(op, sketch_lib.SparseSignSketch):
                shift = torch.arange(op.k, dtype=torch.int32, device=op.device)[:, None] * op.d
                h, w, d = op.buckets[:, sl] + shift, op.signs[:, sl], op.k * op.d
            else:
                h, w, d = op.buckets[sl], op._weights()[sl], op.d
            on_card = op.device.type == "cuda" and backend_lib.uses_kernels(self.backend)
            csr = countsketch_csr(h, w, d, dtype) if on_card else None
            op._csr[key] = (h, w, d, csr)
        return op._csr[key]

    # ----------------------------------------------------------- update
    def update(self, tile, row_offset: int) -> "SketchAccumulator":
        """Fold rows [row_offset, row_offset + t) of A into the state."""
        op = self.op
        tile = backend_lib.as_tensor(tile, op.device)
        t, ncols = tile.shape
        if ncols != self.ncols:
            raise ValueError(f"tile has {ncols} columns, expected {self.ncols}")
        if row_offset < 0 or row_offset + t > op.m:
            raise ValueError(
                f"tile rows [{row_offset}, {row_offset + t}) outside [0, {op.m})"
            )
        sl = slice(row_offset, row_offset + t)
        if isinstance(op, sketch_lib.SRHTSketch):
            self.state[sl] = op.apply_rows(tile, row_offset)
        elif isinstance(op, sketch_lib._BucketSketch):
            h, w, d, csr = self._tile_fold(sl, t, tile.dtype)
            if backend_lib.uses_kernels(self.backend):
                countsketch_apply(tile, h, w, d, csr=csr, out=self.state)
            else:  # the plain fold, on any device (index_add_)
                countsketch_fold_ref(self.state, tile, h, w)
        else:  # dense-S kinds: one (d, t) × (t, ncols) block product
            self.state += op.apply_rows(tile, row_offset, backend=self.backend)
        self.rows_seen += t
        self.tiles_seen += 1
        return self

    # ------------------------------------------------------------ merge
    def merge(self, other: "SketchAccumulator") -> "SketchAccumulator":
        """Combine with a partial sketch over a DISJOINT row range.

        Associative; both sides must hold the same operator draw (checked
        with ``torch.equal`` on the operators' tensors when they are
        distinct objects: the sum of two different S's is a silently wrong
        B).
        """
        same = type(self.op) is type(other.op) and (
            self.op.d, self.op.m, self.ncols
        ) == (other.op.d, other.op.m, other.ncols)
        if same and self.op is not other.op:
            same = _same_draw(self.op, other.op)
        if not same:
            raise ValueError(
                "can only merge partial sketches of the same operator draw; "
                f"got {type(self.op).__name__}(d={self.op.d}, m={self.op.m}) "
                f"x{self.ncols} vs "
                f"{type(other.op).__name__}(d={other.op.d}, m={other.op.m}) "
                f"x{other.ncols}"
            )
        out = make_accumulator(self.op, self.ncols, dtype=self.dtype, backend=self.backend)
        out.state = self.state + other.state
        out.rows_seen = self.rows_seen + other.rows_seen
        out.tiles_seen = self.tiles_seen + other.tiles_seen
        return out

    # --------------------------------------------------------- finalize
    def finalize(self) -> torch.Tensor:
        """The assembled sketch B = S·A — equals ``op.apply`` on the full A."""
        if self.rows_seen != self.op.m:
            raise ValueError(
                f"stream covered {self.rows_seen} of m={self.op.m} rows; "
                "merge the remaining partial sketches before finalize"
            )
        op, state = self.op, self.state
        if isinstance(op, sketch_lib.SRHTSketch):
            if "unsigned" not in op._plan:  # D was applied per tile
                op._plan["unsigned"] = srht_plan(torch.ones_like(op.signs), op.rows)
            ones = torch.ones(op.m_pad, dtype=state.dtype, device=state.device)
            if backend_lib.uses_kernels(self.backend):
                return srht_apply(state, ones, op.rows, op.d, plan=op._plan["unsigned"])
            return srht_ref(state, ones, op.rows, op.d)
        if isinstance(op, sketch_lib.SparseSignSketch):
            # the k partials added one by one (torch's sum(0) over a short
            # axis is not sequential), then the 1/√k scale
            B = torch.zeros_like(state[: op.d])
            for part in state.view(op.k, op.d, self.ncols):
                B = B + part
            return B / sqrt_tensor(op.k, B.dtype, B.device)
        return state


def make_accumulator(op, ncols: int, dtype=torch.float64, backend="auto"):
    """Fresh accumulator for one operator draw (see module docstring)."""
    return SketchAccumulator(op, ncols, dtype=dtype, backend=backend)


def accumulate_source(op, source, *, base_offset: int = 0, backend="auto", acc=None) -> SketchAccumulator:
    """Stream every tile of ``source`` (through :func:`device_tiles`, onto
    the operator's device) into an accumulator.

    ``base_offset`` shifts the source's local offsets into the global row
    space: shard i of a ``ShardedSource`` uses ``base_offset=
    source.shard_offsets[i]``, so the per-shard partials merge into the
    same global sketch.
    """
    m, ncols = source.shape
    if acc is None:
        acc = make_accumulator(op, ncols, dtype=source.dtype, backend=backend)
    for offset, tile in device_tiles(source, op.device):
        acc.update(tile, base_offset + offset)
    return acc


def merge_all(accs) -> SketchAccumulator:
    """Pairwise tree-reduction of partial accumulators (associative)."""
    accs = list(accs)
    if not accs:
        raise ValueError("nothing to merge")
    while len(accs) > 1:
        accs = [
            accs[i].merge(accs[i + 1]) if i + 1 < len(accs) else accs[i]
            for i in range(0, len(accs), 2)
        ]
    return accs[0]


def sharded_sketch(A, op, *, group=None, mesh=None, axes=("data",), backend="auto"):
    """S·A for a row-sharded A in ONE collective.

    The collective form of :meth:`SketchAccumulator.merge`: each rank of
    the group passes its contiguous row block ``A`` (ranks in order) and
    the same global operator ``op``; it restricts S to its global rows
    (``op.restrict_cols``), sketches them with the kind's
    backend-dispatched ``apply`` (kernel B1 for the bucket kinds, B6 for the
    uniform-dense kind and for the Gaussian, whose restriction is a stored
    ``UniformDenseSketch`` as in the reference), and one all-reduce sums
    the (d, n) partials.  Communication is O(d·n), independent of m — the
    assembly ``repro_torch.core.distributed.sketched_lstsq`` performs inside
    its solver.  Every rank returns the same (d, n) sketch.

    ``group``/``mesh``/``axes`` name the group as in ``sketched_lstsq``
    (``repro_torch.sharding.resolve_group``).  Additive kinds only: the
    SRHT couples rows through the Hadamard transform and has no
    independent column restriction — stream it through the padded-buffer
    accumulator instead.
    """
    if op.stream_semantics != "add":
        raise ValueError(
            f"{type(op).__name__} cannot be assembled by per-shard "
            "restriction (stream_semantics="
            f"{op.stream_semantics!r}); use make_accumulator instead"
        )
    backend_lib.check_backend(backend)
    group = sharding.resolve_group(group, mesh, axes, who="sharded_sketch")
    A = backend_lib.as_tensor(A, op.device)
    m, row0 = sharding.row_offset(A.shape[0], group, A.device)
    if m != op.m:
        raise ValueError(f"the shards hold {m} rows, the operator has m = {op.m}")
    sub = op.restrict_cols(slice(row0, row0 + A.shape[0]))
    return sharding.psum(sub.apply(A, backend=backend), group)
