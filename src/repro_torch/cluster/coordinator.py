"""Multi-worker, fault-tolerant driver for the two-pass streaming solve.

Port of ``repro/cluster/coordinator.py``.  The :class:`ClusterEngine` owns
a pool of workers (threads standing in for hosts: this module implements
the state logistics, not a transport) and fans the streaming engine's two
passes out across them:

- **pass 1** (``cluster_sketch``): each worker streams its tile-aligned
  row range through ``device_tiles`` into its own mergeable
  :class:`~repro_torch.streaming.accumulate.SketchAccumulator` (for the
  bucket kinds, kernel B1's fold mode per tile), checkpointing the partial
  state every ``checkpoint_every`` tiles (``repro_torch.cluster.
  checkpoint``).  The coordinator merges the per-range partials with
  ``merge_all`` in range order.
- **pass 2** (``matvec`` / ``rmatvec`` / ``residual_grad``): the blocked
  products of the iteration are computed per range and placed or summed
  in range order; stateless, so a failed range is simply recomputed.

Fault tolerance:

- every worker heartbeats per tile; the coordinator's monitor declares a
  worker dead when its beat goes stale (``heartbeat_timeout``) or its
  thread dies (:class:`~repro_torch.cluster.faults.WorkerKilled`);
- a dead worker's unfinished ranges are REASSIGNED to the live worker
  with the least remaining work (``OwnershipMap.reassign``), respawning a
  fresh worker only when nobody is left;
- a reassigned sketch range resumes from its last accumulator checkpoint:
  only the tiles past the watermark are re-streamed, folded in row order
  into the restored state, so the resumed partial is bitwise an
  uninterrupted one;
- late results from workers declared dead but still running (zombies),
  and deliberate double submissions, are dropped by per-range dedup before
  the merge (``duplicates_dropped``).

One departure from the reference: a pass is cut into ``spec.num_workers``
ranges whatever the number of live workers (the reference cuts one range
per live worker), and ranges go round-robin to the live workers.  The
grouping of every merge and range-order sum is then the same after a
worker's death as before it, so a solve that loses a worker is bitwise
the clean solve, its pass-2 products included.

On the card every worker works on the stream that was current on the
coordinator's thread when the pass began (a new thread would otherwise
start on the default stream), so the workers' folds, the merge and the
caller's next work are ordered on one stream without events.  A killed
worker's queued kernels still run; its state is dropped and nothing reads
it.  A worker whose engine was closed stops at its next tile, and writes
no checkpoint after ``close()``.

The engine quacks like a :class:`~repro_torch.streaming.sources.RowSource`
(shape/dtype/tiles), and the streaming drivers probe for its
``cluster_sketch`` / ``matvec`` / ``rmatvec`` / ``residual_grad`` methods,
so ``stream_lstsq(..., cluster=ClusterSpec(...))``,
``StreamingSolver(..., cluster=...)`` and ``lstsq(A, b, gen, cluster=...)``
run their streams through the pool.  ``device=None`` means ``"cuda"``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import queue
import shutil
import tempfile
import threading
import time

import torch

from ..obs import trace as obs_trace
from ..obs.lockcheck import make_lock
from ..obs.metrics import REGISTRY
from ..streaming.accumulate import make_accumulator, merge_all
from ..streaming.sources import RowSource, as_source, device_tiles, solve_device
from . import checkpoint as cckpt
from .faults import WorkerKilled, as_plan
from .shard import OwnershipMap, RowRange, RowRangeSource, partition_rows

__all__ = ["ClusterSpec", "ClusterEngine", "ClusterFailure"]


class ClusterFailure(RuntimeError):
    """The pass cannot complete: recovery budget exhausted."""


class _EngineClosed(RuntimeError):
    """Raised in a worker whose engine was closed while it worked."""


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """Configuration of a cluster run (pass through ``lstsq(cluster=...)``).

    ``num_workers``        worker pool size (≥ 1; 1 degenerates to the
                           single-stream engine plus checkpoints), and the
                           number of ranges a pass is cut into.
    ``tile_rows``          global tile grid (None → the source's tiling).
    ``checkpoint_every``   tiles between mid-range accumulator
                           checkpoints (0/None disables — a killed range
                           then restarts from its first row).
    ``ckpt_dir``           checkpoint root (None → a fresh temp dir per
                           engine, removed again by ``close()``).
    ``heartbeat_timeout``  seconds without a worker heartbeat before the
                           monitor declares it dead.  Staleness is
                           measured from the later of the worker's last
                           beat and the task's dispatch time, so an idle
                           pool between passes never goes stale.
    ``poll_interval``      monitor poll cadence in seconds.
    ``max_recoveries``     worker deaths tolerated per PASS (each
                           fan-out) before :class:`ClusterFailure`;
                           ``stats["recoveries"]`` counts engine lifetime
                           totals.
    ``faults``             a :class:`~repro_torch.cluster.faults.FaultPlan`
                           (or event list) injected into the worker loops.
    """

    num_workers: int = 2
    tile_rows: int | None = None
    checkpoint_every: int | None = 1
    ckpt_dir: str | None = None
    heartbeat_timeout: float = 10.0
    poll_interval: float = 0.01
    max_recoveries: int = 4
    faults: object = None

    def __post_init__(self):
        if self.num_workers < 1:
            raise ValueError(f"need >= 1 worker, got {self.num_workers}")


_STOP = object()


class _Task:
    __slots__ = ("rng", "fn", "epoch", "status", "result", "error", "done", "dispatched_at")

    def __init__(self, rng: RowRange, fn, epoch: int = 0):
        self.rng = rng
        self.fn = fn
        self.epoch = epoch
        self.status = "pending"
        self.result = None
        self.error = None
        self.done = threading.Event()
        self.dispatched_at = time.monotonic()  # re-stamped on submit


class _Worker:
    """One pool member: a thread draining an inbox of range tasks.

    A :class:`WorkerKilled` raised inside a task kills the THREAD (no
    cleanup, no further tasks, heartbeats stop): the preemption model the
    coordinator must recover from.
    """

    def __init__(self, wid: int):
        self.id = wid
        self.inbox: queue.Queue = queue.Queue()
        self.last_beat = time.monotonic()
        self.tasks: list[_Task] = []  # unfinished tasks queued to me
        self.thread = threading.Thread(target=self._loop, name=f"repro-cluster-w{wid}", daemon=True)
        self.thread.start()

    def beat(self):
        self.last_beat = time.monotonic()

    @property
    def thread_alive(self) -> bool:
        return self.thread.is_alive()

    def submit(self, task: _Task):
        task.dispatched_at = time.monotonic()
        self.tasks.append(task)
        self.inbox.put(task)

    def stop(self):
        self.inbox.put(_STOP)

    def _loop(self):
        while True:
            task = self.inbox.get()
            if task is _STOP:
                return
            if task.status == "abandoned":
                task.done.set()
                continue
            self.beat()
            try:
                task.result = task.fn(self)
                task.status = "done"
            except WorkerKilled as e:
                task.error = e
                task.status = "killed"
                task.done.set()
                return  # the whole worker dies, inbox abandoned
            except Exception as e:  # a real bug: surfaced by the monitor
                task.error = e
                task.status = "error"
            task.done.set()


class ClusterEngine(RowSource):
    """Coordinator + worker pool over one row source (see module doc).

    Subclasses :class:`RowSource`, so an engine drops in anywhere a source
    does (``as_source`` passes it through unchanged); the streaming drivers
    then discover its distributed ``cluster_sketch`` / ``matvec`` /
    ``rmatvec`` / ``residual_grad`` methods by probing.
    """

    # Checked by reprolint R1.  Worker threads and the coordinator both
    # write these; everything else (_workers, _dead, _next_id,
    # _pass_recoveries, _closed) is coordinator-thread-private by
    # construction and deliberately unlisted (workers only read _closed).
    GUARDED_BY = {
        "stats": "_lock",
        "_tile_counts": "_lock",
        "_submissions": "_lock",
        "_sketch_seq": "_lock",
        "_ckpt_open": "_ckpt_lock",
    }

    def __init__(self, source, spec: ClusterSpec | None = None, *, backend: str = "auto",
                 counters: dict | None = None, device=None):
        if spec is not None and not isinstance(spec, ClusterSpec):
            raise TypeError(f"cluster= takes a ClusterSpec or a ClusterEngine, got {type(spec).__name__}")
        self.source = as_source(source)
        self.spec = spec or ClusterSpec()
        self.shape = self.source.shape
        self.dtype = self.source.dtype
        self.backend = backend
        self.device = solve_device(device)
        self.counters = counters  # optional external pass/tile counters
        self._grid = int(self.spec.tile_rows or self.source.tile_rows)
        self._plan = as_plan(self.spec.faults)
        self._owns_ckpt_dir = self.spec.ckpt_dir is None
        self._ckpt_dir = self.spec.ckpt_dir or tempfile.mkdtemp(prefix="repro-cluster-")
        self._closed = False
        self._pass_recoveries = 0  # reset by every _execute fan-out
        self._workers: dict[int, _Worker] = {w: _Worker(w) for w in range(self.spec.num_workers)}
        self._dead: set[int] = set()
        self._next_id = self.spec.num_workers
        self._lock = make_lock("ClusterEngine._lock")  # counters + submissions
        self._ckpt_lock = make_lock("ClusterEngine._ckpt_lock")  # checkpoint reads and writes
        self._ckpt_open = True  # False once close() has removed or released the ckpt dir
        self._tile_counts: dict[tuple[int, str], int] = {}
        self._submissions: list = []
        self._sketch_seq = 0  # guards against zombie submissions from a
        # previous pass leaking into a later one
        self.stats = REGISTRY.stats_dict("cluster", {
            "workers": self.spec.num_workers,
            "recoveries": 0,
            "reassignments": 0,
            "respawns": 0,
            "restores": 0,
            "checkpoints": 0,
            "duplicates_dropped": 0,
            "heartbeat_evictions": 0,
            "passes": 0,
            "tiles": 0,
        })

    # ------------------------------------------------------- RowSource face
    @property
    def tile_rows(self) -> int:
        return self._grid

    @property
    def num_tiles(self) -> int:
        return -(-self.shape[0] // self._grid)

    def tiles(self):
        # serial fallback so the engine drops in anywhere a source does
        yield from self.source.tiles()

    @property
    def supports_random_access(self) -> bool:
        return self.source.supports_random_access

    def read_rows(self, offset, length):
        return self.source.read_rows(offset, length)

    @property
    def ckpt_dir(self) -> str:
        return self._ckpt_dir

    def close(self):
        """Stop the pool; idempotent.  A temp checkpoint dir the engine
        created for itself is removed with it (a caller-provided
        ``spec.ckpt_dir`` is left untouched); no worker writes a
        checkpoint after this."""
        if self._closed:
            return
        self._closed = True
        for w in self._workers.values():
            w.stop()
        for w in self._workers.values():
            # bounded join: healthy workers exit on _STOP at once; an
            # injected zombie may still be sleeping (it stops at its next
            # tile) — don't hang on it
            w.thread.join(timeout=0.5)
        with self._ckpt_lock:
            self._ckpt_open = False
            if self._owns_ckpt_dir:
                shutil.rmtree(self._ckpt_dir, ignore_errors=True)

    # ------------------------------------------------------------ plumbing
    def _live_ids(self) -> list[int]:
        return [w for w, wk in self._workers.items() if w not in self._dead and wk.thread_alive]

    def _scope(self):
        """The coordinator's device and stream, to be entered by a worker:
        every worker then queues on the stream the caller works on."""
        if self.device.type != "cuda":
            return contextlib.nullcontext
        stream = torch.cuda.current_stream(self.device)

        @contextlib.contextmanager
        def scope():
            with torch.cuda.device(self.device), torch.cuda.stream(stream):
                yield
        return scope

    def _fault_gate(self, worker: _Worker, phase: str):
        worker.beat()  # starting a tile is life, even if it computes long
        with self._lock:
            k = (worker.id, phase)
            tile = self._tile_counts.get(k, 0)
            self._tile_counts[k] = tile + 1
        self._plan.before_tile(worker.id, phase, tile)
        if self._closed:
            raise _EngineClosed(f"worker {worker.id}: the engine was closed")

    def _count_tiles(self, k: int = 1):
        with self._lock:
            self.stats["tiles"] += k
            if self.counters is not None:
                self.counters["tiles"] += k

    def _count_pass(self):
        with self._lock:
            self.stats["passes"] += 1
            if self.counters is not None:
                self.counters["passes"] += 1

    def _recover(self, ownership: OwnershipMap, victim: int, make_fn, pending: dict):
        """Declare ``victim`` dead and reassign its unfinished ranges."""
        obs_trace.instant("cluster.recover", victim=victim)
        with self._lock:
            self.stats["recoveries"] += 1
        self._pass_recoveries += 1
        if self._pass_recoveries > self.spec.max_recoveries:
            raise ClusterFailure(
                f"recovery budget exhausted ({self.spec.max_recoveries} "
                f"per pass); last casualty: worker {victim}"
            )
        self._dead.add(victim)
        wk = self._workers[victim]
        for t in wk.tasks:
            if not t.done.is_set():
                t.status = "abandoned"
        live = self._live_ids()
        if not live:
            nid = self._next_id
            self._next_id += 1
            self._workers[nid] = _Worker(nid)
            obs_trace.instant("cluster.respawn", worker=nid)
            with self._lock:
                self.stats["respawns"] += 1
            live = [nid]
            ownership.assignments.setdefault(nid, [])
        moves = ownership.reassign(victim, live)
        for tgt, rng in moves:
            obs_trace.instant("cluster.reassign", range=(rng.start, rng.stop), to=tgt)
            with self._lock:
                self.stats["reassignments"] += 1
            task = _Task(rng, make_fn(rng), epoch=pending[rng].epoch + 1)
            pending[rng] = task
            self._workers[tgt].submit(task)

    def _execute(self, ranges: list[RowRange], make_fn) -> dict:
        """Run ``make_fn(rng)(worker)`` for every range on the pool with
        heartbeat monitoring and kill/timeout recovery.  Returns {range:
        result} once every range has completed somewhere.  While no range
        finishes, the monitor sleeps ``poll_interval`` between polls."""
        if self._closed:
            raise ClusterFailure("engine is closed")
        self._pass_recoveries = 0
        live = self._live_ids()
        if not live:
            raise ClusterFailure("no live workers")
        ownership = OwnershipMap(m=self.shape[0], tile_rows=self._grid, assignments={w: [] for w in live})
        pending: dict[RowRange, _Task] = {}
        for i, rng in enumerate(ranges):
            w = live[i % len(live)]
            ownership.assignments[w].append(rng)
            task = _Task(rng, make_fn(rng))
            pending[rng] = task
            self._workers[w].submit(task)
        results: dict[RowRange, object] = {}
        while any(rng not in results for rng in ranges):
            progressed = False
            for rng in ranges:
                if rng in results:
                    continue
                task = pending[rng]
                owner = ownership.owner_of(rng)
                if task.done.is_set() and task.status == "done":
                    results[rng] = task.result
                    if owner is not None:
                        self._workers[owner].tasks = [t for t in self._workers[owner].tasks if t is not task]
                        ownership.assignments[owner].remove(rng)
                    progressed = True
                elif task.done.is_set() and task.status == "killed":
                    self._recover(ownership, owner, make_fn, pending)
                    progressed = True
                elif task.done.is_set() and task.status == "error":
                    raise task.error
                elif owner is not None:
                    wk = self._workers[owner]
                    # staleness from the later of the worker's last beat
                    # and this task's dispatch: a pool that sat idle
                    # between passes (or a queued task behind a long tile)
                    # is not dead, it just hasn't started yet
                    alive_ref = max(wk.last_beat, task.dispatched_at)
                    stale = time.monotonic() - alive_ref > self.spec.heartbeat_timeout
                    if stale or not wk.thread_alive:
                        if stale and wk.thread_alive:
                            obs_trace.instant("cluster.eviction", worker=owner,
                                              stale_s=time.monotonic() - alive_ref)
                            with self._lock:
                                self.stats["heartbeat_evictions"] += 1
                        self._recover(ownership, owner, make_fn, pending)
                        progressed = True
            if not progressed:
                time.sleep(self.spec.poll_interval)
        return results

    def _partition(self) -> list[RowRange]:
        """``spec.num_workers`` tile-aligned ranges, whatever the number of
        live workers: the grouping of every merge stays put when one dies."""
        if not self._live_ids():
            raise ClusterFailure("no live workers")
        ranges = partition_rows(self.shape[0], self.spec.num_workers, self._grid)
        return [r for r in ranges if r.rows > 0]

    # -------------------------------------------------------------- pass 1
    def cluster_sketch(self, op, *, rhs=None, backend: str = "auto"):
        """Fan pass-1 sketching out over the pool → the finalized (s,
        ncols) sketch of [A | rhs].  The per-range partial accumulators
        are checkpointed mid-range, restored on reassignment, deduped,
        then merged in range order."""
        m, n = self.shape
        if solve_device(op.device) != self.device:
            raise ValueError(f"sketch operator is on {op.device}, the engine on {self.device}")
        if rhs is not None:
            rhs = torch.as_tensor(rhs, device=self.device)
        ncols = n + (1 if rhs is not None else 0)
        dtype = self.dtype
        ckpt_every = self.spec.checkpoint_every or 0
        # checkpoints are namespaced by (operator draw, rhs): leftovers in a
        # persistent ckpt_dir from another draw or rhs restore None (a
        # fresh start) instead of failing, or poisoning, the new pass.  The
        # draw is digested once a pass, and only when it checkpoints.
        digest = cckpt.op_digest(op) if ckpt_every else None
        ns = cckpt.pass_namespace(op, rhs, digest=digest) if ckpt_every else None
        self._count_pass()
        with self._lock:
            self._submissions = []
            self._sketch_seq += 1
            seq = self._sketch_seq
        scope = self._scope()

        def submit(rng, acc, wid):
            with self._lock:
                if self._sketch_seq == seq:
                    self._submissions.append((rng, acc, wid))

        def restore(rng, worker):
            with self._ckpt_lock:  # never read a step a zombie is replacing
                if not self._ckpt_open:
                    raise _EngineClosed(f"worker {worker.id}: the engine was closed")
                got = cckpt.restore_accumulator(
                    self._ckpt_dir, op, ncols, range_start=rng.start, range_stop=rng.stop,
                    phase=ns, dtype=dtype, backend=backend, digest=digest,
                )
            if got is not None:
                obs_trace.instant("cluster.restore", worker=worker.id, watermark=got[1],
                                  start=rng.start, stop=rng.stop)
                with self._lock:
                    self.stats["restores"] += 1
            return got

        def checkpoint(rng, acc, wm, worker):
            with self._ckpt_lock:
                if not self._ckpt_open:
                    return
                cckpt.save_accumulator(self._ckpt_dir, acc, wm, range_start=rng.start,
                                       range_stop=rng.stop, phase=ns, digest=digest)
            obs_trace.instant("cluster.checkpoint", worker=worker.id, watermark=wm)
            with self._lock:
                self.stats["checkpoints"] += 1

        def make_fn(rng):
            def fn(worker: _Worker):
                with scope(), obs_trace.span("cluster.task", phase="sketch", worker=worker.id,
                                             start=rng.start, stop=rng.stop):
                    acc, wm = None, rng.start
                    if ckpt_every:
                        got = restore(rng, worker)
                        if got is not None:
                            acc, wm = got
                    if acc is None:
                        acc = make_accumulator(op, ncols, dtype=dtype, backend=backend)
                    sub = RowRangeSource(self.source, wm, rng.stop, tile_rows=self._grid)
                    since = 0
                    # Each tile's CSR is cached on the shared operator by its
                    # offset (accumulate.py): ranges are disjoint, so only a
                    # resumed or zombie range builds a key again, and the
                    # dict assignment is atomic — a duplicate costs time only.
                    for local_o, tile in device_tiles(sub, self.device):
                        self._fault_gate(worker, "sketch")
                        gl = wm + local_o
                        t = tile.shape[0]
                        if rhs is not None:
                            tile = torch.cat([tile, rhs[gl : gl + t, None].to(tile.dtype)], dim=1)
                        acc.update(tile, gl)
                        worker.beat()
                        obs_trace.instant("cluster.heartbeat", worker=worker.id, row=gl)
                        self._count_tiles()
                        since += 1
                        if ckpt_every and since >= ckpt_every and gl + t < rng.stop:
                            checkpoint(rng, acc, gl + t, worker)
                            since = 0
                    submit(rng, acc, worker.id)
                    if self._plan.duplicate_submission(worker.id):
                        submit(rng, acc, worker.id)  # the dedup guard's moment
                    return True
            return fn

        with obs_trace.span("cluster.pass1", rows=m, workers=len(self._live_ids())):
            ranges = self._partition()
            self._execute(ranges, make_fn)
            chosen: dict[RowRange, object] = {}
            with self._lock:
                submissions = list(self._submissions)
            for rng, acc, _wid in submissions:
                if rng in chosen:
                    with self._lock:
                        self.stats["duplicates_dropped"] += 1
                    continue
                chosen[rng] = acc
            covered = 0
            for rng in sorted(chosen):
                if rng.start != covered:
                    raise ClusterFailure(f"pass-1 coverage gap at row {covered} (next range {rng})")
                covered = rng.stop
            if covered != m:
                raise ClusterFailure(f"pass-1 covered {covered} of {m} rows")
            with obs_trace.span("cluster.merge", ranges=len(chosen)):
                merged = merge_all([chosen[rng] for rng in sorted(chosen)])
                out = merged.finalize()
                obs_trace.maybe_block(out)
        # the pass succeeded: its mid-range checkpoints are spent — clear
        # them so a persistent ckpt_dir does not grow without bound
        if ckpt_every:
            with self._ckpt_lock:
                shutil.rmtree(os.path.join(self._ckpt_dir, ns), ignore_errors=True)
        return out

    # -------------------------------------------------------------- pass 2
    def _map_ranges(self, per_range_fn, phase: str = "map"):
        """Fan a stateless per-range computation out and return the results
        in ascending range order (a deterministic reduction)."""
        self._count_pass()
        scope = self._scope()

        def make_fn(rng):
            def fn(worker: _Worker):
                with scope(), obs_trace.span("cluster.task", phase=phase, worker=worker.id,
                                             start=rng.start, stop=rng.stop):
                    sub = RowRangeSource(self.source, rng.start, rng.stop, tile_rows=self._grid)
                    return per_range_fn(rng, sub, worker)
            return fn

        with obs_trace.span("cluster.pass2", phase=phase, workers=len(self._live_ids())):
            ranges = self._partition()
            results = self._execute(ranges, make_fn)
            return [results[rng] for rng in sorted(ranges)]

    def _tiles(self, sub, worker):
        """A range's tiles on the engine's device, each behind the fault
        gate and counted."""
        for local_o, tile in device_tiles(sub, self.device):
            self._fault_gate(worker, "matvec")
            yield local_o, tile
            worker.beat()
            self._count_tiles()

    def matvec(self, x):
        """A @ x by per-range placement (exact: no cross-range sums; each
        tile's product is the serial stream's)."""
        x = torch.as_tensor(x, device=self.device)

        def per_range(rng, sub, worker):
            out = torch.empty((rng.rows,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
            for local_o, tile in self._tiles(sub, worker):
                torch.matmul(tile, x, out=out[local_o : local_o + tile.shape[0]])
            return out

        return torch.cat(self._map_ranges(per_range, phase="matvec"), dim=0)

    def rmatvec(self, u):
        """Aᵀ @ u: per-range partial adjoint products summed in range order
        (a fixed grouping, so reproducible whatever workers compute it)."""
        u = torch.as_tensor(u, device=self.device)
        n = self.shape[1]

        def per_range(rng, sub, worker):
            g = torch.zeros((n,) + tuple(u.shape[1:]), dtype=u.dtype, device=u.device)
            for local_o, tile in self._tiles(sub, worker):
                gl = rng.start + local_o
                g = g + tile.T @ u[gl : gl + tile.shape[0]]
            return g

        parts = self._map_ranges(per_range, phase="rmatvec")
        g = parts[0]
        for p in parts[1:]:
            g = g + p
        return g

    def residual_grad(self, b, x):
        """ONE fused distributed pass: (‖b − Ax‖² per column, Aᵀ(b − Ax))."""
        b = torch.as_tensor(b, device=self.device)
        x = torch.as_tensor(x, device=self.device)
        n = self.shape[1]

        def per_range(rng, sub, worker):
            g = torch.zeros((n,) + tuple(b.shape[1:]), dtype=b.dtype, device=b.device)
            rn2 = torch.zeros(tuple(b.shape[1:]), dtype=b.dtype, device=b.device)
            for local_o, tile in self._tiles(sub, worker):
                gl = rng.start + local_o
                r_t = b[gl : gl + tile.shape[0]] - tile @ x
                g = g + tile.T @ r_t
                rn2 = rn2 + torch.sum(r_t * r_t, dim=0)
            return rn2, g

        parts = self._map_ranges(per_range, phase="residual_grad")
        rn2, g = parts[0]
        for p_rn2, p_g in parts[1:]:
            rn2 = rn2 + p_rn2
            g = g + p_g
        return rn2, g
