"""``SolveService`` — the multi-tenant front-end over the solver stack.

Port of ``repro/serve/service.py``.  The request path, end to end:

1. ``submit(A, b, ...)`` validates the request in the caller's thread,
   fingerprints the problem (``serve.fingerprint``), routes it — big A →
   the *session* path (cached factor, coalesced ``solve_many``), tiny A →
   the *bucket* path (padded batched QR) — and returns a
   ``concurrent.futures.Future`` immediately.  Shape and dtype are read
   from the caller's object; A itself is not copied at submit (b is moved
   to the service's device).
2. ``pump()`` releases ready micro-batches (``serve.batching``): for each
   same-fingerprint batch it fetches the live ``SketchedSolver`` from the
   LRU factor cache (``serve.cache``; on a miss it builds the session,
   moving A to the service's device once, and certifies its embedding),
   sketches the stacked right-hand sides ONCE (kernel B1 for the default
   CountSketch) and runs one block whitened LSQR; for each shape bucket it
   runs the padded batched QR.
3. Every response carries a posterior ``Certificate`` for its requested
   ``certified_rtol`` (``None`` → the service-level SLO
   ``default_rtol``).  The batch is certified in ONE blocked pass (the
   embedding-level distortion/spectrum are cached per factor), and each
   batch reads its results to the host in one transfer.
4. Requests whose certificate fails get the *slow path* — a per-request
   ``lstsq(accuracy="certified")`` with its full escalation ladder — and
   are REJECTED with a reason when even that cannot meet the SLO, or when
   their deadline expired: you get the accuracy you asked for, or an
   honest refusal, never a silently degraded answer.

Synchronous callers use ``solve()`` (submit + flush); load generators
call ``start()`` to run the pump on a background thread (continuous
micro-batching: batches release on size OR age, so tail latency is
bounded by ``max_delay_s`` even at low arrival rates).  The pump is
exception-isolated per batch — an internal failure (a CUDA error
included) rejects that batch's futures with the error as the reason and
keeps serving — and holds the submission lock only while popping queues,
so clients enqueue freely while a batch computes.

Random draws: the service holds a seed (an int, or a ``torch.Generator``'s
initial seed, read without drawing from it).  Each session build and each
slow-path solve gets a fresh generator on the service's device seeded from
(seed, counter) — the counterpart of the reference's
``fold_in(key, counter)`` — so a session's S depends only on its build
order.

A response's ``x`` is a CPU tensor; its ``result`` fields are host values
of the batch's single transfer (the slow path's certificate stays where
``lstsq`` made it).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict
from concurrent.futures import Future

import numpy as np
import torch

from ..core import backend as backend_lib
from ..core import certify as certify_lib
from ..core import linop
from ..core.lstsq import lstsq
from ..core.precond import default_sketch_size
from ..core.result import SolveResult
from ..core.session import SketchedSolver
from ..obs import trace as obs_trace
from ..obs.lockcheck import make_rlock
from ..obs.metrics import REGISTRY
from .batching import (
    MicroBatcher,
    _next_pow2,
    bucket_shape,
    pad_problem,
    solve_bucket,
)
from .cache import FactorCache
from .fingerprint import Fingerprint, fingerprint, version_tracked

__all__ = ["SolveService", "SolveResponse", "SMALL_PROBLEM_FLOPS", "derive_generator"]

# Route problems below this m·n² flop count to the padded-bucket direct
# path: same cutoff the lstsq auto-selector uses for "QR is free".
SMALL_PROBLEM_FLOPS = 1 << 26


def derive_generator(seed: int, counter: int, device) -> torch.Generator:
    """A fresh ``torch.Generator`` on ``device`` for draw number
    ``counter`` of a service seeded with ``seed`` (nothing is drawn from
    any shared generator)."""
    words = np.random.SeedSequence([int(seed) % 2**64, int(counter)]).generate_state(2)
    s = ((int(words[0]) << 32) | int(words[1])) & (2**63 - 1)
    return torch.Generator(device=torch.device(device)).manual_seed(s)


def _certify_block(op, factor, B_aug, X, distortion, smin, floor):
    """Blocked posterior pieces for a whole RHS batch: residuals, whitened
    gradients ‖R⁻ᵀAᵀr̂‖ and the certified bounds
    ‖x̂ − x⋆‖ ≤ ‖Yᵀr̂‖ / (σ_w² σ_min(R)) per column."""
    tiny = torch.finfo(factor.R.dtype).tiny
    Rres = B_aug - op.matmat(X)
    WG = factor.rt_solve(op.rmatmat(Rres))
    wg = torch.linalg.vector_norm(WG, dim=0)
    rn = torch.linalg.vector_norm(Rres, dim=0)
    xn = torch.linalg.vector_norm(X, dim=0)
    eps = torch.clamp(distortion, 0.0, 0.999)
    sigma_w = torch.clamp(torch.minimum(1.0 - eps, floor), min=tiny)
    bounds = wg / (sigma_w**2 * torch.clamp(smin, min=tiny))
    rels = bounds / torch.clamp(xn, min=tiny)
    return wg, rn, bounds, rels


@dataclasses.dataclass
class SolveResponse:
    """What a request's future resolves to — answer or honest refusal."""

    status: str  # "ok" | "rejected"
    x: torch.Tensor | None  # on the host
    result: SolveResult | None
    certificate: object | None  # repro_torch.core.certify.Certificate
    reason: str | None  # rejection reason ("rejected" only)
    path: str  # "session" | "bucket" | "slow"
    cache_hit: bool
    batch_size: int
    queued_s: float  # submit → dispatch
    latency_s: float  # submit → response

    @property
    def ok(self) -> bool:
        return self.status == "ok"


@dataclasses.dataclass
class _Request:
    future: Future
    A: object  # raw user input (array / sparse / operator), never copied
    b: torch.Tensor  # on the service's device, in A's dtype
    reg: float | None
    rtol: float  # resolved SLO (never None inside the service)
    deadline: float | None  # absolute time.monotonic() deadline
    t_submit: float
    t_dispatch: float | None = None  # stamped when the batch is popped
    fp: Fingerprint | None = None  # session path only
    raw_shape: tuple[int, int] = (0, 0)  # bucket path: pre-pad shape


class SolveService:
    """Multi-tenant least-squares serving: cached factors + micro-batching.

    Parameters
    ----------
    key : an int seed or a ``torch.Generator`` (its initial seed) seeding
        every session build and slow-path solve (module docstring).
    cache_bytes : byte budget of the LRU factor cache.
    max_batch / max_delay_s : the continuous micro-batching window.
    default_rtol : the service-level accuracy SLO — the ``certified_rtol``
        a request gets when it doesn't name one.  Session LSQR tolerances
        are derived from it (``atol = btol = default_rtol * tol_margin``)
        so solves stop as soon as the certificate can pass, not at the
        machine floor; requests demanding much tighter rtol than the
        service class fall through to the slow path.
    sketch / sketch_size_factor : the embedding the cached sessions are
        built with.  Serving wants a *larger* sketch than one-shot solves
        (default 8n vs 4n): the build is amortized anyway, and the lower
        distortion ε ≈ √(n/s) cuts every request's LSQR iteration count.
    small_problem_flops : m·n² below which requests take the bucket path.
    device : where sessions and buckets run; ``None`` means ``"cuda"``.
    """

    # Checked by reprolint R1: these attrs may only be written under
    # ``with self._lock:``.  The dispatch-side state (cache, sessions'
    # internals) is guarded by the objects' own locks, not listed here.
    GUARDED_BY = {
        "counters": "_lock",
        "_session_counter": "_lock",
        "_bucket_keys": "_lock",
    }

    def __init__(
        self,
        key,
        *,
        cache_bytes: int = 256 * 1024 * 1024,
        max_batch: int = 64,
        max_delay_s: float = 0.002,
        default_rtol: float = 1e-6,
        tol_margin: float = 0.02,
        sketch: str = "clarkson_woodruff",
        sketch_size_factor: int = 8,
        iter_lim: int = 100,
        small_problem_flops: int = SMALL_PROBLEM_FLOPS,
        max_distortion: float = certify_lib.DEFAULT_MAX_DISTORTION,
        device=None,
    ):
        self.device = backend_lib.resolve_device(device)
        if isinstance(key, torch.Generator):
            self._seed = int(key.initial_seed())
        elif isinstance(key, (int, np.integer)):
            self._seed = int(key)
        else:
            raise TypeError(
                f"key must be a torch.Generator or an int seed, got {type(key).__name__}"
            )
        self._session_counter = 0
        self.cache = FactorCache(max_bytes=cache_bytes)
        self.sessions = MicroBatcher(max_batch=max_batch, max_delay_s=max_delay_s)
        self.buckets = MicroBatcher(max_batch=max_batch, max_delay_s=max_delay_s)
        self.default_rtol = float(default_rtol)
        self.session_tol = float(default_rtol) * float(tol_margin)
        self.sketch = sketch
        self.sketch_size_factor = int(sketch_size_factor)
        self.iter_lim = int(iter_lim)
        self.small_problem_flops = int(small_problem_flops)
        self.max_distortion = float(max_distortion)
        self.counters = REGISTRY.stats_dict("serve", {
            "requests": 0, "ok": 0, "rejected": 0, "slow_path": 0,
            "session_batches": 0, "bucket_batches": 0,
        })
        self._h_latency = REGISTRY.histogram("serve.latency_s")
        self._h_queued = REGISTRY.histogram("serve.queued_s")
        self._bucket_keys: set = set()
        # _lock guards the queues/counters only and is held for
        # microseconds; _dispatch_lock serializes the dispatchers (pump
        # thread vs. a concurrent flush()) so sessions and their spectrum
        # caches stay single-threaded.  submit() never touches
        # _dispatch_lock — clients keep enqueueing while a batch computes.
        self._lock = make_rlock("SolveService._lock")
        self._dispatch_lock = make_rlock("SolveService._dispatch_lock")
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()

    # ------------------------------------------------------------ submission
    def _resolve_sketch_size(self, m: int, n: int) -> int:
        s = self.sketch_size_factor * n
        if m // 2 <= n + 1:
            return default_sketch_size(n, m)
        return max(n + 1, min(s, m // 2))

    def submit(
        self,
        A,
        b,
        *,
        reg: float | None = None,
        certified_rtol: float | None = None,
        deadline_s: float | None = None,
        token: str | None = None,
        tenant: str | None = None,
        mode: str = "auto",
    ) -> Future:
        """Enqueue one solve; resolves to a :class:`SolveResponse`.

        ``certified_rtol=None`` inherits the service SLO ``default_rtol``;
        ``deadline_s`` is a relative latency budget — a request whose
        certificate cannot be met before it expires is rejected with a
        reason rather than answered late or loosely.  ``token`` names the
        content of matrix-free operators and ``tenant`` scopes tokens per
        caller (see ``serve.fingerprint``).  ``mode`` forces the
        ``"session"`` or ``"bucket"`` path (``"auto"`` routes by problem
        size).

        Validation is front-loaded here, in the CALLER's thread: a b of
        the wrong shape or a dtype that would promote past A's precision
        raises immediately instead of poisoning the shared batch its
        fingerprint would coalesce into.  The fingerprint is taken here
        too, before the queue lock, so a digest never holds up other
        submitters.
        """
        if mode not in ("auto", "session", "bucket"):
            raise ValueError(f"unknown mode {mode!r}")
        kind = linop.input_kind(A)
        if kind == "dense" and not isinstance(A, (torch.Tensor, linop.DenseOperator)):
            A = np.asarray(A)
        m, n = (int(A.shape[0]), int(A.shape[1]))
        dtype = linop._torch_dtype(A.dtype)
        b = backend_lib.as_tensor(b, self.device)
        if b.ndim != 1 or b.shape[0] != m:
            raise ValueError(
                f"submit needs a single right-hand side of shape ({m},), "
                f"got {tuple(b.shape)}"
            )
        if b.dtype != dtype:
            # Same policy as SketchedSolver._check_rhs, enforced at the
            # service door: a promoting RHS is the CALLER's error and must
            # not surface mid-dispatch inside someone else's batch.
            if torch.promote_types(b.dtype, dtype) != dtype:
                raise TypeError(
                    f"right-hand side dtype {b.dtype} does not fit A's "
                    f"{dtype}: solving would silently promote past the "
                    f"precision the cached factor is built at — cast b "
                    f"(or submit A at {b.dtype}) explicitly"
                )
            b = b.to(dtype)
        if mode == "auto":
            small = m * n * n <= self.small_problem_flops
            mode = "bucket" if small and kind == "dense" else "session"
        if mode == "bucket" and kind != "dense":
            raise ValueError(
                f"the bucket path pads dense arrays; got a {kind} A — use "
                "mode='session'"
            )
        now = time.monotonic()
        req = _Request(
            future=Future(),
            A=A,
            b=b,
            reg=None if reg is None else float(reg),
            rtol=(
                self.default_rtol
                if certified_rtol is None
                else float(certified_rtol)
            ),
            deadline=None if deadline_s is None else now + float(deadline_s),
            t_submit=now,
            raw_shape=(m, n),
        )
        if mode == "session":
            req.fp = fingerprint(
                A, reg=req.reg, sketch=self.sketch,
                sketch_size=self._resolve_sketch_size(m, n), token=token,
                tenant=tenant,
            )
        with self._lock:
            self.counters["requests"] += 1
            if mode == "bucket":
                key = (*bucket_shape(m, n), str(dtype))
                self._bucket_keys.add(key)
                self.buckets.add(key, req, now=now)
            else:
                self.sessions.add(req.fp, req, now=now)
        obs_trace.instant("serve.submit", mode=mode, m=m, n=n)
        return req.future

    def solve(self, A, b, **kw) -> SolveResponse:
        """Synchronous convenience: submit + flush (or wait on the pump)."""
        fut = self.submit(A, b, **kw)
        if self._thread is None:
            self.flush()
        return fut.result()

    # -------------------------------------------------------------- pumping
    def pump(self, *, drain: bool = False) -> int:
        """Dispatch every ready micro-batch; returns #requests completed.

        The queue pop is the only work under ``_lock`` — the popped
        request lists are private, so the dispatches (session builds,
        solves, certification) run with submissions flowing freely.  Each
        batch dispatch is exception-isolated: an internal failure rejects
        THAT batch's futures with the error as the reason and the pump
        keeps serving everyone else.
        """
        with self._lock:
            ready = self.sessions.ready(drain=drain)
            ready_b = self.buckets.ready(drain=drain)
            self.counters["session_batches"] += len(ready)
            self.counters["bucket_batches"] += len(ready_b)
        now = time.monotonic()
        for _, reqs in (*ready, *ready_b):
            for r in reqs:
                r.t_dispatch = now
        done = 0
        with self._dispatch_lock:
            for fp, reqs in ready:
                done += self._dispatch_guarded(
                    self._dispatch_session, fp, reqs, "session"
                )
            for key, reqs in ready_b:
                done += self._dispatch_guarded(
                    self._dispatch_bucket, key, reqs, "bucket"
                )
        return done

    def _dispatch_guarded(self, dispatch, key, reqs, path: str) -> int:
        try:
            with obs_trace.span(f"serve.dispatch.{path}", batch=len(reqs)):
                return dispatch(key, reqs)
        except Exception as e:  # noqa: BLE001 — the pump must survive
            for r in reqs:
                if not r.future.done():
                    self._reject(
                        r,
                        f"internal error during {path} dispatch: {e!r}",
                        path, False, len(reqs),
                    )
            return len(reqs)

    def flush(self) -> int:
        """Drain every queue (the synchronous caller's barrier)."""
        total = 0
        while True:
            n = self.pump(drain=True)
            total += n
            with self._lock:
                if self.sessions.pending + self.buckets.pending == 0:
                    return total

    def start(self, poll_s: float = 0.0005) -> None:
        """Run the pump on a daemon thread (open-loop serving mode)."""
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                if self.pump() == 0:
                    time.sleep(poll_s)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join()
        self._thread = None
        self.flush()

    def prewarm(self, A, *, reg: float | None = None,
                token: str | None = None,
                tenant: str | None = None) -> None:
        """The serving warmup request: build + certify A's session and run
        the whole batch-width ladder before real traffic lands, so no
        tenant's first requests eat a session build as tail latency."""
        m, n = (int(A.shape[0]), int(A.shape[1]))
        fp = fingerprint(
            A, reg=reg, sketch=self.sketch,
            sketch_size=self._resolve_sketch_size(m, n), token=token,
            tenant=tenant,
        )
        with self._dispatch_lock:
            session, _ = self.cache.get_or_build(
                fp, lambda: self._build_session(A, fp)
            )
            self._ensure_certified_embedding(session)
            self._spectrum(session)
            op = session.A
            b = op.matvec(torch.ones((n,), dtype=op.dtype, device=op.device))
            res = session.solve(b)
            self._certify_columns(session, b[:, None], res.x[:, None],
                                  [self.default_rtol])
            w = 2
            while w <= self.sessions.max_batch:
                B = b[:, None].repeat(1, w)
                res = session.solve_many(B)
                self._certify_columns(session, B, res.x,
                                      [self.default_rtol] * w)
                w *= 2

    # ------------------------------------------------------------- sessions
    def _next_key(self) -> torch.Generator:
        with self._lock:
            self._session_counter += 1
            counter = self._session_counter
        return derive_generator(self._seed, counter, self.device)

    def _session_data(self, A):
        """A on the service's device as a session may hold it.  A card
        tensor is held as it is, and the factor cache watches its version
        counter (``serve/cache.py``).  Memory whose writes that counter may
        not see (host memory, which numpy can write; an inference tensor)
        is copied, so the session owns the bytes it was keyed on."""
        kind = linop.input_kind(A)
        if kind == "dense":
            t = backend_lib.as_tensor(
                A.A if isinstance(A, linop.DenseOperator) else A, self.device
            )
            return t if version_tracked(t) else t.clone()
        if kind == "sparse":
            if isinstance(A, linop.SparseOperator):
                held = (A.rows, A.cols, A.vals)
                if all(version_tracked(t) for t in held):
                    return A
                return linop.SparseOperator.from_entries(
                    *(t.clone() for t in held), A.shape, device=self.device
                )
            M = A.to(self.device)
            return M if version_tracked(M) else M.clone()
        return A  # matrix-free: the caller's token names the content

    def _build_session(self, A, fp: Fingerprint) -> SketchedSolver:
        return SketchedSolver(
            self._session_data(A), self._next_key(), sketch=fp.sketch,
            sketch_size=fp.sketch_size, reg=fp.reg,
            atol=self.session_tol, btol=self.session_tol,
            iter_lim=self.iter_lim, max_distortion=self.max_distortion,
            device=self.device,
        )

    def _ensure_certified_embedding(self, session: SketchedSolver) -> bool:
        """Embedding-level certificate, escalating in place on failure."""
        if session.certificate is None:
            session._recertify_after_update()
        return bool(session.certificate.passed)

    def _spectrum(self, session: SketchedSolver):
        """(smax, smin, cond, floor) of the CURRENT factor, cached on it."""
        cached = getattr(session, "_serve_spectrum", None)
        if cached is not None and cached[0] is session.factor:
            return cached[1:]
        smax, smin, cond = certify_lib.factor_spectrum(session.factor)
        floor = certify_lib.probe_spectrum_floor(
            session._solve_op, session.factor
        )
        session._serve_spectrum = (session.factor, smax, smin, cond, floor)
        return smax, smin, cond, floor

    def _certify_columns(self, session: SketchedSolver, B, X, rtols):
        """Per-column Certificates from ONE blocked posterior pass.

        The embedding pieces (distortion probe, spectrum, floor) are
        cached per factor; only ‖Yᵀr̂‖ is per-request, and the whole
        batch shares one matmat/rmatmat/triangular-solve trio.  ``rtols``
        may be shorter than B's width (padding columns get no
        certificate).  Everything lands on the host in ONE transfer and
        the Certificate assembly is host-side.
        """
        emb = session.certificate
        smax, smin, cond, floor = self._spectrum(session)
        if session.reg is not None:
            n = session.A.shape[1]
            B = torch.cat([B, B.new_zeros((n, B.shape[1]))], 0)
        wg, rn, bounds, rels = _certify_block(
            session._solve_op, session.factor, B, X, emb.distortion,
            smin, floor,
        )
        k = len(rtols)
        dtype = wg.dtype
        head = torch.stack([emb.distortion.to(dtype), cond.to(dtype),
                            emb.passed.to(dtype)])
        host = torch.cat([head, torch.stack([wg, rn, bounds, rels])[:, :k].reshape(-1)]).cpu()
        distortion, cond_h, emb_ok = host[0], host[1], bool(host[2])
        wg, rn, bounds, rels = host[3:].reshape(4, k)
        target = torch.tensor(rtols, dtype=dtype)
        passed = torch.isfinite(rels) & (rels <= target) & emb_ok
        return [
            certify_lib.Certificate(
                distortion=distortion, cond_R=cond_h, rnorm=rn[j],
                whitened_arnorm=wg[j], error_bound=bounds[j],
                rel_error_bound=rels[j], target=target[j], passed=passed[j],
                sketch_rows=session.sketch_size,
                escalations=session.escalations,
            )
            for j in range(k)
        ]

    def _dispatch_session(self, fp: Fingerprint, reqs: list[_Request]) -> int:
        now = time.monotonic()
        live = []
        for r in reqs:
            if r.deadline is not None and now > r.deadline:
                self._reject(r, "deadline expired while queued", "session",
                             False, len(reqs))
            else:
                live.append(r)
        if not live:
            return len(reqs)
        session, hit = self.cache.get_or_build(
            fp, lambda: self._build_session(live[0].A, fp)
        )
        emb_ok = self._ensure_certified_embedding(session)
        k = len(live)
        # Pad the RHS block up the power-of-two ladder (duplicating the
        # last column), as the reference does to bound its compiles: the
        # duplicate columns ride the same Y-bound gemms nearly for free,
        # the batch widths stay those ``prewarm`` runs, and each response
        # is its column of a block solve of width k_pad.
        k_pad = min(_next_pow2(k), self.sessions.max_batch)
        with obs_trace.span("serve.solve", k=k, k_pad=k_pad, cache_hit=hit):
            if k_pad == 1:
                res = session.solve(live[0].b)
                B_full = live[0].b[:, None]
                X = res.x[:, None]
            else:
                B_full = torch.stack(
                    [r.b for r in live] + [live[-1].b] * (k_pad - k), dim=1
                )
                res = session.solve_many(B_full)
                X = res.x
            obs_trace.maybe_block(X)
        with obs_trace.span("serve.certify", k=k):
            certs = self._certify_columns(
                session, B_full, X, [r.rtol for r in live]
            )
        host = self._host_columns(X, res, k_pad)
        for j, r in enumerate(live):
            cert = certs[j]
            res_j = self._slice_result(res, host, j)._replace(certificate=cert)
            if bool(cert.passed):
                self._resolve(r, res_j, cert, "session", hit, k)
                continue
            if not emb_ok:
                reason = (
                    "embedding could not be certified even at the maximum "
                    f"sketch size (distortion {float(cert.distortion):.3f})"
                )
            else:
                reason = None
            self._retry_slow(r, fp, reason, batch_size=k, cache_hit=hit,
                             fast_cert=cert)
        return len(reqs)

    @staticmethod
    def _host_columns(X, res, k_pad):
        """X (n, k_pad) and the per-column istop/itn/rnorm/arnorm/fallback
        of a solve, in one device→host transfer."""
        dtype = X.dtype
        cols = [
            torch.broadcast_to(v.to(dtype).reshape(-1), (k_pad,))
            for v in (res.istop, res.itn, res.rnorm, res.arnorm, res.used_fallback)
        ]
        host = torch.cat([X, torch.stack(cols)], 0).cpu()
        return host[: X.shape[0]], host[X.shape[0]:]

    @staticmethod
    def _slice_result(res, host, j) -> SolveResult:
        X_host, stats = host
        istop, itn, rnorm, arnorm, fb = stats[:, j]
        return res._replace(
            x=X_host[:, j], istop=istop.to(torch.int32), itn=itn.to(torch.int32),
            rnorm=rnorm, arnorm=arnorm, used_fallback=fb.to(torch.bool),
        )

    def _retry_slow(
        self, r: _Request, fp: Fingerprint, forced_reason: str | None,
        *, batch_size: int, cache_hit: bool, fast_cert,
    ):
        """Fast-path certificate failed: per-request certified lstsq on
        the request's own A (moved to the service's device by ``lstsq``;
        a card tensor is not copied), with deadline-aware graceful
        rejection."""
        if forced_reason is not None:
            self._reject(r, forced_reason, "session", cache_hit, batch_size)
            return
        now = time.monotonic()
        if r.deadline is not None and now > r.deadline:
            self._reject(
                r,
                f"certificate for rtol={r.rtol:.1e} not met in deadline "
                f"(best bound {float(fast_cert.rel_error_bound):.2e})",
                "session", cache_hit, batch_size,
            )
            return
        with self._lock:
            self.counters["slow_path"] += 1
        with obs_trace.span("serve.slow_path", rtol=r.rtol):
            res = lstsq(
                r.A, r.b, self._next_key(), accuracy="certified",
                certified_rtol=r.rtol, reg=r.reg, sketch=fp.sketch,
                device=self.device,
            )
        cert = res.certificate
        if cert is not None and bool(cert.passed):
            self._resolve(r, res._replace(x=res.x.cpu()), cert, "slow",
                          cache_hit, batch_size)
        else:
            bound = (
                float(cert.rel_error_bound) if cert is not None else float("nan")
            )
            self._reject(
                r,
                f"certificate for rtol={r.rtol:.1e} unattainable (full "
                f"escalation ladder exhausted; best bound {bound:.2e})",
                "slow", cache_hit, batch_size,
            )

    # -------------------------------------------------------------- buckets
    def _dispatch_bucket(self, key, reqs: list[_Request]) -> int:
        m_pad, n_pad, _ = key
        now = time.monotonic()
        live = []
        for r in reqs:
            if r.deadline is not None and now > r.deadline:
                self._reject(r, "deadline expired while queued", "bucket",
                             False, len(reqs))
            else:
                live.append(r)
        if not live:
            return len(reqs)
        pads = [
            pad_problem(
                backend_lib.as_tensor(
                    r.A.A if isinstance(r.A, linop.DenseOperator) else r.A,
                    self.device,
                ),
                r.b, m_pad, n_pad,
            )
            for r in live
        ]
        A_stack = torch.stack([p[0] for p in pads])
        b_stack = torch.stack([p[1] for p in pads])
        dtype = A_stack.dtype
        lam = torch.tensor([r.reg or 0.0 for r in live], dtype=dtype,
                           device=self.device)
        with obs_trace.span("serve.solve", k=len(live), method="bucket"):
            out = solve_bucket(A_stack, b_stack, lam, certify=True)
            obs_trace.maybe_block(out["x"])
        k = len(live)
        xn = torch.clamp(torch.linalg.vector_norm(out["x"], dim=1),
                         min=torch.finfo(dtype).tiny)
        cols = ("rnorm", "whitened_arnorm", "error_bound", "cond")
        host = torch.cat(
            [out["x"], torch.stack([out[c] for c in cols] + [out["error_bound"] / xn], 1)],
            1,
        ).cpu()
        x_h, (rnorm, wg, bound, cond, rel) = host[:, :n_pad], host[:, n_pad:].T
        target = torch.tensor([r.rtol for r in live], dtype=dtype)
        passed = torch.isfinite(rel) & (rel <= target)
        zero = torch.zeros((), dtype=dtype)
        for j, r in enumerate(live):
            # Direct QR answers certify with ZERO embedding distortion —
            # R here is A_aug's own triangular factor, so the bound is
            # deterministic (module docstring of serve.batching).
            cert = certify_lib.Certificate(
                distortion=zero, cond_R=cond[j], rnorm=rnorm[j],
                whitened_arnorm=wg[j], error_bound=bound[j],
                rel_error_bound=rel[j], target=target[j], passed=passed[j],
                sketch_rows=m_pad + n_pad, escalations=0,
            )
            res = SolveResult(
                x=x_h[j, : r.raw_shape[1]], istop=torch.tensor(1, dtype=torch.int32),
                itn=torch.tensor(0, dtype=torch.int32), rnorm=rnorm[j],
                arnorm=torch.tensor(float("nan"), dtype=dtype),
                used_fallback=torch.tensor(False), method="bucket_direct",
                certificate=cert,
            )
            if bool(cert.passed):
                self._resolve(r, res, cert, "bucket", False, k)
            else:
                self._reject(
                    r,
                    f"rtol={r.rtol:.1e} is below direct-QR attainable "
                    f"accuracy for this problem (posterior bound "
                    f"{float(rel[j]):.2e}); no tighter method exists",
                    "bucket", False, k,
                )
        return len(reqs)

    # ------------------------------------------------------------ responses
    def _queued_s(self, r, now: float) -> float:
        # Queue wait = submit → the pump popping the request's batch; a
        # request answered without ever being popped charges its whole
        # life to the queue.
        t_dispatch = r.t_dispatch if r.t_dispatch is not None else now
        return max(0.0, t_dispatch - r.t_submit)

    def _resolve(self, r, res, cert, path, hit, batch):
        now = time.monotonic()
        with self._lock:
            self.counters["ok"] += 1
        queued_s = self._queued_s(r, now)
        latency_s = now - r.t_submit
        self._h_queued.observe(queued_s)
        self._h_latency.observe(latency_s)
        r.future.set_result(SolveResponse(
            status="ok", x=res.x, result=res, certificate=cert, reason=None,
            path=path, cache_hit=hit, batch_size=batch,
            queued_s=queued_s, latency_s=latency_s,
        ))

    def _reject(self, r, reason, path, hit, batch):
        now = time.monotonic()
        with self._lock:
            self.counters["rejected"] += 1
        queued_s = self._queued_s(r, now)
        latency_s = now - r.t_submit
        self._h_queued.observe(queued_s)
        self._h_latency.observe(latency_s)
        obs_trace.instant("serve.reject", path=path, reason=reason)
        r.future.set_result(SolveResponse(
            status="rejected", x=None, result=None, certificate=None,
            reason=reason, path=path, cache_hit=hit, batch_size=batch,
            queued_s=queued_s, latency_s=latency_s,
        ))

    # ---------------------------------------------------------------- stats
    def stats(self) -> dict:
        # ONE consistent snapshot: the counters dict, both batchers'
        # occupancy/pending and the bucket-key census are read under a
        # single acquisition of the service lock, so a stats() poll racing
        # the pump never sees a batch counted in ``session_batches`` whose
        # requests are still missing from ``ok``/``rejected``.  The cache
        # keeps its own lock and is snapshotted after.
        with self._lock:
            counters = dict(self.counters)
            occ = OrderedDict(
                session_occupancy=self.sessions.mean_occupancy,
                bucket_occupancy=self.buckets.mean_occupancy,
            )
            pending = self.sessions.pending + self.buckets.pending
            bucket_executables = len(self._bucket_keys)
        return {
            **counters,
            **occ,
            "pending": pending,
            "bucket_executables": bucket_executables,
            "cache": self.cache.stats(),
        }
