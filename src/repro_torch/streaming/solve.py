"""Two-pass streaming solvers: least squares without ever holding A.

Port of ``repro/streaming/solve.py``.  Pass 1 streams the row tiles once
and assembles the sketch B = S·A and c = S·b from the same stream (b rides
along as column n + 1 of each tile), then QR-factors the small (s, n) B
into the shared :class:`repro_torch.core.precond.SketchedFactor`.  Pass 2
re-streams the tiles for the iteration's products with A — ``A@v`` by
placing per-tile products, ``Aᵀ@u`` by adding per-tile adjoint products in
tile order (cuBLAS gemv/gemm on each tile) — so the solver holds one tile
(two while the next is staged), the sketch and a few n- and m-vectors.

Methods (``stream_lstsq(source, b, gen, method=...)``):

- ``"saa"``              — preconditioned LSQR on Y = A R⁻¹, warm-started
  at z₀ = Qᵀ(Sb): two streams per iteration;
- ``"iterative"``        — iterative sketching with damping and momentum,
  the forward-stable default: one fused stream per iteration (residual
  tile, then its adjoint product);
- ``"sketch_and_solve"`` — pass 1 only: x̂ = R⁻¹Qᵀ(Sb), with nan
  ``rnorm``/``arnorm`` (a second pass would be needed for them).

``method="auto"`` picks ``"iterative"`` (``"saa"`` with ``certify=True``).
``reg=λ`` solves the ridge problem through the exact [B; √λI] / [c; 0]
augmentation of the sketched system, with the diagnostics of the original
ridge problem.  ``certify=True`` attaches a posterior certificate from the
same pass-1 sketch: one stream for the blocked distortion probes, one for
the residual and gradient.

Draws come from one ``torch.Generator`` on the solve's device, in the order
of the in-memory ``lstsq``: S, then (with ``certify=True``) the probe
matrix W; so ``stream_lstsq(src, b, gen)`` and ``lstsq(A, b, gen)`` from the
same seed use the same S.  The Gaussian S is drawn unmaterialized and each
tile's block comes from kernel B4 with a column offset.  Every tile reaches
the device through ``sources.device_tiles``.

:class:`StreamingSolver` is the session form: one pass-1 sketch and QR,
served to many ``solve``/``solve_many`` calls, with ``stats`` (``sketches``,
``qr_factorizations``, ``solves``, ``passes``, ``tiles``) kept through
``REGISTRY.stats_dict("streaming", ...)``.

Spans (``repro_torch.obs.trace``), as the reference names them:
``stream_lstsq``, ``stream.pass1`` with one ``stream.tile`` per tile,
``factor.qr``, ``stream.solve`` with one ``stream.iter`` per iteration,
``stream.pass2`` per product stream, ``certify.streamed``, and the
session's ``streaming.solve`` / ``streaming.solve_many``.

``cluster=ClusterSpec(...)`` (or a prebuilt ``ClusterEngine``) runs every
stream across the worker pool of ``repro_torch.cluster``: a source with a
cluster engine's hooks (``cluster_sketch``, ``matvec``, ``rmatvec``,
``residual_grad``) takes pass 1 and each pass-2 product through them.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core import backend as backend_lib
from ..core import certify as certify_lib
from ..core import sketch as sketch_lib
from ..core.iterative import _IMPROVE_FACTOR, _STALL_LIMIT, _StepFloor, damping_momentum
from ..core.precond import SketchedFactor, default_sketch_size
from ..core.result import SolveResult
from ..obs import trace as obs_trace
from ..obs.metrics import REGISTRY
from .accumulate import make_accumulator
from .sources import RowSource, as_source, device_tiles, solve_device

__all__ = ["stream_lstsq", "stream_sketch", "StreamingSolver", "STREAM_METHODS"]

STREAM_METHODS = ("saa", "iterative", "sketch_and_solve")
_ALIASES = {"sketch": "sketch_and_solve", "single_pass": "sketch_and_solve"}


def _maybe_cluster(source, cluster, backend, counters=None, device=None):
    """Wrap ``source`` in a ``ClusterEngine`` when a spec or engine was given.

    Returns ``(source, owned)``: ``owned`` is the engine THIS call built
    (the caller must ``close()`` it when done, or its worker threads and
    temp checkpoint dir outlive the solve), or ``None`` when the source
    passed through or the engine was the caller's (left open for reuse).
    Lazy import: ``repro_torch.cluster`` imports the streaming layer.
    """
    if cluster is None:
        return source, None
    from ..cluster.coordinator import ClusterEngine

    if isinstance(cluster, ClusterEngine):
        if counters is not None and cluster.counters is None:
            cluster.counters = counters
        return cluster, None
    engine = ClusterEngine(source, cluster, backend=backend, counters=counters, device=device)
    return engine, engine


def _operator(source, key, sketch, sketch_size, device):
    """The sketch operator: drawn from ``key`` for a kind name (the
    Gaussian unmaterialized), or the drawn operator given as ``sketch``."""
    m, n = source.shape
    if not isinstance(sketch, str):
        if sketch_size is not None and sketch_size != sketch.d:
            raise ValueError(f"sketch_size={sketch_size} but the operator has d = {sketch.d}")
        if sketch.device != device:
            raise ValueError(f"sketch operator is on {sketch.device}, the solve on {device}")
        return sketch
    if key is None:
        raise ValueError("stream_sketch needs a key (torch.Generator) or an operator")
    s = sketch_size if sketch_size is not None else default_sketch_size(n, m)
    kw = {"materialize": False} if sketch == "gaussian" else {}
    gen = backend_lib.as_generator(key, device)
    return sketch_lib.sample(sketch, gen, s, m, dtype=source.dtype, device=device, **kw)


# --------------------------------------------------------------------------
# Pass 1: streamed sketch assembly
# --------------------------------------------------------------------------


def stream_sketch(source, key=None, *, op=None, sketch="clarkson_woodruff",
                  sketch_size: int | None = None, backend: str = "auto",
                  rhs: torch.Tensor | None = None, device=None):
    """One pass over the tiles → ``(B, op, c)`` with B = S·A, c = S·rhs.

    Draws the operator from ``key`` as the in-memory solvers do (the same
    generator state gives the same S), or reuses ``op`` (or an operator
    passed as ``sketch``).  ``rhs`` rides along as an extra column of each
    tile, so sketch-and-solve costs exactly one pass over A.  ``device=None``
    means ``"cuda"``.
    """
    source = as_source(source)
    m, n = source.shape
    dev = solve_device(device)
    op = _operator(source, key, op if op is not None else sketch, sketch_size, dev)
    if op.m != m:
        raise ValueError(f"operator over m={op.m} rows, source has m={m}")
    if rhs is not None and tuple(rhs.shape) != (m,):
        raise ValueError(f"rhs must have shape ({m},), got {tuple(rhs.shape)}")
    ncols = n + (1 if rhs is not None else 0)
    cluster_sketch = getattr(source, "cluster_sketch", None)
    if callable(cluster_sketch):
        # a ClusterEngine source: pass 1 fans out over the worker pool
        # (checkpointed, fault-tolerant) and merges to the same sketch
        with obs_trace.span("stream.pass1", mode="cluster", rows=m):
            Bc = cluster_sketch(op, rhs=rhs, backend=backend)
            obs_trace.maybe_block(Bc)
    else:
        with obs_trace.span("stream.pass1", mode="serial", rows=m):
            acc = make_accumulator(op, ncols, dtype=source.dtype, backend=backend)
            for offset, tile in device_tiles(source, dev):
                with obs_trace.span("stream.tile", offset=offset):
                    if rhs is not None:
                        t = tile.shape[0]
                        tile = torch.cat([tile, rhs[offset : offset + t, None].to(tile.dtype)], dim=1)
                    acc.update(tile, offset)
                    obs_trace.maybe_block(tile)
            Bc = acc.finalize()
            obs_trace.maybe_block(Bc)
    if rhs is None:
        return Bc, op, None
    # contiguous, as the in-memory sketches are: the products that read B
    # and c then take the same routes on the same bits
    return Bc[:, :n].contiguous(), op, Bc[:, n].contiguous()


# --------------------------------------------------------------------------
# Pass 2: blocked products with A
# --------------------------------------------------------------------------


def _stream_matvec(source, x):
    """A @ x by placing per-tile products (exact placement, no summation).

    A source that distributes the product itself (``ClusterEngine``) has a
    ``matvec`` method, which takes precedence over the serial tile loop;
    the same holds for ``rmatvec`` and ``residual_grad`` below.
    """
    mv = getattr(source, "matvec", None)
    with obs_trace.span("stream.pass2", op="matvec"):
        if callable(mv):
            return obs_trace.maybe_block(mv(x))
        out = torch.empty((source.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
        for offset, tile in device_tiles(source, x.device):
            torch.matmul(tile, x, out=out[offset : offset + tile.shape[0]])
        return obs_trace.maybe_block(out)


def _stream_rmatvec(source, u):
    """Aᵀ @ u by adding per-tile adjoint products in tile order."""
    rmv = getattr(source, "rmatvec", None)
    with obs_trace.span("stream.pass2", op="rmatvec"):
        if callable(rmv):
            return obs_trace.maybe_block(rmv(u))
        g = torch.zeros((source.shape[1],) + tuple(u.shape[1:]), dtype=u.dtype, device=u.device)
        for offset, tile in device_tiles(source, u.device):
            g = g + tile.T @ u[offset : offset + tile.shape[0]]
        return obs_trace.maybe_block(g)


def _stream_residual_grad(source, b, x):
    """ONE fused pass: (‖b − Ax‖², Aᵀ(b − Ax)).

    The residual tile feeds the adjoint product before the next tile is
    read, so an iterative-sketching step reads A once.  Generic over
    stacked right-hand sides (b (m, k), x (n, k)): the squared norms come
    back per column.
    """
    rg = getattr(source, "residual_grad", None)
    with obs_trace.span("stream.pass2", op="residual_grad"):
        if callable(rg):
            out = rg(b, x)
            obs_trace.maybe_block(out)
            return out
        g = torch.zeros((source.shape[1],) + tuple(b.shape[1:]), dtype=b.dtype, device=b.device)
        rn2 = torch.zeros(tuple(b.shape[1:]), dtype=b.dtype, device=b.device)
        for offset, tile in device_tiles(source, b.device):
            r_t = b[offset : offset + tile.shape[0]] - tile @ x
            g = g + tile.T @ r_t
            rn2 = rn2 + torch.sum(r_t * r_t, dim=0)
        obs_trace.maybe_block(g)
        return rn2, g


# --------------------------------------------------------------------------
# Host-loop solvers (the products are streamed, so each iteration is a
# Python loop step; one host read per iteration)
# --------------------------------------------------------------------------


def _lsqr_streamed(mv, rmv, b, x0, *, atol, btol, steptol, iter_lim, history=False):
    """Column-batched Golub–Kahan LSQR with streamed products.

    The reference's host-loop LSQR (stopping tests 1/2/7/8, warm-started
    on the correction against r₀ = b − A x₀), over stacked right-hand
    sides: the bidiagonalization scalars are per-column (k,) tensors while
    the two products per iteration are shared.  Converged columns keep
    iterating (their updates are ~0) until the slowest stops; ``istop``
    records each column's own reason.  One host read per iteration.

    A 1-D ``b`` is the k = 1 case and returns 0-d results.
    """
    vec = b.ndim == 1
    B = b[:, None] if vec else b
    X0 = x0[:, None] if vec else x0
    k = B.shape[1]
    dtype, dev = B.dtype, B.device
    tiny = torch.finfo(dtype).tiny

    def cnorm(M):
        return torch.sqrt(torch.sum(M * M, dim=0))  # per-column norms (k,)

    def safe(s):
        return torch.where(s > 0, s, torch.ones_like(s))

    bnorm = cnorm(B)
    R0 = B - mv(X0)
    beta = cnorm(R0)
    U = R0 / safe(beta)
    V_raw = rmv(U)
    alfa = cnorm(V_raw)
    V = V_raw / safe(alfa)
    W = V
    X = torch.zeros_like(V)
    rhobar, phibar = alfa, beta
    anorm2 = torch.zeros((k,), dtype=dtype, device=dev)
    arnorm = alfa * beta
    rnorm = beta

    istop = np.zeros(k, np.int32)
    # columns that are trivially solved (b = 0 or already at the optimum)
    istop[((bnorm == 0) | (arnorm == 0)).cpu().numpy()] = -1
    itn = 0
    n_small = np.zeros(k, np.int64)
    min_step = np.full(k, np.inf)
    n_stall = np.zeros(k, np.int64)
    rhist = []
    while (istop == 0).any() and itn < iter_lim:
        itn += 1
        with obs_trace.span("stream.iter", itn=itn, method="saa"):
            U_raw = mv(V) - alfa * U
            beta_k = cnorm(U_raw)
            U = U_raw / safe(beta_k)
            anorm2 = anorm2 + alfa**2 + beta_k**2
            V_raw = rmv(U) - beta_k * V
            alfa_k = cnorm(V_raw)
            V = V_raw / safe(alfa_k)

            rho = torch.hypot(rhobar, beta_k)
            c = torch.where(rho > 0, rhobar / safe(rho), 1.0)
            sn = torch.where(rho > 0, beta_k / safe(rho), 0.0)
            theta = sn * alfa_k
            phi = c * phibar
            arnorm = alfa_k * torch.abs(sn * phibar)  # pre-update phibar
            t1 = torch.where(rho > 0, phi / safe(rho), 0.0)
            t2 = torch.where(rho > 0, -theta / safe(rho), 0.0)
            step = torch.abs(t1) * cnorm(W)
            X = X + t1 * W
            W = V + t2 * W
            rhobar = -c * alfa_k
            phibar = sn * phibar
            alfa = alfa_k

            rnorm = phibar
            anorm = torch.sqrt(anorm2)
            xnorm = cnorm(X + X0)
            tests = torch.stack([
                rnorm / safe(bnorm),  # test1
                arnorm / safe(anorm * rnorm),  # test2
                btol + atol * anorm * xnorm / safe(bnorm),  # rtol
                step / torch.clamp(xnorm, min=tiny),  # relstep
                step,
            ]).cpu().numpy()  # the host read of this iteration
            test1, test2, rtol, relstep, stepn = tests
            if history:
                rhist.append(rnorm[0] if vec else rnorm)

            n_small = np.where((steptol > 0) & (relstep <= steptol), n_small + 1, 0)
            n_stall = np.where(stepn < _IMPROVE_FACTOR * min_step, 0, n_stall + 1)
            min_step = np.minimum(min_step, stepn)

            new = np.full(k, 7 if itn >= iter_lim else 0, np.int32)
            new = np.where((n_small >= 3) | (n_stall >= _STALL_LIMIT), 8, new)
            new = np.where(test2 <= atol, 2, new)
            new = np.where(test1 <= rtol, 1, new)
            istop = np.where(istop == 0, new, istop)

    X = X + X0
    istop = np.where(istop == -1, 0, istop)  # trivial columns: SciPy's code 0
    if vec:
        return X[:, 0], int(istop[0]), itn, rnorm[0], arnorm[0], rhist
    return X, istop, itn, rnorm, arnorm, rhist


def _iterative_streamed(source, b, factor, x0, *, alpha, beta, reg, atol, btol, steptol,
                        iter_lim, history=False):
    """Heavy-ball iterative sketching, one fused stream per iteration (the
    reference's host-loop ``iterative_sketching``), its step floor the
    port's ``core.iterative._StepFloor``.  Block mode (stacked right-hand
    sides) takes Frobenius norms and runs until the slowest column's
    floor.  One host read per iteration."""
    dtype, dev = b.dtype, b.device
    lam = None if reg is None else torch.as_tensor(reg, dtype=dtype, device=dev)
    bnorm = torch.linalg.vector_norm(b)
    anorm = torch.linalg.vector_norm(factor.R)  # ‖R‖_F ≈ ‖A‖_F
    tiny = torch.finfo(dtype).tiny
    x, x_prev = x0, x0
    istop, itn = 0, 0
    floor = _StepFloor.init(dtype, dev)
    rhist = []
    if float(bnorm) == 0.0:
        return torch.zeros_like(x0), 0, 0, bnorm, 0.0, rhist
    while istop == 0 and itn < iter_lim:
        itn += 1
        with obs_trace.span("stream.iter", itn=itn, method="iterative"):
            rn2, g = _stream_residual_grad(source, b, x)
            if lam is not None:
                # [A; √λI]x ≈ [b; 0]: the tail adds −λx to the gradient and
                # λ‖x‖² to the squared residual
                rn2 = rn2 + lam * torch.sum(x * x, dim=0)
                g = g - lam * x
            rnorm = torch.sqrt(torch.sum(rn2))
            arnorm = torch.linalg.vector_norm(g)
            dx = alpha * factor.normal_solve(g) + beta * (x - x_prev)
            x_prev, x = x, x + dx

            xnorm = torch.linalg.vector_norm(x)
            stepnorm = torch.linalg.vector_norm(dx)
            relstep = stepnorm / torch.clamp(xnorm, min=tiny)
            floor, reached = floor.update(stepnorm, relstep, steptol)
            prod = anorm * rnorm
            test1 = rnorm / bnorm
            test2 = arnorm / torch.where(prod > 0, prod, torch.ones_like(prod))
            rtol = btol + atol * anorm * xnorm / bnorm
            # precedence as the reference: 1 over 2 over 8 over 7
            code = torch.full((), 7 if itn >= iter_lim else 0, dtype=torch.int32, device=dev)
            code = torch.where(reached, 8, code)
            code = torch.where(test2 <= atol, 2, code)
            code = torch.where(test1 <= rtol, 1, code)
            if history:
                rhist.append(rnorm)
            istop = int(code)  # the host read of this iteration
    return x, istop, itn, None, None, rhist


# --------------------------------------------------------------------------
# Driver
# --------------------------------------------------------------------------


def _final_diagnostics(source, b, x, reg):
    """(rnorm, arnorm) of the ORIGINAL system at x — one fused pass."""
    rn2, g = _stream_residual_grad(source, b, x)
    if reg is not None:
        g = g - torch.as_tensor(reg, dtype=b.dtype, device=b.device) * x
    return torch.sqrt(rn2), torch.linalg.vector_norm(g)


def _certify_streamed(source, b, x, factor, key, *, lam, sketch_rows, n_probes=8, target=None):
    """Streamed posterior certificate from the pass-1 sketch: the probe
    matrix W (n × ``n_probes``) is the next draw of ``key``
    (``certify._draw_probes``), then :func:`_certify_streamed_w`."""
    W = certify_lib._draw_probes(factor, key, n_probes)
    return _certify_streamed_w(source, b, x, factor, W, lam=lam, sketch_rows=sketch_rows,
                               target=target)


def _certify_streamed_w(source, b, x, factor, W, *, lam, sketch_rows, target=None):
    """:func:`_certify_streamed` with the probe matrix W given.

    One stream evaluates every whitened distortion probe as a blocked
    matvec (‖S A R⁻¹w‖ = ‖w‖ exactly, so only ‖A R⁻¹w‖ needs A), and one
    fused stream gives the residual and gradient for the forward-error
    bound.  Ridge certificates are for [A; √λI], whose solution is the
    ridge solution; the √λ terms are exact column arithmetic.

    Returns ``(certificate, rnorm, arnorm)``, the latter two the ORIGINAL
    system's diagnostics of the same fused pass.
    """
    dtype = b.dtype
    with obs_trace.span("certify.streamed", n_probes=int(W.shape[1])):
        V = factor.precondition(W)
        AV = _stream_matvec(source, V)  # one pass serves every probe
        yn2 = torch.sum(AV * AV, dim=0)
        if lam is not None:
            yn2 = yn2 + lam * torch.sum(V * V, dim=0)
        wn = torch.linalg.vector_norm(W, dim=0)
        ratios = wn / torch.clamp(torch.sqrt(yn2), min=torch.finfo(dtype).tiny)
        eps_hat = torch.max(torch.abs(ratios - 1.0))

        rn2, g = _stream_residual_grad(source, b, x)
        rn2_aug = rn2
        if lam is not None:
            rn2_aug = rn2 + lam * torch.sum(x * x)
            g = g - lam * x  # the ridge gradient, also the augmented system's
        wg = factor.rt_solve(g)
        cert = certify_lib.build_certificate(
            factor, distortion=eps_hat, rnorm=torch.sqrt(rn2_aug),
            whitened_arnorm=torch.linalg.vector_norm(wg), xnorm=torch.linalg.vector_norm(x),
            target=target, sketch_rows=sketch_rows,
        )
        obs_trace.maybe_block(cert.passed)
    return cert, torch.sqrt(rn2), torch.linalg.vector_norm(g)


def _augment(B, lam):
    """[B; √λI]: the exact ridge rows of the sketch, never streamed."""
    eye = torch.eye(B.shape[1], dtype=B.dtype, device=B.device)
    return torch.cat([B, torch.sqrt(lam) * eye], dim=0)


def _augment_rhs(b, lam, n):
    """[b; 0] under ridge (n zero rows; b a vector or a block), else b."""
    if lam is None:
        return b
    return torch.cat([b, torch.zeros((n,) + tuple(b.shape[1:]), dtype=b.dtype, device=b.device)])


def _whitened_ops(source, factor, lam, m):
    """(mv, rmv) of the whitened — and, under ridge, augmented — system,
    for single vectors and stacked columns alike."""
    if lam is None:
        def mv(z):
            return _stream_matvec(source, factor.precondition(z))

        def rmv(u):
            return factor.rt_solve(_stream_rmatvec(source, u))
    else:
        sqrt_lam = torch.sqrt(lam)

        def mv(z):
            v = factor.precondition(z)
            return torch.cat([_stream_matvec(source, v), sqrt_lam * v])

        def rmv(u):
            return factor.rt_solve(_stream_rmatvec(source, u[:m]) + sqrt_lam * u[m:])
    return mv, rmv


def stream_lstsq(
    source,
    b,
    key=None,
    *,
    method: str = "auto",
    sketch="clarkson_woodruff",
    sketch_size: int | None = None,
    reg=None,
    atol: float = 0.0,
    btol: float = 0.0,
    steptol: float | None = None,
    iter_lim: int = 100,
    backend: str = "auto",
    history: bool = False,
    tile_rows: int | None = None,
    certify: bool = False,
    certified_rtol: float | None = None,
    certified_probes: int = 8,
    cluster=None,
    trace: bool | None = None,
    device=None,
) -> SolveResult:
    """min‖Ax − b‖ (+ λ‖x‖² with ``reg=λ``) over a row-streamed A.

    ``source``: anything :func:`repro_torch.streaming.sources.as_source`
    accepts — a ``RowSource``, a tensor or numpy array (tiled at
    ``tile_rows``), or a path to a ``.npy`` file (memory-mapped).  ``key``
    is a ``torch.Generator`` on the solve's device (or an int seed);
    ``sketch`` a kind name or an already-drawn operator.  ``device=None``
    means ``"cuda"``.  A is streamed once for the sketch and once per
    iteration (twice for ``"saa"``).

    ``certify=True`` (also reached through ``lstsq(accuracy="certified")``
    on a row source) attaches a posterior ``Certificate`` built from the
    same pass-1 sketch: one stream for the distortion probes and one fused
    residual/gradient stream (which also fills the diagnostics that
    ``"sketch_and_solve"`` otherwise skips).  No escalation runs
    out-of-core: a failed certificate reports ``passed=False``.

    ``cluster=ClusterSpec(...)`` (or a prebuilt
    ``repro_torch.cluster.ClusterEngine``) runs every stream, the pass-1
    sketch and each pass-2 product, across a fault-tolerant worker pool
    with checkpointed sketch state (``repro_torch.cluster``).  An engine
    built here from a spec is closed before returning (its threads joined,
    its temp checkpoint dir removed); a prebuilt engine stays open for the
    caller to reuse and ``close()``.
    """
    source = as_source(source, tile_rows)
    scope = obs_trace.solve_scope(trace)
    with scope, obs_trace.span("stream_lstsq"):
        source, owned = _maybe_cluster(source, cluster, backend, device=device)
        try:
            res = _stream_lstsq_impl(
                source, b, key, method=method, sketch=sketch, sketch_size=sketch_size, reg=reg,
                atol=atol, btol=btol, steptol=steptol, iter_lim=iter_lim, backend=backend,
                history=history, certify=certify, certified_rtol=certified_rtol,
                certified_probes=certified_probes, device=device,
            )
        finally:
            if owned is not None:
                owned.close()
    return scope.attach(res)


def _stream_lstsq_impl(source, b, key, *, method, sketch, sketch_size, reg, atol, btol, steptol,
                       iter_lim, backend, history, certify, certified_rtol, certified_probes,
                       device) -> SolveResult:
    m, n = source.shape
    dev = solve_device(device)
    b = backend_lib.as_tensor(b, dev, source.dtype)
    if tuple(b.shape) != (m,):
        raise ValueError(f"b must have shape ({m},), got {tuple(b.shape)}")
    method = _ALIASES.get(method, method)
    if method == "auto":
        # certified runs take the whitened LSQR: it iterates to the
        # numerical floor, which the heavy-ball tail may leave short of
        method = "saa" if certify else "iterative"
    if method not in STREAM_METHODS:
        raise ValueError(
            f"unknown streaming method {method!r}; have {('auto',) + STREAM_METHODS} "
            "(direct/lsqr/sap/fossils need the in-memory lstsq)"
        )
    if key is None and isinstance(sketch, str):
        raise ValueError("stream_lstsq needs a key (torch.Generator): all methods sketch")
    gen = None if key is None else backend_lib.as_generator(key, dev)
    if steptol is None:
        steptol = 32 * float(torch.finfo(b.dtype).eps)

    # ---- pass 1: sketch A and b together ------------------------------
    B, op, c = stream_sketch(source, gen, sketch=sketch, sketch_size=sketch_size,
                             backend=backend, rhs=b, device=dev)
    s = op.d
    lam = None if reg is None else torch.as_tensor(reg, dtype=b.dtype, device=dev)
    if lam is not None:
        B, c = _augment(B, lam), _augment_rhs(c, lam, n)
    with obs_trace.span("factor.qr", shape=tuple(B.shape)):
        factor = SketchedFactor.from_sketch(B)
        obs_trace.maybe_block(factor.R)
    x0 = factor.sketch_and_solve(c)

    def certificate(x):
        """(certificate, rnorm, arnorm), or Nones when not certifying."""
        if not certify:
            return None, None, None
        if gen is None:
            raise ValueError("certify=True needs a key (torch.Generator) for the probes")
        return _certify_streamed(source, b, x, factor, gen, lam=lam, sketch_rows=s,
                                 n_probes=certified_probes, target=certified_rtol)

    def result(x, istop, itn, rnorm, arnorm, hist, cert):
        return SolveResult(
            x=x,
            istop=torch.tensor(int(istop), dtype=torch.int32, device=dev),
            itn=torch.tensor(int(itn), dtype=torch.int32, device=dev),
            rnorm=torch.as_tensor(rnorm, dtype=b.dtype, device=dev),
            arnorm=torch.as_tensor(arnorm, dtype=b.dtype, device=dev),
            used_fallback=torch.tensor(False, device=dev),
            history=_history(hist, b) if history else None,
            method=f"stream_{method}",
            certificate=cert,
        )

    if method == "sketch_and_solve":
        # pass 1 only, unless a certificate's fused pass fills the diagnostics
        cert, rnorm, arnorm = certificate(x0)
        if cert is None:
            rnorm = arnorm = math.nan
        return result(x0, 1, 0, rnorm, arnorm, [], cert)
    if method == "iterative":
        alpha, beta = damping_momentum(s, n)
        with obs_trace.span("stream.solve", method="iterative"):
            x, istop, itn, _, _, hist = _iterative_streamed(
                source, b, factor, x0, alpha=alpha, beta=beta, reg=lam, atol=atol, btol=btol,
                steptol=steptol, iter_lim=iter_lim, history=history,
            )
        cert, rnorm, arnorm = certificate(x)
        if cert is None:
            rnorm, arnorm = _final_diagnostics(source, b, x, lam)
    else:  # saa: preconditioned LSQR on the whitened system, warm-started
        mv, rmv = _whitened_ops(source, factor, lam, m)
        with obs_trace.span("stream.solve", method="saa"):
            z, istop, itn, rnorm, arnorm, hist = _lsqr_streamed(
                mv, rmv, _augment_rhs(b, lam, n), factor.warm_start(c), atol=atol, btol=btol,
                steptol=steptol, iter_lim=iter_lim, history=history,
            )
        x = factor.precondition(z)
        cert, rnorm_c, arnorm_c = certificate(x)
        if cert is not None:
            rnorm, arnorm = rnorm_c, arnorm_c
        elif lam is not None:
            rnorm, arnorm = _final_diagnostics(source, b, x, lam)
    return result(x, istop, itn, rnorm, arnorm, hist, cert)


def _history(hist, b):
    if not hist:
        return torch.zeros((0,), dtype=b.dtype, device=b.device)
    return torch.stack([torch.as_tensor(h, dtype=b.dtype, device=b.device) for h in hist])


# --------------------------------------------------------------------------
# Session
# --------------------------------------------------------------------------


class _CountingSource(RowSource):
    """Transparent wrapper that counts passes and tiles into a stats dict.

    Unknown attributes forward to the wrapped source, so the probes in
    ``_stream_matvec`` and the others find a ``ClusterEngine``'s methods
    through the wrapper (the engine then counts its own passes and tiles
    through its ``counters`` hook; the serial count here fires only on the
    serial ``tiles()`` path, never both)."""

    def __init__(self, inner: RowSource, stats: dict):
        self.inner = inner
        self.stats = stats
        self.shape = inner.shape
        self.dtype = inner.dtype

    def __getattr__(self, name):
        return getattr(self.__dict__["inner"], name)

    @property
    def tile_rows(self):
        return self.inner.tile_rows

    @property
    def supports_random_access(self):
        return self.inner.supports_random_access

    def read_rows(self, offset, length):
        return self.inner.read_rows(offset, length)

    def tiles(self):
        self.stats["passes"] += 1
        for offset, tile in self.inner.tiles():
            self.stats["tiles"] += 1
            yield offset, tile


class StreamingSolver:
    """One streamed sketch + QR, amortized over many right-hand sides.

    The out-of-core twin of :class:`repro_torch.core.session.SketchedSolver`:
    construction streams the tiles ONCE to build the sketched factor; each
    ``solve(b)`` then costs one sketch of b (a pass over b, not A) plus the
    pass-2 streams.  ``solve_many(B)`` runs the column-batched whitened
    LSQR: k right-hand sides share every stream.  ``key`` is a
    ``torch.Generator`` on the solve's device (or an int seed), ``sketch``
    a kind name or a drawn operator, ``device=None`` means ``"cuda"``.

    ``stats`` counts ``sketches`` / ``qr_factorizations`` / ``solves`` as
    the in-memory session does, plus ``passes`` / ``tiles``.  With
    ``cluster=`` every stream runs on a ``ClusterEngine`` whose counters
    feed ``stats``; ``close()`` (or leaving a ``with`` block) releases an
    engine the session built.
    """

    def __init__(
        self,
        source,
        key,
        *,
        sketch="clarkson_woodruff",
        sketch_size: int | None = None,
        reg=None,
        tile_rows: int | None = None,
        atol: float = 0.0,
        btol: float = 0.0,
        steptol: float | None = None,
        iter_lim: int = 100,
        backend: str = "auto",
        cluster=None,
        device=None,
    ):
        self.stats = REGISTRY.stats_dict("streaming", {
            "sketches": 0, "qr_factorizations": 0, "solves": 0, "passes": 0, "tiles": 0,
        })
        self.device = solve_device(device)
        self.backend = backend_lib.check_backend(backend)
        inner, self._owned_engine = _maybe_cluster(
            as_source(source, tile_rows), cluster, self.backend, counters=self.stats, device=self.device,
        )
        try:
            self.source = _CountingSource(inner, self.stats)
            m, n = self.source.shape
            self.shape = (m, n)
            self.reg = reg
            self._dtype = self.source.dtype
            if steptol is None:
                steptol = 32 * float(torch.finfo(self._dtype).eps)
            self._kw = dict(atol=atol, btol=btol, steptol=steptol, iter_lim=iter_lim)
            self._lam = None if reg is None else torch.as_tensor(reg, dtype=self._dtype, device=self.device)

            gen = None if key is None else backend_lib.as_generator(key, self.device)
            B, self._sketch_op, _ = stream_sketch(
                self.source, gen, sketch=sketch, sketch_size=sketch_size, backend=self.backend,
                device=self.device,
            )
            self.sketch_size = self._sketch_op.d
            self.stats["sketches"] += 1
            if self._lam is not None:
                B = _augment(B, self._lam)
            with obs_trace.span("factor.qr", shape=tuple(B.shape)):
                self.factor = SketchedFactor.from_sketch(B)
                obs_trace.maybe_block(self.factor.R)
            self.stats["qr_factorizations"] += 1
        except BaseException:
            self.close()  # a failed build must not leak the worker pool
            raise

    def close(self):
        """Release a cluster engine this session built from a ``cluster=``
        spec (worker threads and temp checkpoint dir); a no-op otherwise
        and on repeat calls.  A caller-provided engine is never touched."""
        if self._owned_engine is not None:
            self._owned_engine.close()
            self._owned_engine = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------- helpers
    def _sketch_rhs(self, B_rhs: torch.Tensor) -> torch.Tensor:
        """S·b (or S·B for stacked columns), b streamed tile-wise through
        the accumulator (the tiles' cached CSRs; the Gaussian from B4 with
        its column offset): one pass over b only."""
        m, n = self.shape
        cols = B_rhs[:, None] if B_rhs.ndim == 1 else B_rhs
        acc = make_accumulator(self._sketch_op, cols.shape[1], dtype=self._dtype, backend=self.backend)
        step = self.source.tile_rows
        for o in range(0, m, step):
            acc.update(cols[o : o + step], o)
        c = _augment_rhs(acc.finalize(), self._lam, n)
        return c[:, 0] if B_rhs.ndim == 1 else c

    def _rhs(self, b, ndim):
        b = backend_lib.as_tensor(b, self.device, self._dtype)
        m = self.shape[0]
        if ndim == 1 and tuple(b.shape) != (m,):
            raise ValueError(f"b must have shape ({m},), got {tuple(b.shape)}")
        if ndim == 2 and (b.ndim != 2 or b.shape[0] != m):
            raise ValueError(f"solve_many needs B of shape ({m}, k), got {tuple(b.shape)}")
        return b

    # -------------------------------------------------------------- solves
    def solve(self, b, *, method: str = "saa", history: bool = False) -> SolveResult:
        """One right-hand side against the stored factor; ``method`` as in
        :func:`stream_lstsq` (``"saa"``, ``"iterative"``,
        ``"sketch_and_solve"``)."""
        m, n = self.shape
        b = self._rhs(b, 1)
        method = _ALIASES.get(method, method)
        dev = self.device
        with obs_trace.span("streaming.solve", method=method):
            c = self._sketch_rhs(b)
            x0 = self.factor.sketch_and_solve(c)
            if method == "sketch_and_solve":
                nan = torch.tensor(math.nan, dtype=b.dtype, device=dev)
                self.stats["solves"] += 1
                return SolveResult(
                    x=x0, istop=torch.tensor(1, dtype=torch.int32, device=dev),
                    itn=torch.tensor(0, dtype=torch.int32, device=dev), rnorm=nan, arnorm=nan,
                    used_fallback=torch.tensor(False, device=dev),
                    method="stream_sketch_and_solve",
                )
            if method == "iterative":
                alpha, beta = damping_momentum(self.sketch_size, n)
                x, istop, itn, _, _, hist = _iterative_streamed(
                    self.source, b, self.factor, x0, alpha=alpha, beta=beta, reg=self._lam,
                    history=history, **self._kw,
                )
            elif method == "saa":
                mv, rmv = _whitened_ops(self.source, self.factor, self._lam, m)
                z, istop, itn, _, _, hist = _lsqr_streamed(
                    mv, rmv, _augment_rhs(b, self._lam, n), self.factor.warm_start(c),
                    history=history, **self._kw,
                )
                x = self.factor.precondition(z)
            else:
                raise ValueError(f"unknown streaming method {method!r}; have {STREAM_METHODS}")
            rnorm, arnorm = _final_diagnostics(self.source, b, x, self._lam)
        self.stats["solves"] += 1
        return SolveResult(
            x=x, istop=torch.tensor(int(istop), dtype=torch.int32, device=dev),
            itn=torch.tensor(int(itn), dtype=torch.int32, device=dev), rnorm=rnorm, arnorm=arnorm,
            used_fallback=torch.tensor(False, device=dev),
            history=_history(hist, b) if history else None,
            method=f"stream_{method}",
        )

    def solve_many(self, B, *, method: str = "saa") -> SolveResult:
        """k stacked right-hand sides (m, k) → x of shape (n, k).

        Every stream serves all k columns (the per-tile products become
        matrix products).  ``"saa"`` (default) runs the column-batched
        whitened LSQR and iterates until the slowest column stops;
        ``"iterative"`` the block heavy ball on the Frobenius step floor.
        """
        m, n = self.shape
        B = self._rhs(B, 2)
        k = B.shape[1]
        dev = self.device
        method = _ALIASES.get(method, method)
        with obs_trace.span("streaming.solve_many", method=method, k=int(k)):
            C = self._sketch_rhs(B)
            if method == "saa":
                mv, rmv = _whitened_ops(self.source, self.factor, self._lam, m)
                Z, istop, itn, _, _, _ = _lsqr_streamed(
                    mv, rmv, _augment_rhs(B, self._lam, n), self.factor.warm_start(C), **self._kw,
                )
                X = self.factor.precondition(Z)
            elif method == "iterative":
                X0 = self.factor.sketch_and_solve(C)
                alpha, beta = damping_momentum(self.sketch_size, n)
                X, istop, itn, _, _, _ = _iterative_streamed(
                    self.source, B, self.factor, X0, alpha=alpha, beta=beta, reg=self._lam,
                    **self._kw,
                )
                istop = np.full((k,), istop, np.int32)
            else:
                raise ValueError(
                    f"solve_many supports methods ('saa', 'iterative'); got {method!r}"
                )
            rn2, G = _stream_residual_grad(self.source, B, X)
            if self._lam is not None:
                G = G - self._lam * X
        self.stats["solves"] += int(k)
        return SolveResult(
            x=X, istop=torch.as_tensor(np.asarray(istop, np.int32), device=dev),
            itn=torch.tensor(int(itn), dtype=torch.int32, device=dev),
            rnorm=torch.sqrt(rn2), arnorm=torch.linalg.vector_norm(G, dim=0),
            used_fallback=torch.zeros(k, dtype=torch.bool, device=dev),
            method=f"stream_{method}",
        )
