"""``lstsq`` — the one-call driver over the port's least-squares solvers.

Port of ``repro/core/lstsq.py``.  ``lstsq(A, b, gen)`` auto-selects a
solver by shape, sketch-size regime and requested accuracy (or runs the
one ``method=`` forces) and returns the unified ``SolveResult`` with
``.method`` naming the solver that ran:

=============  ============================================================
method         solver
=============  ============================================================
``direct``     Householder-QR ``qr_solve`` (ground truth; small problems)
``lsqr``       plain LSQR on A (no sketching; works without a key)
``saa``        SAA-SAS, paper Algorithm 1 (fastest sketched path)
``sap``        sketch-and-precondition baseline (paper §4)
``iterative``  iterative sketching with damping + momentum (forward stable)
``fossils``    sketch-and-precondition + iterative refinement (forward
               stable, direct-method accuracy)
=============  ============================================================

``accuracy="certified"`` is the adaptive tier: solve, certify the answer
with ``repro_torch.core.certify``, and on a failed certificate escalate
along :data:`CERTIFIED_LADDER`, growing the sketch by appended rows (the
stored B = SA is extended, never recomputed).  Row sources (A9) and
``cluster=`` (A11) raise ``NotImplementedError`` naming their ROADMAP
slice.

``A`` is a dense matrix, a torch sparse tensor (COO, CSR or CSC), a
duck-typed operator or any ``repro_torch.core.linop`` operator.  Selection
runs on the data's shape, and a sparse or matrix-free A never selects
``direct``; the certified ladder stops at its ``fossils`` rung for them
(A is never densified as a fallback).  ``reg=λ`` solves the ridge problem
min‖Ax − b‖² + λ‖x‖² as least squares on ``TikhonovAugmented`` [A; √λI]
with right-hand side [b; 0], sketched through ``AugmentedSketch``, and
reports ``rnorm``/``arnorm`` of the original ridge problem.

``trace=True`` records the call's span tree (``repro_torch.obs.trace``):
the root ``lstsq`` (``accuracy``, then ``method``), ``lstsq.select`` and
``lstsq.solve`` (``method``, then ``itn``), the factor's ``factor.build``,
``sketch.apply`` and ``factor.qr``, and on the certified tier one
``certified.rung`` per attempt with its ``certify.probe`` and
``certify.floor``, ``certified.precision_escalate`` and
``certified.escalate``.  It is attached as ``SolveResult.timeline``.

The tolerance forwarding audit (``TOL_SUPPORT``) and ``precision=``/
``fused=`` for the sketched methods are as in the reference.
"""
from __future__ import annotations

import math

import torch

from ..obs import trace as obs_trace
from . import backend as backend_lib
from . import certify as certify_lib
from . import linop
from .direct import qr_solve
from .iterative import (
    damping_momentum,
    default_inner_iter_lim,
    fossils,
    fossils_refine,
    heavy_ball_refine,
    iterative_sketching,
)
from .lsqr import lsqr_operator
from .precond import SketchedFactor, default_sketch_size
from .result import SolveResult
from . import sketch as sketch_lib
from .saa import _solve_with_factor, saa_sas
from .sap import sap_sas

__all__ = [
    "lstsq",
    "select_method",
    "METHODS",
    "ACCURACIES",
    "TOL_SUPPORT",
]

METHODS = ("direct", "lsqr", "saa", "sap", "iterative", "fossils")
ACCURACIES = ("fast", "balanced", "high", "certified")
_ALIASES = {"iterative_sketching": "iterative", "qr": "direct"}

# m·n² flops below which Householder QR is effectively free and sketching
# overhead (operator draw + sketch + small QR) cannot pay for itself.
DIRECT_FLOP_CUTOFF = 1 << 26

_SKETCHED_BY_ACCURACY = {"fast": "saa", "balanced": "iterative", "high": "fossils"}

# Which tolerance knobs each method consumes.  Forcing a method with a knob
# outside its set raises; under auto-selection unsupported knobs are dropped.
_TOL_KEYS = ("atol", "btol", "steptol", "iter_lim")
TOL_SUPPORT = {
    "direct": frozenset(),
    "lsqr": frozenset(_TOL_KEYS),
    "saa": frozenset(_TOL_KEYS),
    "sap": frozenset(_TOL_KEYS),
    "iterative": frozenset(_TOL_KEYS),
    "fossils": frozenset({"steptol"}),
}

# The certified tier's escalation ladder: each failed certificate both
# grows the sketch (appended rows, stored B reused) and climbs one rung.
CERTIFIED_LADDER = ("saa", "iterative", "fossils", "direct")

# Methods whose factor build honours ``precision=``/``fused=``.
PRECISION_SUPPORT = frozenset({"saa", "iterative", "fossils"})


def select_method(
    m: int,
    n: int,
    *,
    has_key: bool = True,
    accuracy: str = "balanced",
    sketch_size: int | None = None,
    matrix_free: bool = False,
) -> str:
    """Pick a solver from shape, sketch-size regime and requested accuracy
    (the reference's rule, unchanged)."""
    if accuracy not in _SKETCHED_BY_ACCURACY:
        raise ValueError(
            f"select_method picks a single solver; accuracy must be one of "
            f"{tuple(_SKETCHED_BY_ACCURACY)} (the 'certified' tier runs its "
            f"own escalation ladder), got {accuracy!r}"
        )
    s = sketch_size if sketch_size is not None else default_sketch_size(n, m)
    regime_ok = (s >= n + 1) and (m >= 2 * s) and (m >= 4 * n)
    if matrix_free:
        if has_key and regime_ok:
            return _SKETCHED_BY_ACCURACY[accuracy]
        return "lsqr"
    big = m * n * n > DIRECT_FLOP_CUTOFF
    if big and regime_ok and has_key:
        return _SKETCHED_BY_ACCURACY[accuracy]
    if big and not has_key:
        return "lsqr"
    return "direct"


def _direct_result(A, b):
    x = qr_solve(A, b, device=A.device)
    r = b - A @ x
    dev = A.device
    return SolveResult(
        x=x,
        istop=torch.tensor(1, dtype=torch.int32, device=dev),
        itn=torch.tensor(0, dtype=torch.int32, device=dev),
        rnorm=torch.linalg.vector_norm(r),
        arnorm=torch.linalg.vector_norm(A.T @ r),
        used_fallback=torch.tensor(False, device=dev),
    )


def _ridge_diagnostics(A, b, x, reg):
    """(rnorm, arnorm) of the original ridge problem at x: ‖b − Ax‖ and
    ‖Aᵀ(b − Ax) − λx‖ (x a vector, or a block of columns)."""
    lam = torch.as_tensor(reg, dtype=A.dtype, device=A.device)
    r = b - (A @ x)
    g = (A.rmatvec(r) if r.ndim == 1 else A.rmatmat(r)) - lam * x
    return torch.linalg.vector_norm(r, dim=0), torch.linalg.vector_norm(g, dim=0)


def _not_ported(what: str, slice_: str):
    return NotImplementedError(f"{what} arrives with ROADMAP {slice_}")


def _certified_lstsq(
    A_in, A_op, b, gen, *, sketch, sketch_size, backend, tol, history, rtol,
    n_probes, precision="full", fused=None,
):
    """The adaptive certified driver: solve → certify → escalate.

    One factor is built at the initial sketch size; every escalation
    appends rows to it (``SketchedFactor.extend``: only the new rows are
    sketched, the stored B is reused) and climbs one rung of
    :data:`CERTIFIED_LADDER`.  Under ``precision="mixed"`` the first
    escalation re-applies the same operator at full precision and retries
    the same rung.  Returns ``(result, method)`` for the first certificate
    that passes, else the attempt with the smallest relative error bound
    (its certificate has ``passed`` False).

    Draws from ``gen``, in order: S; then, for each attempt, its probe
    matrix W (n × ``n_probes``) and, when it escalates by rows, the
    extension block.  The ``direct`` rung is a Householder QR of A on A's
    device; a sparse or matrix-free ``A_in`` (the data operator; ``A_op``
    is what the solvers see, [A; √λI] under ``reg=``) stops before it.
    Sketch rows count the data block's S only.  Each rung reads ``passed``
    and the relative bound to the host once.
    """
    m, n = A_in.shape
    dtype = A_op.dtype
    dense = isinstance(A_in, linop.DenseOperator)
    steptol = tol.get("steptol")
    if steptol is None:
        steptol = 32 * float(torch.finfo(dtype).eps)
    atol = tol.get("atol", 0.0)
    btol = tol.get("btol", 0.0)
    iter_lim = tol.get("iter_lim", 100)

    factor, op, B = SketchedFactor.build_full(
        A_op, gen, sketch=sketch, sketch_size=sketch_size, backend=backend,
        precision=precision, fused=fused,
    )
    s = op.inner.d if isinstance(op, sketch_lib.AugmentedSketch) else op.d
    prec_now = precision
    escalations = 0
    best = None  # (bound, result, method) of the best failed attempt
    rung = 0
    attempt = 0
    while rung < len(CERTIFIED_LADDER):
        meth = CERTIFIED_LADDER[rung]
        rung_span = obs_trace.span(
            "certified.rung", method=meth, attempt=attempt, sketch_rows=s,
            precision=prec_now,
        )
        attempt += 1
        with rung_span:
            if meth == "direct":
                if not dense:
                    # a sparse or matrix-free A stops at the fossils rung:
                    # those inputs are never densified as a fallback
                    break
                res = _direct_result(linop.ensure_dense(A_op, who="the certified QR rung"), b)
            elif meth == "saa":
                c = op.apply(b, backend=backend)
                x, inner = _solve_with_factor(
                    A_op, b, factor, c, materialize_y=dense, atol=atol, btol=btol,
                    iter_lim=iter_lim, steptol=steptol, history=history,
                )
                res = inner._replace(x=x)
            else:
                alpha, beta = damping_momentum(s, n)
                x0 = factor.sketch_and_solve(op.apply(b, backend=backend))
                if meth == "iterative":
                    res = heavy_ball_refine(
                        A_op, b, factor, x0, alpha, beta, atol=atol, btol=btol,
                        steptol=steptol, iter_lim=iter_lim, history=history,
                    )
                else:  # fossils
                    res = fossils_refine(
                        A_op, b, factor, op, x0, alpha, beta,
                        inner_iter_lim=default_inner_iter_lim(beta, dtype),
                        steptol=steptol, backend=backend, history=history,
                    )
            obs_trace.maybe_block(res.x)
            cert = certify_lib.certify(
                A_op, b, res.x, factor, gen, n_probes=n_probes, target=rtol,
                sketch_rows=s, escalations=escalations, precision=prec_now,
            )
            res = res._replace(certificate=cert)
            passed, bound = torch.stack(
                [cert.passed.to(dtype), cert.rel_error_bound]
            ).tolist()  # the host read of this rung
            if rung_span:
                rung_span.set(passed=bool(passed), bound=bound)
        if passed:
            return res, meth
        if not math.isfinite(bound):
            bound = math.inf
        if best is None or bound < best[0]:
            best = (bound, res, meth)
        if prec_now == "mixed" and meth != "direct":
            # Precision escalation: the SAME operator at full precision (one
            # sketch apply, no extra rows), and this rung again
            with obs_trace.span("certified.precision_escalate", rows=s):
                B = op.apply_op(A_op, backend=backend)
                factor = SketchedFactor.from_sketch(B)
                obs_trace.maybe_block(factor.R)
            prec_now = "full"
            escalations += 1
            continue
        # Before the next sketched rung, double the sketch by appending
        # rows, capped at the data's row count
        if rung + 1 < len(CERTIFIED_LADDER):
            extra = min(s, max(m - s, 0))
            if extra > 0 and CERTIFIED_LADDER[rung + 1] != "direct":
                with obs_trace.span("certified.escalate", extra=extra):
                    factor, op, B = factor.extend(A_op, op, gen, extra, B=B, backend=backend)
                    obs_trace.maybe_block(factor.R)
                s += extra
                escalations += 1
        rung += 1

    _, res, meth = best
    return res, meth


def lstsq(
    A,
    b,
    key=None,
    *,
    method: str = "auto",
    accuracy: str = "balanced",
    sketch="clarkson_woodruff",
    sketch_size: int | None = None,
    reg=None,
    atol: float | None = None,
    btol: float | None = None,
    steptol: float | None = None,
    iter_lim: int | None = None,
    backend: str = "auto",
    precision: str = "full",
    fused: bool | None = None,
    history: bool = False,
    certified_rtol: float | None = None,
    certified_probes: int = 8,
    cluster=None,
    trace: bool | None = None,
    device=None,
) -> SolveResult:
    """Solve min‖Ax − b‖₂ with an auto-selected (or forced) solver.

    ``A`` is a dense matrix (tensor or numpy array), a torch sparse
    tensor, a duck-typed operator or a ``repro_torch.core.linop``
    operator; ``key`` a ``torch.Generator`` on the data's device (or an int
    seed), needed by the sketched methods and the certified tier.
    ``sketch`` is a kind name or an already-drawn operator (under ``reg=``,
    over the data rows).  ``reg=λ`` adds λ‖x‖² (module docstring).
    ``device=None`` means ``"cuda"``.

    ``accuracy="certified"`` (``method="auto"`` only) runs the certified
    driver: ``certified_rtol`` is the relative forward-error target
    (``None`` → the adaptive QR-attainable default), ``certified_probes``
    the distortion probe count; ``SolveResult.certificate`` carries the
    final posterior bound.  ``precision="mixed"`` sketches a bf16-rounded
    copy of A for the sketched methods; the certified tier then verifies
    the factor and escalates back to full precision when rounding broke
    the embedding.  ``cluster`` (unported) keeps the reference's name and
    accepts only its default.

    ``trace=True`` records a nested wall-clock span timeline of this call
    (method selection, sketch and QR, the solve, certificate rungs) and
    attaches it as ``SolveResult.timeline`` (a
    ``repro_torch.obs.trace.Timeline``: ``str(...)`` renders the tree,
    ``.save(path)`` writes Chrome-trace JSON); each span waits for the
    card, so its duration is device wall time.  With ``REPRO_TRACE=1`` (or
    inside ``repro_torch.obs.tracing()``) the timeline is attached without
    the flag; ``trace=None`` otherwise records nothing and synchronizes
    nothing.
    """
    scope = obs_trace.solve_scope(trace)
    with scope:
        root = obs_trace.span("lstsq", accuracy=accuracy)
        with root:
            res = _lstsq_impl(
                A, b, key, method=method, accuracy=accuracy, sketch=sketch,
                sketch_size=sketch_size, reg=reg, atol=atol, btol=btol,
                steptol=steptol, iter_lim=iter_lim, backend=backend,
                precision=precision, fused=fused, history=history,
                certified_rtol=certified_rtol,
                certified_probes=certified_probes, cluster=cluster, device=device,
            )
            if root and res.method:
                root.set(method=res.method)
    return scope.attach(res)


def _lstsq_impl(
    A, b, key, *, method, accuracy, sketch, sketch_size, reg, atol, btol,
    steptol, iter_lim, backend, precision, fused, history, certified_rtol,
    certified_probes, cluster, device,
) -> SolveResult:
    if accuracy not in ACCURACIES:
        raise ValueError(f"unknown accuracy {accuracy!r}; have {ACCURACIES}")
    backend_lib.check_precision(precision)
    backend_lib.check_backend(backend)
    if cluster is not None:
        raise _not_ported("cluster= (multi-worker solves)", "A11")
    if callable(getattr(A, "tiles", None)):
        raise _not_ported("row-streamed inputs", "A9")

    A_in = linop.as_operator(A, device=device)
    b = backend_lib.as_tensor(b, A_in.device, A_in.dtype)
    if reg is not None:
        A_op = linop.TikhonovAugmented.wrap(A_in, reg)
        b_solve = A_op.augment_rhs(b)
    else:
        A_op, b_solve = A_in, b
    # select on the data's shape: the √λ·I rows are exact, never sketched,
    # and must not inflate m in the regime tests
    m, n = A_in.shape
    method = _ALIASES.get(method, method)
    forced = method != "auto"
    tol = {
        k: v
        for k, v in dict(atol=atol, btol=btol, steptol=steptol,
                         iter_lim=iter_lim).items()
        if v is not None
    }

    if accuracy == "certified":
        if forced:
            raise ValueError(
                "accuracy='certified' drives its own method ladder "
                f"{CERTIFIED_LADDER}; don't force method={method!r}"
            )
        if key is None:
            raise ValueError("accuracy='certified' needs a key (torch.Generator)")
        res, used = _certified_lstsq(
            A_in, A_op, b_solve, backend_lib.as_generator(key, A_op.device),
            sketch=sketch, sketch_size=sketch_size, backend=backend, tol=tol,
            history=history, rtol=certified_rtol, n_probes=certified_probes,
            precision=precision, fused=fused,
        )
        if reg is not None:
            rnorm, arnorm = _ridge_diagnostics(A_in, b, res.x, reg)
            res = res._replace(rnorm=rnorm, arnorm=arnorm)
        return res._replace(method=used)

    if method == "auto":
        with obs_trace.span("lstsq.select", m=m, n=n, accuracy=accuracy) as sel:
            method = select_method(
                m, n, has_key=key is not None, accuracy=accuracy,
                sketch_size=sketch_size,
                matrix_free=not isinstance(A_in, linop.DenseOperator),
            )
            if sel:
                sel.set(method=method)
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; have {('auto',) + METHODS}")
    if method in ("saa", "sap", "iterative", "fossils") and key is None:
        raise ValueError(f"method {method!r} needs a key (torch.Generator)")

    unsupported = sorted(set(tol) - TOL_SUPPORT[method])
    if unsupported:
        if forced:
            supported = sorted(TOL_SUPPORT[method]) or ["(none)"]
            raise ValueError(
                f"method {method!r} does not consume {unsupported}; it "
                f"supports {supported} — drop the unsupported knobs or let "
                "method='auto' do so"
            )
        for k in unsupported:
            tol.pop(k)
    sk = dict(sketch=sketch, sketch_size=sketch_size, backend=backend)
    if method in PRECISION_SUPPORT:
        sk.update(precision=precision, fused=fused)
    elif precision != "full" and forced:
        raise ValueError(
            f"method {method!r} does not sketch through "
            "SketchedFactor.build and cannot honour precision="
            f"{precision!r}; supported: {sorted(PRECISION_SUPPORT)}"
        )

    with obs_trace.span("lstsq.solve", method=method) as sp:
        if method == "direct":
            res = _direct_result(linop.ensure_dense(A_op, who="method='direct'"), b_solve)
        elif method == "lsqr":
            res = lsqr_operator(A_op, b_solve, history=history, **tol)
        elif method == "saa":
            res = saa_sas(A_op, b_solve, key, history=history, **sk, **tol)
        elif method == "sap":
            res = sap_sas(A_op, b_solve, key, history=history, **sk, **tol)
        elif method == "iterative":
            res = iterative_sketching(A_op, b_solve, key, history=history, **sk, **tol)
        else:  # fossils (tol holds at most steptol after the audit above)
            res = fossils(A_op, b_solve, key, history=history, **sk, **tol)
        obs_trace.maybe_block(res.x)
        if sp:
            sp.set(itn=int(res.itn))
    if reg is not None:
        # report the original ridge problem's residuals, not the augmented one's
        rnorm, arnorm = _ridge_diagnostics(A_in, b, res.x, reg)
        res = res._replace(rnorm=rnorm, arnorm=arnorm)
    return res._replace(method=method)
