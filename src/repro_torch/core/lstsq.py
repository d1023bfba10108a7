"""``lstsq`` — the one-call driver over the port's least-squares solvers.

Port of ``repro/core/lstsq.py``.  ``select_method`` is ported whole (pure
arithmetic over shape, sketch-size regime and accuracy, every accuracy).
``lstsq`` runs the methods of this slice:

=============  ============================================================
method         solver
=============  ============================================================
``direct``     Householder-QR ``qr_solve`` (ground truth; small problems)
``lsqr``       plain LSQR on A (no sketching; works without a key)
``saa``        SAA-SAS, paper Algorithm 1 (fastest sketched path)
=============  ============================================================

``method="auto"`` runs when it selects one of them (``accuracy="fast"``,
or shapes that route to ``direct``/``lsqr``).  The rest raises
``NotImplementedError`` naming its ROADMAP slice: ``sap``, ``iterative``
and ``fossils`` and ``accuracy="certified"`` (A6), ``reg=`` (A8), row
sources (A9), ``cluster=`` (A11), ``trace=True`` (A4).

The tolerance forwarding audit (``TOL_SUPPORT``) and ``precision=``/
``fused=`` for ``saa`` are as in the reference.
"""
from __future__ import annotations

import torch

from . import backend as backend_lib
from . import linop
from .direct import qr_solve
from .lsqr import lsqr_operator
from .precond import default_sketch_size
from .result import SolveResult
from .saa import saa_sas

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

CERTIFIED_LADDER = ("saa", "iterative", "fossils", "direct")

# Methods whose factor build honours ``precision=``/``fused=``.
PRECISION_SUPPORT = frozenset({"saa", "iterative", "fossils"})

_PORTED_METHODS = frozenset({"direct", "lsqr", "saa"})


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


def _not_ported(what: str, slice_: str):
    return NotImplementedError(f"{what} arrives with ROADMAP {slice_}")


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

    ``A`` is a dense matrix (tensor or numpy array) or a
    ``repro_torch.core.linop.DenseOperator``; ``key`` a ``torch.Generator``
    on the data's device (or an int seed), needed by ``saa``.  ``sketch``
    is a kind name or an already-drawn operator.  ``device=None`` means
    ``"cuda"``.  The arguments of unported features (``reg``,
    ``certified_*``, ``cluster``, ``trace``) keep the reference's names and
    accept only their defaults.
    """
    if accuracy not in ACCURACIES:
        raise ValueError(f"unknown accuracy {accuracy!r}; have {ACCURACIES}")
    backend_lib.check_precision(precision)
    backend_lib.check_backend(backend)
    if trace:
        raise _not_ported("trace=True (solve timelines)", "A4")
    if cluster is not None:
        raise _not_ported("cluster= (multi-worker solves)", "A11")
    if callable(getattr(A, "tiles", None)):
        raise _not_ported("row-streamed inputs", "A9")
    if reg is not None:
        raise _not_ported("reg= (Tikhonov)", "A8")
    if accuracy == "certified" or certified_rtol is not None or certified_probes != 8:
        raise _not_ported("the certified tier (accuracy='certified', certified_*)", "A6")

    A_op = linop.as_operator(A, device=device)
    b = backend_lib.as_tensor(b, A_op.device, A_op.dtype)
    m, n = A_op.shape
    method = _ALIASES.get(method, method)
    forced = method != "auto"
    tol = {
        k: v
        for k, v in dict(atol=atol, btol=btol, steptol=steptol,
                         iter_lim=iter_lim).items()
        if v is not None
    }

    if method == "auto":
        method = select_method(
            m, n, has_key=key is not None, accuracy=accuracy,
            sketch_size=sketch_size,
            matrix_free=not isinstance(A_op, linop.DenseOperator),
        )
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; have {('auto',) + METHODS}")
    if method not in _PORTED_METHODS:
        raise _not_ported(f"method {method!r}", "A6")
    if method == "saa" and key is None:
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

    if method == "direct":
        res = _direct_result(linop.ensure_dense(A_op, who="method='direct'"), b)
    elif method == "lsqr":
        res = lsqr_operator(A_op, b, history=history, **tol)
    else:
        res = saa_sas(A_op, b, key, history=history, **sk, **tol)
    return res._replace(method=method)
