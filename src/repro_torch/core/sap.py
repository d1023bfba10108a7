"""Sketch-and-Precondition (SAP-SAS) baseline — paper §4.

Port of ``repro/core/sap.py``.  Blendenpik-style: sketch, QR-factor the
sketch, then run LSQR on the right-preconditioned operator A R⁻¹ without
reducing the problem's row dimension: each iteration takes one product
with A, one with Aᵀ and two triangular solves (Y is never formed).  The
solve starts from the sketch-and-solve warm start z₀ = Qᵀ(Sb);
``warm_start=False`` keeps the zero-initialized variant of the paper's
negative result.

All draws come from one ``torch.Generator`` on the data's device: S
(unless an operator is passed as ``sketch=``); nothing else is drawn.
"""
from __future__ import annotations

import torch

from . import backend as backend_lib
from . import linop
from .lsqr import lsqr
from .precond import SketchedFactor
from .result import SolveResult

__all__ = ["sap_sas"]


def sap_sas(
    A,
    b,
    key,
    *,
    sketch="clarkson_woodruff",
    sketch_size: int | None = None,
    atol: float = 0.0,
    btol: float = 0.0,
    steptol: float | None = None,
    iter_lim: int = 200,
    warm_start: bool = True,
    backend: str = "auto",
    history: bool = False,
    device=None,
) -> SolveResult:
    """Solve min‖Ax − b‖ by sketch-and-precondition (LSQR on A R⁻¹).

    ``key`` is a ``torch.Generator`` on the data's device (or an int seed);
    ``sketch`` a kind name or an already-drawn operator.
    """
    A = linop.as_operator(A, device=device)
    b = backend_lib.as_tensor(b, A.device, A.dtype)
    gen = backend_lib.as_generator(key, A.device)
    if steptol is None:
        steptol = 32 * float(torch.finfo(A.dtype).eps)
    factor, op = SketchedFactor.build(
        A, gen, sketch=sketch, sketch_size=sketch_size, backend=backend
    )
    z0 = factor.warm_start(op.apply(b, backend=backend)) if warm_start else None
    res = lsqr(
        lambda z: factor.whiten_mv(A, z),
        lambda u: factor.whiten_rmv(A, u),
        b, x0=z0, atol=atol, btol=btol, iter_lim=iter_lim, steptol=steptol,
        history=history,
    )
    return res._replace(x=factor.precondition(res.x))
