"""Unified solver result type.

Port of ``repro/core/result.py``: every solver of the port returns this
one :class:`SolveResult`, with tensors in place of JAX arrays.  ``method``
is filled in by :func:`repro_torch.core.lstsq.lstsq` and is ``None`` when a
solver is called directly.  ``certificate`` holds the
:class:`repro_torch.core.certify.Certificate` of a certified solve
(``accuracy="certified"``) and is ``None`` otherwise; ``timeline`` holds
the call's ``repro_torch.obs.trace.Timeline`` when tracing was active
(``lstsq(..., trace=True)``) and is ``None`` otherwise.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["SolveResult", "ISTOP_MEANING"]

# istop follows SciPy's LSQR convention, extended with the step-floor code.
ISTOP_MEANING = {
    0: "x = 0 is the exact solution",
    1: "residual-level convergence (btol/atol)",
    2: "least-squares convergence (Aᵀr small)",
    3: "condition-number limit reached",
    4: "residual-level convergence at machine precision",
    5: "least-squares convergence at machine precision",
    6: "condition-number limit at machine precision",
    7: "iteration limit",
    8: "step-size floor (converged to the numerical floor)",
}


class SolveResult(NamedTuple):
    """What every ``repro_torch.core`` least-squares solver returns."""

    x: torch.Tensor
    istop: torch.Tensor  # int32, see ISTOP_MEANING
    itn: torch.Tensor  # int32, iterations taken (0 for direct methods)
    rnorm: torch.Tensor  # ‖b − Ax‖
    arnorm: torch.Tensor  # ‖Aᵀ(b − Ax)‖ estimate (nan if untracked)
    used_fallback: torch.Tensor  # bool; only SAA-SAS's perturbation path sets it
    history: torch.Tensor | None = None  # (iter_lim,) residual norms, nan-padded
    method: str | None = None  # set by lstsq()
    certificate: object | None = None
    timeline: object | None = None

    @property
    def converged(self) -> torch.Tensor:
        return (self.istop > 0) & (self.istop != 7)
