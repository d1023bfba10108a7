"""SAA-SAS — Sketch-and-Apply (paper Algorithm 1).

Port of ``repro/core/saa.py``:

  1. Draw S ∈ R^{s×m} (Clarkson–Woodruff by default, the paper's choice;
     ``sketch="gaussian"`` or ``"uniform_dense"`` for the dense kinds).
  2. B = SA, c = Sb (on the card: kernel B1, B4 or B6 by kind; B3, B5 or
     B7 for B with ``fused=True``).
  3. QR of B (Householder, or shifted CholeskyQR3 on the fused route).
  4. Y = A R⁻¹ (the "apply" step).
  5. Warm start z₀ = Qᵀ c.
  6. LSQR on min‖Y z − b‖.
  7. x = R⁻¹ z.
  8. If LSQR did not converge: perturb Ã = A + σG/√m with σ = 10‖A‖₂u,
     re-sketch with the same S, re-factor and re-solve (paper lines 10–17).

The reference's ``lax.cond`` fallback is a Python branch here, on one host
read of ``converged``.  All draws come from one ``torch.Generator`` in this
order: S (unless an operator is passed as ``sketch=``), then, on the
fallback only, the power-iteration start vector and the Gaussian G.
``saa_sas_batch`` arrives with ROADMAP A6.
"""
from __future__ import annotations

import math

import torch

from . import backend as backend_lib
from . import linop
from .linop import estimate_2norm
from .lsqr import lsqr
from .precond import SketchedFactor, default_sketch_size
from .result import SolveResult

__all__ = ["saa_sas", "default_sketch_size"]


def _solve_with_factor(
    A, b, factor: SketchedFactor, c, *,
    materialize_y, atol, btol, iter_lim, steptol, history=False,
):
    """Steps 4–7 of Algorithm 1 given the sketched factor and c = Sb."""
    z0 = factor.warm_start(c)
    if materialize_y:
        Y = factor.materialize_whitened(A)
        mv, rmv = (lambda z: Y @ z), (lambda u: Y.T @ u)
    else:
        def mv(z):
            return factor.whiten_mv(A, z)

        def rmv(u):
            return factor.whiten_rmv(A, u)
    res = lsqr(
        mv, rmv, b, x0=z0, atol=atol, btol=btol, iter_lim=iter_lim,
        steptol=steptol, history=history,
    )
    return factor.precondition(res.x), res


def saa_sas(
    A,
    b,
    key,
    *,
    sketch="clarkson_woodruff",
    sketch_size: int | None = None,
    atol: float = 0.0,
    btol: float = 0.0,
    steptol: float | None = None,
    iter_lim: int = 100,
    materialize_y: bool | None = None,
    use_fallback: bool = True,
    backend: str = "auto",
    precision: str = "full",
    fused: bool | None = None,
    history: bool = False,
    device=None,
) -> SolveResult:
    """Solve min‖Ax − b‖ by Sketch-and-Apply (paper Algorithm 1).

    ``key`` is a ``torch.Generator`` on the data's device (or an int seed).
    ``sketch`` is a kind name or an already-drawn operator (the
    carry-across hook of ``SketchedFactor.build``).
    """
    A = linop.as_operator(A, device=device)
    b = backend_lib.as_tensor(b, A.device, A.dtype)
    gen = backend_lib.as_generator(key, A.device)
    dense_input = isinstance(A, linop.DenseOperator)
    if materialize_y is None:
        materialize_y = dense_input
    m, n = A.shape
    if steptol is None:
        # z-space numerical floor of the whitened system (see lsqr docstring)
        steptol = 32 * float(torch.finfo(A.dtype).eps)
    kw = dict(
        materialize_y=materialize_y, atol=atol, btol=btol,
        iter_lim=iter_lim, steptol=steptol, history=history,
    )

    factor, op = SketchedFactor.build(
        A, gen, sketch=sketch, sketch_size=sketch_size, backend=backend,
        precision=precision, fused=fused,
    )
    c = op.apply(b, backend=backend)
    x, res = _solve_with_factor(A, b, factor, c, **kw)
    no_fallback = torch.tensor(False, device=A.device)
    if not (use_fallback and dense_input) or bool(res.converged):
        return res._replace(x=x, used_fallback=no_fallback)

    # Lines 10–17: Ã = A + σ G/√m, σ = 10‖A‖₂u.
    u_round = torch.finfo(A.dtype).eps / 2
    sigma = 10.0 * estimate_2norm(A, gen) * u_round
    G = torch.randn(A.shape, generator=gen, dtype=A.dtype, device=A.device)
    A_t = A.A + (sigma / math.sqrt(m)) * G
    del G
    factor2 = SketchedFactor.from_sketch(op.apply(A_t, backend=backend))
    x2, res2 = _solve_with_factor(A_t, b, factor2, c, **kw)
    return res2._replace(x=x2, used_fallback=torch.tensor(True, device=A.device))
