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

``saa_sas_batch`` amortizes one draw of S over many solves: k right-hand
sides of one A share its factor and one LSQR over the block (a column
stops at its own stop, as each lane of the reference's ``vmap`` does), and
a batch of equally-shaped problems shares S, each solved as ``saa_sas``
solves it.
"""
from __future__ import annotations

import math

import torch

from . import backend as backend_lib
from . import linop
from .linop import estimate_2norm
from .lsqr import lsqr
from .precond import SketchedFactor, _operator_for, default_sketch_size
from .result import SolveResult

__all__ = ["saa_sas", "saa_sas_batch", "SAAResult", "default_sketch_size"]

# The reference's name for the result type, kept for its callers.
SAAResult = SolveResult


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


def saa_sas_batch(
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
    backend: str = "auto",
    device=None,
) -> SolveResult:
    """Batched SAA-SAS: one operator draw amortized over many solves.

    - ``A (m, n), b (m, k)``: one design matrix, k right-hand sides.  The
      sketch, the factor and Y = A R⁻¹ are made once; one LSQR runs over
      the (m, k) block, each product taking all k columns (Y is read once
      per iteration), and a column that has stopped keeps its state, so
      it ends as its own solve through those products would.  Returns x
      of shape (n, k) and per-column istop, itn, rnorm and arnorm.
    - ``A (batch, m, n), b (batch, m)``: equally-shaped problems sharing
      one S; each is factored and solved as :func:`saa_sas` does it.
      Returns x of shape (batch, n).

    The perturbation fallback is not taken (``used_fallback`` is all
    False); re-solve a non-converged column or problem on its own.
    ``key`` is a ``torch.Generator`` on the data's device (or an int
    seed); ``sketch`` a kind name or an already-drawn operator.
    """
    if getattr(A, "ndim", 2) == 3:
        return _problem_batch(
            A, b, key, sketch=sketch, sketch_size=sketch_size, atol=atol,
            btol=btol, steptol=steptol, iter_lim=iter_lim,
            materialize_y=materialize_y, backend=backend, device=device,
        )
    A = linop.as_operator(A, device=device)
    b = backend_lib.as_tensor(b, A.device, A.dtype)
    gen = backend_lib.as_generator(key, A.device)
    if b.ndim != 2 or b.shape[0] != A.shape[0]:
        raise ValueError(
            f"multi-RHS mode needs b of shape ({A.shape[0]}, k), got {tuple(b.shape)}"
        )
    if materialize_y is None:
        materialize_y = isinstance(A, linop.DenseOperator)
    if steptol is None:
        steptol = 32 * float(torch.finfo(A.dtype).eps)
    factor, op = SketchedFactor.build(
        A, gen, sketch=sketch, sketch_size=sketch_size, backend=backend
    )
    C = op.apply(b, backend=backend)  # (s, k)
    X, res = _solve_with_factor(
        A, b, factor, C, materialize_y=materialize_y, atol=atol, btol=btol,
        iter_lim=iter_lim, steptol=steptol,
    )
    k = b.shape[1]
    return res._replace(x=X, used_fallback=torch.zeros(k, dtype=torch.bool, device=A.device))


def _problem_batch(
    A, b, key, *, sketch, sketch_size, atol, btol, steptol, iter_lim,
    materialize_y, backend, device,
):
    A = backend_lib.as_tensor(A, device)
    b = backend_lib.as_tensor(b, A.device, A.dtype)
    gen = backend_lib.as_generator(key, A.device)
    batch, m, n = A.shape
    if b.shape != (batch, m):
        raise ValueError(
            f"problem-batch mode needs b of shape {(batch, m)}, got {tuple(b.shape)}"
        )
    if materialize_y is None:
        materialize_y = True
    if steptol is None:
        steptol = 32 * float(torch.finfo(A.dtype).eps)
    kw = dict(
        materialize_y=materialize_y, atol=atol, btol=btol, iter_lim=iter_lim,
        steptol=steptol,
    )
    op = _operator_for(sketch, linop.DenseOperator(A[0]), sketch_size, gen)
    results = []
    for A_i, b_i in zip(A, b):
        factor = SketchedFactor.from_sketch(op.apply(A_i, backend=backend))
        c = op.apply(b_i, backend=backend)
        x, res = _solve_with_factor(A_i, b_i, factor, c, **kw)
        results.append(res._replace(x=x))
    stacked = {
        f: torch.stack([getattr(r, f) for r in results])
        for f in ("x", "istop", "itn", "rnorm", "arnorm")
    }
    return SolveResult(
        **stacked, used_fallback=torch.zeros(batch, dtype=torch.bool, device=A.device)
    )
