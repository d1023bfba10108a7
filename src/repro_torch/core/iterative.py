"""Forward-stable iterative solvers on the shared sketched factor.

Port of ``repro/core/iterative.py``.  Plain sketch-and-solve (and
sketch-and-precondition with a sketch-and-solve warm start) is not forward
stable: on ill-conditioned problems with a non-negligible residual its
forward error stagnates a κ(A)-dependent factor above Householder QR's.
Epperly (2024) and Epperly–Meier–Nakatsukasa (2024) give two fixes, both
on the same :class:`repro_torch.core.precond.SketchedFactor`:

- :func:`iterative_sketching` — heavy ball in x-space.  Each step solves the
  sketched normal equations (RᵀR) d = Aᵀ(b − Ax) (two triangular solves)
  and updates x with damping α = (1 − ε²)² and momentum β = ε², ε ≈ √(n/s)
  the embedding distortion, so the error contracts by ≈ ε per step
  whatever κ(A).
- :func:`fossils` — sketch-and-precondition with iterative refinement:
  each refinement step solves the residual system min‖A d − r‖ in the
  whitened coordinates z = R d by the same heavy ball, then adds R⁻¹z.

The reference runs each loop as a ``lax.while_loop`` whose stop test never
leaves the device.  Here each loop is a Python loop over device tensors
that reads its stop flag to the host once per iteration, as the port's
LSQR does, so no product with A runs past the stop.  A window of
iterations between reads would spend the frozen iterations' products (an
8-iteration window cost LSQR 13 extra gemvs at m = 2^20); keeping the loop
on the device is ROADMAP §A item 4.

Products with A, as in the reference: :func:`heavy_ball_refine` takes
``itn + 1`` matvecs and ``itn + 1`` rmatvecs (the last pair reports the
residual of the returned iterate); each inner step of FOSSILS takes one
matvec, one rmatvec and two triangular solves, and each refinement step
one more matvec for its residual, with one matvec and one rmatvec at the
end.

All draws come from one ``torch.Generator`` on the data's device: S
(unless an operator is passed as ``sketch=``); nothing else is drawn.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import backend as backend_lib
from . import linop
from .precond import SketchedFactor, default_sketch_size, distortion
from .result import SolveResult

__all__ = [
    "iterative_sketching",
    "fossils",
    "damping_momentum",
    "heavy_ball_refine",
    "fossils_refine",
    "default_inner_iter_lim",
]


def damping_momentum(sketch_size: int, n: int) -> tuple[float, float]:
    """Optimal heavy-ball (damping, momentum) for distortion ε ≈ √(n/s):
    α = (1 − ε²)², β = ε² (Polyak's coefficients for squared singular
    values in [1/(1+ε)², 1/(1−ε)²])."""
    eps = distortion(sketch_size, n)
    return (1.0 - eps**2) ** 2, eps**2


# Once the step norm stops reaching new minima for this many iterations the
# iterate is bouncing around its numerical floor: istop=8.  The minimum is
# tracked on the ABSOLUTE step ‖Δx‖ (the relative step plateaus while ‖x‖
# itself still collapses from a far-off warm start), and a new minimum must
# beat the old one by 1%.
_STALL_LIMIT = 10
_IMPROVE_FACTOR = 0.99


class _StepFloor(NamedTuple):
    """The two-signal step-floor test of both solvers: three consecutive
    relative steps below ``steptol`` (only when ``steptol > 0``), or no new
    step-norm minimum for ``_STALL_LIMIT`` iterations."""

    n_small: torch.Tensor
    min_step: torch.Tensor
    n_stall: torch.Tensor

    @classmethod
    def init(cls, dtype, device) -> "_StepFloor":
        i32 = dict(dtype=torch.int32, device=device)
        return cls(
            n_small=torch.zeros((), **i32),
            min_step=torch.full((), math.inf, dtype=dtype, device=device),
            n_stall=torch.zeros((), **i32),
        )

    def update(self, stepnorm, relstep, steptol: float):
        """Returns (next_state, floor_reached)."""
        if steptol > 0:
            n_small = torch.where(relstep <= steptol, self.n_small + 1, 0).to(torch.int32)
        else:
            n_small = torch.zeros_like(self.n_small)
        improved = stepnorm < _IMPROVE_FACTOR * self.min_step
        min_step = torch.minimum(self.min_step, stepnorm)
        n_stall = torch.where(improved, 0, self.n_stall + 1).to(torch.int32)
        nxt = _StepFloor(n_small=n_small, min_step=min_step, n_stall=n_stall)
        return nxt, (n_small >= 3) | (n_stall >= _STALL_LIMIT)


def _norm(t):
    return torch.linalg.vector_norm(t)


def heavy_ball_refine(
    A,
    b: torch.Tensor,
    factor: SketchedFactor,
    x0: torch.Tensor,
    alpha: float,
    beta: float,
    *,
    atol: float = 0.0,
    btol: float = 0.0,
    steptol: float,
    iter_lim: int = 100,
    history: bool = False,
) -> SolveResult:
    """The damped/momentum iteration of :func:`iterative_sketching` against
    a prebuilt factor (the certified driver re-runs it after escalating the
    factor).  Same stopping semantics as ``iterative_sketching``."""
    A = linop.as_operator(A, device=b.device)
    dtype, device = b.dtype, b.device
    tiny = torch.finfo(dtype).tiny
    bnorm = _norm(b)
    bnorm_safe = torch.where(bnorm > 0, bnorm, torch.ones_like(bnorm))
    anorm = _norm(factor.R)  # ‖R‖_F = ‖SA‖_F ≈ ‖A‖_F

    itn = torch.zeros((), dtype=torch.int32, device=device)
    istop = torch.zeros_like(itn)
    x = x_prev = x0
    floor = _StepFloor.init(dtype, device)
    rhist = torch.full((iter_lim if history else 0,), math.nan, dtype=dtype, device=device)
    for i in range(iter_lim):
        itn = itn + 1
        r = b - A.matvec(x)
        rnorm = _norm(r)
        g = A.rmatvec(r)  # the true gradient (up to sign)
        arnorm = _norm(g)
        dx = alpha * factor.normal_solve(g) + beta * (x - x_prev)
        x_prev, x = x, x + dx

        xnorm = _norm(x)
        stepnorm = _norm(dx)
        relstep = stepnorm / torch.clamp(xnorm, min=tiny)
        floor, floor_reached = floor.update(stepnorm, relstep, steptol)

        test1 = rnorm / bnorm_safe
        prod = anorm * rnorm
        test2 = arnorm / torch.where(prod > 0, prod, torch.ones_like(prod))
        rtol = btol + atol * anorm * xnorm / bnorm_safe

        # precedence as the reference: 1 over 2 over 8 over 7
        istop = torch.zeros_like(itn)
        istop = torch.where(itn >= iter_lim, 7, istop)
        istop = torch.where(floor_reached, 8, istop)
        istop = torch.where(test2 <= atol, 2, istop)
        istop = torch.where(test1 <= rtol, 1, istop).to(torch.int32)
        if history:
            rhist[i] = rnorm
        if bool(istop != 0):  # the host sync of this iteration
            break

    # the residual of the RETURNED iterate (the loop's lags one update)
    r = b - A.matvec(x)
    g = A.rmatvec(r)
    return SolveResult(
        x=x,
        istop=torch.where(bnorm == 0, 0, istop).to(torch.int32),
        itn=itn,
        rnorm=_norm(r),
        arnorm=_norm(g),
        used_fallback=torch.tensor(False, device=device),
        history=rhist if history else None,
    )


def _setup(A, b, key, device, sketch, sketch_size, steptol, damping, momentum):
    """Shared prologue: operator, rhs, generator, steptol, (α, β).  The
    coefficients use the sketch's row count: ``sketch_size``, an operator's
    d, or the default's."""
    A = linop.as_operator(A, device=device)
    b = backend_lib.as_tensor(b, A.device, A.dtype)
    gen = backend_lib.as_generator(key, A.device)
    m, n = A.shape
    s = sketch_size
    if s is None:
        s = default_sketch_size(n, m) if isinstance(sketch, str) else sketch.d
    if steptol is None:
        steptol = 32 * float(torch.finfo(A.dtype).eps)
    alpha, beta = damping_momentum(s, n)
    if damping is not None:
        alpha = damping
    if momentum is not None:
        beta = momentum
    return A, b, gen, steptol, alpha, beta


def iterative_sketching(
    A,
    b,
    key,
    *,
    sketch="clarkson_woodruff",
    sketch_size: int | None = None,
    damping: float | None = None,
    momentum: float | None = None,
    atol: float = 0.0,
    btol: float = 0.0,
    steptol: float | None = None,
    iter_lim: int = 100,
    backend: str = "auto",
    precision: str = "full",
    fused: bool | None = None,
    history: bool = False,
    device=None,
) -> SolveResult:
    """Iterative sketching with damping + momentum (forward stable).

    x₀ = sketch-and-solve; then
    x_{i+1} = x_i + α (RᵀR)⁻¹ Aᵀ(b − A x_i) + β (x_i − x_{i−1}).

    Stops on the step floor (istop=8), on residual tolerances (istop=1/2,
    SciPy semantics) or at ``iter_lim`` (istop=7).  ``key`` is a
    ``torch.Generator`` on the data's device (or an int seed); ``sketch``
    a kind name or an already-drawn operator.
    """
    A, b, gen, steptol, alpha, beta = _setup(
        A, b, key, device, sketch, sketch_size, steptol, damping, momentum
    )
    factor, op = SketchedFactor.build(
        A, gen, sketch=sketch, sketch_size=sketch_size, backend=backend,
        precision=precision, fused=fused,
    )
    x0 = factor.sketch_and_solve(op.apply(b, backend=backend))
    return heavy_ball_refine(
        A, b, factor, x0, alpha, beta, atol=atol, btol=btol, steptol=steptol,
        iter_lim=iter_lim, history=history,
    )


def _whitened_heavy_ball(factor: SketchedFactor, A, r, z0, *, alpha, beta, iter_lim, steptol):
    """Heavy ball on min‖Y z − r‖, Y = A R⁻¹: the FOSSILS inner solve.

    Returns (z, iterations, hit_floor), stopping on the z-space step floor
    or on step stagnation, the same two-signal test as
    ``iterative_sketching``.  One host read per iteration.
    """
    dtype, device = r.dtype, r.device
    tiny = torch.finfo(dtype).tiny
    itn = torch.zeros((), dtype=torch.int32, device=device)
    done = torch.zeros((), dtype=torch.bool, device=device)
    z = z_prev = z0
    floor = _StepFloor.init(dtype, device)
    for _ in range(iter_lim):
        g = factor.whiten_rmv(A, r - factor.whiten_mv(A, z))
        dz = alpha * g + beta * (z - z_prev)
        z_prev, z = z, z + dz
        stepnorm = _norm(dz)
        relstep = stepnorm / torch.clamp(_norm(z), min=tiny)
        floor, done = floor.update(stepnorm, relstep, steptol)
        itn = itn + 1
        if bool(done):  # the host sync of this iteration
            break
    return z, itn, done


def fossils_refine(
    A,
    b: torch.Tensor,
    factor: SketchedFactor,
    op,
    x0: torch.Tensor,
    alpha: float,
    beta: float,
    *,
    refine_steps: int = 2,
    inner_iter_lim: int,
    steptol: float,
    backend: str = "auto",
    history: bool = False,
) -> SolveResult:
    """The FOSSILS refinement passes against a prebuilt (factor, op) pair:
    after an escalation the certified driver re-runs them on the extended
    factor, warm-starting each residual solve with the same (extended)
    operator."""
    A = linop.as_operator(A, device=b.device)
    device = b.device
    x = x0
    itn_total = torch.zeros((), dtype=torch.int32, device=device)
    # refine_steps=0 returns the raw sketch-and-solve estimate: never
    # certify that as converged to the floor
    hit_floor = torch.tensor(refine_steps > 0, device=device)
    rhist = []
    for _ in range(refine_steps):
        r = b - A.matvec(x)
        rhist.append(_norm(r))
        z0 = factor.warm_start(op.apply(r, backend=backend))
        z, itn, done = _whitened_heavy_ball(
            factor, A, r, z0, alpha=alpha, beta=beta, iter_lim=inner_iter_lim,
            steptol=steptol,
        )
        x = x + factor.precondition(z)
        itn_total = itn_total + itn
        hit_floor = hit_floor & done

    r = b - A.matvec(x)
    rnorm = _norm(r)
    rhist.append(rnorm)
    g = A.rmatvec(r)
    istop = torch.where(hit_floor, 8, 7)
    istop = torch.where(_norm(b) == 0, 0, istop).to(torch.int32)
    return SolveResult(
        x=x,
        istop=istop,
        itn=itn_total,
        rnorm=rnorm,
        arnorm=_norm(g),
        used_fallback=torch.tensor(False, device=device),
        history=torch.stack(rhist) if history else None,
    )


def default_inner_iter_lim(beta: float, dtype=torch.float64) -> int:
    """FOSSILS inner-iteration budget: the error contracts by ≈ √β per
    step; budget to the numerical floor, with margin for the stall
    detector to certify it (istop=8)."""
    eps_mach = float(torch.finfo(dtype).eps)
    rate = max(math.sqrt(beta), 1e-3)
    return min(int(math.log(eps_mach) / math.log(rate)) + 30, 500)


def fossils(
    A,
    b,
    key,
    *,
    sketch="clarkson_woodruff",
    sketch_size: int | None = None,
    refine_steps: int = 2,
    inner_iter_lim: int | None = None,
    damping: float | None = None,
    momentum: float | None = None,
    steptol: float | None = None,
    backend: str = "auto",
    precision: str = "full",
    fused: bool | None = None,
    history: bool = False,
    device=None,
) -> SolveResult:
    """FOSSILS-style sketch-and-precondition with iterative refinement.

    x₀ = sketch-and-solve; each of the ``refine_steps`` passes solves the
    residual system min‖A d − r‖ in whitened coordinates with the
    damped/momentum inner iteration, warm-started from the sketched
    residual system z₀ = Qᵀ(Sr) (the same operator S), then updates
    x ← x + R⁻¹z.  ``history=True`` records the outer residual norms, a
    ``(refine_steps + 1,)`` tensor; ``itn`` counts inner iterations.
    """
    A, b, gen, steptol, alpha, beta = _setup(
        A, b, key, device, sketch, sketch_size, steptol, damping, momentum
    )
    if inner_iter_lim is None:
        inner_iter_lim = default_inner_iter_lim(beta, A.dtype)
    factor, op = SketchedFactor.build(
        A, gen, sketch=sketch, sketch_size=sketch_size, backend=backend,
        precision=precision, fused=fused,
    )
    x0 = factor.sketch_and_solve(op.apply(b, backend=backend))
    return fossils_refine(
        A, b, factor, op, x0, alpha, beta, refine_steps=refine_steps,
        inner_iter_lim=inner_iter_lim, steptol=steptol, backend=backend,
        history=history,
    )
