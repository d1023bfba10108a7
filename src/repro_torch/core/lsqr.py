"""LSQR (Paige & Saunders 1982) in PyTorch.

Port of ``repro/core/lsqr.py``: minimizes ``‖Ax − b‖₂`` given
``matvec(x) = A x`` and ``rmatvec(u) = Aᵀ u``, with a warm start ``x0``
(SAA-SAS's ``z₀ = Qᵀc``) solved for as a correction against ``b − A x₀``.

The reference runs the iteration as one ``lax.while_loop`` whose stop test
never leaves the device.  Here the iteration is a Python loop, the state
stays on the device as 0-d tensors, and the host reads ``istop`` after
every iteration, so no operator product runs past the stop.  Reading it
only every few iterations, with the updates after a stop frozen by
``torch.where``, saves host syncs but spends the frozen iterations' two
products each; on an H100 the frozen products cost more than the syncs
they save (PERF.md, "LSQR's wasted operator products").

istop codes follow SciPy's convention:
  0 x=0 is the exact solution;  1 residual-level convergence (btol/atol);
  2 least-squares convergence (AᵀR small);  7 iteration limit;
  8 step-size floor — three consecutive relative updates below ``steptol``,
    the right test for SAA-SAS's whitened inner system (see the reference
    module's docstring).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .backend import as_tensor
from .result import SolveResult

__all__ = ["lsqr", "lsqr_dense", "lsqr_operator"]


class _State(NamedTuple):
    itn: torch.Tensor
    istop: torch.Tensor
    x: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    w: torch.Tensor
    alfa: torch.Tensor
    rhobar: torch.Tensor
    phibar: torch.Tensor
    anorm2: torch.Tensor  # running ‖A‖_F² estimate
    acond: torch.Tensor
    ddnorm: torch.Tensor
    xnorm: torch.Tensor
    arnorm: torch.Tensor
    n_small_steps: torch.Tensor  # consecutive relative steps below steptol
    rhist: torch.Tensor  # (iter_lim,) residual history, or (0,) when disabled


def _nonzero(t):
    """``t`` where it is non-zero, else 1 (safe denominator)."""
    return torch.where(t == 0, torch.ones_like(t), t)


def _sym_ortho(a, b):
    """Stable Givens rotation (c, s, r) with r = hypot(a, b)."""
    r = torch.hypot(a, b)
    safe = _nonzero(r)
    c = torch.where(r == 0, torch.ones_like(r), a / safe)
    s = torch.where(r == 0, torch.zeros_like(r), b / safe)
    return c, s, r


def lsqr(
    matvec: Callable,
    rmatvec: Callable,
    b: torch.Tensor,
    *,
    x0: torch.Tensor | None = None,
    atol: float = 1e-8,
    btol: float = 1e-8,
    conlim: float = 1e8,
    iter_lim: int | None = None,
    steptol: float = 0.0,
    history: bool = False,
) -> SolveResult:
    """Minimize ‖Ax − b‖₂ for the operator given by ``matvec``/``rmatvec``.

    ``b`` (and ``x0``) are tensors on the operator's device.
    ``history=True`` records per-iteration residual norms (``(iter_lim,)``,
    nan-padded).
    """
    dtype, device = b.dtype, b.device

    def norm(t):
        return torch.sqrt(torch.dot(t, t))

    # Warm start: iterate on the correction dx against r0 = b − A x0, but
    # keep the ORIGINAL ‖b‖ and ‖x0 + dx‖ in the stopping tests.
    bnorm = norm(b)
    x_base = x0
    if x0 is not None:
        b = b - matvec(x0)

    finfo = torch.finfo(dtype)
    beta = norm(b)
    u = b / _nonzero(beta)
    v_raw = rmatvec(u)
    alfa = norm(v_raw)
    v = v_raw / _nonzero(alfa)
    if iter_lim is None:
        iter_lim = 2 * v.shape[0]

    def scalar(val, dt=dtype):
        return torch.tensor(val, dtype=dt, device=device)

    init = _State(
        itn=scalar(0, torch.int32),
        istop=scalar(0, torch.int32),
        x=torch.zeros_like(v),
        u=u,
        v=v,
        w=v,
        alfa=alfa,
        rhobar=alfa,
        phibar=beta,
        anorm2=scalar(0.0),
        acond=scalar(0.0),
        ddnorm=scalar(0.0),
        xnorm=scalar(0.0),
        arnorm=alfa * beta,
        n_small_steps=scalar(0, torch.int32),
        rhist=torch.full((iter_lim if history else 0,), float("nan"),
                         dtype=dtype, device=device),
    )
    ctol = 0.0 if conlim <= 0 else 1.0 / conlim
    hist_idx = torch.arange(iter_lim if history else 0, device=device)

    def body(s: _State) -> _State:
        itn = s.itn + 1
        # Golub–Kahan bidiagonalization step.
        u_raw = matvec(s.v) - s.alfa * s.u
        beta_k = norm(u_raw)
        u = u_raw / _nonzero(beta_k)
        anorm2 = s.anorm2 + s.alfa**2 + beta_k**2
        v_raw = rmatvec(u) - beta_k * s.v
        alfa_k = norm(v_raw)
        v = v_raw / _nonzero(alfa_k)

        # Givens rotation to zero out beta_k of the bidiagonal system.
        c, sn, rho = _sym_ortho(s.rhobar, beta_k)
        theta = sn * alfa_k
        rhobar = -c * alfa_k
        phi = c * s.phibar
        phibar = sn * s.phibar

        rho_safe = _nonzero(rho)
        t1 = phi / rho_safe
        t2 = -theta / rho_safe
        x = s.x + t1 * s.w
        dk = s.w / rho_safe
        ddnorm = s.ddnorm + torch.dot(dk, dk)
        w = v + t2 * s.w

        anorm = torch.sqrt(anorm2)
        acond = anorm * torch.sqrt(ddnorm)
        rnorm = phibar
        arnorm = alfa_k * torch.abs(sn * s.phibar)  # ‖Aᵀr‖ estimate
        x_full = x if x_base is None else x + x_base
        xnorm = norm(x_full)

        # Stopping tests (SciPy-compatible).
        test1 = rnorm / _nonzero(bnorm)
        test2 = arnorm / _nonzero(anorm * rnorm)
        test3 = 1.0 / _nonzero(acond)
        rtol = btol + atol * anorm * xnorm / _nonzero(bnorm)

        # Step-size floor test (istop=8): relative z-update below steptol
        # for three consecutive iterations.
        step = torch.abs(t1) * norm(s.w)
        relstep = step / torch.clamp(xnorm, min=finfo.tiny)
        small = (relstep <= steptol) if steptol > 0 else torch.zeros_like(itn, dtype=torch.bool)
        n_small = torch.where(small, s.n_small_steps + 1, 0).to(torch.int32)

        istop = torch.zeros_like(itn)
        istop = torch.where(itn >= iter_lim, 7, istop)
        istop = torch.where(n_small >= 3, 8, istop)
        istop = torch.where(1 + test3 <= 1, 6, istop)
        istop = torch.where(1 + test2 <= 1, 5, istop)
        istop = torch.where(1 + test1 <= 1, 4, istop)
        istop = torch.where(test3 <= ctol, 3, istop)
        istop = torch.where(test2 <= atol, 2, istop)
        istop = torch.where(test1 <= rtol, 1, istop)

        rhist = s.rhist
        if history:
            rhist = torch.where(hist_idx == itn - 1, rnorm, rhist)

        return _State(
            itn=itn, istop=istop.to(torch.int32), x=x, u=u, v=v, w=w,
            alfa=alfa_k, rhobar=rhobar, phibar=phibar, anorm2=anorm2,
            acond=acond, ddnorm=ddnorm, xnorm=xnorm, arnorm=arnorm,
            n_small_steps=n_small, rhist=rhist,
        )

    state = init
    for _ in range(iter_lim):
        state = body(state)
        if bool(state.istop != 0):  # the host sync of this iteration
            break

    istop = torch.where((bnorm == 0) | (init.arnorm == 0), 0, state.istop)
    x_out = state.x if x_base is None else state.x + x_base
    return SolveResult(
        x=x_out,
        istop=istop.to(torch.int32),
        itn=state.itn,
        rnorm=state.phibar,
        arnorm=state.arnorm,
        used_fallback=torch.tensor(False, device=device),
        history=state.rhist if history else None,
    )


def lsqr_operator(A, b, *, device=None, **kw) -> SolveResult:
    """LSQR on a dense matrix or ``linop.LinearOperator`` — the sketch-free
    iterative path (``lstsq``'s keyless fallback)."""
    from . import linop

    A = linop.as_operator(A, device=device)
    b = as_tensor(b, A.device, A.dtype)
    return lsqr(A.matvec, A.rmatvec, b, **kw)


def lsqr_dense(A, b, *, device=None, **kw) -> SolveResult:
    """LSQR with an explicit A (the paper's baseline configuration)."""
    return lsqr_operator(A, b, device=device, **kw)
