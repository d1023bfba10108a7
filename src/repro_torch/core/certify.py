"""Posterior certification of sketched least-squares solutions.

Port of ``repro/core/certify.py``: the trust layer behind
``lstsq(accuracy="certified")`` (Epperly 2024; Epperly–Meier–Nakatsukasa
2024).  Cheap quantities computed after a solve certify, or refute, the
returned solution:

- **Embedding distortion**, :func:`probe_distortion`.  For any probe w,
  ``‖S·A·R⁻¹w‖ = ‖Qw‖ = ‖w‖`` exactly (B = SA = QR), so k whitened
  Gaussian probes estimate the distortion from below at the cost of one
  blocked product with A.  A ratio far from 1 proves the embedding failed.
- **Condition estimate**, :func:`factor_spectrum`: σ_max, σ_min and κ₂ of
  R (one SVD of the n×n factor); σ_min(R)⁻¹ = ‖R⁻¹‖₂ is what the error
  bound pays to map whitened coordinates back to x-space.
- **Spectrum-floor probe**, :func:`probe_spectrum_floor`: ‖A R⁻¹ u‖ over
  R's k weakest left singular vectors, sharp where a noise-floored sketch
  (a bf16 apply at high κ) collapsed a few directions that isotropic
  probes dilute.
- **Forward-error bound**, :func:`error_bound`:
  ‖x̂ − x⋆‖ ≤ ‖Yᵀ(b − A x̂)‖ / (σ_min(Y)² · σ_min(R)) with Y = A R⁻¹ and
  σ_min(Y) estimated as min(1 − ε̂, σ̂).

Under ``precision="mixed"`` :func:`certify` takes σ_min(Y) exactly: it
forms Y = A R⁻¹ and takes the smallest singular value of the R factor of a
Householder QR of Y, the same value as the reference's ``svd(Y)[-1]`` to
rounding.  A QR of a tall (m, n) matrix is blocked level-3 work; an SVD of
it on the card bidiagonalizes with level-2 sweeps over all of Y.

The probe matrix W is drawn from the ``torch.Generator`` passed as
``key``.  :func:`_probe_distortion_w` and :func:`_certify_w` take W
itself, so a test can feed the reference's draw.  Spans
(``repro_torch.obs.trace``): ``certify.probe`` around the distortion probe
and the SVD of R, ``certify.floor`` around the σ_min(Y) floor.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..obs import trace as obs_trace
from . import backend as backend_lib
from . import linop
from .precond import SketchedFactor

__all__ = [
    "Certificate",
    "probe_distortion",
    "probe_spectrum_floor",
    "factor_spectrum",
    "error_bound",
    "certify",
    "build_certificate",
    "DEFAULT_MAX_DISTORTION",
]

# A healthy default sketch (s = 4n) has a-priori distortion ε ≈ √(n/s) =
# 0.5; probed values beyond that mean the embedding is no better than the
# most aggressive sketch the solvers' damping/momentum coefficients are
# derived for: treat it as failed and escalate.
DEFAULT_MAX_DISTORTION = 0.5


class Certificate(NamedTuple):
    """Posterior trust report for one sketched factor (and a solve).

    The tensor fields are 0-d tensors on the data's device.  The
    solution-independent ones (``distortion``, ``cond_R``) certify the
    embedding; the rest certify a solution x̂ and are nan when the
    certificate was issued without one.
    """

    distortion: torch.Tensor  # probed embedding distortion ε̂ (lower estimate)
    cond_R: torch.Tensor  # κ₂(R) ≈ κ₂(A) up to (1±ε) factors
    rnorm: torch.Tensor  # ‖b − A x̂‖ of the certified system
    whitened_arnorm: torch.Tensor  # ‖Yᵀ(b − A x̂)‖ = ‖R⁻ᵀ Aᵀ r̂‖
    error_bound: torch.Tensor  # posterior bound on ‖x̂ − x⋆‖
    rel_error_bound: torch.Tensor  # error_bound / ‖x̂‖
    target: torch.Tensor  # relative tolerance certified against (nan = none)
    passed: torch.Tensor  # bool: distortion ok AND bound within target
    sketch_rows: int = 0  # rows of S when the certificate was issued
    escalations: int = 0  # escalation steps taken before this certificate
    precision: str = "full"  # sketch precision the certified factor was built at


def _tiny(dtype):
    return torch.finfo(dtype).tiny


def _draw_probes(factor: SketchedFactor, key, n_probes: int) -> torch.Tensor:
    """W: (n, n_probes) standard normals from ``key`` on R's device."""
    R = factor.R
    gen = backend_lib.as_generator(key, R.device)
    return torch.randn((factor.n, int(n_probes)), generator=gen, dtype=R.dtype, device=R.device)


def _probe_distortion_w(A, factor: SketchedFactor, W: torch.Tensor) -> torch.Tensor:
    """max_j |‖w_j‖ / ‖A R⁻¹ w_j‖ − 1| for the given probes W (n, k)."""
    A = linop.as_operator(A, device=W.device)
    Yw = A.matmat(factor.precondition(W))
    wn = torch.linalg.vector_norm(W, dim=0)
    yn = torch.linalg.vector_norm(Yw, dim=0)
    ratios = wn / torch.clamp(yn, min=_tiny(W.dtype))
    return torch.max(torch.abs(ratios - 1.0))


def probe_distortion(A, factor: SketchedFactor, key, *, n_probes: int = 8) -> torch.Tensor:
    """Probed embedding distortion ε̂ = max_j |‖w_j‖ / ‖A R⁻¹ w_j‖ − 1|.

    The k probes share one blocked product with A.  The estimate only ever
    under-reports the true subspace distortion, so a failing probe is
    conclusive.  ``key`` is a ``torch.Generator`` (or an int seed).
    """
    return _probe_distortion_w(A, factor, _draw_probes(factor, key, n_probes))


def _floor_from_u(A, factor: SketchedFactor, U: torch.Tensor, k: int) -> torch.Tensor:
    """min_j ‖A R⁻¹ u_j‖ over the last k columns of R's left singular
    vectors U (descending singular values)."""
    n = factor.n
    kk = max(1, min(int(k), n))
    A = linop.as_operator(A, device=U.device)
    Yw = A.matmat(factor.precondition(U[:, n - kk:]))
    return torch.min(torch.linalg.vector_norm(Yw, dim=0))


def probe_spectrum_floor(A, factor: SketchedFactor, *, k: int = 4) -> torch.Tensor:
    """σ̂ = min_j ‖A R⁻¹ u_j‖ over R's k weakest left singular vectors.

    An upper estimate of σ_min(A R⁻¹) that is sharp where Gaussian probes
    are blind: a factor whose weakness is confined to a few directions (a
    noise-floored sketch).  For a healthy factor σ̂ lies in
    [1/(1+ε), 1/(1−ε)].  Cost: one n×n SVD and k matvecs.
    """
    U, _, _ = torch.linalg.svd(factor.R)
    return _floor_from_u(A, factor, U, k)


def factor_spectrum(factor: SketchedFactor):
    """(σ_max, σ_min, κ₂) of R — one SVD of the n×n triangular factor."""
    return _spectrum(torch.linalg.svdvals(factor.R))


def _spectrum(svals):
    smax, smin = svals[0], svals[-1]
    return smax, smin, smax / torch.clamp(smin, min=_tiny(svals.dtype))


def error_bound(A, b, x, factor: SketchedFactor, distortion) -> tuple:
    """Posterior ``(rnorm, whitened_arnorm, bound)`` at a solution x̂, with
    σ_min(Y) estimated as ``min(1 − distortion, probe_spectrum_floor)``.
    Cost: one matvec, one rmatvec, one triangular solve, two n×n SVDs and
    k floor matvecs."""
    _, smin, _ = factor_spectrum(factor)
    floor = probe_spectrum_floor(A, factor)
    return _error_bound_parts(A, b, x, factor, distortion, smin, floor)


def _error_bound_parts(A, b, x, factor, distortion, smin, sigma_floor=None):
    A = linop.as_operator(A, device=x.device)
    r = b - A.matvec(x)
    rnorm = torch.linalg.vector_norm(r)
    wg_norm = torch.linalg.vector_norm(factor.rt_solve(A.rmatvec(r)))
    tiny = _tiny(factor.R.dtype)
    eps = torch.clamp(torch.as_tensor(distortion, dtype=rnorm.dtype, device=rnorm.device), 0.0, 0.999)
    # ‖x̂−x⋆‖ = ‖R⁻¹(YᵀY)⁻¹Yᵀr̂‖ ≤ ‖Yᵀr̂‖ / (σ_min(Y)² σ_min(R)); both
    # σ_min(Y) estimates are upper estimates, take the sharper one
    sigma_w = 1.0 - eps
    if sigma_floor is not None:
        sigma_w = torch.minimum(sigma_w, sigma_floor)
    sigma_w = torch.clamp(sigma_w, min=tiny)
    bound = wg_norm / (sigma_w**2 * torch.clamp(smin, min=tiny))
    return rnorm, wg_norm, bound


def _adaptive_target(dtype, cond_R, rnorm, smax, xnorm):
    """Default relative-error target: 100x the attainable QR-level error
    ε_mach·(κ + κ²·‖r‖/(‖A‖‖x‖)), clipped to [64·ε_mach, 1e-2]."""
    eps_mach = torch.finfo(dtype).eps
    kappa_term = cond_R + cond_R**2 * rnorm / torch.clamp(smax * xnorm, min=_tiny(dtype))
    return torch.clamp(100.0 * eps_mach * kappa_term, 64.0 * eps_mach, 1e-2)


def _exact_whitened_floor(A, factor: SketchedFactor) -> torch.Tensor:
    """σ_min(A R⁻¹) exactly: Y = A R⁻¹, then the smallest singular value
    of the R factor of a Householder QR of Y (the singular values of Y)."""
    Y = factor.materialize_whitened(A)
    R_y = torch.linalg.qr(Y, mode="r").R
    del Y
    return torch.linalg.svdvals(R_y)[-1]


def certify(
    A,
    b,
    x,
    factor: SketchedFactor,
    key,
    *,
    n_probes: int = 8,
    target: float | None = None,
    max_distortion: float = DEFAULT_MAX_DISTORTION,
    sketch_rows: int | None = None,
    escalations: int = 0,
    precision: str = "full",
) -> Certificate:
    """Issue a :class:`Certificate` for ``x ≈ argmin‖Ax − b‖`` (or, with
    ``b = x = None``, for the embedding alone).

    ``key`` is a ``torch.Generator`` on the data's device (or an int
    seed); the (n, ``n_probes``) probe matrix is its one draw.
    ``target=None`` resolves to the adaptive default, 100x the classical
    attainable-accuracy floor.  ``passed`` requires the probed distortion
    ≤ ``max_distortion`` and, with a solution, the relative error bound
    ≤ the target.
    """
    W = _draw_probes(factor, key, n_probes)
    return _certify_w(
        A, b, x, factor, W, target=target, max_distortion=max_distortion,
        sketch_rows=sketch_rows, escalations=escalations, precision=precision,
    )


def _certify_w(
    A, b, x, factor, W, *, target=None, max_distortion=DEFAULT_MAX_DISTORTION,
    sketch_rows=None, escalations=0, precision="full",
) -> Certificate:
    """:func:`certify` with the probe matrix W given."""
    A = linop.as_operator(A, device=W.device)
    dtype = factor.R.dtype
    with obs_trace.span("certify.probe", n_probes=W.shape[1]):
        eps_hat = _probe_distortion_w(A, factor, W)
        U, svals, _ = torch.linalg.svd(factor.R)
        smax, smin, cond_R = _spectrum(svals)
        obs_trace.maybe_block(eps_hat)
    nan = torch.full((), float("nan"), dtype=dtype, device=W.device)
    emb_ok = (eps_hat <= max_distortion) & torch.isfinite(cond_R)
    meta = dict(
        sketch_rows=int(sketch_rows or factor.sketch_size),
        escalations=int(escalations), precision=precision,
    )
    if x is None:
        return Certificate(
            distortion=eps_hat, cond_R=cond_R, rnorm=nan, whitened_arnorm=nan,
            error_bound=nan, rel_error_bound=nan, target=nan, passed=emb_ok, **meta,
        )

    with obs_trace.span("certify.floor", precision=precision):
        if precision == "mixed":
            # Sampling probes cannot price a low-precision sketch: its
            # rounding noise floors R's trailing subspace and hides A's weak
            # directions where no O(1) probe set looks.  A mixed factor pays
            # one exact whitened-spectrum pass, O(mn²), the order of the
            # full-precision apply the bf16 sketch skipped.
            floor = _exact_whitened_floor(A, factor)
        else:
            floor = _floor_from_u(A, factor, U, 4)
        obs_trace.maybe_block(floor)
    rnorm, wg_norm, bound = _error_bound_parts(A, b, x, factor, eps_hat, smin, floor)
    xnorm = torch.linalg.vector_norm(x)
    rel = bound / torch.clamp(xnorm, min=_tiny(dtype))
    if target is None:
        tgt = _adaptive_target(dtype, cond_R, rnorm, smax, xnorm)
    else:
        tgt = torch.full((), float(target), dtype=dtype, device=W.device)
    passed = emb_ok & torch.isfinite(bound) & (rel <= tgt)
    return Certificate(
        distortion=eps_hat, cond_R=cond_R, rnorm=rnorm, whitened_arnorm=wg_norm,
        error_bound=bound, rel_error_bound=rel, target=tgt, passed=passed, **meta,
    )


def build_certificate(
    factor: SketchedFactor,
    *,
    distortion,
    rnorm,
    whitened_arnorm,
    xnorm,
    target: float | None = None,
    max_distortion: float = DEFAULT_MAX_DISTORTION,
    sketch_rows: int | None = None,
    escalations: int = 0,
) -> Certificate:
    """Assemble a :class:`Certificate` from pieces computed elsewhere (the
    streaming certified mode's own passes over A), with the same bound,
    adaptive target and pass rule; σ_min(Y) is the isotropic probe's
    1 − ε̂ alone, since there is no A here."""
    R = factor.R
    dtype = R.dtype

    def t(v):
        return torch.as_tensor(v, dtype=dtype, device=R.device)

    distortion, rnorm, whitened_arnorm, xnorm = map(t, (distortion, rnorm, whitened_arnorm, xnorm))
    smax, smin, cond_R = factor_spectrum(factor)
    tiny = _tiny(dtype)
    eps = torch.clamp(distortion, 0.0, 0.999)
    bound = whitened_arnorm / ((1.0 - eps) ** 2 * torch.clamp(smin, min=tiny))
    rel = bound / torch.clamp(xnorm, min=tiny)
    tgt = _adaptive_target(dtype, cond_R, rnorm, smax, xnorm) if target is None else t(float(target))
    passed = (
        (distortion <= max_distortion)
        & torch.isfinite(cond_R)
        & torch.isfinite(bound)
        & (rel <= tgt)
    )
    return Certificate(
        distortion=distortion, cond_R=cond_R, rnorm=rnorm,
        whitened_arnorm=whitened_arnorm, error_bound=bound, rel_error_bound=rel,
        target=tgt, passed=passed,
        sketch_rows=int(sketch_rows or factor.sketch_size),
        escalations=int(escalations),
    )
