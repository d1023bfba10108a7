"""``SketchedSolver`` — a reusable sketch-and-solve session.

Port of ``repro/core/session.py``.  Every sketched solver pays the same
precompute: draw S, sketch B = SA, QR-factor B.  For many right-hand sides
against one design matrix that precompute dominates, and the functional
``lstsq``/``saa_sas`` API redoes it per call.

``SketchedSolver(A, gen)`` builds the :class:`repro_torch.core.precond
.SketchedFactor` once (and, for dense A, the whitened Y = A R⁻¹) and then
serves:

- ``solve(b)``        — one right-hand side: one sketch of b, LSQR on the
  kept Y warm-started at Qᵀ(Sb), one back substitution;
- ``solve_many(B)``   — k stacked right-hand sides: one sketch of the
  (m, k) block and one block LSQR in which each column stops at its own
  stop (as each lane of the reference's ``vmap`` of a ``while_loop``);
- ``update_rows(idx, rows)`` — a row update of A with an O(|idx|·n)
  *delta-sketch*: S is linear in the rows of A, so
  SA′ = SA + S[:, idx]·(A′[idx] − A[idx]) (on the card, kernel B1 on a CSR
  of |idx| entries for the bucket kinds, B6 for the dense ones); the SRHT
  has no column restriction and sketches the new A again with the SAME S
  (kernel B8).  The caller's A is never written: the session works on a
  copy with the rows replaced, and drops its old Y before forming the new
  one.

``stats`` (mirrored into ``repro_torch.obs.REGISTRY`` under ``session.*``)
counts ``sketches``, ``qr_factorizations`` and ``solves``: the point of the
session is that the first two stay put while ``solves`` grows.

Trust layer: ``certify()`` gives a posterior certificate for the stored
factor (or, given ``(b, result)``, for that answer).  Row updates drift the
embedding, so ``auto_recertify=True`` re-probes after each ``update_rows``
and, while the probe fails, escalates the sketch by appended rows
(``SketchedFactor.extend``) until it certifies or reaches m rows.

Random draws, all from the one ``torch.Generator`` passed in, in call
order: S at construction; then each ``certify`` call's probe matrix W and
each escalation's extension block, as they happen.

Dense A only: ``reg=`` and sparse or matrix-free inputs raise
``NotImplementedError`` naming ROADMAP A8.
"""
from __future__ import annotations

import torch

from ..obs import trace as obs_trace
from ..obs.metrics import REGISTRY
from . import backend as backend_lib
from . import certify as certify_lib
from . import linop
from .lsqr import lsqr
from .precond import SketchedFactor, _kind_name, _operator_for
from .result import SolveResult

__all__ = ["SketchedSolver"]


class SketchedSolver:
    """One sketch + QR, amortized over arbitrarily many solves.

    Parameters mirror ``saa_sas`` (sketch kind or an already-drawn
    operator, sketch size, tolerances, backend); ``key`` is a
    ``torch.Generator`` on the data's device (or an int seed) and
    ``device=None`` means ``"cuda"``.  ``materialize_y=None`` keeps
    Y = A R⁻¹ (LSQR by two gemvs over Y per iteration); ``False`` runs LSQR
    in operator form on A and R.
    """

    def __init__(
        self,
        A,
        key,
        *,
        sketch="clarkson_woodruff",
        sketch_size: int | None = None,
        reg=None,
        atol: float = 0.0,
        btol: float = 0.0,
        steptol: float | None = None,
        iter_lim: int = 100,
        materialize_y: bool | None = None,
        backend: str = "auto",
        auto_recertify: bool = False,
        max_distortion: float = certify_lib.DEFAULT_MAX_DISTORTION,
        certify_probes: int = 8,
        device=None,
    ):
        if reg is not None:
            raise NotImplementedError(
                "SketchedSolver(reg=...) (Tikhonov) arrives with ROADMAP A8"
            )
        self.A = linop.as_operator(A, device=device)
        if not isinstance(self.A, linop.DenseOperator):
            raise NotImplementedError(
                f"SketchedSolver on a {type(self.A).__name__} (matrix-free "
                "input) arrives with ROADMAP A8"
            )
        self.backend = backend_lib.check_backend(backend)
        self._gen = backend_lib.as_generator(key, self.A.device)
        if steptol is None:
            steptol = 32 * float(torch.finfo(self.A.dtype).eps)
        self._kw = dict(atol=atol, btol=btol, steptol=steptol, iter_lim=iter_lim)
        self._materialize_y = True if materialize_y is None else bool(materialize_y)
        self._sketch_op = _operator_for(sketch, self.A, sketch_size, self._gen)
        self.sketch_size = self._sketch_op.d
        self.auto_recertify = auto_recertify
        self.max_distortion = float(max_distortion)
        self.certify_probes = int(certify_probes)
        self.certificate = None  # embedding-level certificate of the CURRENT factor
        self.recertifications = 0  # auto-recertify probes taken so far
        self.escalations = 0  # sketch extensions taken by recertification
        self._Y = None

        self.stats = REGISTRY.stats_dict(
            "session", {"sketches": 0, "qr_factorizations": 0, "solves": 0}
        )
        with obs_trace.span("session.build", rows=self.sketch_size):
            with obs_trace.span("sketch.apply", kind=_kind_name(sketch)):
                self._B = self._sketch_op.apply_op(self.A, backend=self.backend)
                obs_trace.maybe_block(self._B)
            self.stats["sketches"] += 1
            self._refactor()

    # ------------------------------------------------------------------ build
    def _refactor(self):
        """(Re)build the QR factor — and Y, if kept — from ``self._B``."""
        with obs_trace.span("factor.qr", shape=tuple(self._B.shape)):
            self.factor = SketchedFactor.from_sketch(self._B)
            obs_trace.maybe_block(self.factor.R)
        self._after_refactor()

    def _after_refactor(self):
        """Bookkeeping shared by every path that replaced the factor.  The
        old Y goes before the new one is formed (one Y at a time)."""
        self.stats["qr_factorizations"] += 1
        self._Y = None
        if self._materialize_y:
            self._Y = self.factor.materialize_whitened(self.A)

    @property
    def shape(self) -> tuple[int, int]:
        return self.A.shape

    # ------------------------------------------------------- certification
    def certify(self, b=None, result=None, *, n_probes=None, target=None):
        """Posterior :class:`~repro_torch.core.certify.Certificate` for the
        stored factor — or, given one solve's ``(b, result)``, for that
        answer (forward-error bound included).

        The embedding-level form (no arguments) is kept on
        ``self.certificate`` and is what ``auto_recertify`` refreshes
        after row updates.  Cost: ``certify_probes`` products with A plus
        one n×n SVD; nothing is sketched again.  Draws its probe matrix
        from the session's generator.
        """
        if (b is None) != (result is None):
            raise ValueError("pass b and result together (or neither)")
        x = None
        b_solve = None
        if b is not None:
            x = result.x
            if x.ndim != 1:
                raise ValueError(
                    "certify takes one right-hand side at a time; "
                    "certify solve_many columns individually"
                )
            b_solve = backend_lib.as_tensor(b, self.A.device, self.A.dtype)
        with obs_trace.span("session.certify", with_solution=x is not None):
            cert = certify_lib.certify(
                self.A, b_solve, x, self.factor, self._gen,
                n_probes=(
                    self.certify_probes if n_probes is None else int(n_probes)
                ),
                target=target, max_distortion=self.max_distortion,
                sketch_rows=self._sketch_op.d, escalations=self.escalations,
            )
        if x is None:
            self.certificate = cert
        return cert

    def _escalate(self, extra: int):
        """Append ``extra`` fresh rows to S and re-QR — the stored sketch
        is extended (never recomputed), the certified ladder's move."""
        with obs_trace.span("session.escalate", extra=extra):
            self.factor, self._sketch_op, self._B = self.factor.extend(
                self.A, self._sketch_op, self._gen, extra, B=self._B,
                backend=self.backend,
            )
        # extend() sketched the new rows and re-QRed
        self.stats["sketches"] += 1
        self._after_refactor()
        self.sketch_size = self._sketch_op.d
        self.escalations += 1

    def _recertify_after_update(self):
        """Probe the drifted embedding; escalate until it certifies again
        (or the sketch reaches the data's row count)."""
        m = self.A.shape[0]
        cert = self.certify()
        self.recertifications += 1
        while not bool(cert.passed):
            s = self._sketch_op.d
            extra = min(s, m - s)
            if extra <= 0:
                break
            self._escalate(extra)
            cert = self.certify()
            self.recertifications += 1

    # ----------------------------------------------------------------- solves
    def _check_rhs(self, b, *, many: bool) -> torch.Tensor:
        """Validate a right-hand side up front — shape and dtype.

        Shape mismatches raise here with the session's expectation spelled
        out.  Dtype policy: a right-hand side that would *promote* the
        solve away from A's dtype (f64 b against an f32 session, complex
        against real) is an error — it would misstate the precision the
        factor was built at; a safely representable one (f32 b, f64 A) is
        cast to A's dtype explicitly.
        """
        b = backend_lib.as_tensor(b, self.A.device)
        m = self.A.shape[0]
        if many:
            if b.ndim != 2 or b.shape[0] != m:
                raise ValueError(
                    f"solve_many needs B of shape ({m}, k), got {tuple(b.shape)}"
                )
        else:
            if b.ndim != 1 or b.shape[0] != m:
                raise ValueError(
                    f"solve needs b of shape ({m},) matching A's row count, "
                    f"got {tuple(b.shape)}"
                )
        dtype = self.A.dtype
        if b.dtype != dtype:
            if torch.promote_types(b.dtype, dtype) != dtype:
                raise TypeError(
                    f"right-hand side dtype {b.dtype} does not fit the "
                    f"session's {dtype} factor: solving would silently "
                    f"promote past the precision A was sketched at — cast "
                    f"b (or rebuild the session at {b.dtype}) explicitly"
                )
            b = b.to(dtype)
        return b

    def _solve(self, b, history: bool) -> SolveResult:
        """One sketch of b (or of a block), the warm start z₀ = Qᵀ(Sb), LSQR
        on the whitened system (Y's gemvs, or operator form) and x = R⁻¹z."""
        A, f, Y = self.A, self.factor, self._Y
        if Y is not None:
            mv, rmv = (lambda z: Y @ z), (lambda u: Y.T @ u)
        else:
            mv, rmv = (lambda z: f.whiten_mv(A, z)), (lambda u: f.whiten_rmv(A, u))
        c = self._sketch_op.apply(b, backend=self.backend)
        res = lsqr(mv, rmv, b, x0=f.warm_start(c), history=history, **self._kw)
        return res._replace(x=f.precondition(res.x))

    def solve(self, b, *, history: bool = False) -> SolveResult:
        """min‖Ax − b‖ against the stored factor (one whitened LSQR run)."""
        b = self._check_rhs(b, many=False)
        with obs_trace.span("session.solve") as sp:
            res = self._solve(b, history)
            obs_trace.maybe_block(res.x)
            if sp:
                sp.set(itn=int(res.itn))
        self.stats["solves"] += 1
        return res._replace(method="session")

    def solve_many(self, B) -> SolveResult:
        """k stacked right-hand sides (m, k) → x of shape (n, k).

        One sketch of B, one block LSQR (each column stops at its own stop;
        every product with Y takes all k columns), one blocked back
        substitution — the factor is shared by construction.
        """
        B = self._check_rhs(B, many=True)
        k = int(B.shape[1])
        with obs_trace.span("session.solve_many", k=k):
            res = self._solve(B, False)
            obs_trace.maybe_block(res.x)
        self.stats["solves"] += k
        return res._replace(
            used_fallback=torch.zeros(k, dtype=torch.bool, device=B.device),
            method="session",
        )

    # ---------------------------------------------------------------- updates
    def update_rows(self, idx, rows) -> None:
        """Replace rows ``A[idx] ← rows`` and refresh the factor in
        O(|idx|·n) sketch work + one s×n QR (no full re-sketch; the SRHT
        sketches the new A again with the same S).

        ``idx`` must hold unique row indices in [−m, m).  The caller's A is
        not written: the session keeps a copy with the rows replaced.
        """
        A = self.A.A
        m, n = A.shape
        idx = backend_lib.as_tensor(idx, A.device).reshape(-1).to(torch.int64)
        rows = backend_lib.as_tensor(rows, A.device, A.dtype)
        if tuple(rows.shape) != (idx.shape[0], n):
            raise ValueError(
                f"rows must have shape ({idx.shape[0]}, {n}), got {tuple(rows.shape)}"
            )
        if idx.numel() and not (-m <= int(idx.min()) and int(idx.max()) < m):
            raise ValueError(f"row indices must lie in [-{m}, {m})")
        idx = torch.where(idx < 0, idx + m, idx)
        if int(torch.unique(idx).numel()) != int(idx.numel()):
            # duplicates would double-count in the delta-sketch while the
            # row rewrite is last-write-wins — the stored B would stop
            # matching S·A and poison every later solve
            raise ValueError("idx must contain unique row indices")
        with obs_trace.span("session.update_rows", rows=int(idx.numel())):
            A_new = A.clone()
            A_new[idx] = rows
            # The sub-sketch S[:, idx]; None for the SRHT.
            sub = self._sketch_op.restrict_cols(idx)
            if sub is None:
                # SRHT: no column restriction — sketch again with the SAME S.
                self.A = linop.DenseOperator(A_new)
                self._B = self._sketch_op.apply_op(self.A, backend=self.backend)
                self.stats["sketches"] += 1
            else:
                d_sk = sub.apply(rows - A[idx], backend=self.backend)
                self._B = self._B + d_sk
                self.A = linop.DenseOperator(A_new)
            del A, A_new  # a caller that dropped the old A frees it before Y
            self._refactor()
        # The delta-sketch is exact, but S was drawn obliviously to the
        # ORIGINAL rows: its embedding quality for the new range(A) must be
        # re-established, not assumed.
        self.certificate = None
        if self.auto_recertify:
            self._recertify_after_update()
