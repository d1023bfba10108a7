"""Request coalescing: continuous micro-batching and padded shape buckets.

Port of ``repro/serve/batching.py``.  Two traffic shapes, two batching
strategies:

- **Same-fingerprint traffic** (many right-hand sides against one cached
  factor) coalesces into ONE ``solve_many`` call: the sketch of the RHS
  block, the block whitened LSQR and the blocked back-substitution all
  amortize, and the per-request marginal cost drops to a few gemm columns.
- **Many-small-problem traffic** (each request carries its own tiny A)
  can't share a factor, but it CAN share one batched call: problems are
  padded into geometric *shape buckets* ``(m_pad, n_pad)`` (next power of
  two per axis) and solved by one batched direct QR per bucket.  (The
  reference pads so that XLA compiles one executable per bucket; here the
  buckets let one ``torch.linalg.qr`` launch serve a whole batch of
  different shapes.)

Padding preserves exactness: a problem (A, b) lands in its bucket as

    A_pad = [[A, 0], [0, I_extra]],   b_pad = [b, 0]

block-diagonal, so the padded least-squares problem decouples —
``x_pad = [x*, 0]`` with x* the original minimizer (the identity block
keeps A_pad full column rank; the extra coordinates are driven to zero
by their zero right-hand side, also under ridge).  Per-problem ridge is
appended as ``√λᵢ·I`` rows inside the same bucket (λ = 0 rows are zero
rows and change nothing, so regularized and plain problems share one
batch).

:class:`MicroBatcher` is the queue policy shared by both paths: per-key
FIFO queues released when they reach ``max_batch`` or when their oldest
request has waited ``max_delay_s`` (the continuous-batching window), plus
occupancy accounting for the load harness.
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Any, Hashable

import torch

from ..core import backend as backend_lib
from ..obs.lockcheck import make_lock

__all__ = [
    "MicroBatcher",
    "bucket_shape",
    "pad_problem",
    "solve_bucket",
]


# ---------------------------------------------------------------------------
# micro-batch queue


@dataclasses.dataclass
class _Queue:
    items: list
    oldest: float  # enqueue time of the head request


class MicroBatcher:
    """Per-key FIFO queues with a continuous micro-batching release rule.

    A key's queue is released as a batch when it holds ``max_batch``
    requests (size-triggered) or when its oldest request has aged past
    ``max_delay_s`` (latency-triggered — the knob bounding the queueing
    delay a lone request can suffer).  ``drain=True`` releases everything
    regardless of age, the flush path.  ``now=`` overrides the monotonic
    clock (tests script it).

    Thread-safe on its own lock: the service pump, racing submitters and
    a stats() poll can all touch one batcher without relying on the
    caller's locking.
    """

    GUARDED_BY = {"_queues": "_mu", "batch_sizes": "_mu", "enqueued": "_mu"}
    GUARDED_READS = frozenset({"_queues"})

    def __init__(self, max_batch: int = 64, max_delay_s: float = 0.002):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.max_batch = int(max_batch)
        self.max_delay_s = float(max_delay_s)
        self._mu = make_lock("MicroBatcher._mu")
        self._queues: "OrderedDict[Hashable, _Queue]" = OrderedDict()
        self.batch_sizes: list[int] = []  # every released batch's occupancy
        self.enqueued = 0

    def add(self, key: Hashable, item: Any, now: float | None = None) -> None:
        now = time.monotonic() if now is None else now
        with self._mu:
            q = self._queues.get(key)
            if q is None:
                self._queues[key] = _Queue(items=[item], oldest=now)
            else:
                q.items.append(item)
            self.enqueued += 1

    @property
    def pending(self) -> int:
        with self._mu:
            return sum(len(q.items) for q in self._queues.values())

    def ready(
        self, now: float | None = None, *, drain: bool = False
    ) -> list[tuple[Hashable, list]]:
        """Pop and return every batch the release rule fires for."""
        now = time.monotonic() if now is None else now
        out: list[tuple[Hashable, list]] = []
        with self._mu:
            for key in list(self._queues):
                q = self._queues[key]
                while len(q.items) >= self.max_batch:
                    out.append((key, q.items[: self.max_batch]))
                    q.items = q.items[self.max_batch:]
                    q.oldest = now
                if q.items and (drain or (now - q.oldest) >= self.max_delay_s):
                    out.append((key, q.items))
                    q.items = []
                if not q.items:
                    del self._queues[key]
            for _, items in out:
                self.batch_sizes.append(len(items))
        return out

    @property
    def mean_occupancy(self) -> float:
        """Mean released-batch size / max_batch ∈ (0, 1]."""
        with self._mu:
            if not self.batch_sizes:
                return 0.0
            return sum(self.batch_sizes) / (
                len(self.batch_sizes) * self.max_batch
            )


# ---------------------------------------------------------------------------
# shape buckets


def _next_pow2(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length()


def bucket_shape(m: int, n: int, *, min_n: int = 8) -> tuple[int, int]:
    """The padded bucket a raw (m, n) problem lands in.

    ``n_pad`` is the next power of two (≥ ``min_n``); ``m_pad`` the next
    power of two that also leaves room for the ``n_pad − n`` identity
    rows the column padding needs.  Geometric rounding ⇒ the number of
    distinct buckets grows with log(m)·log(n), not with the number of
    distinct request shapes.
    """
    if m < 1 or n < 1:
        raise ValueError(f"need m, n >= 1, got ({m}, {n})")
    n_pad = _next_pow2(max(n, min_n))
    m_pad = _next_pow2(max(m + (n_pad - n), n_pad))
    return m_pad, n_pad


def pad_problem(
    A: torch.Tensor, b: torch.Tensor, m_pad: int, n_pad: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Embed (A, b) block-diagonally into the (m_pad, n_pad) bucket, on
    A's device and in A's dtype."""
    m, n = A.shape
    extra = n_pad - n
    if m + extra > m_pad or extra < 0:
        raise ValueError(
            f"problem ({m}, {n}) does not fit bucket ({m_pad}, {n_pad})"
        )
    A_pad = A.new_zeros((m_pad, n_pad))
    A_pad[:m, :n] = A
    if extra:
        i = torch.arange(extra, device=A.device)
        A_pad[m + i, n + i] = 1.0
    b_pad = A.new_zeros((m_pad,))
    b_pad[:m] = b.to(device=A.device, dtype=A.dtype)
    return A_pad, b_pad


def _solve_bucket_direct(A_stack, b_stack, lam, *, certify: bool):
    """One batched QR over the whole bucket.

    Ridge rides along as exact ``√λᵢ·I`` rows appended per problem
    (λᵢ = 0 appends zero rows — a no-op).  With ``certify=True`` the QR's
    own R yields a rigorous posterior bound per problem: Y = A_aug R⁻¹ = Q
    is *exactly* orthonormal here (S = I, zero distortion), so
    ‖x̂ − x⋆‖ ≤ ‖R⁻ᵀ A_augᵀ r̂‖ / σ_min(R) with no probabilistic qualifier.
    """
    k, m_pad, n_pad = A_stack.shape
    dtype = A_stack.dtype
    eye = torch.eye(n_pad, dtype=dtype, device=A_stack.device)
    A_aug = torch.cat([A_stack, torch.sqrt(lam)[:, None, None] * eye], dim=1)
    b_aug = torch.cat([b_stack, b_stack.new_zeros((k, n_pad))], dim=1)[..., None]
    Q, R = torch.linalg.qr(A_aug, mode="reduced")
    x = torch.linalg.solve_triangular(R, Q.mT @ b_aug, upper=True)
    r = b_aug - A_aug @ x
    rnorm = torch.linalg.vector_norm(r[..., 0], dim=1)
    x = x[..., 0]
    if not certify:
        z = torch.full((k,), float("nan"), dtype=dtype, device=A_stack.device)
        return x, rnorm, z, z, z, z
    wg = torch.linalg.solve_triangular(R.mT, A_aug.mT @ r, upper=False)[..., 0]
    svals = torch.linalg.svdvals(R)
    tiny = torch.finfo(dtype).tiny
    smax, smin = svals[:, 0], svals[:, -1]
    wg_norm = torch.linalg.vector_norm(wg, dim=1)
    bound = wg_norm / torch.clamp(smin, min=tiny)
    cond = smax / torch.clamp(smin, min=tiny)
    return x, rnorm, wg_norm, bound, cond, smax


def solve_bucket(
    A_stack: torch.Tensor,
    b_stack: torch.Tensor,
    lam: torch.Tensor | None = None,
    *,
    certify: bool = False,
) -> dict:
    """Solve a stacked bucket of padded problems under one batched QR.

    ``A_stack (k, m_pad, n_pad)``, ``b_stack (k, m_pad)``, ``lam (k,)``
    per-problem ridge (``None`` → all zero).  Returns a dict of
    per-problem columns: ``x (k, n_pad)``, ``rnorm``, and with
    ``certify=True`` the posterior pieces ``whitened_arnorm`` /
    ``error_bound`` / ``cond`` / ``smax`` the service assembles
    :class:`~repro_torch.core.certify.Certificate` objects from (nan
    without it).  Runs where ``A_stack`` lies.
    """
    if A_stack.ndim != 3 or tuple(b_stack.shape) != tuple(A_stack.shape[:2]):
        raise ValueError(
            f"need A_stack (k, m_pad, n_pad) and matching b_stack, got "
            f"{tuple(A_stack.shape)} / {tuple(b_stack.shape)}"
        )
    dev, dtype = A_stack.device, A_stack.dtype
    if lam is None:
        lam = torch.zeros((A_stack.shape[0],), dtype=dtype, device=dev)
    lam = backend_lib.as_tensor(lam, dev, dtype)
    x, rnorm, wg, bound, cond, smax = _solve_bucket_direct(
        A_stack, b_stack.to(dtype), lam, certify=certify
    )
    return {
        "x": x, "rnorm": rnorm, "whitened_arnorm": wg,
        "error_bound": bound, "cond": cond, "smax": smax,
    }
