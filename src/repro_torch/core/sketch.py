"""Sketching operators (paper §2): all seven kinds of the reference.

Port of ``repro/core/sketch.py``.  ``sample(kind, key, d, m)`` draws an
operator from a ``torch.Generator`` (or an int seed); ``op.apply(A,
backend=...)`` applies it to an (m,) vector or (m, n) matrix along axis 0,
and ``op.apply_op(A)`` sketches a ``repro_torch.core.linop`` operator.

Dense:  Gaussian, uniform-dense, SRHT (subsampled randomized Hadamard).
Sparse: CountSketch (Clarkson–Woodruff, the paper's choice), sparse-sign(k),
uniform-sparse.

Backends (see ``repro_torch.core.backend``): ``"auto"`` routes the apply
through the kind's kernel wrapper — ``countsketch_apply`` (B1, also for the
two sparse kinds, as a CSR of k·m or m weighted entries),
``fused_gaussian_sketch`` (B4), ``sketch_matmul`` (B6) or ``srht_apply``
(B8) — which launches the hand kernel for a CUDA tensor and runs the plain
version for a CPU tensor; ``"reference"`` runs plain tensor code (the
reference's segment sums for the sparse kinds, :func:`fwht` for the SRHT).
Both realize the same S: the Gaussian S is drawn from the kernels'
counter-based threefry + Box–Muller stream, so kernel B4 regenerates it
from the key alone.

Operator inputs (``apply_op``, :class:`_OperatorApply`): a sparse A is
sketched from its entries — the bucket kinds through the coordinate
scatter ``countsketch_coo_apply``, the dense-S kinds through one sparse ×
dense product, the SRHT and an unstored Gaussian S on A densified — a
Tikhonov-augmented dense A is materialized, and any other operator is
sketched through panels of Sᵀ and its ``rmatmat``.
:class:`AugmentedSketch` is blockdiag(S, I), the ridge embedding.

Row streaming: ``apply_rows(tile, row_offset)`` is the restriction of S to
a contiguous row tile of A (for the SRHT, which streams by placement, the
D-signed tile), and ``restrict_cols(idx)`` the sub-operator S[:, idx]
(``None`` for the SRHT) — the primitives the streaming and session slices
build on.  Escalation: ``extend_rows(key, extra)`` grows any kind into a
:class:`StackedSketch`, whose ``extend_sketch`` reuses a stored B = SA.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..kernels.common import key_to_u32, sqrt_tensor
from ..kernels.countsketch import (
    countsketch_apply,
    countsketch_coo_apply,
    countsketch_coo_plan,
    countsketch_coo_ref,
    countsketch_csr,
    countsketch_ref,
)
from ..kernels.countsketch.ref import acc_dtype
from ..kernels.sketch_matmul import (
    default_scale,
    fused_gaussian_sketch,
    gaussian_cols_ref,
    sketch_matmul,
)
from ..kernels.srht import SRHTPlan, fwht, hadamard_transform, srht_apply, srht_plan, srht_ref
from . import backend as backend_lib
from . import linop

__all__ = [
    "sample",
    "fwht",
    "GaussianSketch",
    "UniformDenseSketch",
    "SRHTSketch",
    "CountSketch",
    "SparseSignSketch",
    "UniformSparseSketch",
    "StackedSketch",
    "AugmentedSketch",
    "SKETCH_KINDS",
    "T_PANEL_BYTES",
    "t_panel_cols",
]

# The matrix-free sketch forms Sᵀ in column panels of at most this many
# bytes, one ``rmatmat`` each, instead of the whole (m, d) Sᵀ (33.6 GB in
# f64 at m = 2^20, d = 4000).
T_PANEL_BYTES = 1 << 30


def t_panel_cols(m: int, d: int, dtype: torch.dtype) -> int:
    """Columns of Sᵀ in one panel of the matrix-free sketch (128 at
    m = 2^20 in f64)."""
    return max(1, min(d, T_PANEL_BYTES // max(m * dtype.itemsize, 1)))


def _next_pow2(m: int) -> int:
    p = 1
    while p < m:
        p *= 2
    return p


def _as_2d(A):
    """Canonicalize (m,) -> (m, 1); returns (A2d, was_vector)."""
    return (A[:, None], True) if A.ndim == 1 else (A, False)


def _maybe_squeeze(B, was_vector):
    return B[:, 0] if was_vector else B


class _OperatorApply:
    """What every kind shares: operator-aware sketching, the row-streaming
    contract and escalation.

    ``apply_op`` dispatches, in the reference's order:

    - ``DenseOperator`` → the kind's backend-dispatched ``apply``;
    - ``SparseOperator`` → ``_apply_bcoo``: the bucket kinds scatter
      straight from A's entries (``countsketch_coo_apply``), the dense-S
      kinds run one sparse × dense product (Aᵀ's CSR times Sᵀ), and the
      SRHT (and a Gaussian whose S is not stored) densifies A and takes its
      kernel;
    - ``TikhonovAugmented`` over a dense core → materialized, then
      ``apply``;
    - anything else → B = (Aᵀ·Sᵀ)ᵀ through ``rmatmat``, Sᵀ formed in column
      panels of :func:`t_panel_cols` columns (``_dense_t_panel``), never
      whole.
    """

    def apply_op(self, A, *, backend: str = "auto"):
        A = linop.as_operator(A, device=self.device)
        if isinstance(A, linop.DenseOperator):
            return self.apply(A.A, backend=backend)
        if isinstance(A, linop.SparseOperator):
            return self._apply_bcoo(A, backend=backend)
        if isinstance(A, linop.TikhonovAugmented) and isinstance(
            A.op, linop.DenseOperator
        ):
            return self.apply(A.materialize(), backend=backend)
        return self._apply_matrix_free(A)

    def _apply_bcoo(self, A, *, backend: str = "auto"):
        S = getattr(self, "S", None)
        if S is not None:  # dense-S kinds: one sparse × dense library product
            return (A.csr_t.to_torch() @ S.T.to(A.dtype)).T.contiguous()
        # The SRHT's transform is dense whatever A is: densify.
        return self.apply(A.materialize(), backend=backend)

    def _apply_matrix_free(self, A):
        m, n = A.shape
        d = self.d
        w = t_panel_cols(m, d, A.dtype)
        B = torch.empty((d, n), dtype=A.dtype, device=A.device)
        for p0 in range(0, d, w):
            p1 = min(d, p0 + w)
            B[p0:p1] = A.rmatmat(self._dense_t_panel(p0, p1).to(A.dtype)).T
        return B

    def _dense_t_panel(self, p0: int, p1: int):
        """Columns p0..p1 of Sᵀ (rows p0..p1 of S) as an (m, p1 − p0)
        matrix."""
        return self.as_dense()[p0:p1].T

    def as_dense_t(self):
        """Sᵀ as a dense (m, d) matrix (the matrix-free sketch takes it in
        panels)."""
        return self._dense_t_panel(0, self.d)

    # Row streaming: "add" kinds return the (d, n) contribution of a tile;
    # the SRHT ("place") returns the D-signed tile, transformed once at the
    # end of the stream.
    stream_semantics = "add"

    def apply_rows(self, tile, row_offset: int, *, backend: str = "auto"):
        raise NotImplementedError(
            f"{type(self).__name__} does not support row streaming"
        )

    def restrict_cols(self, idx):
        """S[:, idx] as an operator over ``len(idx)`` rows, or ``None`` for
        kinds whose columns couple (the SRHT)."""
        return None

    def _fresh_like(self, key, extra: int):
        """An independent draw of this kind with ``extra`` rows over the
        same m-row space — the new block of an escalated sketch."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support extend_rows"
        )

    def extend_rows(self, key, extra: int) -> "StackedSketch":
        """Escalate to d + ``extra`` rows without touching the first d:
        S′ = [√(d/(d+e))·S; √(e/(d+e))·S_e], with S_e a fresh draw from
        ``key``.  The weights keep E[S′ᵀS′] = I, and a stored B = SA extends
        through :meth:`StackedSketch.extend_sketch`."""
        extra = int(extra)
        if extra <= 0:
            raise ValueError(f"extra must be a positive row count, got {extra}")
        d = self.d
        return StackedSketch(
            top=self,
            bottom=self._fresh_like(key, extra),
            w_top=math.sqrt(d / (d + extra)),
            w_bottom=math.sqrt(extra / (d + extra)),
        )


class _BucketSketch(_OperatorApply):
    """The kinds kernel B1 applies: buckets and weights of shape (m,) or
    (k, m), with the bucket → entries CSR built once per dtype and cached
    on the operator (``_csr``)."""

    def _weights(self) -> torch.Tensor:
        return self.signs

    def csr(self, dtype: torch.dtype):
        """The cached bucket → entries CSR with weights in ``dtype``."""
        if dtype not in self._csr:
            self._csr[dtype] = countsketch_csr(
                self.buckets, self._weights(), self.d, dtype
            )
        return self._csr[dtype]

    def _apply_b1(self, A):
        csr = self.csr(A.dtype) if A.device.type == "cuda" else None
        return countsketch_apply(A, self.buckets, self._weights(), self.d, csr=csr)

    def _apply_bcoo(self, A, *, backend: str = "auto"):
        """SA from A's entries: the coordinate scatter (its kernel on the
        card), or its plain version on the reference backend.  On the card
        the scatter's plan for entries in row order is this operator's
        cached CSR and A's cached row pointer, so nothing is sorted."""
        args = (A.rows, A.cols, A.vals, A.shape, self.buckets, self._weights(), self.d)
        if not backend_lib.uses_kernels(backend):
            return countsketch_coo_ref(*args)
        plan = None
        if A.device.type == "cuda":
            rowptr = A.row_pointer()
            csr = self.csr(A.dtype) if rowptr is not None else None
            plan = countsketch_coo_plan(A.rows, self.buckets, self._weights(), self.d, A.dtype,
                                        csr=csr, rowptr=rowptr)
        return countsketch_coo_apply(*args, plan=plan)

    def _dense_t_panel(self, p0: int, p1: int):
        """Rows p0..p1 of S, transposed: each of the k blocks of entries set
        in turn (within a block, a column of S has one entry), scaled as
        ``as_dense`` scales them."""
        buckets = self.buckets.reshape(-1, self.m).to(torch.int64)
        weights = self._weights().reshape(-1, self.m) * self._entry_scale()
        St = torch.zeros((self.m, p1 - p0), dtype=weights.dtype, device=self.device)
        for h, w in zip(buckets, weights):
            (i,) = torch.nonzero((h >= p0) & (h < p1), as_tuple=True)
            St.index_put_((i, h[i] - p0), w[i], accumulate=True)
        return St

    def _entry_scale(self):
        return 1.0

    def apply_rows(self, tile, row_offset: int, *, backend: str = "auto"):
        t = tile.shape[0]
        return self.restrict_cols(
            slice(row_offset, row_offset + t)
        ).apply(tile, backend=backend)


@dataclasses.dataclass(frozen=True)
class CountSketch(_BucketSketch):
    """Clarkson–Woodruff: one ±1 per column of S, at a random bucket.

    SA[k] = sum_{i : h(i)=k} s(i) · A[i] — an isometry in expectation with
    no scaling.  The bucket → rows CSR that kernel B1 walks is built once
    per dtype and cached on the operator (:meth:`csr`).
    """

    buckets: torch.Tensor  # (m,) int32 in [0, d)
    signs: torch.Tensor  # (m,) ±1
    d: int
    m: int
    _csr: dict = dataclasses.field(
        default_factory=dict, compare=False, repr=False
    )

    @classmethod
    def sample(cls, key, d, m, dtype=torch.float64, *, device=None):
        dev = backend_lib.resolve_device(device)
        gen = backend_lib.as_generator(key, dev)
        buckets = torch.randint(
            0, d, (m,), generator=gen, dtype=torch.int32, device=dev
        )
        signs = torch.randint(
            0, 2, (m,), generator=gen, dtype=torch.int8, device=dev
        ).to(dtype) * 2 - 1
        return cls(buckets=buckets, signs=signs, d=int(d), m=int(m))

    @property
    def device(self) -> torch.device:
        return self.buckets.device

    def apply(self, A, *, backend: str = "auto"):
        A = backend_lib.as_tensor(A, self.device)
        if backend_lib.uses_kernels(backend):
            return self._apply_b1(A)
        return countsketch_ref(A, self.buckets, self.signs, self.d)

    def restrict_cols(self, idx):
        buckets, signs = self.buckets[idx], self.signs[idx]
        return CountSketch(
            buckets=buckets, signs=signs, d=self.d, m=buckets.shape[0]
        )

    def _fresh_like(self, key, extra):
        return CountSketch.sample(
            key, extra, self.m, dtype=self.signs.dtype, device=self.device
        )

    def as_dense(self):
        S = torch.zeros((self.d, self.m), dtype=self.signs.dtype, device=self.device)
        S[self.buckets.to(torch.int64), torch.arange(self.m, device=self.device)] = self.signs
        return S


@dataclasses.dataclass(frozen=True)
class GaussianSketch(_OperatorApply):
    """S with iid N(0, 1/d) entries.

    S is drawn from the counter-based threefry2x32 + Box–Muller stream of
    ``repro_torch.kernels.sketch_matmul`` (element (i, j) ← counter pair
    (i, j) under the key words ``key = (k0, k1)``), scaled by 1/√d in f32
    and then cast, so kernel B4 regenerates the SAME matrix inside the
    kernel from the key alone.  The kernel route never reads ``S``.

    ``sample(..., materialize=False)`` stores no S (``S=None``): every
    column block is regenerated on demand from the key, bitwise equal to
    slicing the stored matrix.  ``SketchedFactor.build`` draws that way on
    a CUDA device (``precond._operator_for``): at d = 4000, m = 2^16 the
    stored S would be 2.1 GB that kernel B4 never reads, and the result
    depends only on the key.  The streaming drivers always draw that way.

    ``apply_rows(tile, o)`` (a row tile of a streamed A starting at row o)
    is kernel B4 with its column offset, ``fused_gaussian_sketch(tile, key,
    d, col0=o)``: the kernel draws S[:, o : o + t] from the counters itself,
    so a streamed Gaussian never regenerates S in plain tensor code on the
    card.  ``restrict_cols`` with an arbitrary index list draws its columns
    with the plain ``gaussian_cols_ref``, as the reference draws them with
    jnp outside any Pallas kernel (``repro/core/sketch.py:310–312``).
    """

    S: torch.Tensor | None
    key: tuple  # (k0, k1): the threefry key words, ints in [0, 2^32)
    d: int
    m: int
    dev: torch.device = dataclasses.field(compare=False, repr=False, default=None)

    @classmethod
    def sample(cls, key, d, m, dtype=torch.float64, materialize=True, *, device=None):
        dev = backend_lib.resolve_device(device)
        if isinstance(key, torch.Generator):
            key = backend_lib.as_generator(key, dev)
        words = key_to_u32(key)
        cols = torch.arange(m, dtype=torch.int64, device=dev)
        S = cls._gen_cols(words, d, cols, dtype) if materialize else None
        return cls(S=S, key=words, d=int(d), m=int(m), dev=dev)

    @staticmethod
    def _gen_cols(key, d, cols, dtype, rows=None):
        """S[p0:p1, cols] (``rows = (p0, p1)``, all d rows by default) from
        the kernel's counter stream (exact): the f32 Gaussians times the f32
        scale, then cast to ``dtype``."""
        p0, p1 = (0, d) if rows is None else rows
        G = gaussian_cols_ref(key[0], key[1], p1 - p0, cols, torch.float32, row0=p0)
        return G.mul_(default_scale(d)).to(dtype)

    @property
    def device(self) -> torch.device:
        return self.S.device if self.S is not None else self.dev

    def _cols(self, cols, dtype):
        if self.S is not None:
            return self.S[:, cols]
        return self._gen_cols(self.key, self.d, cols, dtype)

    def apply(self, A, *, backend: str = "auto"):
        A = backend_lib.as_tensor(A, self.device)
        if backend_lib.uses_kernels(backend):
            return fused_gaussian_sketch(A, self.key, self.d)
        A2, vec = _as_2d(A)
        return _maybe_squeeze(self.as_dense().to(A2.dtype) @ A2, vec)

    def apply_rows(self, tile, row_offset: int, *, backend: str = "auto"):
        """S[:, o : o + t]·tile: kernel B4 with ``col0 = o`` (its plain
        version on the CPU); ``backend="reference"`` multiplies the slice
        of the stored or regenerated S."""
        tile2, _ = _as_2d(backend_lib.as_tensor(tile, self.device))
        if backend_lib.uses_kernels(backend):
            return fused_gaussian_sketch(tile2, self.key, self.d, col0=int(row_offset))
        t = tile2.shape[0]
        cols = torch.arange(row_offset, row_offset + t, device=self.device)
        return self._cols(cols, tile2.dtype).to(tile2.dtype) @ tile2

    def restrict_cols(self, idx):
        """S[:, idx] as a stored ``UniformDenseSketch``: in the stored S's
        dtype, or f64 when S is regenerated (as the reference), through the
        plain ``gaussian_cols_ref`` (an arbitrary column list; the
        reference's is a jnp draw outside any Pallas kernel)."""
        cols = torch.arange(self.m, device=self.device)[idx]
        S = self._cols(cols, torch.float64)
        return UniformDenseSketch(S=S, d=self.d, m=S.shape[1])

    def _fresh_like(self, key, extra):
        stored = self.S is not None
        return GaussianSketch.sample(
            key, extra, self.m, dtype=self.S.dtype if stored else torch.float64,
            materialize=stored, device=self.device,
        )

    def as_dense(self):
        if self.S is not None:
            return self.S
        cols = torch.arange(self.m, device=self.device)
        return self._gen_cols(self.key, self.d, cols, torch.float64)

    def _dense_t_panel(self, p0: int, p1: int):
        if self.S is not None:
            return self.S[p0:p1].T
        cols = torch.arange(self.m, device=self.device)
        return self._gen_cols(self.key, self.d, cols, torch.float64, rows=(p0, p1)).T


@dataclasses.dataclass(frozen=True)
class UniformDenseSketch(_OperatorApply):
    """S with iid U(-√(3/d), √(3/d)) entries (unit row variance / d).

    The kernel route (B6, ``sketch_matmul``) rounds S to A's dtype before
    the product, so a bf16 A under ``precision="mixed"`` meets a bf16 S.
    That is what the reference's fused route does (``tsqr/fused.py:265``);
    its unfused route keeps S in f64 (``core/sketch.py:346``).  The port
    takes the fused route's rounding on both routes.
    """

    S: torch.Tensor
    d: int
    m: int

    @classmethod
    def sample(cls, key, d, m, dtype=torch.float64, *, device=None):
        dev = backend_lib.resolve_device(device)
        gen = backend_lib.as_generator(key, dev)
        lim = (3.0 / d) ** 0.5
        S = torch.empty((d, m), dtype=dtype, device=dev).uniform_(-lim, lim, generator=gen)
        return cls(S=S, d=int(d), m=int(m))

    @property
    def device(self) -> torch.device:
        return self.S.device

    def apply(self, A, *, backend: str = "auto"):
        A = backend_lib.as_tensor(A, self.device)
        if backend_lib.uses_kernels(backend):
            return sketch_matmul(self.S, A)
        A2, vec = _as_2d(A)
        return _maybe_squeeze(self.S.to(A2.dtype) @ A2, vec)

    def apply_rows(self, tile, row_offset: int, *, backend: str = "auto"):
        del backend
        tile2, _ = _as_2d(backend_lib.as_tensor(tile, self.device))
        St = self.S[:, row_offset : row_offset + tile2.shape[0]]
        return St.to(tile2.dtype) @ tile2

    def restrict_cols(self, idx):
        S = self.S[:, idx]
        return UniformDenseSketch(S=S, d=self.d, m=S.shape[1])

    def _fresh_like(self, key, extra):
        return UniformDenseSketch.sample(
            key, extra, self.m, dtype=self.S.dtype, device=self.device
        )

    def as_dense(self):
        return self.S


@dataclasses.dataclass(frozen=True)
class SRHTSketch(_OperatorApply):
    """Subsampled randomized Hadamard transform: S = (1/√d)·P·H·D.

    H is the unnormalized Hadamard matrix of order m_pad (the next power of
    two ≥ m; A is padded with zero rows), D a random ±1 diagonal, P a
    uniform sample of d rows: without replacement, or with it when
    d > m_pad, as the reference.  The kernel route applies it through B8
    (``srht_apply``), bitwise equal to the reference route's :func:`fwht`,
    with B8's sign mask and gather list built once and cached (:meth:`plan`).
    """

    signs: torch.Tensor  # (m_pad,) ±1
    rows: torch.Tensor  # (d,) int64 indices into m_pad
    d: int
    m: int
    m_pad: int
    _plan: dict = dataclasses.field(
        default_factory=dict, compare=False, repr=False
    )

    @classmethod
    def sample(cls, key, d, m, dtype=torch.float64, *, device=None):
        dev = backend_lib.resolve_device(device)
        gen = backend_lib.as_generator(key, dev)
        m_pad = _next_pow2(m)
        signs = torch.randint(
            0, 2, (m_pad,), generator=gen, dtype=torch.int8, device=dev
        ).to(dtype) * 2 - 1
        if d > m_pad:
            rows = torch.randint(0, m_pad, (d,), generator=gen, device=dev)
        else:
            rows = torch.randperm(m_pad, generator=gen, device=dev)[:d]
        return cls(signs=signs, rows=rows, d=int(d), m=int(m), m_pad=m_pad)

    @property
    def device(self) -> torch.device:
        return self.signs.device

    def plan(self) -> SRHTPlan:
        """B8's cached sign mask and gather list of this operator."""
        if "plan" not in self._plan:
            self._plan["plan"] = srht_plan(self.signs, self.rows)
        return self._plan["plan"]

    def apply(self, A, *, backend: str = "auto"):
        A = backend_lib.as_tensor(A, self.device)
        if backend_lib.uses_kernels(backend):
            return srht_apply(A, self.signs, self.rows, self.d, plan=self.plan())
        return srht_ref(A, self.signs, self.rows, self.d)

    # H mixes every row, so the SRHT streams by placement: the restriction
    # of S to a tile is the D-signed tile, and the padded transform, P and
    # the 1/√d scale run once over the assembled (m_pad, n) buffer.
    stream_semantics = "place"

    def apply_rows(self, tile, row_offset: int, *, backend: str = "auto"):
        """The D-signed rows of the tile — not the (d, n) contribution."""
        del backend
        tile2, _ = _as_2d(backend_lib.as_tensor(tile, self.device))
        signs = self.signs[row_offset : row_offset + tile2.shape[0]]
        return signs[:, None].to(tile2.dtype) * tile2

    def _fresh_like(self, key, extra):
        return SRHTSketch.sample(
            key, extra, self.m, dtype=self.signs.dtype, device=self.device
        )

    def as_dense(self):
        eye = torch.eye(self.m, dtype=self.signs.dtype, device=self.device)
        return self.apply(eye, backend="reference")

    def _dense_t_panel(self, p0: int, p1: int):
        """Columns p0..p1 of Sᵀ = (1/√d)·D·H·Pᵀ: one transform of the
        (m_pad, p1 − p0) row selector (H is symmetric), through B8 on the
        card — O(d·m log m) for all of Sᵀ instead of as_dense()'s
        O(m² log m)."""
        dtype, dev = self.signs.dtype, self.device
        w = p1 - p0
        sel = torch.zeros((self.m_pad, w), dtype=dtype, device=dev)
        sel[self.rows[p0:p1], torch.arange(w, device=dev)] = 1.0
        St = self.signs[:, None] * hadamard_transform(sel) / sqrt_tensor(self.d, dtype, dev)
        return St[: self.m]


@dataclasses.dataclass(frozen=True)
class SparseSignSketch(_BucketSketch):
    """k nonzeros ±1/√k per column of S, at iid random buckets.

    The kernel route sums the k·m ±1 entries through B1 (one CSR, in
    (block, row) order) and then divides by √k, as the reference scales
    after its sum; the reference route is the reference's k segment sums.
    """

    buckets: torch.Tensor  # (k, m) int32 in [0, d)
    signs: torch.Tensor  # (k, m) ±1
    d: int
    m: int
    k: int = 8
    _csr: dict = dataclasses.field(
        default_factory=dict, compare=False, repr=False
    )

    @classmethod
    def sample(cls, key, d, m, dtype=torch.float64, k=8, *, device=None):
        dev = backend_lib.resolve_device(device)
        gen = backend_lib.as_generator(key, dev)
        buckets = torch.randint(
            0, d, (k, m), generator=gen, dtype=torch.int32, device=dev
        )
        signs = torch.randint(
            0, 2, (k, m), generator=gen, dtype=torch.int8, device=dev
        ).to(dtype) * 2 - 1
        return cls(buckets=buckets, signs=signs, d=int(d), m=int(m), k=int(k))

    @property
    def device(self) -> torch.device:
        return self.buckets.device

    def apply(self, A, *, backend: str = "auto"):
        A = backend_lib.as_tensor(A, self.device)
        if backend_lib.uses_kernels(backend):
            B = self._apply_b1(A)
        else:
            # the k segment sums, added in block order (the reference's
            # sum over its vmapped axis)
            A2, vec = _as_2d(A)
            A2 = A2.to(acc_dtype(A2.dtype))
            B = torch.zeros((self.d, A2.shape[1]), dtype=A2.dtype, device=A2.device)
            for h, s in zip(self.buckets, self.signs):
                B = B + torch.zeros_like(B).index_add_(0, h, s.to(A2.dtype)[:, None] * A2)
            B = _maybe_squeeze(B, vec)
        return B / sqrt_tensor(self.k, B.dtype, B.device)

    def _apply_bcoo(self, A, *, backend: str = "auto"):
        B = super()._apply_bcoo(A, backend=backend)
        return B / sqrt_tensor(self.k, B.dtype, B.device)

    def _entry_scale(self):
        return 1.0 / sqrt_tensor(self.k, self.signs.dtype, self.device)

    def restrict_cols(self, idx):
        buckets, signs = self.buckets[:, idx], self.signs[:, idx]
        return SparseSignSketch(
            buckets=buckets, signs=signs, d=self.d, m=buckets.shape[1], k=self.k
        )

    def _fresh_like(self, key, extra):
        return SparseSignSketch.sample(
            key, extra, self.m, dtype=self.signs.dtype, k=self.k, device=self.device
        )

    def as_dense(self):
        dtype, dev = self.signs.dtype, self.device
        S = torch.zeros((self.d, self.m), dtype=dtype, device=dev)
        cols = torch.arange(self.m, device=dev).expand(self.k, self.m)
        scale = 1.0 / sqrt_tensor(self.k, dtype, dev)
        return S.index_put_(
            (self.buckets.to(torch.int64), cols), self.signs * scale, accumulate=True
        )


@dataclasses.dataclass(frozen=True)
class UniformSparseSketch(_BucketSketch):
    """One U(−√3, √3) entry per column of S, at a random bucket.

    The kernel route is B1 with the values as the CSR's weights (rounded to
    A's dtype, as the reference's ``values.astype(A.dtype)``); the reference
    route is the reference's segment sum.
    """

    buckets: torch.Tensor  # (m,) int32 in [0, d)
    values: torch.Tensor  # (m,)
    d: int
    m: int
    _csr: dict = dataclasses.field(
        default_factory=dict, compare=False, repr=False
    )

    @classmethod
    def sample(cls, key, d, m, dtype=torch.float64, *, device=None):
        dev = backend_lib.resolve_device(device)
        gen = backend_lib.as_generator(key, dev)
        buckets = torch.randint(
            0, d, (m,), generator=gen, dtype=torch.int32, device=dev
        )
        lim = math.sqrt(3.0)
        values = torch.empty(m, dtype=dtype, device=dev).uniform_(-lim, lim, generator=gen)
        return cls(buckets=buckets, values=values, d=int(d), m=int(m))

    @property
    def device(self) -> torch.device:
        return self.buckets.device

    def _weights(self) -> torch.Tensor:
        return self.values

    def apply(self, A, *, backend: str = "auto"):
        A = backend_lib.as_tensor(A, self.device)
        if backend_lib.uses_kernels(backend):
            return self._apply_b1(A)
        return countsketch_ref(A, self.buckets, self.values, self.d)

    def restrict_cols(self, idx):
        buckets, values = self.buckets[idx], self.values[idx]
        return UniformSparseSketch(
            buckets=buckets, values=values, d=self.d, m=buckets.shape[0]
        )

    def _fresh_like(self, key, extra):
        return UniformSparseSketch.sample(
            key, extra, self.m, dtype=self.values.dtype, device=self.device
        )

    def as_dense(self):
        dev = self.device
        S = torch.zeros((self.d, self.m), dtype=self.values.dtype, device=dev)
        S[self.buckets.to(torch.int64), torch.arange(self.m, device=dev)] = self.values
        return S


@dataclasses.dataclass(frozen=True)
class StackedSketch(_OperatorApply):
    """Weighted stack [w_t·S_top; w_b·S_bot] — the escalated sketch.

    Made by ``op.extend_rows(key, extra)`` with w_t = √(d/(d+e)) and
    w_b = √(e/(d+e)), so E[SᵀS] = I still holds.  :meth:`extend_sketch`
    extends a stored B = S_top·A by sketching only the new rows, bitwise
    equal to applying the stacked operator from scratch (every apply is
    deterministic).  Nested escalations stack recursively, and
    ``_fresh_like`` always draws the original kind.
    """

    top: object  # the pre-escalation operator (d_top, m)
    bottom: object  # the fresh block (extra, m)
    w_top: float
    w_bottom: float

    @property
    def d(self) -> int:
        return self.top.d + self.bottom.d

    @property
    def m(self) -> int:
        return self.top.m

    @property
    def device(self) -> torch.device:
        return self.top.device

    def _stack(self, top, bot):
        return torch.cat([self.w_top * top, self.w_bottom * bot], dim=0)

    def apply(self, A, *, backend: str = "auto"):
        return self._stack(
            self.top.apply(A, backend=backend), self.bottom.apply(A, backend=backend)
        )

    def apply_op(self, A, *, backend: str = "auto"):
        return self._stack(
            self.top.apply_op(A, backend=backend),
            self.bottom.apply_op(A, backend=backend),
        )

    def extend_sketch(self, B_top, A, *, backend: str = "auto"):
        """[w_t·B_top; w_b·(S_bot·A)] for the stored ``B_top =
        top.apply_op(A)``: only the ``bottom.d`` new rows are sketched."""
        B_top = backend_lib.as_tensor(B_top, self.device)
        if B_top.shape[0] != self.top.d:
            raise ValueError(
                f"B_top has {B_top.shape[0]} rows, the pre-escalation "
                f"operator has d={self.top.d}"
            )
        return self._stack(B_top, self.bottom.apply_op(A, backend=backend))

    @property
    def stream_semantics(self) -> str:
        """"add" when both blocks stream additively, else "place"."""
        both_add = (
            self.top.stream_semantics == "add"
            and self.bottom.stream_semantics == "add"
        )
        return "add" if both_add else "place"

    def apply_rows(self, tile, row_offset: int, *, backend: str = "auto"):
        if self.stream_semantics != "add":
            raise NotImplementedError(
                "a stacked sketch with an SRHT block streams by placement; "
                "accumulate the blocks separately"
            )
        return self._stack(
            self.top.apply_rows(tile, row_offset, backend=backend),
            self.bottom.apply_rows(tile, row_offset, backend=backend),
        )

    def restrict_cols(self, idx):
        top = self.top.restrict_cols(idx)
        bot = self.bottom.restrict_cols(idx)
        if top is None or bot is None:
            return None
        return StackedSketch(
            top=top, bottom=bot, w_top=self.w_top, w_bottom=self.w_bottom
        )

    def _fresh_like(self, key, extra):
        return self.top._fresh_like(key, extra)

    def as_dense(self):
        top = self.top.as_dense()
        return self._stack(top, self.bottom.as_dense().to(top.dtype))

    def _dense_t_panel(self, p0: int, p1: int):
        dt = self.top.d
        parts = []
        if p0 < dt:
            parts.append(self.w_top * self.top._dense_t_panel(p0, min(p1, dt)))
        if p1 > dt:
            bot = self.bottom._dense_t_panel(max(p0, dt) - dt, p1 - dt)
            parts.append(self.w_bottom * bot.to(parts[0].dtype if parts else bot.dtype))
        return torch.cat(parts, dim=1)


@dataclasses.dataclass(frozen=True)
class AugmentedSketch(_OperatorApply):
    """blockdiag(S, I_tail): the structured embedding of a Tikhonov system.

    The rows of the √λ·I block of [A; √λI] are maximally coherent (one
    spike each), the inputs oblivious sparse sketches are worst at.  So
    only the data block is sketched with ``inner`` and the identity block
    is kept exact: B = [S·A; √λI] and BᵀB = (SA)ᵀSA + λI.
    ``SketchedFactor.build`` makes one for ``TikhonovAugmented`` inputs;
    d = inner.d + tail rows.
    """

    inner: object  # sketch operator over the data rows
    tail: int  # identity block size (n of the augmented operator)

    @property
    def d(self) -> int:
        return self.inner.d + self.tail

    @property
    def m(self) -> int:
        return self.inner.m + self.tail

    @property
    def device(self) -> torch.device:
        return self.inner.device

    def apply(self, A, *, backend: str = "auto"):
        A = backend_lib.as_tensor(A, self.device)
        mi = self.inner.m
        top = self.inner.apply(A[:mi], backend=backend)
        return torch.cat([top, A[mi:].to(top.dtype)], dim=0)

    def apply_op(self, A, *, backend: str = "auto"):
        A = linop.as_operator(A, device=self.device)
        if isinstance(A, linop.TikhonovAugmented):
            top = self.inner.apply_op(A.op, backend=backend)
            eye = torch.eye(self.tail, A.op.shape[1], dtype=top.dtype, device=top.device)
            return torch.cat([top, A.sqrt_reg.to(top.dtype) * eye], dim=0)
        return super().apply_op(A, backend=backend)

    def as_dense(self):
        Sd = self.inner.as_dense()
        dev = Sd.device
        top = torch.cat(
            [Sd, torch.zeros((self.inner.d, self.tail), dtype=Sd.dtype, device=dev)], dim=1
        )
        bot = torch.cat(
            [
                torch.zeros((self.tail, self.inner.m), dtype=Sd.dtype, device=dev),
                torch.eye(self.tail, dtype=Sd.dtype, device=dev),
            ],
            dim=1,
        )
        return torch.cat([top, bot], dim=0)

    def extend_rows(self, key, extra: int) -> "AugmentedSketch":
        """Escalate the data block only: the exact identity tail is not a
        random embedding and needs no growing."""
        return AugmentedSketch(inner=self.inner.extend_rows(key, extra), tail=self.tail)

    def extend_sketch(self, B_top, A, *, backend: str = "auto"):
        """Extend a stored augmented sketch [S·A; √λI]: the data rows
        through the stacked inner operator, the exact tail rows moved down
        unchanged — bit-equal to ``apply_op(A)`` of this operator."""
        if not isinstance(self.inner, StackedSketch):
            raise TypeError(
                "extend_sketch needs an operator produced by extend_rows; "
                f"inner is {type(self.inner).__name__}"
            )
        A = linop.as_operator(A, device=self.device)
        if not isinstance(A, linop.TikhonovAugmented):
            raise TypeError(
                "AugmentedSketch.extend_sketch sketches the data block of a "
                f"TikhonovAugmented operator, got {type(A).__name__}"
            )
        B_top = backend_lib.as_tensor(B_top, self.device)
        d_prev = self.inner.top.d
        top = self.inner.extend_sketch(B_top[:d_prev], A.op, backend=backend)
        return torch.cat([top, B_top[d_prev:]], dim=0)


SKETCH_KINDS: dict[str, type] = {
    "gaussian": GaussianSketch,
    "uniform_dense": UniformDenseSketch,
    "srht": SRHTSketch,
    "countsketch": CountSketch,
    "clarkson_woodruff": CountSketch,  # alias — the paper's final choice
    "sparse_sign": SparseSignSketch,
    "uniform_sparse": UniformSparseSketch,
}


def sample(kind: str, key, d: int, m: int, dtype=torch.float64, *, device=None, **kw):
    """Draw a sketching operator ``S : R^m -> R^d`` of the given kind."""
    try:
        cls = SKETCH_KINDS[kind]
    except KeyError:
        raise ValueError(
            f"unknown sketch kind {kind!r}; have {sorted(SKETCH_KINDS)}"
        ) from None
    return cls.sample(key, d, m, dtype=dtype, device=device, **kw)
