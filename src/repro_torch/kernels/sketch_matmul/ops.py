"""Wrappers of kernels B6 (dense S·A) and B4 (in-kernel Gaussian S·A).

Replaces ``repro/kernels/sketch_matmul/kernel.py:27`` (``matmul_kernel``,
launched at ``sketch_matmul/ops.py:51``) and ``kernel.py:40``
(``fused_gaussian_kernel``, launched at ``ops.py:116``).  Both are bound
by operations (2·d·m·n) and in f64 (n ≥ 2) run on the FP64 tensor cores,
the ``mma.sync`` engine of ``csrc/dense_mma.cuh``, their sums over m split
into slabs by :func:`repro_torch.kernels.common.sketch_split` or
:func:`~repro_torch.kernels.common.gaussian_split` and the partials added
in slab order.  B6 copies its S tiles into the engine's ring; B4 generates
them there from the threefry counter (i, j) and Box–Muller, so S never
reaches device memory, and generates each once per thread-block cluster of
:func:`~repro_torch.kernels.common.gen_cluster` blocks along n, which share
it through distributed shared memory.  f32, half inputs and the vector b
run tiled FMA kernels (``csrc/dense_sketch.cuh``), templated on where the
S tile comes from.  No atomics anywhere: the result is deterministic.

Contract (as the reference's): A is (m, n) or (m,); the result is (d, n)
or (d,); f64 and f32 keep their dtype, half inputs give f32.  S is rounded
to A's dtype before the product (``sketch_matmul`` casts it when the
dtypes differ), as the reference's fused route does.  A CUDA tensor
launches the kernel or raises; a CPU tensor runs the plain version of
``ref.py``.  ``wrapper.launches`` counts kernel launches only.

``fused_gaussian_sketch(A, key, d, col0=o)`` is B4 on a row tile of a
streamed A that starts at row o: the kernel draws the counter pair
(i, o + j) for the tile's row j (C entry ``repro_fused_gaussian_cols``, on
every route), so the tile's contribution is formed with S never stored.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..common import gaussian_split, scratch_for, sketch_split, sm_count
from ..countsketch.ref import acc_dtype
from .ref import default_scale, fused_gaussian_ref, sketch_matmul_ref

__all__ = [
    "sketch_matmul", "fused_gaussian_sketch", "threefry_bits", "gaussian_engine",
    "gaussian_clusters",
]

_U32 = 2**32


def _prepare(name, A, ndims):
    """Input checks shared by the dense-sketch wrappers (B4–B7).

    Returns None for a CPU ``A`` (the wrapper runs its plain version); for a
    CUDA ``A`` the kernel's dtype code and A as a contiguous (m, n) matrix.
    """
    if not isinstance(A, torch.Tensor):
        raise TypeError(f"A must be a torch.Tensor, got {type(A).__name__}")
    if A.ndim not in ndims:
        raise ValueError(
            f"{name}: A must have {' or '.join(map(str, ndims))} dims, "
            f"got shape {tuple(A.shape)}"
        )
    if A.shape[0] >= _U32:
        raise ValueError(f"{name}: the counters are 32-bit; m = {A.shape[0]} is too large")
    if A.device.type == "cpu":
        return None
    if A.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or CPU, got {A.device}")
    code = _build.dtype_code(A.dtype)
    return code, (A[:, None] if A.ndim == 1 else A).contiguous()


def _check_S(S, A):
    if not isinstance(S, torch.Tensor) or S.ndim != 2:
        raise ValueError("S must be a 2-D torch.Tensor")
    if S.shape[1] != A.shape[0]:
        raise ValueError(f"S is {tuple(S.shape)} but A has {A.shape[0]} rows")
    if S.device != A.device:
        raise ValueError(f"S is on {S.device}, A on {A.device}")


def _check_key(key, d):
    k0, k1 = key
    if not (0 <= k0 < _U32 and 0 <= k1 < _U32):
        raise ValueError(f"key words must lie in [0, 2^32), got {key}")
    if d >= _U32:
        raise ValueError(f"the counters are 32-bit; d = {d} is too large")
    return int(k0), int(k1)


def sketch_matmul(S: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """S (d, m) · A, through kernel B6 on CUDA."""
    prepared = _prepare("sketch_matmul", A, (1, 2))
    _check_S(S, A)
    if prepared is None:
        return sketch_matmul_ref(S, A)
    code, A2 = prepared
    S = S.to(A.dtype).contiguous()
    d, (m, n) = S.shape[0], A2.shape
    out = torch.empty((d, n), dtype=acc_dtype(A.dtype), device=A.device)
    split = sketch_split(A.dtype, d, m, n, sm_count(A.device))
    scratch = scratch_for([split], A.device)
    lib = _build.load()
    with torch.cuda.device(A.device):
        err = lib.repro_sketch_matmul(
            code, S.data_ptr(), A2.data_ptr(), out.data_ptr(), _build.ptr(scratch), d, m, n,
            split.slab, split.parts, _build.stream_ptr(A.device),
        )
    _build.check(err, "sketch_matmul")
    _build.count_launch(sketch_matmul)
    return out[:, 0] if A.ndim == 1 else out


sketch_matmul.launches = 0


def fused_gaussian_sketch(A: torch.Tensor, key, d: int, *, scale=None, col0: int | None = None) -> torch.Tensor:
    """scale·G·A with G ~ N(0, 1)^{d×m} from ``key = (k0, k1)``, generated
    inside kernel B4 on CUDA; ``scale=None`` means 1/√d.  G·scale is formed
    in f32 and cast to A's dtype.

    ``col0`` is the counter column that A's row 0 meets: A is then the row
    tile starting at row ``col0`` of a larger A, and the result its
    contribution (1/√d)·G[:, col0 : col0 + m]·A, S never formed (the
    streaming accumulator's Gaussian fold; ``GaussianSketch.apply_rows``).
    ``None`` is the whole-A entry; ``col0 = 0`` gives its bits."""
    prepared = _prepare("fused_gaussian_sketch", A, (1, 2))
    k0, k1 = _check_key(key, d)
    if col0 is not None and not 0 <= col0 <= _U32 - A.shape[0]:
        raise ValueError(f"col0 = {col0}: the counter columns col0 .. col0 + m must stay below 2^32")
    if prepared is None:
        return fused_gaussian_ref(A, (k0, k1), d, scale, col0=col0 or 0)
    code, A2 = prepared
    m, n = A2.shape
    out = torch.empty((d, n), dtype=acc_dtype(A.dtype), device=A.device)
    split = gaussian_split(A.dtype, d, m, n, sm_count(A.device))
    scratch = scratch_for([split], A.device)
    lib = _build.load()
    tail = (A2.data_ptr(), out.data_ptr(), _build.ptr(scratch), d, m, n, split.slab, split.parts,
            _build.stream_ptr(A.device))
    with torch.cuda.device(A.device):
        if col0 is None:
            err = lib.repro_fused_gaussian(code, k0, k1, default_scale(d, scale), *tail)
        else:
            err = lib.repro_fused_gaussian_cols(code, k0, k1, int(col0), default_scale(d, scale), *tail)
    _build.check(err, "fused_gaussian_sketch")
    _build.count_launch(fused_gaussian_sketch)
    return out[:, 0] if A.ndim == 1 else out


fused_gaussian_sketch.launches = 0


def _cuda_device(device, name):
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"{name} reads the CUDA kernel library; got {device}")
    return device


def threefry_bits(key, row0: int, col0: int, rows: int, cols: int, device) -> tuple:
    """Raw threefry bits (b0, b1) of counters (row0 + i, col0 + j) as int64
    (rows, cols) tensors, from the device function kernels B4 and B5 call.

    A check, not a kernel of any path: it lets a run hold the card's bits
    bitwise against :func:`repro_torch.kernels.common.threefry2x32`.
    """
    k0, k1 = _check_key(key, row0 + rows)
    device = _cuda_device(device, "threefry_bits")
    out = torch.empty((2, rows, cols), dtype=torch.int32, device=device)
    lib = _build.load()
    with torch.cuda.device(device):
        err = lib.repro_threefry_bits(
            k0, k1, row0, col0, rows, cols, out[0].data_ptr(), out[1].data_ptr(),
            _build.stream_ptr(device),
        )
    _build.check(err, "threefry_bits")
    bits = out.to(torch.int64) & 0xFFFFFFFF
    return bits[0], bits[1]


def gaussian_engine(A: torch.Tensor, key, d: int, cluster: int, *, scale=None) -> torch.Tensor:
    """B4's f64 engine on A (m, n ≥ 2) with clusters of ``cluster`` blocks
    and no split of m: the result of :func:`fused_gaussian_sketch`, for any
    cluster size from 1 (each block generates its whole S tile) to
    GEN_CLUSTER_MAX.

    A check, not a kernel of any path: it lets a run time the design at
    other cluster sizes than the one B4 plans.  It counts no launches.
    """
    k0, k1 = _check_key(key, d)
    device = _cuda_device(A.device, "gaussian_engine")
    if A.dtype != torch.float64 or A.ndim != 2 or A.shape[1] < 2:
        raise ValueError(f"gaussian_engine takes an f64 (m, n ≥ 2) A, got {A.dtype} {tuple(A.shape)}")
    A = A.contiguous()
    m, n = A.shape
    out = torch.empty((d, n), dtype=torch.float64, device=device)
    lib = _build.load()
    with torch.cuda.device(device):
        err = lib.repro_gaussian_engine(
            k0, k1, default_scale(d, scale), A.data_ptr(), out.data_ptr(), d, m, n, cluster,
            _build.stream_ptr(device),
        )
    _build.check(err, "gaussian_engine")
    return out


def gaussian_clusters(cluster: int, device) -> int:
    """How many thread-block clusters of ``cluster`` blocks of B4's f64
    engine, with its shared memory, the card can hold at once
    (``cudaOccupancyMaxActiveClusters``); 0 means such a cluster does not
    fit and its launch is refused."""
    device = _cuda_device(device, "gaussian_clusters")
    count = ctypes.c_int(0)
    lib = _build.load()
    with torch.cuda.device(device):
        err = lib.repro_gaussian_clusters(cluster, ctypes.byref(count))
    _build.check(err, "gaussian_clusters")
    return count.value
