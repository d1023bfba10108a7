"""The tuner's role on the H100: the kernels' cost bound and their plans.

Counterpart of ``repro/kernels/autotune.py``.  The reference sweeps Pallas
block shapes against a roofline cost model on its TPU and commits the
winners to a cache file that ``repro.core.backend.kernel_blocks`` reads at
every dispatch.  The port's kernels have no block shapes to sweep: each
takes its work split from a closed-form plan in ``kernels/common.py``
(``split_plan`` and the engine's ``sketch_split``, ``gaussian_split`` and
``gram_split``; B4's thread-block cluster, ``gen_cluster``; B8's passes and
column panel, ``hadamard_passes``/``hadamard_panel``), a function of the
shape and the card's SM count alone, so a shape always gets the same split
and the same rounding.  So there is no sweep and no cache file:

- :func:`predict_cost` — the least time a launch could take on the H100,
  the larger of the bytes it must move (each input read once, each output
  written once) over the HBM rate and its operations over the peak rate of
  their type: the bound of ``PERF.md``'s kernel table, the one formula
  ``chip_smoke.py`` prints beside each kernel's time (:func:`bound`);
- :func:`best_blocks` — the plan the kernel takes for that shape.

``KINDS`` keeps the reference's names: ``countsketch`` (B1, its CSR walk:
no plan), ``sketch_matmul`` (B6), ``gaussian`` (B4), ``srht`` (B8) and
``tsqr`` (B2's Gram of the (d, n) sketch).
"""
from __future__ import annotations

import torch

from .common import gaussian_split, gen_cluster, gram_split, hadamard_panel, hadamard_passes, sketch_split, sm_count

__all__ = ["KINDS", "PEAK_BYTES_PER_S", "PEAK_FLOPS", "H100_SMS", "bound", "work", "peak", "predict_cost", "best_blocks"]

KINDS = ("countsketch", "sketch_matmul", "gaussian", "srht", "tsqr")
_ALIASES = {"uniform_dense": "sketch_matmul", "clarkson_woodruff": "countsketch"}

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): HBM3 bandwidth and the
# FP64 (tensor core), FP32, TF32 and dense bf16/fp16 tensor-core rates.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float64": 67e12, "float32": 67e12, "tf32": 495e12, "bfloat16": 989e12, "float16": 989e12}
# The kinds whose f32 launches run on the TF32 tensor cores in split TF32,
# and the TF32 products each product takes there (csrc/tf32_mma.cuh): B6
# splits each factor in two (three products), B2 in three (six).
_SPLIT_TF32 = {"sketch_matmul": 3, "tsqr": 6}
H100_SMS = 132  # streaming multiprocessors of the H100 SXM (data sheet)


def bound(ops: float, nbytes: float, dtype: str = "float64") -> tuple[float, str]:
    """The least time (ms) of a call and what bounds it: ``ops`` operations
    at the peak rate of ``dtype``, or ``nbytes`` at the HBM rate."""
    t_ops, t_bytes = ops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def _kind(kind: str) -> str:
    kind = _ALIASES.get(kind, kind)
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}; have {KINDS}")
    return kind


def work(kind: str, m: int, n: int, d: int, dtype=torch.float64) -> tuple[float, float]:
    """(operations, bytes) of one launch on A (m, n) sketched to d rows, as
    ``PERF.md``'s table counts them: B1 an add a nonzero, A, its bucket
    (int32) and sign, and SA once; B6 and B4 2·d·m·n (S read by B6,
    generated by B4); B8 (log2 m_pad + 1)·m·n + d·n, A, D, the d sampled
    rows and SA once; B2 d·n·(n + 1) on the (d, n) sketch and its (n, n)
    Gram.  An f32 launch of B6 counts three TF32 products and of B2 six
    (:func:`peak`).  Inputs count at ``dtype``'s size, outputs at the
    accumulation dtype's: a bf16/f16 launch writes f32, 4 bytes a cell."""
    kind, esz = _kind(kind), torch.empty((), dtype=dtype).element_size()
    osz = 4 if dtype in (torch.bfloat16, torch.float16) else esz
    products = _SPLIT_TF32[kind] if peak(kind, dtype) == "tf32" else 1
    if kind == "countsketch":
        return m * n, m * n * esz + m * (4 + esz) + d * n * osz
    if kind == "sketch_matmul":
        return products * 2 * d * m * n, (d * m + m * n) * esz + d * n * osz
    if kind == "gaussian":
        return 2 * d * m * n, m * n * esz + d * n * osz
    if kind == "srht":
        p_bits = max(m - 1, 1).bit_length()
        return (p_bits + 1) * m * n + d * n, (m * n + m + d) * esz + d * n * osz
    return products * d * n * (n + 1), d * n * esz + n * n * osz


def peak(kind: str, dtype=torch.float64) -> str:
    """The ``PEAK_FLOPS`` entry that bounds a launch of ``kind`` in
    ``dtype``: ``"tf32"`` for B6 and B2 in f32, else the dtype's own."""
    name = str(dtype).removeprefix("torch.")
    if name == "float32" and _kind(kind) in _SPLIT_TF32:
        return "tf32"
    return name if name in PEAK_FLOPS else "float32"


def predict_cost(kind: str, m: int, n: int, d: int, dtype=torch.float64) -> float:
    """The bound (seconds) of one launch of ``kind`` on A (m, n) sketched to
    d rows in ``dtype`` on the H100 (``bound`` of ``work``; the plan does
    not change it, so the reference's ``blocks`` argument has no
    counterpart)."""
    ms, _ = bound(*work(kind, m, n, d, dtype), peak(kind, dtype))
    return ms * 1e-3


def best_blocks(kind: str, m: int, n: int, d: int, dtype=torch.float64, device=None) -> dict:
    """The plan ``kind``'s kernel takes for this shape on ``device`` (its SM
    count where it is a card, else the H100's): ``{"split": Split}`` for the
    engine's products (B6 over m, B4 over m with its ``cluster``, B2 over
    d), ``{"passes", "panel"}`` for B8, ``{}`` for B1."""
    kind = _kind(kind)
    dev = None if device is None else torch.device(device)
    sms = sm_count(dev) if dev is not None and dev.type == "cuda" else H100_SMS
    if kind == "sketch_matmul":
        return {"split": sketch_split(dtype, d, m, n, sms)}
    if kind == "gaussian":
        return {"split": gaussian_split(dtype, d, m, n, sms), "cluster": gen_cluster(n)}
    if kind == "tsqr":
        return {"split": gram_split(dtype, d, n, sms)}
    if kind == "srht":
        m_pad = 1 << max(m - 1, 1).bit_length()
        esz = torch.empty((), dtype=dtype).element_size()
        return {"passes": hadamard_passes(m_pad), "panel": min(hadamard_panel(esz), n)}
    return {}
