#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It puts
``src`` on ``sys.path``, builds the CUDA kernels from
``src/repro_torch/csrc``, and then:

1. prints the device, the card's name and power limit, and the build time;
2. holds every kernel against its plain PyTorch version on the card
   (B1 also bitwise against the plain version run on the CPU; the threefry
   bits of B4/B5 bitwise against the plain version on the card and on the
   CPU, and their Gaussians within ULP_BOUND f32 ulps of both);
3. drives the main path, paper Algorithm 1 through ``lstsq(...,
   method="saa")``, at the paper's size (m = 2^20, n = 1000, κ = 1e10, f64);
4. the fused factor route (``fused=True``, kernel B3);
5. the perturbation fallback (``iter_lim=1``, m = 2^18);
6. mixed precision (bf16 sketch, κ = 1e4);
7. the tsqr CholeskyQR path (kernel B2) on the main path's sketch, and
   per-kernel times at the main path's shapes beside their bounds, their
   plain versions and a one-call library yardstick.  Phase 7 runs right
   after phase 4, on the main path's problem, before that is freed;
8. the dense-sketch paths at m = 2^16, n = 1000, κ = 1e10: ``sketch=
   "gaussian"`` (B4) and ``"uniform_dense"`` (B6), each also with
   ``fused=True`` (B5, B7), one uniform-dense ``precision="mixed"`` run
   at κ = 1e4 (B6 on bf16), warm wall times beside the CountSketch solve
   at the same size, and the times of B4–B7 at those shapes;
9. the SRHT and sparse sketches on the main problem (m = 2^20, run after
   phase 7, before that problem is freed): ``sketch="srht"`` plain (B8 on
   A and b) and fused (B8, then B2), ``"sparse_sign"`` and
   ``"uniform_sparse"`` (B1 on their CSRs), each with its error beside
   ``qr_solve``'s, its warm wall time and its launches; B8 held bitwise
   against its plain version at A (2^20, 1000) and timed there and on b,
   beside its bound, with its plan's panel width, its peak scratch memory
   (under 100 MB) and its time at other panel widths, as one panel of all
   columns (the design's first step) and replayed from a CUDA graph;
   B1 on the sparse-sign and uniform-sparse CSRs at A (2^20, 1000), held
   against its plain version there; ``hadamard_transform`` through
   ``SRHTSketch.as_dense_t``; and, on phase 6's κ = 1e4 problem, one mixed
   SRHT solve (B8 on bf16 A, held against its plain version on that A);
10. the forward-stable solvers and the certified tier (class ``_Phase10``),
   each gated by the bounds of the reference's own tests: on the main
   problem the default ``lstsq(A, b, gen)`` (auto → ``iterative``),
   ``fossils`` (forced and through ``accuracy="high"``), ``sap``,
   ``accuracy="certified"`` from the default sketch and from n + 2 rows
   (counting the 2-D sketch applies: one, plus one per escalation),
   ``saa_sas_batch`` with 8 right-hand sides (each column bitwise its own
   block solve, its whitened solution within 1e-10 of its single solve),
   and the loops' time per pair of products with A; then 4 problems at
   m = 2^16 under one S, the default call with every sketch kind (plain
   and fused) at m = 2^16, forward stability at β = 1e-5, and, on
   phase 6's problem, a mixed certified run with the exact σ_min pass
   timed by its two routes.  Each run prints itn, istop, launches, error
   and the median warm wall of 3;
11. the span tracer and the session (class ``_Phase11``), on the main
   problem: ``lstsq(..., trace=True)`` for the default call, ``method=
   "saa"`` and ``accuracy="certified"``, each timeline printed with its
   spans' durations on the card and checked for its span names and their
   nesting; the default call's median warm wall traced and untraced, and
   the disabled tracer against ``obs_trace.stripped()`` (5 alternating
   rounds, least of each, ≤ 1.05x); a ``SketchedSolver`` serving 8
   ``solve`` calls and one ``solve_many`` of 8 (each within 1e-5 and
   100x ``qr_solve``'s error, each block column bitwise its block solve of
   8 copies) from one operator draw, one QR and one B1 launch on A; row
   updates of 4096 rows (the CountSketch's delta-sketch, B1 on a CSR of
   4096 entries; the SRHT's re-sketch with the same S through B8; an
   auto-recertifying session from n + 2 rows), each updated B held against
   a fresh sketch of the new A, the caller's rows unchanged, the next
   solve against ``qr_solve`` on the new A, the update's wall and peak
   memory printed; at m = 2^16 a Gaussian and a uniform-dense session
   with one update each (B4/B6 on A and b, B6 on the delta); and the
   registry's ``repro_session_*`` counters against the sessions' stats;
12. sparse, Tikhonov and matrix-free inputs (class ``_Phase12``): on the
   main problem, ``reg=1e-8`` through the default call, ``saa`` (B1 on A
   inside ``AugmentedSketch``) and the certified tier, each within 1e-5 of
   the QR of the materialized (m + n, n) system with ``arnorm`` ≤
   1e-8·‖b‖, and a ``SketchedSolver(reg=1e-8)``; a ``CustomOperator`` over
   the main problem through the default call and ``saa`` (Sᵀ in panels,
   ``rmatmat`` under ``torch.vmap``); then a sparse problem (m = 2^20,
   n = 1000, 10 entries a row, κ ≈ 1e6): the coordinate scatter
   (``countsketch_coo_apply``) at its entries for each bucket kind in f64
   and f32, bitwise its plain version on the CPU, two calls bitwise equal,
   within 2·γ·|S||A| of its plain version on the card, timed beside its
   set-up (the stable sort), its bound, its plain version and one atomic
   ``index_add_``; ``SparseOperator``'s products bitwise across two calls;
   the default call, ``saa`` with four kinds (the SRHT on A densified),
   ``sap`` and the certified tier (never its ``direct`` rung), each within
   1e-5 and 100x ``qr_solve``'s error on the densified A; and a session
   on that A.  Each run prints its median warm wall of 3 and its peak.

Phase 2 also holds B8 (``hadamard_transform``, ``srht_apply``) bitwise
against its plain version on the card and on the CPU, in f64 and f32 and on
half inputs (f32 out), at one, two and three passes and at n not a multiple
of the panel width, checks that other panel widths, an unaligned A and a
second call give the same bits and that rows out of range give NaN rows,
the coordinate scatter at its edges (an empty column and bucket, repeated
coordinates, unsorted entries, nnz = 0, a sparse vector b), and B1 bitwise
against the CPU on the sparse-sign
CSR (k·m entries) and on uniform weights.  It drives the f64 tensor-core
engine of B6 and B2 (``csrc/dense_mma.cuh``) at each edge of its design
(ragged d, n, m and s; m and s shorter than one ring stage; both sides of a
change of the split plan; n = 2..8 and odd n; operands not 16-byte
aligned), holds each call to the same bounds, checks that two calls are
bitwise equal, and that B7's B is bitwise B6's there.  It does the same for
B4's generating engine (S made in the ring and shared by a thread-block
cluster; ragged d and n, m shorter than a stage, both sides of a split-plan
change, n = 2..8, clusters of 1, 2, 3 and 8 blocks and a padded grid, an
unaligned A), holding B4 to the plain product on its own S and B5's B
bitwise to B4's, after checking that clusters of every size fit on the
card.  Phases 7 and 8 print each kernel's TFLOP/s and its share of its
bound beside its time; phase 8 also times B4's engine with clusters of 1.

Phases 7 and 9 also time cuSPARSE's SpMM (``torch.sparse.mm`` on S as a
(d, m) CSR matrix) beside B1 on the CountSketch's and the sparse-sign
sketch's CSRs, and B1's plain version on the sparse-sign CSR.

``python3 chip_smoke.py --profile`` instead builds the kernels, draws the
main problem and traces one warm plain, one warm fused and one warm SRHT
solve, and one warm default call (iterative sketching), with ``torch.profiler``: device time by kernel and the device's busy
share of the wall time (the breakdown in PERF.md).  Then it times the warm
main solve at the paper's size and at a smaller, host-bound size, and
traces one warm Gaussian, uniform-dense and CountSketch solve at m = 2^16,
and the fused Gaussian and uniform-dense ones.  Each trace lists its 15
longest rows and every kernel of the port, so the tensor-core kernels show
by name; where a port kernel the call launched has no device record, it
says so instead of printing a busy share.  It prints no result line.

Each path runs with every kernel's launch count set to 0 just before it and
read just after.  TF32 is off for matmuls and cuDNN, so f32 products run in
full f32.  Any failure raises and exits non-zero; without CUDA, or without
the rest of the repository beside it, it exits 2 and prints no result.  The
last line is ``{"ok": true, "device": {...}}``; the line before it lists the
kernels as JSON.
"""
from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): HBM3 bandwidth and the
# FP64 (tensor core) and FP32 rates.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float64": 67e12, "float32": 67e12}

M_MAIN, N_MAIN = 2**20, 1000
COND, BETA = 1e10, 1e-10
# The dense sketches cost 2·d·m·n operations per apply, m/n times a
# CountSketch apply's reads: their paths run at m = 2^16, a point of the
# paper's own m sweep at n = 1000 (PERF.md, section 4).
M_DENSE = 2**16
# Largest gap, in f32 ulps, allowed between the Gaussians the kernels
# generate and those of the plain versions (on the card and on the CPU).
# The plain version on the CPU is within 3 ulps of the reference's.
ULP_BOUND = 3


def _p(*args):
    print(*args, flush=True)


def _rel(x, y):
    return float((x - y).norm() / y.norm())


def _sync_time(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _event_ms(torch, fn, reps=5):
    """Mean device time of ``fn`` over ``reps`` calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def _with_panels(w, fn):
    """``fn()`` with B8's SRHT taking panels of w columns, not the plan's
    (a check and a measurement; the result does not depend on w)."""
    from repro_torch.kernels.srht import ops as srht_ops

    plan = srht_ops.hadamard_panel
    srht_ops.hadamard_panel = lambda in_bytes: w
    try:
        return fn()
    finally:
        srht_ops.hadamard_panel = plan


class _Count2D:
    """Within ``with``: record the shape of every 2-D (matrix) apply of the
    sketch class ``cls`` (as tests/test_certify.py counts them)."""

    def __init__(self, cls):
        self.cls, self.shapes = cls, []

    def __enter__(self):
        real = self.real = self.cls.apply

        def counting(op, M, *, backend="auto"):
            if M.ndim == 2:
                self.shapes.append(tuple(M.shape))
            return real(op, M, backend=backend)

        self.cls.apply = counting
        return self

    def __exit__(self, *exc):
        self.cls.apply = self.real


def _gamma(torch, k, dtype):
    u = torch.finfo(dtype).eps / 2
    return k * u / (1 - k * u)


def _ulps(torch, x, y):
    """Largest gap between two f32 tensors in ulps (IEEE order)."""
    def ordered(t):
        i = t.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(2**31) - i, i)
    return int((ordered(x.cpu()) - ordered(y.cpu())).abs().max())


def _bound(ops, nbytes):
    """The least time (ms) of a call and what bounds it: ``ops`` f64
    operations at the FP64 peak, or ``nbytes`` at the HBM rate."""
    t_ops, t_bytes = ops / PEAK_FLOPS["float64"], nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def _rates(t, ops):
    """Add a timing's TFLOP/s (``ops`` over ``t["ms"]``) and its share of
    its bound (``bound_ms / ms``)."""
    t["tflops"] = ops / t["ms"] / 1e9
    t["bound_share"] = t["bound_ms"] / t["ms"]
    return t


def _sparse_s(torch, buckets, weights, d, m):
    """S as a (d, m) sparse CSR matrix: the bucket sketch's entries
    (weights[j, i] at row buckets[j, i], column i; repeated entries
    summed), for cuSPARSE's SpMM."""
    rows = buckets.reshape(-1).to(torch.int64)
    cols = torch.arange(m, device=rows.device).repeat(rows.numel() // m)
    coo = torch.sparse_coo_tensor(torch.stack([rows, cols]), weights.reshape(-1), (d, m))
    return coo.coalesce().to_sparse_csr()


def _spmm(torch, S_csr, A, B1_out):
    """Time ``torch.sparse.mm(S_csr, A)`` (mean of 5 after a warm-up) and
    return it with its max|Δ| from B1's output on the same inputs."""
    err = float((torch.sparse.mm(S_csr, A) - B1_out).abs().max())
    return _event_ms(torch, lambda: torch.sparse.mm(S_csr, A)), err


def _check_gram(torch, G, G_ref, B, what):
    """Raise unless G is exactly symmetric and within 2·γ_s·(|B|ᵀ|B|) of the
    plain Gram ``G_ref`` of the same B (s = B's rows); return max|Δ|."""
    absB = B.abs().to(torch.float64)
    err = (G.to(torch.float64) - G_ref.to(torch.float64)).abs()
    tol = 2 * _gamma(torch, B.shape[0], G.dtype) * (absB.T @ absB)
    symmetric = torch.equal(G, G.T)
    if G.dtype != G_ref.dtype or not symmetric or not bool((err <= tol).all()):
        raise AssertionError(f"{what}: max|Δ| {float(err.max())}, symmetric {symmetric}, "
                             f"dtype {G.dtype} vs {G_ref.dtype}")
    return float(err.max())


def main() -> int:
    root = Path(__file__).resolve().parent
    if not (root / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke.py: src/repro_torch is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(root / "src"))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.core import (
        SketchedFactor,
        SparseSignSketch,
        SRHTSketch,
        UniformSparseSketch,
        generate_problem,
        lsqr_dense,
        lstsq,
        qr_solve,
        saa_sas,
    )
    from repro_torch.kernels import (
        KERNELS,
        MAX_FUSED_COLS,
        _build,
        countsketch_apply,
        countsketch_csr,
        countsketch_gram,
        countsketch_gram_ref,
        countsketch_ref,
        fused_gaussian_ref,
        fused_gaussian_sketch,
        gaussian_gram,
        gaussian_gram_ref,
        gaussian_matrix_ref,
        hadamard_ref,
        hadamard_transform,
        key_to_u32,
        matmul_gram,
        matmul_gram_ref,
        panel_gram,
        panel_gram_ref,
        reset_launches,
        sketch_matmul,
        sketch_matmul_ref,
        srht_apply,
        srht_ref,
        threefry2x32,
        threefry_bits,
        tsqr,
    )
    from repro_torch.kernels.common import (
        GEN_CLUSTER_MAX,
        gaussian_split,
        gen_grid,
        gram_split,
        hadamard_panel,
        hadamard_passes,
        sketch_split,
        sm_count,
    )
    from repro_torch.kernels.sketch_matmul import default_scale, gaussian_clusters, gaussian_engine

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    _p(f"phase 1: device {kind} x{torch.cuda.device_count()}; torch "
       f"{torch.__version__}, CUDA {torch.version.cuda}; tf32 off for matmul and cuDNN")
    _p(f"phase 1: nvidia-smi: {smi}")
    _, t_build = _sync_time(torch, _build.load)
    _p(f"phase 1: kernels built and loaded in {t_build:.1f} s")
    if "--profile" in sys.argv[1:]:
        return _profile(torch, dev, generate_problem, lstsq)

    gen = torch.Generator(device=dev).manual_seed(0)

    def draw(m, tail, d, dtype):
        A = torch.randn((m,) + tail, generator=gen, dtype=torch.float64, device=dev).to(dtype)
        h = torch.randint(0, d, (m,), generator=gen, dtype=torch.int32, device=dev)
        s = (torch.randint(0, 2, (m,), generator=gen, device=dev) * 2 - 1).to(dtype)
        return A, h, s

    def magnitude(A, h, d):
        """|S||A| in f64 — the scale of each output's rounding error."""
        return countsketch_ref(A.abs().to(torch.float64), h, torch.ones_like(h, dtype=torch.float64), d)

    errs = {f.__name__: 0.0 for f in KERNELS}

    # ---- phase 2: every kernel against its plain version ------------------
    # B1: bitwise against the plain version on the CPU (same summation
    # order, exact ±1 products); within 2·γ_k·|S||A| of the plain version
    # on the card, whose index_add_ adds with atomics in any order (k = the
    # largest bucket).
    for m, tail, d, dtype in [
        (4096, (64,), 256, torch.float64), (4096, (64,), 256, torch.float32),
        (4096, (), 256, torch.float64), (4096, (), 256, torch.float32),
        (1000, (5,), 37, torch.float64), (777, (1,), 300, torch.float32),
        (4096, (33,), 100, torch.bfloat16), (4096, (33,), 100, torch.float16),
        (3000, (), 11, torch.bfloat16),
    ]:
        A, h, s = draw(m, tail, d, dtype)
        out = countsketch_apply(A, h, s, d)
        cpu = countsketch_ref(A.cpu(), h.cpu(), s.cpu(), d)
        card = countsketch_ref(A, h, s, d)
        torch.cuda.synchronize()
        want = torch.float32 if dtype in (torch.bfloat16, torch.float16) else dtype
        if out.dtype != want or out.shape != cpu.shape:
            raise AssertionError(f"B1 {dtype} {tuple(A.shape)}: got {out.dtype} {tuple(out.shape)}")
        if not torch.equal(out.cpu(), cpu):
            raise AssertionError(f"B1 {dtype} {tuple(A.shape)} d={d}: not bitwise equal to the CPU plain version")
        k = int(torch.bincount(h.long(), minlength=d).max())
        err = (out - card).abs()
        tol = 2 * _gamma(torch, k, want) * magnitude(A, h, d).reshape(out.shape)
        if not bool((err <= tol).all()):
            raise AssertionError(f"B1 {dtype} {tuple(A.shape)}: off the card's plain version by {float(err.max())}")
        errs["countsketch_apply"] = max(errs["countsketch_apply"], float(err.max()))
        _p(f"phase 2: B1 countsketch_apply {str(dtype)[6:]} A{tuple(A.shape)} d={d}: "
           f"bitwise = CPU plain; max|Δ| vs card plain {float(err.max()):.3e} (tol 2γ_{k}|S||A|)")

    # B2: within 2·γ_s·(|B|ᵀ|B|) of the plain version on the card, and
    # exactly symmetric.
    for s_rows, n, dtype in [
        (4000, 1000, torch.float64), (700, 48, torch.float32), (333, 1, torch.float64),
        (500, 130, torch.float64), (4 * MAX_FUSED_COLS, MAX_FUSED_COLS, torch.float64),
        (4000, 1000, torch.bfloat16),
    ]:
        B = torch.randn(s_rows, n, generator=gen, dtype=torch.float64, device=dev).to(dtype)
        err = _check_gram(torch, panel_gram(B), panel_gram_ref(B), B, f"B2 {dtype} B({s_rows}, {n})")
        errs["panel_gram"] = max(errs["panel_gram"], err)
        _p(f"phase 2: B2 panel_gram {str(dtype)[6:]} B({s_rows}, {n}): max|Δ| vs card plain "
           f"{err:.3e} (tol 2γ_s|B|ᵀ|B|), exactly symmetric")

    # B3: B bitwise the CPU plain CountSketch; G exactly symmetric and within
    # 2·γ_d·(|B|ᵀ|B|) of the plain Gram of the same B.
    for m, n, d, dtype in [
        (2**16, MAX_FUSED_COLS, 4 * MAX_FUSED_COLS, torch.float64), (1000, 1, 37, torch.float64),
        (1500, 130, 200, torch.float32), (4096, 64, 256, torch.bfloat16),
    ]:
        A, h, s = draw(m, (n,), d, dtype)
        B, G = countsketch_gram(A, h, s, d)
        B_cpu = countsketch_ref(A.cpu(), h.cpu(), s.cpu(), d)
        if not torch.equal(B.cpu(), B_cpu):
            raise AssertionError(f"B3 {dtype} A({m}, {n}) d={d}: B not bitwise equal to the CPU plain version")
        err = _check_gram(torch, G, panel_gram_ref(B), B, f"B3 {dtype} A({m}, {n}) d={d}")
        errs["countsketch_gram"] = max(errs["countsketch_gram"], err)
        _p(f"phase 2: B3 countsketch_gram {str(dtype)[6:]} A({m}, {n}) d={d}: B bitwise = CPU "
           f"plain; G max|Δ| vs plain Gram {err:.3e} (tol 2γ_d|B|ᵀ|B|), exactly symmetric")
    # B4/B5's generator.  The raw threefry bits of the device function both
    # kernels call are bitwise the plain int64 threefry on the card and on
    # the CPU (a tile across the 2^31 and 2^32 - 1 counters included).  The
    # Gaussians are those the kernel itself generates: B4 on an identity A
    # with scale 1 returns its G exactly (one nonzero product per output),
    # held within ULP_BOUND f32 ulps of the plain versions.
    key = key_to_u32(gen)
    for row0, col0, rows, cols in [(0, 0, 300, 700), (3999, 2**31 - 100, 7, 300),
                                   (0, 2**32 - 50, 64, 50)]:
        b0, b1 = threefry_bits(key, row0, col0, rows, cols, dev)
        r = torch.arange(row0, row0 + rows, dtype=torch.int64)[:, None].expand(rows, cols)
        c = torch.arange(col0, col0 + cols, dtype=torch.int64)[None, :].expand(rows, cols)
        cpu0, cpu1 = threefry2x32(*key, r, c)
        card0, card1 = threefry2x32(*key, r.to(dev), c.to(dev))
        if not (torch.equal(b0.cpu(), cpu0) and torch.equal(b1.cpu(), cpu1)
                and torch.equal(b0, card0) and torch.equal(b1, card1)):
            raise AssertionError(f"threefry bits of tile ({row0}, {col0}) differ from the plain version")
    _p("phase 2: B4/B5 threefry bits (3 tiles): bitwise = plain on the card and on the CPU")

    def kernel_S(d, m, dtype):
        """The S kernel B4 generates for (d, m): its unscaled G from an
        identity A, then the kernel's f32 scale and cast."""
        G = fused_gaussian_sketch(torch.eye(m, dtype=torch.float32, device=dev), key, d, scale=1.0)
        return G, (G * default_scale(d)).to(dtype)

    d_g, m_g = 300, 700
    G_k, _ = kernel_S(d_g, m_g, torch.float32)
    u_card = _ulps(torch, G_k, gaussian_matrix_ref(*key, d_g, m_g, device=dev))
    u_cpu = _ulps(torch, G_k, gaussian_matrix_ref(*key, d_g, m_g))
    if max(u_card, u_cpu) > ULP_BOUND:
        raise AssertionError(f"B4 Gaussians {u_card} (card) / {u_cpu} (CPU) ulps off the plain version")
    e5 = torch.zeros(m_g, dtype=torch.float32, device=dev)
    e5[5] = 1
    eye64 = torch.eye(m_g, dtype=torch.float64, device=dev)
    B5_eye, _ = gaussian_gram(torch.eye(m_g, dtype=torch.float32, device=dev), key, d_g, scale=1.0)
    if not (torch.equal(fused_gaussian_sketch(e5, key, d_g, scale=1.0), G_k[:, 5])
            and torch.equal(fused_gaussian_sketch(eye64, key, d_g, scale=1.0), G_k.double())
            and torch.equal(B5_eye, G_k)):
        raise AssertionError("B4's vector or f64 route, or B5, generated another G than B4's tile route")
    _p(f"phase 2: B4/B5 Gaussians G({d_g}, {m_g}): {u_card} ulps from the card's plain version, "
       f"{u_cpu} from the CPU's (bound {ULP_BOUND}); vector, f64 and B5 routes bitwise the same G")

    # B4 and B6: within 2·γ_m·(|S||A|) of the plain product on the card, with
    # B4's plain product taken on the S the kernel generated (held to the
    # plain Gaussians above), so the bound is the sums' alone.
    def check_product(name, out, plain, S, A, m):
        mag = S.abs().to(torch.float64) @ A.abs().to(torch.float64).reshape(m, -1)
        err = (out.to(torch.float64) - plain.to(torch.float64)).abs()
        tol = 2 * _gamma(torch, m, out.dtype) * mag.reshape(out.shape)
        if out.dtype != plain.dtype or out.shape != plain.shape or not bool((err <= tol).all()):
            raise AssertionError(f"{name}: max|Δ| {float(err.max())} ({out.dtype} {tuple(out.shape)} "
                                 f"vs {plain.dtype} {tuple(plain.shape)})")
        return float(err.max())

    for m, tail, d, dtype in [
        (4096, (64,), 256, torch.float64), (4096, (64,), 256, torch.float32),
        (4096, (), 256, torch.float64), (4096, (), 256, torch.float32),
        (1000, (5,), 300, torch.float64), (777, (1,), 300, torch.float32),
        (4096, (33,), 100, torch.bfloat16), (3000, (), 11, torch.bfloat16),
        (1000, (5,), 37, torch.float16), (8192, (MAX_FUSED_COLS,), 2500, torch.float64),
    ]:
        A = torch.randn((m,) + tail, generator=gen, dtype=torch.float64, device=dev).to(dtype)
        _, S_k = kernel_S(d, m, dtype)
        out = fused_gaussian_sketch(A, key, d)
        err = check_product(f"B4 {dtype} A{tuple(A.shape)} d={d}", out, sketch_matmul_ref(S_k, A), S_k, A, m)
        errs["fused_gaussian_sketch"] = max(errs["fused_gaussian_sketch"], err)
        S = torch.randn((d, m), generator=gen, dtype=torch.float64, device=dev).to(dtype)
        err6 = check_product(f"B6 {dtype} A{tuple(A.shape)} d={d}", sketch_matmul(S, A),
                             sketch_matmul_ref(S, A), S, A, m)
        errs["sketch_matmul"] = max(errs["sketch_matmul"], err6)
        _p(f"phase 2: B4 fused_gaussian_sketch / B6 sketch_matmul {str(dtype)[6:]} A{tuple(A.shape)} "
           f"d={d}: max|Δ| vs card plain {err:.3e} / {err6:.3e} (tol 2γ_m|S||A|)")

    # B5 and B7: B bitwise B4's or B6's output on the same inputs; G exactly
    # symmetric and within 2·γ_d·(|B|ᵀ|B|) of the plain Gram of that B.
    for m, n, d, dtype in [
        (4096, 64, 256, torch.float64), (1000, 1, 37, torch.float64),
        (1500, 130, 200, torch.float32), (4096, 64, 256, torch.bfloat16),
        (8192, MAX_FUSED_COLS, 2500, torch.float64),
    ]:
        A = torch.randn((m, n), generator=gen, dtype=torch.float64, device=dev).to(dtype)
        S = torch.randn((d, m), generator=gen, dtype=torch.float64, device=dev).to(dtype)
        for name, (B, G), B_ref in [
            ("gaussian_gram", gaussian_gram(A, key, d), fused_gaussian_sketch(A, key, d)),
            ("matmul_gram", matmul_gram(S, A), sketch_matmul(S, A)),
        ]:
            if not torch.equal(B, B_ref):
                raise AssertionError(f"{name} {dtype} A({m}, {n}) d={d}: B differs from the unfused kernel's")
            err = _check_gram(torch, G, panel_gram_ref(B), B, f"{name} {dtype} A({m}, {n}) d={d}")
            errs[name] = max(errs[name], err)
            _p(f"phase 2: {name} {str(dtype)[6:]} A({m}, {n}) d={d}: B bitwise = unfused kernel; "
               f"G max|Δ| vs plain Gram {err:.3e} (tol 2γ_d|B|ᵀ|B|), exactly symmetric")

    # B6 and B2 in f64 run on the tensor-core engine (csrc/dense_mma.cuh):
    # shapes at each edge of its design, held to the same bounds, each
    # called twice (the split's partials are added in a fixed order, with no
    # atomics, so the two calls are bitwise equal).  Edges: d and n not
    # multiples of the block tile; m and s not multiples of the ring's
    # stage; m and s shorter than one stage; lengths on both sides of a
    # change of the split plan; n = 2..8 and odd n (8-byte copies);
    # operands whose first element is not 16-byte aligned (8-byte copies on
    # every row); n = MAX_FUSED_COLS is in the lists above and below.
    sms = sm_count(dev)

    def plan_edge(parts_of, start):
        """The lengths on both sides of the last change of the split plan's
        slab count ``parts_of(length)`` at or below ``start``."""
        parts = parts_of(start)
        edge = start
        while edge > 1 and parts_of(edge - 1) == parts:
            edge -= 1
        return [edge - 1, edge] if edge > 1 else [edge]

    def misaligned(*shape):
        """A contiguous f64 tensor whose data starts 8 bytes past a 16-byte boundary."""
        flat = torch.randn(math.prod(shape) + 1, generator=gen, dtype=torch.float64, device=dev)
        return flat[1:].view(shape)

    sketch_shapes = [(300, 1007, 130), (37, 5, 3), (200, 9, 17), (129, 4096, 257)]
    sketch_shapes += [(100, 300, n) for n in range(2, 9)]
    sketch_shapes += [(300, m, 130) for m in plan_edge(
        lambda m: sketch_split(torch.float64, 300, m, 130, sms).parts, 700)]
    for d, m, n in sketch_shapes + [("misaligned", 501, 33)]:
        if d == "misaligned":
            d, S, A = 77, misaligned(77, m), misaligned(m, n)
        else:
            S = torch.randn((d, m), generator=gen, dtype=torch.float64, device=dev)
            A = torch.randn((m, n), generator=gen, dtype=torch.float64, device=dev)
        out = sketch_matmul(S, A)
        err6 = check_product(f"B6 engine S({d}, {m}) A({m}, {n})", out, sketch_matmul_ref(S, A), S, A, m)
        if not torch.equal(out, sketch_matmul(S, A)):
            raise AssertionError(f"B6 engine S({d}, {m}) A({m}, {n}): two calls differ")
        errs["sketch_matmul"] = max(errs["sketch_matmul"], err6)
        B, G = matmul_gram(S, A)
        if not torch.equal(B, out):
            raise AssertionError(f"B7 at S({d}, {m}) A({m}, {n}): B differs from B6's")
        errs["matmul_gram"] = max(errs["matmul_gram"], _check_gram(torch, G, panel_gram_ref(B), B, "B7 G"))
        split = sketch_split(torch.float64, d, m, n, sms)
        _p(f"phase 2: B6 engine S({d}, {m}) A({m}, {n}) f64{' misaligned' if S.data_ptr() % 16 else ''}, "
           f"split (slab, parts) {split[:2]}: max|Δ| vs card plain {err6:.3e} (tol 2γ_m|S||A|); "
           f"two calls bitwise equal; B7's B bitwise B6's, its G exactly symmetric")
    gram_shapes = [(4000, 130), (1007, 777), (3, 5), (9, 70), (333, 1)]
    gram_shapes += [(300, n) for n in range(2, 9)]
    gram_shapes += [(s_rows, n) for n, start in ((130, 500), (1000, 4000)) for s_rows in plan_edge(
        lambda s_rows: gram_split(torch.float64, s_rows, n, sms).parts, start)]
    for s_rows, n in gram_shapes + [("misaligned", 65)]:
        if s_rows == "misaligned":
            s_rows, B = 1001, misaligned(1001, n)
        else:
            B = torch.randn((s_rows, n), generator=gen, dtype=torch.float64, device=dev)
        G = panel_gram(B)
        err = _check_gram(torch, G, panel_gram_ref(B), B, f"B2 engine B({s_rows}, {n})")
        if not torch.equal(G, panel_gram(B)):
            raise AssertionError(f"B2 engine B({s_rows}, {n}): two calls differ")
        errs["panel_gram"] = max(errs["panel_gram"], err)
        _p(f"phase 2: B2 engine B({s_rows}, {n}) f64{' misaligned' if B.data_ptr() % 16 else ''}, split "
           f"(slab, parts) {gram_split(torch.float64, s_rows, n, sms)[:2]}: max|Δ| vs card plain {err:.3e} "
           f"(tol 2γ_s|B|ᵀ|B|), exactly symmetric, two calls bitwise equal")

    # B4 and B5 in f64 run on the generating engine (csrc/dense_mma.cuh):
    # S made in the ring by a producing warpgroup, shared by a
    # thread-block cluster of gen_cluster(n) blocks along n.  First, that
    # clusters of every size with this shared memory fit on the card.  Then
    # the engine's edges, as for B6: d and n ragged, m shorter than a stage,
    # both sides of a split-plan change, n = 2..8, clusters of 1, 2, 3 and 8
    # blocks and a padded grid (n = 1152: 9 n-tiles in two clusters of 5),
    # an A 8 bytes off 16-byte alignment.  Each held to 2·γ_m·|S||A| of the
    # plain product on the kernel's own S, two calls bitwise equal, B5's B
    # bitwise B4's and its G exactly symmetric.
    fit = {c: gaussian_clusters(c, dev) for c in range(1, GEN_CLUSTER_MAX + 1)}
    _p(f"phase 2: B4 engine: clusters of C blocks resident at once (cudaOccupancyMaxActiveClusters) "
       f"{json.dumps(fit)}")
    if min(fit.values()) < 1:
        raise AssertionError(f"B4 engine: some cluster size does not fit on the card: {fit}")
    gauss_shapes = [(300, 1007, 130), (37, 5, 3), (200, 9, 17), (129, 4096, 257)]
    gauss_shapes += [(100, 300, n) for n in range(2, 9)]
    gauss_shapes += [(300, m, 130) for m in plan_edge(
        lambda m: gaussian_split(torch.float64, 300, m, 130, sms).parts, 700)]
    gauss_shapes += [(200, 600, n) for n in (1000, 1152, 2048)]
    for d, m, n in gauss_shapes + [("misaligned", 501, 33)]:
        if d == "misaligned":
            d, A = 77, misaligned(m, n)
        else:
            A = torch.randn((m, n), generator=gen, dtype=torch.float64, device=dev)
        _, S_k = kernel_S(d, m, torch.float64)
        out = fused_gaussian_sketch(A, key, d)
        err4 = check_product(f"B4 engine d={d} A({m}, {n})", out, sketch_matmul_ref(S_k, A), S_k, A, m)
        if not torch.equal(out, fused_gaussian_sketch(A, key, d)):
            raise AssertionError(f"B4 engine d={d} A({m}, {n}): two calls differ")
        errs["fused_gaussian_sketch"] = max(errs["fused_gaussian_sketch"], err4)
        B, G = gaussian_gram(A, key, d)
        if not torch.equal(B, out):
            raise AssertionError(f"B5 at d={d} A({m}, {n}): B differs from B4's")
        errs["gaussian_gram"] = max(errs["gaussian_gram"], _check_gram(torch, G, panel_gram_ref(B), B, "B5 G"))
        _p(f"phase 2: B4 engine d={d} A({m}, {n}) f64{' misaligned' if A.data_ptr() % 16 else ''}, cluster "
           f"and grid width {gen_grid(n)}, split (slab, parts) {gaussian_split(torch.float64, d, m, n, sms)[:2]}: "
           f"max|Δ| vs card plain on its S {err4:.3e} (tol 2γ_m|S||A|); two calls bitwise equal; "
           f"B5's B bitwise B4's, its G exactly symmetric")
    # The identity check above (n = 700, clusters of 6) once more at n = 1000,
    # clusters of 8: B4's f64 engine on an identity A returns its G exactly.
    G_c, _ = kernel_S(300, 1000, torch.float32)
    if not torch.equal(fused_gaussian_sketch(torch.eye(1000, dtype=torch.float64, device=dev), key, 300,
                                             scale=1.0), G_c.double()):
        raise AssertionError("B4's f64 engine with clusters of 8 generated another G than B4's FMA route")
    _p("phase 2: B4 engine on an identity A(1000, 1000), clusters of 8: bitwise the G of the FMA route")
    del G_c

    # B1 on the sparse sketches' CSRs: the sparse-sign sketch's k·m ±1
    # entries (k = 8) and the uniform-sparse sketch's uniform weights.
    # Bitwise the plain version on the CPU (each product rounded on its own,
    # the same order of adds); within 2·γ_k·|S||A| of the card's index_add_
    # (k = the most entries of one bucket).
    for m, tail, d, dtype in [
        (4096, (64,), 256, torch.float64), (4096, (), 256, torch.float32),
        (3000, (33,), 100, torch.bfloat16),
    ]:
        A = torch.randn((m,) + tail, generator=gen, dtype=torch.float64, device=dev).to(dtype)
        hk = torch.randint(0, d, (8, m), generator=gen, dtype=torch.int32, device=dev)
        sk = (torch.randint(0, 2, (8, m), generator=gen, device=dev) * 2 - 1).double()
        vu = torch.empty(m, dtype=torch.float64, device=dev).uniform_(-3**0.5, 3**0.5, generator=gen)
        for sparse_kind, h, w in [("sparse_sign", hk, sk), ("uniform_sparse", hk[0], vu)]:
            out = countsketch_apply(A, h, w, d)
            cpu = countsketch_ref(A.cpu(), h.cpu(), w.cpu(), d)
            card = countsketch_ref(A, h, w, d)
            torch.cuda.synchronize()
            if not torch.equal(out.cpu(), cpu):
                raise AssertionError(f"B1 on the {sparse_kind} CSR {dtype} {tuple(A.shape)}: not bitwise the CPU plain version")
            k = int(torch.bincount(h.long().flatten(), minlength=d).max())
            mag = countsketch_ref(A.abs().double(), h, w.to(dtype).double().abs(), d).reshape(out.shape)
            err = (out.double() - card.double()).abs()
            if not bool((err <= 2 * _gamma(torch, k, out.dtype) * mag).all()):
                raise AssertionError(f"B1 on the {sparse_kind} CSR: off the card's plain version by {float(err.max())}")
            errs["countsketch_apply"] = max(errs["countsketch_apply"], float(err.max()))
            _p(f"phase 2: B1 on the {sparse_kind} CSR ({h.numel()} entries) {str(dtype)[6:]} A{tuple(A.shape)} d={d}: "
               f"bitwise = CPU plain; max|Δ| vs card plain {float(err.max()):.3e} (tol 2γ_{k}|S||A|)")

    # B8: bitwise against the plain version on the card and on the CPU (the
    # same stages in the same order, the same division by √d).  m = 3000 is
    # padded to 4096 (rows ≥ m read as zeros); d > m_pad draws the rows
    # with replacement; half inputs give f32, and the plain version then
    # transforms the same rounded data in f32, so those are bitwise too.
    # The edges of the panel schedule: n not a multiple of the panel width
    # (8 f64 or 16 f32 columns at m = 2^20: n = 1, 3, 5, 37), one pass
    # (m ≤ 2^10), two, and three (m = 2^21), half inputs at two passes.
    def srht_draw(m, d):
        m_pad = 1 << max(0, (m - 1).bit_length())
        signs = (torch.randint(0, 2, (m_pad,), generator=gen, device=dev) * 2 - 1).double()
        rows = (torch.randint(0, m_pad, (d,), generator=gen, device=dev) if d > m_pad
                else torch.randperm(m_pad, generator=gen, device=dev)[:d])
        return signs, rows

    def check_b8(A, signs, rows, d, cpu_cols=None):
        """Raise unless B8 (both wrappers where m is a power of two) is
        bitwise its plain version on the card and on the CPU (there on the
        first ``cpu_cols`` columns only, where given)."""
        want = torch.float32 if A.dtype in (torch.bfloat16, torch.float16) else A.dtype
        cut = (lambda X: X) if cpu_cols is None or A.ndim == 1 else (lambda X: X[:, :cpu_cols])
        runs = [("srht_apply", srht_apply(A, signs, rows, d),
                 lambda X: srht_ref(X, signs.to(X.device), rows.to(X.device), d))]
        if A.shape[0] & (A.shape[0] - 1) == 0:
            runs.append(("hadamard_transform", hadamard_transform(A), hadamard_ref))
        for name, out, plain in runs:
            card = plain(A)
            if out.dtype != want or not torch.equal(out, card):
                raise AssertionError(f"B8 {name} {A.dtype} {tuple(A.shape)} d={d}: not bitwise the card's "
                                     f"plain version (max|Δ| {float((out - card).abs().max())})")
            del card
            if not torch.equal(cut(out).cpu(), plain(cut(A).cpu())):
                raise AssertionError(f"B8 {name} {A.dtype} {tuple(A.shape)} d={d}: not bitwise the CPU plain version")

    for m, n, d, dtype in [
        (2**10, 1, 300, torch.float64), (2**10, 37, 300, torch.float32), (2**10, 1000, 4000, torch.float64),
        (3000, 1, 300, torch.float32), (3000, 37, 300, torch.float64), (3000, 1000, 4000, torch.float64),
        (2**20, 1, 4000, torch.float64), (2**20, 1, 4000, torch.float32), (2**20, 37, 4000, torch.float64),
        (2**20, 37, 4000, torch.float32), (4096, 33, 100, torch.bfloat16), (3000, 1, 11, torch.float16),
        (2**20, 3, 4000, torch.float64), (2**20, 5, 4000, torch.float64), (2**21, 37, 4000, torch.float64),
        (2**20, 5, 4000, torch.bfloat16), (2**20, 3, 4000, torch.float16),
    ]:
        A = torch.randn((m, n) if n > 1 else (m,), generator=gen, dtype=torch.float64, device=dev).to(dtype)
        signs, rows = srht_draw(m, d)
        check_b8(A, signs, rows, d)
        _p(f"phase 2: B8 srht_apply{' / hadamard_transform' if m & (m - 1) == 0 else ''} {str(dtype)[6:]} "
           f"A{tuple(A.shape)} d={d}{' (rows with replacement)' if d > 1 << (m - 1).bit_length() else ''}, "
           f"passes {hadamard_passes(1 << (m - 1).bit_length())}: bitwise = plain on the card and on the CPU")
    # The result does not depend on the panel width (every output is the
    # same sequence of adds) nor on the order the items ran in: other
    # widths, an A whose first element is 8 bytes off 16-byte alignment,
    # and two calls, all bitwise equal.
    A = torch.randn((2**20, 37), generator=gen, dtype=torch.float64, device=dev)
    signs, rows = srht_draw(2**20, 4000)
    want, want_h = srht_apply(A, signs, rows, 4000), hadamard_transform(A)
    for w in (1, 2, 3, 8, 16, 37):
        if not torch.equal(_with_panels(w, lambda: srht_apply(A, signs, rows, 4000)), want):
            raise AssertionError(f"B8 at A(2^20, 37) with panels of {w} columns: not bitwise the default")
    flat = torch.empty(2**20 * 37 + 1, dtype=torch.float64, device=dev)
    A_off = flat[1:].view(2**20, 37)
    A_off.copy_(A)
    if A_off.data_ptr() % 16 != 8:
        raise AssertionError("the unaligned B8 operand is aligned")
    check_b8(A_off, signs, rows, 4000)
    if not (torch.equal(srht_apply(A_off, signs, rows, 4000), want)
            and torch.equal(srht_apply(A, signs, rows, 4000), want)
            and torch.equal(hadamard_transform(A_off), want_h)):
        raise AssertionError("B8: two calls, or an unaligned A, gave other bits")
    _p("phase 2: B8 at A(2^20, 37) f64: srht_apply with panels of 1, 2, 3, 8, 16 and 37 columns (37: one "
       "panel, ordinary launches), an A 8 bytes off 16-byte alignment, and two calls of each wrapper: "
       "bitwise the same")
    del flat, A_off, want, want_h
    # A row index outside [0, m_pad) is not checked on the host on the card
    # (a round trip per call): the last pass writes NaN into that row
    # instead.  One pass (m = 1024) and two (m = 2^20, over several panels).
    for m_bad, n_bad in ((1024, 5), (2**20, 21)):
        A = torch.randn((m_bad, n_bad), generator=gen, dtype=torch.float64, device=dev)
        signs, rows = srht_draw(m_bad, 8)
        bad = rows.clone()
        bad[3], bad[5] = m_bad, -1
        out, good = srht_apply(A, signs, bad, 8), srht_apply(A, signs, rows, 8)
        keep = torch.ones(8, dtype=torch.bool, device=dev)
        keep[[3, 5]] = False
        if not (bool(torch.isnan(out[~keep]).all()) and torch.equal(out[keep], good[keep])):
            raise AssertionError("B8 with rows out of range: expected NaN rows there and the rest unchanged")
    _p("phase 2: B8 srht_apply with two rows out of [0, m_pad), at m = 1024 and 2^20: NaN rows there, "
       "the rest bitwise unchanged")
    del bad, good, keep
    errs["countsketch_coo_apply"] = _coo_edges(torch, dev, gen)
    _p(f"phase 2: kernels {json.dumps({f.__name__: {'launches': f.launches, 'match': True} for f in KERNELS})}")
    del A, S, B, G, B_ref, S_k, G_k, out, B5_eye, eye64, e5, b0, b1, card0, card1
    del h, s, B_cpu, cpu, card, hk, sk, vu, signs, rows
    torch.cuda.empty_cache()

    # ---- phase 3: the main path at the paper's size -----------------------
    prob, t_gen = _sync_time(torch, lambda: generate_problem(
        gen, M_MAIN, N_MAIN, cond=COND, beta=BETA, device=dev))
    A, b, x_true = prob.A, prob.b, prob.x_true
    _p(f"phase 3: generate_problem(m=2^20, n=1000, cond=1e10, beta=1e-10, haar, f64) "
       f"{t_gen:.2f} s, peak {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    paths = {}

    def run_path(name, fn):
        torch.cuda.synchronize()
        reset_launches()
        out = fn()
        torch.cuda.synchronize()
        paths[name] = {f.__name__: f.launches for f in KERNELS}
        return out

    res = run_path("main", lambda: lstsq(A, b, gen, method="saa"))
    x_qr, t_qr = _sync_time(torch, lambda: qr_solve(A, b))
    e_saa, e_qr = _rel(res.x, x_true), _rel(x_qr, x_true)
    _p(f"phase 3: lstsq(method='saa'): itn {int(res.itn)} istop {int(res.istop)} "
       f"used_fallback {bool(res.used_fallback)} rel.err {e_saa:.3e}; qr_solve rel.err {e_qr:.3e}; "
       f"launches {paths['main']}")
    if not (e_saa < 1e-5 and e_saa <= 100 * max(e_qr, 1e-12)):
        raise AssertionError(f"main path: rel.err {e_saa} (qr_solve {e_qr})")
    if paths["main"]["countsketch_apply"] < 2:
        raise AssertionError("main path did not launch B1 for A and for b")
    _, t_saa = _sync_time(torch, lambda: lstsq(A, b, gen, method="saa"))
    _, t_qr = _sync_time(torch, lambda: qr_solve(A, b))
    _p(f"phase 3: warm wall time: saa {t_saa:.3f} s, qr_solve {t_qr:.3f} s")
    rl, t_lsqr = _sync_time(torch, lambda: lsqr_dense(A, b, iter_lim=2 * N_MAIN))
    _p(f"phase 3: lsqr_dense(iter_lim=2n) baseline: itn {int(rl.itn)} istop {int(rl.istop)} "
       f"rel.err {_rel(rl.x, x_true):.3e} wall {t_lsqr:.2f} s")
    del rl, x_qr

    # ---- phase 4: the fused factor route ----------------------------------
    n_fused = min(N_MAIN, MAX_FUSED_COLS)
    A_f = A if n_fused == N_MAIN else A[:, :n_fused].contiguous()
    res_f = run_path("fused", lambda: lstsq(A_f, b, gen, method="saa", fused=True))
    x_f_qr = x_true if n_fused == N_MAIN else qr_solve(A_f, b)
    e_f = _rel(res_f.x, x_f_qr)
    _p(f"phase 4: lstsq(method='saa', fused=True) n={n_fused}: itn {int(res_f.itn)} istop "
       f"{int(res_f.istop)} used_fallback {bool(res_f.used_fallback)} rel.err {e_f:.3e}; "
       f"launches {paths['fused']}")
    if not (e_f < 1e-5 and e_f <= 100 * max(e_qr, 1e-12)):
        raise AssertionError(f"fused route: rel.err {e_f}")
    if paths["fused"]["countsketch_gram"] < 1:
        raise AssertionError("fused route did not launch B3")
    _, t_fused = _sync_time(torch, lambda: lstsq(A_f, b, gen, method="saa", fused=True))
    _p(f"phase 4: warm wall time: saa fused {t_fused:.3f} s")

    # ---- phase 7a: kernel times at the main path's shapes -----------------
    d = 4 * N_MAIN  # default_sketch_size(1000, 2^20)
    h = torch.randint(0, d, (M_MAIN,), generator=gen, dtype=torch.int32, device=dev)
    s = (torch.randint(0, 2, (M_MAIN,), generator=gen, device=dev) * 2 - 1).to(torch.float64)
    csr = countsketch_csr(h, s, d, torch.float64)
    SA = countsketch_apply(A, h, s, d, csr=csr)
    SA_cpu = countsketch_ref(A.cpu(), h.cpu(), s.cpu(), d)
    if not torch.equal(SA.cpu(), SA_cpu):
        raise AssertionError("B1 at the main path's shape: not bitwise equal to the CPU plain version")
    del SA_cpu
    Sb = countsketch_apply(b, h, s, d, csr=csr)
    if not torch.equal(Sb.cpu(), countsketch_ref(b.cpu(), h.cpu(), s.cpu(), d)):
        raise AssertionError("B1 on b at the main path's shape: not bitwise equal to the CPU plain version")
    err1 = float((SA - countsketch_ref(A, h, s, d)).abs().max())
    _p(f"phase 7: B1 at A(2^20, 1000) d=4000 and b(2^20,): bitwise = CPU plain; max|Δ| vs card plain {err1:.3e}")
    A_signed = s[:, None] * A
    out_lib = torch.zeros(d, N_MAIN, dtype=torch.float64, device=dev)
    esz = 8
    t1 = dict(
        ms=_event_ms(torch, lambda: countsketch_apply(A, h, s, d, csr=csr)),
        plain_ms=_event_ms(torch, lambda: countsketch_ref(A, h, s, d)),
        library_ms=_event_ms(torch, lambda: out_lib.zero_().index_add_(0, h, A_signed)),
    )
    del A_signed, out_lib
    bytes1 = M_MAIN * N_MAIN * esz + M_MAIN * (4 + esz) + d * N_MAIN * esz
    t1["bound_ms"], t1["bound_by"] = _bound(M_MAIN * N_MAIN, bytes1)
    t1["vec_ms"] = _event_ms(torch, lambda: countsketch_apply(b, h, s, d, csr=csr))
    # cuSPARSE's SpMM on S as a (d, m) CSR matrix, built once here: a second
    # one-call yardstick (timed only; no path of the port calls it)
    S_csr = _sparse_s(torch, h, s, d, M_MAIN)
    t1["spmm_ms"], t1["spmm_err"] = _spmm(torch, S_csr, A, SA)
    del S_csr

    # ---- phase 7b: the tsqr CholeskyQR path (B2) on the main path's sketch
    Q2, R2 = run_path("tsqr_cholqr", lambda: tsqr(SA, mode="cholqr"))
    orth = float(torch.linalg.norm(Q2.T @ Q2 - torch.eye(N_MAIN, dtype=Q2.dtype, device=dev)))
    recon = float(torch.linalg.norm(Q2 @ R2 - SA) / torch.linalg.norm(SA))
    _p(f"phase 7: tsqr(SA, mode='cholqr') on B(4000, 1000): ‖QᵀQ−I‖ {orth:.2e} ‖QR−B‖/‖B‖ "
       f"{recon:.2e}; launches {paths['tsqr_cholqr']}")
    if not (orth < 1e-10 and recon < 1e-12 and paths["tsqr_cholqr"]["panel_gram"] >= 1):
        raise AssertionError("tsqr cholqr path failed")
    G_ref = panel_gram_ref(SA)
    err2 = _check_gram(torch, panel_gram(SA), G_ref, SA, "B2 on the main sketch SA(4000, 1000)")
    t2 = dict(
        ms=_event_ms(torch, lambda: panel_gram(SA)),
        plain_ms=_event_ms(torch, lambda: panel_gram_ref(SA)),
        library_ms=_event_ms(torch, lambda: SA.T @ SA),
    )
    ops2 = d * N_MAIN * (N_MAIN + 1)  # flops of the n(n+1)/2 distinct entries
    bytes2 = (d * N_MAIN + N_MAIN * N_MAIN) * esz
    t2["bound_ms"], t2["bound_by"] = _bound(ops2, bytes2)

    B3, G3 = countsketch_gram(A, h, s, d, csr=csr)
    if not torch.equal(B3, SA):
        raise AssertionError("B3 at the main path's shape: B differs from B1's output")
    err3 = _check_gram(torch, G3, G_ref, B3, "B3 at A(2^20, 1000) d=4000")
    _p(f"phase 7: B2 on SA and B3's G at A(2^20, 1000) d=4000: exactly symmetric, max|Δ| vs "
       f"plain Gram {err2:.3e} and {err3:.3e} (tol 2γ_d|B|ᵀ|B|)")
    del B3, G3
    t3 = dict(
        ms=_event_ms(torch, lambda: countsketch_gram(A, h, s, d, csr=csr)),
        plain_ms=_event_ms(torch, lambda: countsketch_gram_ref(A, h, s, d)),
        library_ms=None,
    )
    bytes3 = bytes1 + N_MAIN * N_MAIN * esz
    t3["bound_ms"], t3["bound_by"] = _bound(M_MAIN * N_MAIN + ops2, bytes3)
    _rates(t1, M_MAIN * N_MAIN)
    _rates(t2, ops2)
    _rates(t3, M_MAIN * N_MAIN + ops2)
    _p(f"phase 7: B1 {t1}; B2 {t2}; B3 {t3} (ms, TFLOP/s, share of the bound; f64, m=2^20, n=1000, "
       f"d=4000; card: {smi})")
    del SA, Sb, Q2, R2, G_ref, csr, h, s, res, res_f, A_f
    torch.cuda.empty_cache()

    # ---- phase 9: the SRHT and sparse sketches on the main problem --------
    walls9 = {"countsketch": t_saa}
    for name, kw, need in [
        ("srht", dict(sketch="srht"), {"srht_apply": 2}),
        ("srht_fused", dict(sketch="srht", fused=True), {"srht_apply": 2, "panel_gram": 1}),
        ("sparse_sign", dict(sketch="sparse_sign"), {"countsketch_apply": 2}),
        ("uniform_sparse", dict(sketch="uniform_sparse"), {"countsketch_apply": 2}),
    ]:
        res9 = run_path(name, lambda: lstsq(A, b, gen, method="saa", **kw))
        e9 = _rel(res9.x, x_true)
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        _, walls9[name] = _sync_time(torch, lambda: lstsq(A, b, gen, method="saa", **kw))
        peak9 = (torch.cuda.max_memory_allocated() - before) / 2**30
        _p(f"phase 9: lstsq(method='saa', {', '.join(f'{k}={v!r}' for k, v in kw.items())}) m=2^20: "
           f"itn {int(res9.itn)} istop {int(res9.istop)} used_fallback {bool(res9.used_fallback)} "
           f"rel.err {e9:.3e}; qr_solve rel.err {e_qr:.3e}; warm wall {walls9[name]:.4f} s; "
           f"peak device memory {peak9:.2f} GiB above its start; launches {paths[name]}")
        if not (e9 < 1e-5 and e9 <= 100 * max(e_qr, 1e-12)):
            raise AssertionError(f"{name} path: rel.err {e9} (qr_solve {e_qr})")
        if any(paths[name][k] < v for k, v in need.items()):
            raise AssertionError(f"{name} path did not launch its kernels: {paths[name]}")
    del res9
    _p(f"phase 9: warm wall time at m=2^20, n=1000 (s): {json.dumps(walls9)}")

    # B8 at the main path's shapes: A (2^20, 1000) and b, f64, d = 4000.
    # Bitwise its plain version on the card, and on the CPU (A's first 64
    # columns: the transform is column by column).
    d9 = 4 * N_MAIN
    s9, rows9 = srht_draw(M_MAIN, d9)
    check_b8(A, s9, rows9, d9, cpu_cols=64)
    check_b8(b, s9, rows9, d9)
    _p("phase 9: B8 srht_apply / hadamard_transform at A(2^20, 1000) and b(2^20,) d=4000: bitwise = plain "
       "on the card and on the CPU (A's first 64 columns there)")
    p_bits = M_MAIN.bit_length() - 1
    # The operator's cached plan (sign bits and gather list), as the solves
    # use it.  Peak device memory of one call beyond A and its (d, n)
    # output: the (m_pad, w) panel buffer.
    plan9 = SRHTSketch(signs=s9, rows=rows9, d=d9, m=M_MAIN, m_pad=M_MAIN).plan()
    w9 = hadamard_panel(esz)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    out9 = srht_apply(A, s9, rows9, d9, plan=plan9)
    torch.cuda.synchronize()
    extra_mb = (torch.cuda.max_memory_allocated() - before - out9.numel() * esz) / 1e6
    del out9
    if extra_mb >= 100:
        raise AssertionError(f"B8 srht_apply at A(2^20, 1000) took {extra_mb:.1f} MB of scratch")
    # bytes: the input read once, the output written once (plus signs and
    # rows); operations: p·m adds per column, the signs' products, the
    # divisions by √d
    t8 = dict(
        ms=_event_ms(torch, lambda: srht_apply(A, s9, rows9, d9, plan=plan9)),
        plain_ms=_event_ms(torch, lambda: srht_ref(A, s9, rows9, d9)),
        library_ms=None,
    )
    t8["bound_ms"], t8["bound_by"] = _bound(
        (p_bits + 1) * M_MAIN * N_MAIN + d9 * N_MAIN, (M_MAIN * N_MAIN + M_MAIN + d9 + d9 * N_MAIN) * esz)
    t8["panel_width"], t8["scratch_mb"] = w9, extra_mb
    # the other panel widths, beside the plan's (the same bits); w = n is
    # one panel of all columns through an (m_pad, n) buffer in two launches:
    # the design's first step, sampled rows and sign bits alone
    for w in (2, 4, 8, 16, N_MAIN):
        t8[f"w{w}_ms"] = _with_panels(
            w, lambda: _event_ms(torch, lambda: srht_apply(A, s9, rows9, d9, plan=plan9)))
    # What the plan's 250 launches cost the host and the gaps between them:
    # the same launches replayed from one CUDA graph (the same bits)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out_g = srht_apply(A, s9, rows9, d9, plan=plan9)
    graph.replay()
    if not torch.equal(out_g, srht_apply(A, s9, rows9, d9, plan=plan9)):
        raise AssertionError("B8 srht_apply replayed from a CUDA graph: other bits")
    t8["graph_ms"] = _event_ms(torch, graph.replay)
    del graph, out_g
    t8["vec_ms"] = _event_ms(torch, lambda: srht_apply(b, s9, rows9, d9, plan=plan9))
    t8["vec_plain_ms"] = _event_ms(torch, lambda: srht_ref(b, s9, rows9, d9))
    t8["vec_bound_ms"], _ = _bound((p_bits + 1) * M_MAIN + d9, (2 * M_MAIN + 2 * d9) * esz)
    tH = dict(
        ms=_event_ms(torch, lambda: hadamard_transform(A)),
        plain_ms=_event_ms(torch, lambda: hadamard_ref(A)),
        library_ms=None,
    )
    tH["bound_ms"], tH["bound_by"] = _bound(p_bits * M_MAIN * N_MAIN, 2 * M_MAIN * N_MAIN * esz)
    _p(f"phase 9: B8 srht_apply at A(2^20, 1000) f64 d=4000: {t8['ms']:.3f} ms against its "
       f"{t8['bound_ms']:.3f} ms bound, panels of {w9} columns (the plan: 64-byte row segments of A), "
       f"peak scratch {extra_mb:.1f} MB beyond A and its output; on b {t8['vec_ms']:.4f} ms against "
       f"{t8['vec_bound_ms']:.4f} (card: {smi})")
    _p(f"phase 9: B8 srht_apply {t8}; hadamard_transform {tH} (ms; f64, m=2^20, n=1000, d=4000; "
       f"wN_ms: panels of N columns, w{N_MAIN}_ms one panel, graph_ms the plan's launches replayed "
       f"from a CUDA graph; no single PyTorch call computes a "
       f"Walsh-Hadamard transform; "
       f"card: {smi})")
    del s9, rows9, plan9

    # B1 on the sparse sketches' CSRs at the same shape (the sparse kinds
    # have no kernel row of their own): the sparse-sign sketch's 8m ±1
    # entries and the uniform-sparse sketch's uniform weights.  Held within
    # 2·γ_k·|S||A| of the plain version on the card, and bitwise the plain
    # version on the CPU on A's first 64 columns (B1 sums column by column).
    t_b1 = {}
    op_ss = SparseSignSketch.sample(gen, d9, M_MAIN, device=dev)
    op_us = UniformSparseSketch.sample(gen, d9, M_MAIN, device=dev)
    for sparse_kind, op9, w9 in [("sparse_sign", op_ss, op_ss.signs), ("uniform_sparse", op_us, op_us.values)]:
        csr9 = op9.csr(torch.float64)
        out = countsketch_apply(A, op9.buckets, w9, d9, csr=csr9)
        err = (out - countsketch_ref(A, op9.buckets, w9, d9)).abs()
        k = int(torch.bincount(op9.buckets.long().flatten(), minlength=d9).max())
        tol = 2 * _gamma(torch, k, out.dtype) * countsketch_ref(A.abs(), op9.buckets, w9.abs(), d9)
        if not bool((err <= tol).all()):
            raise AssertionError(f"B1 on the {sparse_kind} CSR at A(2^20, 1000): off the card's plain "
                                 f"version by {float(err.max())}")
        if not torch.equal(out[:, :64].cpu(), countsketch_ref(A[:, :64].cpu(), op9.buckets.cpu(), w9.cpu(), d9)):
            raise AssertionError(f"B1 on the {sparse_kind} CSR at A(2^20, 1000): not bitwise the CPU plain "
                                 f"version on A's first 64 columns")
        e_b1 = float(err.max())
        errs["countsketch_apply"] = max(errs["countsketch_apply"], e_b1)
        del out, err, tol
        t_b1[sparse_kind] = dict(
            ms=_event_ms(torch, lambda: countsketch_apply(A, op9.buckets, w9, d9, csr=csr9)),
            plain_ms=_event_ms(torch, lambda: countsketch_ref(A, op9.buckets, w9, d9)),
        )
        S_csr = _sparse_s(torch, op9.buckets, w9, d9, M_MAIN)
        out = countsketch_apply(A, op9.buckets, w9, d9, csr=csr9)
        t_b1[sparse_kind]["spmm_ms"], t_b1[sparse_kind]["spmm_err"] = _spmm(torch, S_csr, A, out)
        del S_csr, out
        _p(f"phase 9: B1 on the {sparse_kind} CSR ({op9.buckets.numel()} entries) at A(2^20, 1000) d=4000: "
           f"max|Δ| vs card plain {e_b1:.3e} (tol 2γ_{k}|S||A|), bitwise = CPU plain "
           f"on 64 columns; {json.dumps(t_b1[sparse_kind])} (ms; spmm: torch.sparse.mm on S as a (d, m) "
           f"CSR, spmm_err its max|Δ| from B1; card: {smi})")
    del op_ss, op_us, op9, w9, csr9

    # hadamard_transform's own path: the SRHT's Sᵀ (as_dense_t), one
    # transform of the (m_pad, d) row selector; its entries are ±1/√d
    # exactly, so it is bitwise the transpose of the plain S.
    op_t = SRHTSketch.sample(gen, 300, 3000, device=dev)
    St = run_path("srht_as_dense_t", op_t.as_dense_t)
    if not torch.equal(St, op_t.as_dense().T) or paths["srht_as_dense_t"]["hadamard_transform"] < 1:
        raise AssertionError("SRHTSketch.as_dense_t is not the transpose of as_dense, or skipped B8")
    _p(f"phase 9: SRHTSketch(d=300, m=3000).as_dense_t() = as_dense().T bitwise; "
       f"launches {paths['srht_as_dense_t']}")

    # ---- phase 10: the forward-stable solvers and the certified tier -----
    # (its mixed run comes with phase 6's problem)
    phase10 = _Phase10(torch, dev, gen, smi, run_path, paths)
    phase10.main_problem(A, b, x_true, e_qr)

    # ---- phase 11: the span tracer and the SketchedSolver session --------
    # (its m = 2^16 sessions come after phase 10's m = 2^16 runs)
    phase11 = _Phase11(torch, dev, gen, smi, run_path, paths, t_saa)
    phase11.tracing(A, b, x_true, e_qr)
    phase11.main_problem(A, b, x_true, e_qr)

    # ---- phase 12: ridge and matrix-free inputs on the main problem, then
    # the sparse problem once the main one is freed
    phase12 = _Phase12(torch, dev, gen, smi, run_path, paths, phase11.stats_seen)
    phase12.ridge(A, b)
    phase12.matrix_free(A, b, x_true, e_qr)
    del op_t, St, prob, A, b, x_true
    torch.cuda.empty_cache()
    phase12.sparse()
    torch.cuda.empty_cache()
    phase10.after_main()
    phase11.dense()
    phase11.metrics()

    # ---- phase 5: the perturbation fallback -------------------------------
    p5 = generate_problem(gen, 2**18, N_MAIN, cond=COND, beta=BETA, device=dev)
    res5 = run_path("fallback", lambda: saa_sas(p5.A, p5.b, gen, iter_lim=1))
    e5 = _rel(res5.x, p5.x_true)
    _p(f"phase 5: saa_sas(iter_lim=1) m=2^18: used_fallback {bool(res5.used_fallback)} itn "
       f"{int(res5.itn)} rel.err vs truth {e5:.3e}; launches {paths['fallback']}")
    if not bool(res5.used_fallback) or not math.isfinite(e5) or e5 >= 1.0:
        raise AssertionError("fallback branch did not run or returned a non-finite answer")
    del p5, res5
    torch.cuda.empty_cache()

    # ---- phase 6: mixed precision (bf16 sketch) ---------------------------
    p6 = generate_problem(gen, M_MAIN, N_MAIN, cond=1e4, beta=BETA, device=dev)
    res6 = run_path("mixed", lambda: lstsq(p6.A, p6.b, gen, method="saa", precision="mixed"))
    e6 = _rel(res6.x, p6.x_true)
    _p(f"phase 6: lstsq(method='saa', precision='mixed') cond=1e4: itn {int(res6.itn)} istop "
       f"{int(res6.istop)} used_fallback {bool(res6.used_fallback)} rel.err {e6:.3e}; "
       f"launches {paths['mixed']}")
    if not e6 < 1e-5 or paths["mixed"]["countsketch_apply"] < 2:
        raise AssertionError("mixed-precision path failed")
    if bool(res6.used_fallback) or int(res6.istop) == 7:
        raise AssertionError("mixed-precision cell hit its iteration limit or took the fallback; "
                             "it no longer measures the plain Algorithm 1 path")
    _, op6 = SketchedFactor.build(p6.A, gen, precision="mixed")
    if torch.bfloat16 not in op6._csr:
        raise AssertionError("mixed precision did not feed bf16 to B1")
    _p(f"phase 6: B1 ran on bf16 input; peak device memory "
       f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    e_qr6 = _rel(qr_solve(p6.A, p6.b), p6.x_true)
    phase10.mixed(p6, e_qr6)

    # phase 9's mixed SRHT solve, on this κ = 1e4 problem: B8 on bf16 A.
    # iter_lim=200 for the reason given at phase 8's mixed run.
    kw_m = dict(method="saa", sketch="srht", precision="mixed", iter_lim=200)
    res_m = run_path("srht_mixed", lambda: lstsq(p6.A, p6.b, gen, **kw_m))
    e_m = _rel(res_m.x, p6.x_true)
    _, walls9["srht_mixed"] = _sync_time(torch, lambda: lstsq(p6.A, p6.b, gen, **kw_m))
    _p(f"phase 9: lstsq(sketch='srht', precision='mixed', iter_lim=200) cond=1e4 m=2^20: itn {int(res_m.itn)} "
       f"istop {int(res_m.istop)} used_fallback {bool(res_m.used_fallback)} rel.err {e_m:.3e}; qr_solve "
       f"rel.err {e_qr6:.3e}; warm wall {walls9['srht_mixed']:.4f} s; launches {paths['srht_mixed']}")
    if not e_m < 1e-5 or paths["srht_mixed"]["srht_apply"] < 2:
        raise AssertionError("mixed SRHT path failed")
    if bool(res_m.used_fallback) or int(res_m.istop) == 7:
        raise AssertionError("mixed SRHT run hit its iteration limit or took the fallback")
    _, op_m, B_m = SketchedFactor.build_full(p6.A, gen, sketch="srht", precision="mixed")
    A_bf = p6.A.to(torch.bfloat16)
    if not torch.equal(B_m, srht_apply(A_bf, op_m.signs, op_m.rows, op_m.d).to(B_m.dtype)):
        raise AssertionError("mixed precision did not feed bf16 to B8")
    check_b8(A_bf, op_m.signs, op_m.rows, op_m.d, cpu_cols=64)
    _p("phase 9: B8 ran on bf16 input (B bitwise B8 on bf16 A, f32 out); B8 on that bf16 A(2^20, 1000) "
       "bitwise = plain on the card and on the CPU (A's first 64 columns there)")
    del A_bf
    del p6, res6, op6, res_m, op_m, B_m
    torch.cuda.empty_cache()

    # ---- phase 8: the dense-sketch paths at m = 2^16 ----------------------
    p8 = generate_problem(gen, M_DENSE, N_MAIN, cond=COND, beta=BETA, device=dev)
    A8, b8 = p8.A, p8.b
    e_qr8 = _rel(qr_solve(A8, b8), p8.x_true)
    walls = {}
    for name, kw, kernel, unfused in [
        ("gaussian", dict(sketch="gaussian"), "fused_gaussian_sketch", None),
        ("gaussian_fused", dict(sketch="gaussian", fused=True), "gaussian_gram", "fused_gaussian_sketch"),
        ("uniform_dense", dict(sketch="uniform_dense"), "sketch_matmul", None),
        ("uniform_dense_fused", dict(sketch="uniform_dense", fused=True), "matmul_gram", "sketch_matmul"),
    ]:
        res8 = run_path(name, lambda: lstsq(A8, b8, gen, method="saa", **kw))
        e8 = _rel(res8.x, p8.x_true)
        _p(f"phase 8: lstsq(method='saa', {', '.join(f'{k}={v!r}' for k, v in kw.items())}) m=2^16: "
           f"itn {int(res8.itn)} istop {int(res8.istop)} used_fallback {bool(res8.used_fallback)} "
           f"rel.err {e8:.3e}; qr_solve rel.err {e_qr8:.3e}; launches {paths[name]}")
        if not (e8 < 1e-5 and e8 <= 100 * max(e_qr8, 1e-12)):
            raise AssertionError(f"{name} path: rel.err {e8} (qr_solve {e_qr8})")
        # the unfused route sketches A and b with one kernel; the fused one
        # sketches A with the fused kernel and b with the unfused kernel
        if paths[name][kernel] < (1 if unfused else 2) or (unfused and paths[name][unfused] < 1):
            raise AssertionError(f"{name} path did not launch its kernels: {paths[name]}")
        _, walls[name] = _sync_time(torch, lambda: lstsq(A8, b8, gen, method="saa", **kw))
    lstsq(A8, b8, gen, method="saa")  # warm-up of the CountSketch solve at this size
    _, walls["countsketch"] = _sync_time(torch, lambda: lstsq(A8, b8, gen, method="saa"))
    _p(f"phase 8: warm wall time at m=2^16, n=1000 (s): {json.dumps(walls)}")
    del res8

    # The kernels at the dense paths' shapes: A (2^16, 1000) f64, d = 4000.
    # B4 is held to its plain version on the card, whose S may differ from
    # the kernel's by ULP_BOUND f32 ulps and one more for the scale's
    # rounding; B6 to the plain product of the same S.
    d8 = 4000  # default_sketch_size(1000, 2^16)
    key8 = key_to_u32(gen)
    S_g = gaussian_matrix_ref(*key8, d8, M_DENSE, device=dev).mul_(default_scale(d8)).double()
    S_u = torch.empty((d8, M_DENSE), dtype=torch.float64, device=dev).uniform_(
        -(3 / d8) ** 0.5, (3 / d8) ** 0.5, generator=gen)
    ab8 = torch.cat([A8, b8[:, None]], dim=1).abs()
    slack = (ULP_BOUND + 1) * 2.0**-23
    for name, out, plain, S, rel in [
        ("fused_gaussian_sketch", fused_gaussian_sketch(A8, key8, d8), fused_gaussian_ref(A8, key8, d8), S_g, slack),
        ("fused_gaussian_sketch", fused_gaussian_sketch(b8, key8, d8)[:, None],
         fused_gaussian_ref(b8, key8, d8)[:, None], S_g, slack),
        ("sketch_matmul", sketch_matmul(S_u, A8), sketch_matmul_ref(S_u, A8), S_u, 0.0),
        ("sketch_matmul", sketch_matmul(S_u, b8)[:, None], sketch_matmul_ref(S_u, b8)[:, None], S_u, 0.0),
    ]:
        cols = slice(0, N_MAIN) if out.shape[1] == N_MAIN else slice(N_MAIN, N_MAIN + 1)
        err = (out - plain).abs()
        tol = (2 * _gamma(torch, M_DENSE, torch.float64) + rel) * (S.abs() @ ab8[:, cols])
        if not bool((err <= tol).all()):
            raise AssertionError(f"{name} at the dense paths' shape {tuple(out.shape)}: max|Δ| {float(err.max())}")
        errs[name] = max(errs[name], float(err.max()))
    del ab8, out, plain, err, tol
    B4 = fused_gaussian_sketch(A8, key8, d8)
    B6 = sketch_matmul(S_u, A8)
    for name, (B, G), B_ref in [
        ("gaussian_gram", gaussian_gram(A8, key8, d8), B4),
        ("matmul_gram", matmul_gram(S_u, A8), B6),
    ]:
        if not torch.equal(B, B_ref):
            raise AssertionError(f"{name} at A(2^16, 1000) d=4000: B differs from the unfused kernel's")
        errs[name] = max(errs[name], _check_gram(torch, G, panel_gram_ref(B), B, f"{name} at A(2^16, 1000)"))
    del B4, B6, B, G, B_ref
    _p(f"phase 8: B4–B7 at A(2^16, 1000) d=4000 against their plain versions: max|Δ| "
       f"{json.dumps({k: errs[k] for k in ('fused_gaussian_sketch', 'gaussian_gram', 'sketch_matmul', 'matmul_gram')})}"
       f"; B5/B7's B bitwise = B4/B6's")

    ops_p = 2 * d8 * M_DENSE * N_MAIN  # the product S·A
    ops_g = d8 * N_MAIN * (N_MAIN + 1)  # the n(n+1)/2 distinct Gram entries
    bytes_a, bytes_s, bytes_b, bytes_g = (x * 8 for x in (M_DENSE * N_MAIN, d8 * M_DENSE, d8 * N_MAIN,
                                                          N_MAIN * N_MAIN))
    t_dense = {}
    for name, fn, plain, library, ops, nbytes in [
        ("fused_gaussian_sketch", lambda: fused_gaussian_sketch(A8, key8, d8),
         lambda: fused_gaussian_ref(A8, key8, d8), lambda: S_g @ A8, ops_p, bytes_a + bytes_b),
        ("gaussian_gram", lambda: gaussian_gram(A8, key8, d8), lambda: gaussian_gram_ref(A8, key8, d8),
         None, ops_p + ops_g, bytes_a + bytes_b + bytes_g),
        ("sketch_matmul", lambda: sketch_matmul(S_u, A8), lambda: sketch_matmul_ref(S_u, A8),
         lambda: S_u @ A8, ops_p, bytes_s + bytes_a + bytes_b),
        ("matmul_gram", lambda: matmul_gram(S_u, A8), lambda: matmul_gram_ref(S_u, A8),
         None, ops_p + ops_g, bytes_s + bytes_a + bytes_b + bytes_g),
    ]:
        bound_ms, bound_by = _bound(ops, nbytes)
        t_dense[name] = _rates(dict(
            ms=_event_ms(torch, fn), plain_ms=_event_ms(torch, plain),
            library_ms=None if library is None else _event_ms(torch, library),
            bound_ms=bound_ms, bound_by=bound_by,
        ), ops)
    t_dense["fused_gaussian_sketch"]["vec_ms"] = _event_ms(torch, lambda: fused_gaussian_sketch(b8, key8, d8))
    # B4's engine with clusters of 1 (each block generates its whole S tile)
    # beside the planned clusters: the same sums in the same order, so
    # bitwise the same B where the plan keeps one slab.
    t4 = t_dense["fused_gaussian_sketch"]
    t4["cluster"], _ = gen_grid(N_MAIN)
    t4["split_parts"] = gaussian_split(torch.float64, d8, M_DENSE, N_MAIN, sm_count(dev)).parts
    if t4["split_parts"] == 1 and not torch.equal(gaussian_engine(A8, key8, d8, 1),
                                                  fused_gaussian_sketch(A8, key8, d8)):
        raise AssertionError("B4's engine with clusters of 1 differs from the planned clusters")
    t4["cluster1_ms"] = _event_ms(torch, lambda: gaussian_engine(A8, key8, d8, 1))
    t4["cluster1_tflops"] = ops_p / t4["cluster1_ms"] / 1e9
    t_dense["sketch_matmul"]["vec_ms"] = _event_ms(torch, lambda: sketch_matmul(S_u, b8))
    _p(f"phase 8: kernel times (ms, TFLOP/s, share of the bound; f64, m=2^16, n=1000, d=4000; "
       f"B4's library_ms is S @ A on an S "
       f"generated beforehand, the product half only; card: {smi}): {json.dumps(t_dense)}")
    del S_g, S_u, p8, A8, b8
    torch.cuda.empty_cache()

    # The mixed uniform-dense run: B6 on bf16 A, at κ = 1e4.  The bf16
    # rounding of A (‖E‖ ≈ 1.5e-4 against σ_min = 1e-4) leaves Y with κ of a
    # few units, so LSQR needs close to 100 iterations to its step floor
    # (PERF.md; phase 6 runs 98 at m = 2^20).  iter_lim=200 keeps the run on
    # plain Algorithm 1 instead of at the edge of the default 100, and the
    # checks below still fail on any fallback or iteration-limit stop.
    p9 = generate_problem(gen, M_DENSE, N_MAIN, cond=1e4, beta=BETA, device=dev)
    kw9 = dict(method="saa", sketch="uniform_dense", precision="mixed", iter_lim=200)
    res9 = run_path("uniform_dense_mixed", lambda: lstsq(p9.A, p9.b, gen, **kw9))
    e9 = _rel(res9.x, p9.x_true)
    _p(f"phase 8: lstsq(sketch='uniform_dense', precision='mixed') cond=1e4 m=2^16: itn {int(res9.itn)} "
       f"istop {int(res9.istop)} used_fallback {bool(res9.used_fallback)} rel.err {e9:.3e}; "
       f"launches {paths['uniform_dense_mixed']}")
    if not e9 < 1e-5 or paths["uniform_dense_mixed"]["sketch_matmul"] < 2:
        raise AssertionError("mixed uniform-dense path failed")
    if bool(res9.used_fallback) or int(res9.istop) == 7:
        raise AssertionError("mixed uniform-dense run hit its iteration limit or took the fallback")
    _, walls["uniform_dense_mixed"] = _sync_time(torch, lambda: lstsq(p9.A, p9.b, gen, **kw9))
    _, op9, B9 = SketchedFactor.build_full(p9.A, gen, sketch="uniform_dense", precision="mixed")
    if not torch.equal(B9, sketch_matmul(op9.S, p9.A.to(torch.bfloat16)).to(B9.dtype)):
        raise AssertionError("mixed precision did not feed bf16 to B6")
    _p(f"phase 8: B6 ran on bf16 input (B bitwise B6 on bf16 A); warm wall {walls['uniform_dense_mixed']:.3f} s")
    del p9, res9, op9, B9
    torch.cuda.empty_cache()

    # Every kernel of KERNELS: its source, the TPU kernel it replaces, the
    # path whose launches it reports, and its times.
    table = {
        "countsketch_apply": ("countsketch.cuh", "countsketch/kernel.py:27", "main", t1, err1),
        "panel_gram": ("gram.cuh", "tsqr/kernel.py:51", "tsqr_cholqr", t2, err2),
        "countsketch_gram": ("countsketch_gram.cu", "tsqr/kernel.py:68", "fused", t3, err3),
        "fused_gaussian_sketch": ("dense_sketch.cuh", "sketch_matmul/kernel.py:40", "gaussian",
                                  t_dense["fused_gaussian_sketch"], 0.0),
        "gaussian_gram": ("gaussian_gram.cu", "tsqr/kernel.py:131", "gaussian_fused",
                          t_dense["gaussian_gram"], 0.0),
        "sketch_matmul": ("dense_sketch.cuh", "sketch_matmul/kernel.py:27", "uniform_dense",
                          t_dense["sketch_matmul"], 0.0),
        "matmul_gram": ("matmul_gram.cu", "tsqr/kernel.py:101", "uniform_dense_fused",
                        t_dense["matmul_gram"], 0.0),
        "hadamard_transform": ("hadamard.cuh", "srht/kernel.py:25", "srht_as_dense_t", tH, 0.0),
        "srht_apply": ("hadamard.cuh", "srht/kernel.py:25", "srht", t8, 0.0),
        # no TPU kernel: the counterpart of the reference's jnp scatter
        "countsketch_coo_apply": ("countsketch.cuh", "src/repro/core/sketch.py:514", "sparse_default",
                                  phase12.t_coo, phase12.err_coo),
    }
    rows = []
    for f in KERNELS:
        name = f.__name__
        src, replaces, path, t, err = table[name]
        src = f"src/repro_torch/csrc/{src}"
        if not replaces.startswith("src/"):
            replaces = f"src/repro/kernels/{replaces}"
        launches = paths[path][name]
        if launches < 1:
            raise AssertionError(f"{name} was not launched on the {path} path")
        rows.append(dict(
            name=name, route="cuda", source=src, replaces=replaces, launches=launches,
            max_abs_err=max(err, errs[name]), ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=t["library_ms"],
        ))
    _p(f"paths (launches per path) {json.dumps(paths)}")
    _p(smi)
    _p(json.dumps({"kernels": rows}))
    _p(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


class _Phase10:
    """Phase 10: the forward-stable solvers and the certified tier, each run
    gated by the bounds of the reference's own tests (tests/test_iterative.py,
    test_sap.py, test_certify.py).  ``run_path(name, fn)`` runs ``fn`` with
    every launch count set to 0 just before and stores the counts in
    ``paths[name]`` just after."""

    def __init__(self, torch, dev, gen, smi, run_path, paths):
        self.torch, self.dev, self.gen, self.smi = torch, dev, gen, smi
        self.run_path, self.paths = run_path, paths
        self.walls = {}
        self.steptol = 32 * torch.finfo(torch.float64).eps

    def run(self, name, fn, x_ref, e_ref, first=None):
        """One counted run (inside the context ``first``, if given), then the
        median warm wall of 3; prints and returns the counted run's result
        and its error against ``x_ref``."""
        torch = self.torch
        with first or contextlib.nullcontext():
            res = self.run_path(name, fn)
        e = _rel(res.x, x_ref)
        self.walls[name] = sorted(_sync_time(torch, fn)[1] for _ in range(3))[1]
        cert, more = res.certificate, ""
        if cert is not None:
            more = (f"; certificate passed {bool(cert.passed)} rel_error_bound {float(cert.rel_error_bound):.3e} "
                    f"error_bound {float(cert.error_bound):.3e} cond_R {float(cert.cond_R):.3e} distortion "
                    f"{float(cert.distortion):.3f} sketch_rows {cert.sketch_rows} escalations "
                    f"{cert.escalations} precision {cert.precision}")
        _p(f"phase 10: {name}: method {res.method} itn {res.itn.tolist()} istop {res.istop.tolist()} "
           f"rel.err {e:.3e}; qr_solve rel.err {e_ref:.3e}; median warm wall of 3 {self.walls[name]:.4f} s; "
           f"launches {self.paths[name]}{more} (card: {self.smi})")
        return res, e

    def main_problem(self, A, b, x_true, e_qr):
        """On the main problem: the default call (auto → iterative), FOSSILS
        (forced and through accuracy='high'), SAP, the certified ladder from
        the default sketch and from an n + 2 row one, the multi-RHS batch,
        and the loops' time per iteration."""
        from repro_torch.core import CountSketch, lstsq, qr_solve, select_method

        torch, gen = self.torch, self.gen
        m, n = A.shape
        paths = self.paths
        x_qr = qr_solve(A, b)
        good = lambda e, f: e < 1e-5 and e <= f * max(e_qr, 1e-12)  # noqa: E731

        res, e = self.run("default", lambda: lstsq(A, b, gen), x_true, e_qr)
        if not (res.method == "iterative" and good(e, 10)):
            raise AssertionError(f"lstsq default: method {res.method}, rel.err {e} (qr_solve {e_qr})")
        if paths["default"]["countsketch_apply"] < 2:
            raise AssertionError("the default call did not launch B1 for A and for b")
        for name, kw in [("fossils", dict(method="fossils")), ("high", dict(accuracy="high"))]:
            res, e = self.run(name, lambda: lstsq(A, b, gen, **kw), x_true, e_qr)
            if not (res.method == "fossils" == select_method(m, n, accuracy="high") and good(e, 10)):
                raise AssertionError(f"{name}: method {res.method}, rel.err {e} (qr_solve {e_qr})")
            # B1 on A, on b, and on each of the two refinement residuals
            if paths[name]["countsketch_apply"] < 4:
                raise AssertionError(f"{name} did not launch B1 on A, b and its residuals: {paths[name]}")
        res, e = self.run("sap", lambda: lstsq(A, b, gen, method="sap"), x_true, e_qr)
        if not (good(e, 100) and int(res.itn) < 40 and bool(res.converged)):
            raise AssertionError(f"sap: itn {int(res.itn)} rel.err {e} (qr_solve {e_qr})")
        res, e = self.run("certified", lambda: lstsq(A, b, gen, accuracy="certified"), x_true, e_qr)
        cert = res.certificate
        gap = float((res.x - x_qr).norm())
        _p(f"phase 10: certified: ‖x − x_qr‖ {gap:.3e} against 10 × error_bound {10 * float(cert.error_bound):.3e}")
        if not (bool(cert.passed) and gap <= 10 * float(cert.error_bound)
                and float(cert.rel_error_bound) < 1e-4 and float(cert.cond_R) > 1e9):
            raise AssertionError(f"certified: {cert}")

        # From an n + 2 row sketch the ladder must escalate, sketching A once
        # at the start and once per escalation (its fresh block), never again.
        counted = _Count2D(CountSketch)
        res, e = self.run("certified_n+2", lambda: lstsq(A, b, gen, accuracy="certified", sketch_size=n + 2),
                          x_true, e_qr, first=counted)
        cert = res.certificate
        _p(f"phase 10: certified_n+2: 2-D sketch applies {counted.shapes} (1 + escalations = {1 + cert.escalations})")
        if not (bool(cert.passed) and cert.escalations >= 1 and cert.sketch_rows > n + 2 and res.method != "saa"
                and len(counted.shapes) == 1 + cert.escalations and all(sh[0] == m for sh in counted.shapes)):
            raise AssertionError(f"certified from n + 2 rows: method {res.method}, {cert}, applies {counted.shapes}")
        del x_qr, res
        self.batch(A, b, x_true)
        self.loops(A, b)

    def batch(self, A, b, x_true):
        """The multi-RHS batch: b and 7 more right-hand sides made as
        generate_problem makes b (A·x_j plus a residual of norm β orthogonal
        to range(A)) under one S.  Each column must stop as its own solve: bitwise column
        0 of the block LSQR of 8 copies of it (the same product kernels),
        and, against the single solve on the same factor (matrix-vector
        products, which cuBLAS rounds otherwise than the (m, n)·(n, 8)
        ones), the same istop, itn within 2 and the whitened solution
        z = R x within 1e-10.  x = R⁻¹z itself moves by up to about
        κ(R)·1e-16 there; its gap is printed beside."""
        from repro_torch.core import SketchedFactor, default_sketch_size, saa_sas_batch, sample_sketch
        from repro_torch.core.lsqr import lsqr
        from repro_torch.core.saa import _solve_with_factor

        torch, gen = self.torch, self.gen
        m, n = A.shape
        k = 8
        X = torch.randn(n, k - 1, generator=gen, dtype=torch.float64, device=self.dev)
        X /= X.norm(dim=0)
        Qa, Ra = torch.linalg.qr(A)
        G = torch.randn(m, k - 1, generator=gen, dtype=torch.float64, device=self.dev)
        G -= Qa @ (Qa.T @ G)
        B = torch.cat([b[:, None], A @ X + BETA * G / G.norm(dim=0)], dim=1)
        X_true = torch.cat([x_true[:, None], X], dim=1)
        X_qr = torch.linalg.solve_triangular(Ra, Qa.T @ B, upper=True)
        del Qa, Ra, G
        op = sample_sketch("clarkson_woodruff", gen, default_sketch_size(n, m), m, device=self.dev)
        res, _ = self.run("batch_k8", lambda: saa_sas_batch(A, B, gen, sketch=op), X_true, _rel(X_qr, X_true))
        factor, _ = SketchedFactor.build(A, gen, sketch=op)
        Y = factor.materialize_whitened(A)
        C = op.apply(B)
        Z0 = factor.warm_start(C)

        def block_lsqr(Bk, Zk):
            return lsqr(lambda z: Y @ z, lambda u: Y.T @ u, Bk, x0=Zk, atol=0.0, btol=0.0, iter_lim=100,
                        steptol=self.steptol)

        block = block_lsqr(B, Z0)
        if not torch.equal(factor.precondition(block.x), res.x):
            raise AssertionError("saa_sas_batch is not the block LSQR on its factor")
        cols = []
        for j in range(k):
            copies = block_lsqr(B[:, j:j + 1].repeat(1, k), Z0[:, j:j + 1].repeat(1, k))
            exact = (torch.equal(copies.x[:, 0], block.x[:, j]) and int(copies.itn[0]) == int(block.itn[j])
                     and int(copies.istop[0]) == int(block.istop[j]))
            x1, single = _solve_with_factor(A, B[:, j], factor, C[:, j], materialize_y=True, atol=0.0, btol=0.0,
                                            iter_lim=100, steptol=self.steptol)
            z_gap = float((factor.R @ (res.x[:, j] - x1)).norm() / (factor.R @ x1).norm())
            e, e_qr = _rel(res.x[:, j], X_true[:, j]), _rel(X_qr[:, j], X_true[:, j])
            cols.append(dict(itn=int(res.itn[j]), istop=int(res.istop[j]), single_itn=int(single.itn),
                             single_istop=int(single.istop), freeze_bitwise=exact, z_gap=z_gap,
                             x_gap=_rel(res.x[:, j], x1), err=e, qr_err=e_qr))
            if not (exact and int(res.istop[j]) == int(single.istop) and abs(int(res.itn[j]) - int(single.itn)) <= 2
                    and z_gap <= 1e-10 and e < 1e-5 and e <= 100 * max(e_qr, 1e-12)):
                raise AssertionError(f"saa_sas_batch column {j}: {cols[-1]}")
        _p(f"phase 10: batch_k8 columns {json.dumps(cols)}")
        del Y, C, Z0, block, copies
        torch.cuda.empty_cache()

    def loops(self, A, b):
        """The loops alone, on one prebuilt factor: time per pair of
        products with A (a matvec and an rmatvec: one iteration) beside the
        bound of the pair's two reads of A at the HBM rate."""
        from repro_torch.core import SketchedFactor, damping_momentum, fossils_refine, heavy_ball_refine
        from repro_torch.core.iterative import default_inner_iter_lim
        from repro_torch.core.lsqr import lsqr

        torch, gen, steptol = self.torch, self.gen, self.steptol
        m, n = A.shape
        f, op = SketchedFactor.build(A, gen)
        x0 = f.sketch_and_solve(op.apply(b))
        alpha, beta = damping_momentum(op.d, n)
        loops = {}
        for name, fn, products in [
            # itn + 1 matvecs and rmatvecs
            ("heavy_ball_refine", lambda: heavy_ball_refine(A, b, f, x0, alpha, beta, steptol=steptol),
             lambda itn: 2 * itn + 2),
            # a pair per inner step, a residual matvec per refinement step,
            # a pair at the end
            ("fossils_refine", lambda: fossils_refine(A, b, f, op, x0, alpha, beta,
                                                      inner_iter_lim=default_inner_iter_lim(beta),
                                                      steptol=steptol), lambda itn: 2 * itn + 4),
            # SAP's LSQR in operator form: a pair per iteration, one to start
            ("sap_lsqr", lambda: lsqr(lambda z: f.whiten_mv(A, z), lambda u: f.whiten_rmv(A, u), b,
                                      x0=f.warm_start(op.apply(b)), atol=0.0, btol=0.0, iter_lim=200,
                                      steptol=steptol), lambda itn: 2 * itn + 2),
        ]:
            itn = int(fn().itn)
            t = sorted(_sync_time(torch, fn)[1] for _ in range(3))[1]
            loops[name] = dict(itn=itn, products_with_A=products(itn), wall_s=t,
                               ms_per_pair=2e3 * t / products(itn),
                               bound_ms_per_pair=1e3 * 2 * m * n * A.element_size() / PEAK_BYTES_PER_S)
        _p(f"phase 10: refinement loops on one factor (median of 3; card: {self.smi}): {json.dumps(loops)}")

    def after_main(self):
        """Four problems at m = 2^16 under one S, each x as its own saa_sas;
        the default call with each sketch kind, plain and fused, at
        m = 2^16; then forward stability (tests/test_iterative.py:29–41): at β = 1e-5
        the forward-stable solvers stay within 10x of QR's error.  The
        operator-form SAA's ratio (the reference's test chose its seed to
        keep that gap clear of 10x) is printed, not gated."""
        from repro_torch.core import (
            default_sketch_size,
            fossils,
            generate_problem,
            iterative_sketching,
            lstsq,
            qr_solve,
            saa_sas,
            saa_sas_batch,
            sample_sketch,
        )

        torch, gen, dev = self.torch, self.gen, self.dev
        n = N_MAIN
        P = [generate_problem(gen, M_DENSE, n, cond=COND, beta=BETA, device=dev) for _ in range(4)]
        A4, b4 = torch.stack([p.A for p in P]), torch.stack([p.b for p in P])
        x4 = [p.x_true for p in P]
        del P
        op = sample_sketch("clarkson_woodruff", gen, default_sketch_size(n, M_DENSE), M_DENSE, device=dev)
        res = self.run_path("problem_batch", lambda: saa_sas_batch(A4, b4, gen, sketch=op))
        self.walls["problem_batch"] = sorted(
            _sync_time(torch, lambda: saa_sas_batch(A4, b4, gen, sketch=op))[1] for _ in range(3))[1]
        probs = []
        for i in range(4):
            single = saa_sas(A4[i], b4[i], gen, sketch=op)
            probs.append(dict(itn=int(res.itn[i]), istop=int(res.istop[i]), gap=_rel(res.x[i], single.x),
                              bitwise=torch.equal(res.x[i], single.x), err=_rel(res.x[i], x4[i])))
            if not (probs[-1]["gap"] <= 1e-10 and probs[-1]["err"] < 1e-5):
                raise AssertionError(f"problem batch, problem {i}: {probs[-1]}")
        _p(f"phase 10: problem_batch (4 × A(2^16, 1000), one S): {json.dumps(probs)}; median warm wall of 3 "
           f"{self.walls['problem_batch']:.4f} s; launches {self.paths['problem_batch']} (card: {self.smi})")
        del A4, b4, x4, res

        # The default call with every sketch kind, plain and fused, on one
        # of these problems: each kind's kernels on the new path.
        p = generate_problem(gen, M_DENSE, n, cond=COND, beta=BETA, device=dev)
        e_qr = _rel(qr_solve(p.A, p.b), p.x_true)
        for kind, kernel in [("clarkson_woodruff", "countsketch_apply"),
                             ("gaussian", "fused_gaussian_sketch"), ("uniform_dense", "sketch_matmul"),
                             ("srht", "srht_apply"), ("sparse_sign", "countsketch_apply"),
                             ("uniform_sparse", "countsketch_apply")]:
            for fused in (False, True):
                name = f"default_{kind}{'_fused' if fused else ''}"
                res = self.run_path(name, lambda: lstsq(p.A, p.b, gen, sketch=kind, fused=fused))
                e = _rel(res.x, p.x_true)
                _p(f"phase 10: {name} m=2^16: method {res.method} itn {int(res.itn)} istop {int(res.istop)} "
                   f"rel.err {e:.3e}; qr_solve rel.err {e_qr:.3e}; launches {self.paths[name]}")
                if not (res.method == "iterative" and e < 1e-5 and e <= 10 * max(e_qr, 1e-12)
                        and self.paths[name][kernel] >= 1):
                    raise AssertionError(f"{name}: method {res.method}, rel.err {e}, launches {self.paths[name]}")
        del p, res
        torch.cuda.empty_cache()

        p = generate_problem(gen, M_MAIN, n, cond=COND, beta=1e-5, device=dev)
        e_qr = _rel(qr_solve(p.A, p.b), p.x_true)
        ratios = {}
        for name, fn in [
            ("stability_iterative", lambda: iterative_sketching(p.A, p.b, gen)),
            ("stability_fossils", lambda: fossils(p.A, p.b, gen)),
            ("stability_saa_operator", lambda: saa_sas(p.A, p.b, gen, materialize_y=False)),
        ]:
            _, e = self.run(name, fn, p.x_true, e_qr)
            ratios[name] = e / e_qr
            if name != "stability_saa_operator" and not e <= 10 * e_qr:
                raise AssertionError(f"{name}: rel.err {e} against qr_solve's {e_qr}")
        _p(f"phase 10: forward stability at beta=1e-5: error over qr_solve's {json.dumps(ratios)}")
        del p
        torch.cuda.empty_cache()

    def mixed(self, p, e_qr):
        """The mixed certified run on phase 6's κ = 1e4 problem: a bf16
        sketch, certified, escalating precision if its certificate fails.
        A mixed certificate pays one exact σ_min(A R⁻¹): timed here on a
        mixed factor by the port's route (σ_min of the R factor of a QR of
        Y) and by an SVD of Y itself, with the peak memory of each."""
        from repro_torch.core import SketchedFactor, lstsq
        from repro_torch.core.certify import _exact_whitened_floor

        torch, gen = self.torch, self.gen
        res, _ = self.run("certified_mixed", lambda: lstsq(p.A, p.b, gen, accuracy="certified", precision="mixed"),
                          p.x_true, e_qr)
        if not bool(res.certificate.passed):
            raise AssertionError(f"certified mixed: {res.certificate}")
        f, _ = SketchedFactor.build(p.A, gen, precision="mixed")
        floor = {}
        for route, fn in [
            ("qr_of_Y", lambda: _exact_whitened_floor(p.A, f)),
            ("svd_of_Y", lambda: torch.linalg.svdvals(f.materialize_whitened(p.A))[-1]),
        ]:
            fn()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            sigma, t = _sync_time(torch, fn)
            floor[route] = dict(sigma_min=float(sigma), s=t,
                                peak_gib=(torch.cuda.max_memory_allocated() - before) / 2**30)
        _p(f"phase 10: certified_mixed certified at precision {res.certificate.precision} after "
           f"{res.certificate.escalations} escalations; the exact σ_min(A R⁻¹) pass on a mixed factor: "
           f"{json.dumps(floor)} (card: {self.smi})")
        if abs(floor["qr_of_Y"]["sigma_min"] - floor["svd_of_Y"]["sigma_min"]) > 1e-12:
            raise AssertionError(f"the two routes to σ_min(A R⁻¹) disagree: {floor}")


class _Phase11:
    """Phase 11: the span tracer and the ``SketchedSolver`` session.

    On the main problem: the default call, ``method="saa"`` and the
    certified tier with ``trace=True`` (each timeline printed, its spans
    nested, every child no longer than its parent), the warm walls traced
    and untraced, and the disabled tracer's overhead against a stripped
    build (``obs_trace.stripped()``, ≤ 1.05x); a session serving 8
    solves and one ``solve_many`` of 8 from one sketch and one QR; row
    updates (CountSketch delta-sketch, the SRHT's re-sketch, an
    auto-recertifying session from n + 2 rows).  At m = 2^16 a Gaussian
    and a uniform-dense session, each with one row update.  Then the
    registry's ``session`` counters against the sessions' stats.
    ``run_path(name, fn)`` counts launches as for phase 10."""

    SPANS = ("lstsq", "lstsq.select", "lstsq.solve", "factor.build", "sketch.apply", "factor.qr")

    def __init__(self, torch, dev, gen, smi, run_path, paths, t_saa):
        from repro_torch.obs import REGISTRY

        self.torch, self.dev, self.gen, self.smi = torch, dev, gen, smi
        self.run_path, self.paths, self.t_saa = run_path, paths, t_saa
        self.stats_seen = []  # the stats dict of every session built here
        REGISTRY.reset()  # the session counters read at the end are this phase's

    # ------------------------------------------------------------ tracing
    def _timeline(self, name, tl, need):
        """Print ``tl`` and its time by span name; raise unless every name
        in ``need`` is there, each span lies within its parent's window
        and no child lasts longer than its parent."""
        names = tl.names()
        missing = [n for n in need if n not in names]
        spans = sorted(tl.spans(), key=lambda e: (e["ts"], e["depth"]))
        open_ = []  # the chain of enclosing spans
        for e in spans:
            while open_ and open_[-1]["depth"] >= e["depth"]:
                open_.pop()
            if e["depth"] > 0:
                parent = open_[-1] if open_ else None
                if (parent is None or parent["depth"] != e["depth"] - 1 or e["dur"] > parent["dur"]
                        or e["ts"] + e["dur"] > parent["ts"] + parent["dur"]):
                    raise AssertionError(f"{name}: span {e['name']} is not nested in its parent {parent}")
            open_.append(e)
        by_name = {}
        for e in spans:
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] / 1e3
        _p(f"phase 11: {name} timeline (span durations on the card; card: {self.smi}):\n{tl.render()}")
        _p(f"phase 11: {name} ms by span name {json.dumps(by_name)}")
        if missing:
            raise AssertionError(f"{name}: timeline lacks {missing}: {names}")
        return spans

    def tracing(self, A, b, x_true, e_qr):
        from repro_torch.core import lstsq
        from repro_torch.obs import trace as obs_trace

        torch, gen = self.torch, self.gen
        good = lambda e: e < 1e-5 and e <= 10 * max(e_qr, 1e-12)  # noqa: E731
        res = self.run_path("traced_default", lambda: lstsq(A, b, gen, trace=True))
        e = _rel(res.x, x_true)
        if not (good(e) and res.method == "iterative"):
            raise AssertionError(f"traced default: method {res.method}, rel.err {e}")
        self._timeline("default (iterative)", res.timeline, self.SPANS)
        res = self.run_path("traced_saa", lambda: lstsq(A, b, gen, method="saa", trace=True))
        e_saa = _rel(res.x, x_true)
        if not (e_saa < 1e-5 and e_saa <= 100 * max(e_qr, 1e-12)):
            raise AssertionError(f"traced saa: rel.err {e_saa}")
        # a forced method selects nothing: no lstsq.select span
        self._timeline("saa", res.timeline, [n for n in self.SPANS if n != "lstsq.select"])
        res = self.run_path("traced_certified", lambda: lstsq(A, b, gen, accuracy="certified", trace=True))
        spans = self._timeline("certified", res.timeline, ("lstsq", "certified.rung", "certify.probe",
                                                           "certify.floor", "factor.build"))
        rungs = [e for e in spans if e["name"] == "certified.rung"]
        if not (all("passed" in r["args"] for r in rungs) and rungs[-1]["args"]["passed"] is True
                and bool(res.certificate.passed)):
            raise AssertionError(f"traced certified: rungs {[r['args'] for r in rungs]}")
        for name, p in (("traced_default", "countsketch_apply"), ("traced_saa", "countsketch_apply")):
            if self.paths[name][p] < 2:
                raise AssertionError(f"{name} did not launch B1 on A and b: {self.paths[name]}")
        if obs_trace.enabled():
            raise AssertionError("a per-call trace left its tracer active")

        def call(trace=None):
            # a generator seeded alike for every call: the same S, the same
            # iterations, so the walls differ only by what is timed
            g = torch.Generator(device=self.dev).manual_seed(11)
            return lstsq(A, b, g, trace=trace)

        walls = {
            "traced": sorted(_sync_time(torch, lambda: call(True))[1] for _ in range(3))[1],
            "untraced": sorted(_sync_time(torch, call)[1] for _ in range(3))[1],
        }
        # The disabled tracer against a build whose call sites do nothing:
        # alternate rounds, the least wall of each.
        plain, bare = [], []
        for _ in range(5):
            plain.append(_sync_time(torch, call)[1])
            with obs_trace.stripped():
                bare.append(_sync_time(torch, call)[1])
        overhead_x = min(plain) / min(bare)
        _p(f"phase 11: default call (one seed, itn {int(call().itn)}) median warm wall of 3: traced "
           f"{walls['traced']:.4f} s, untraced "
           f"{walls['untraced']:.4f} s; disabled tracer vs stripped (min of 5, alternating): "
           f"{min(plain):.4f} s vs {min(bare):.4f} s, overhead_x {overhead_x:.4f} (gate ≤ 1.05; card: {self.smi})")
        if overhead_x > 1.05:
            raise AssertionError(f"disabled-tracer overhead {overhead_x} > 1.05")

    # ------------------------------------------------------------ session
    def _session(self, *a, **kw):
        from repro_torch.core import SketchedSolver

        s = SketchedSolver(*a, **kw)
        self.stats_seen.append(s.stats)
        return s

    def main_problem(self, A, b, x_true, e_qr):
        """The session at the paper's size: one build, 8 solves on
        b_i = b + A·δ_i (solution x_true + δ_i, the same residual), one
        solve_many of those 8; then the row updates."""
        from repro_torch.core import CountSketch, SketchedFactor
        from repro_torch.core import sketch as sketch_lib

        torch, gen, dev = self.torch, self.gen, self.dev
        m, n = A.shape
        k = 8
        D = torch.randn(n, k, generator=gen, dtype=A.dtype, device=dev)
        B = b[:, None] + A @ D
        X_true = x_true[:, None] + D
        Qa, Ra = torch.linalg.qr(A)
        X_qr = torch.linalg.solve_triangular(Ra, Qa.T @ B, upper=True)
        del Qa, Ra
        e_qrs = [_rel(X_qr[:, j], X_true[:, j]) for j in range(k)]

        counts = {"sample": 0, "qr": 0}
        real_sample, real_qr = sketch_lib.sample, SketchedFactor.from_sketch.__func__

        def counting_sample(*a, **kw):
            counts["sample"] += 1
            return real_sample(*a, **kw)

        def counting_qr(cls, Bm):
            counts["qr"] += 1
            return real_qr(cls, Bm)

        torch.cuda.synchronize()
        start = torch.cuda.memory_allocated()
        t = {}

        def serve():
            s = self._session(A, gen)
            torch.cuda.synchronize()
            t["build"] = time.perf_counter() - t0
            out, walls = [], []
            for j in range(k):
                res, w = _sync_time(torch, lambda: s.solve(B[:, j]))
                out.append(res)
                walls.append(w)
            t["solve"] = sorted(walls)[k // 2]
            many, t["solve_many"] = _sync_time(torch, lambda: s.solve_many(B))
            return s, out, many

        sketch_lib.sample, SketchedFactor.from_sketch = counting_sample, classmethod(counting_qr)
        try:
            with _Count2D(CountSketch) as counted:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                s, singles, many = self.run_path("session", serve)
        finally:
            sketch_lib.sample, SketchedFactor.from_sketch = real_sample, classmethod(real_qr)
        on_A = [sh for sh in counted.shapes if sh == (m, n)]
        launches = self.paths["session"]["countsketch_apply"]
        stats = dict(s.stats)
        cols = []
        for j in range(k):
            e1, e8 = _rel(singles[j].x, X_true[:, j]), _rel(many.x[:, j], X_true[:, j])
            copies = s.solve_many(B[:, j:j + 1].repeat(1, k))
            frozen = (torch.equal(copies.x[:, 0], many.x[:, j]) and int(copies.itn[0]) == int(many.itn[j])
                      and int(copies.istop[0]) == int(many.istop[j]))
            cols.append(dict(solve_itn=int(singles[j].itn), solve_err=e1, many_itn=int(many.itn[j]),
                             many_err=e8, qr_err=e_qrs[j], freeze_bitwise=frozen))
            ok = lambda e: e < 1e-5 and e <= 100 * max(e_qrs[j], 1e-12)  # noqa: E731
            if not (ok(e1) and ok(e8) and frozen and singles[j].method == many.method == "session"):
                raise AssertionError(f"session column {j}: {cols[-1]}")
        _p(f"phase 11: session at A({m}, {n}) clarkson_woodruff: columns {json.dumps(cols)}")
        _p(f"phase 11: session stats {stats}; operator draws {counts['sample']}, QR factorizations "
           f"{counts['qr']}, 2-D sketch applies on A {len(on_A)}, B1 launches {launches} (1 on A + {k} "
           f"solves + 1 solve_many); launches {self.paths['session']}")
        if not (stats == {"sketches": 1, "qr_factorizations": 1, "solves": 2 * k}
                and counts == {"sample": 1, "qr": 1} and len(on_A) == 1 and launches == 1 + k + 1):
            raise AssertionError("the session sketched or factored more than once")
        _p(f"phase 11: session walls: build {t['build']:.4f} s, median solve {t['solve']:.4f} s, solve_many "
           f"(k = {k}) {t['solve_many']:.4f} s; phase 3's lstsq(method='saa') {self.t_saa:.4f} s "
           f"(card: {self.smi})")
        del singles, many, copies, D, B, X_true, X_qr
        self.updates(A, b, s, start)

    def _update(self, name, s, A, idx, rows, start, tol_of):
        """One counted, timed update_rows; hold its B against a fresh
        sketch of the new A (``tol_of(A_new)`` gives the bound, None for
        bitwise) and the caller's rows against a saved copy."""
        torch = self.torch
        saved = A[idx].clone()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _, wall = _sync_time(torch, lambda: self.run_path(name, lambda: s.update_rows(idx, rows)))
        peak = (torch.cuda.max_memory_allocated() - start) / 2**30
        # where the update's time goes: the same update again (its memory
        # now cached by the allocator), and forming Y alone
        _, again = _sync_time(torch, lambda: s.update_rows(idx, rows))
        _, t_y = _sync_time(torch, lambda: s.factor.materialize_whitened(s.A))
        if not torch.equal(A[idx], saved):
            raise AssertionError(f"{name}: update_rows wrote into the caller's A")
        A_new = s.A.A
        if not torch.equal(A_new[idx], rows):
            raise AssertionError(f"{name}: the session's A does not hold the new rows")
        fresh = s._sketch_op.apply(A_new)
        err = float((s._B - fresh).abs().max())
        tol = tol_of(A_new)
        if (tol is None and not torch.equal(s._B, fresh)) or (tol is not None and not bool(((s._B - fresh).abs() <= tol).all())):
            raise AssertionError(f"{name}: updated B off a fresh sketch of the new A by {err}")
        _p(f"phase 11: {name}: update_rows of {idx.numel()} rows: wall {wall:.4f} s (again {again:.4f} s; "
           f"Y = A R⁻¹ alone {t_y:.4f} s), peak device memory "
           f"{peak:.2f} GiB above the session's start; updated B vs a fresh sketch of the new A: max|Δ| "
           f"{err:.3e} ({'bitwise' if tol is None else 'within its bound'}); stats {dict(s.stats)}; "
           f"launches {self.paths[name]} (card: {self.smi})")
        return A_new

    def _bucket_tol(self, op, idx, delta_abs):
        """2·γ_{k+2}·|S|(|A_new| + |A_new − A|) for a CountSketch, k its
        largest bucket: B = SA, plus the delta-sketch, plus one add.
        ``delta_abs`` is |rows − A[idx]|."""
        from repro_torch.kernels import countsketch_ref

        torch = self.torch

        def tol(A_new):
            k = int(torch.bincount(op.buckets.long(), minlength=op.d).max())
            w = op.signs.abs()
            return 2 * _gamma(torch, k + 2, A_new.dtype) * (
                countsketch_ref(A_new.abs(), op.buckets, w, op.d)
                + countsketch_ref(delta_abs, op.buckets[idx], w[idx], op.d))
        return tol

    def updates(self, A, b, s, start):
        """update_rows on the session of ``main_problem`` (CountSketch
        delta-sketch, B1 on a CSR of |idx| entries), then an SRHT session
        (B8 on the whole new A) and an auto-recertifying one from n + 2
        rows.  Each next solve is held against qr_solve on the new A."""
        from repro_torch.core import SRHTSketch, qr_solve

        torch, gen, dev = self.torch, self.gen, self.dev
        m, n = A.shape
        n_rows = min(4096, m // 16)
        idx = torch.randperm(m, generator=gen, device=dev)[:n_rows]
        # new rows of A's own scale (its entries' RMS), a second draw
        scale = float(A.norm() / math.sqrt(A.numel()))
        rows = torch.randn(n_rows, n, generator=gen, dtype=A.dtype, device=dev) * scale
        A_new = self._update("session_update", s, A, idx, rows, start,
                             self._bucket_tol(s._sketch_op, idx, (rows - A[idx]).abs()))
        if self.paths["session_update"]["countsketch_apply"] != 1:
            raise AssertionError(f"the delta-sketch did not launch B1 once: {self.paths['session_update']}")
        x_qr = qr_solve(A_new, b)
        del A_new

        def check_solve(name, sess):
            res, wall = _sync_time(torch, lambda: sess.solve(b))
            gap = _rel(res.x, x_qr)
            _p(f"phase 11: {name}: next solve itn {int(res.itn)} istop {int(res.istop)}, ‖x − x_qr‖/‖x_qr‖ "
               f"on the new A {gap:.3e}, wall {wall:.4f} s (card: {self.smi})")
            if not gap < 1e-8:
                raise AssertionError(f"{name}: solve after update_rows off qr_solve by {gap}")

        check_solve("session_update", s)
        del s
        torch.cuda.empty_cache()

        # The SRHT: no column restriction, so the same S sketches the new A.
        torch.cuda.synchronize()
        start = torch.cuda.memory_allocated()
        s = self._session(A, gen, sketch="srht")
        with _Count2D(SRHTSketch) as counted:
            self._update("session_update_srht", s, A, idx, rows, start, lambda A_new: None)
        on_A = [sh for sh in counted.shapes if sh == (m, n)]
        if not (s.stats["sketches"] == 3 and len(on_A) == 3
                and self.paths["session_update_srht"]["srht_apply"] == 1):
            # 2-D applies on (m, n): the counted update's, the repeat's and
            # the fresh check's
            raise AssertionError(f"SRHT update: stats {s.stats}, applies {counted.shapes}")
        check_solve("session_update_srht", s)
        del s
        torch.cuda.empty_cache()

        # From n + 2 rows, auto_recertify escalates after the update.
        s = self._session(A, gen, sketch_size=n + 2, auto_recertify=True)
        _, wall = _sync_time(torch, lambda: self.run_path("session_recertify", lambda: s.update_rows(idx, rows)))
        cert = s.certificate
        _p(f"phase 11: session_recertify (n + 2 rows, auto_recertify): update wall {wall:.4f} s, escalations "
           f"{s.escalations}, recertifications {s.recertifications}, sketch rows {s.sketch_size}, certificate "
           f"passed {bool(cert.passed)} distortion {float(cert.distortion):.3f}; stats {dict(s.stats)}; launches "
           f"{self.paths['session_recertify']} (card: {self.smi})")
        if not (bool(cert.passed) and s.escalations >= 1 and s.sketch_size > n + 2):
            raise AssertionError(f"auto_recertify did not escalate to a passing certificate: {cert}")
        check_solve("session_recertify", s)
        del s, x_qr
        torch.cuda.empty_cache()

    def dense(self):
        """At m = 2^16: a Gaussian session (B4 on A and b, B6 on the
        delta) and a uniform-dense one (B6 on A, b and the delta), each
        with one row update held against a fresh sketch of the new A."""
        from repro_torch.core import generate_problem, qr_solve

        torch, gen, dev = self.torch, self.gen, self.dev
        p = generate_problem(gen, M_DENSE, N_MAIN, cond=COND, beta=BETA, device=dev)
        A, b = p.A, p.b
        m, n = A.shape
        e_qr = _rel(qr_solve(A, b), p.x_true)
        n_rows = min(4096, m // 16)
        idx = torch.randperm(m, generator=gen, device=dev)[:n_rows]
        scale = float(A.norm() / math.sqrt(A.numel()))
        rows = torch.randn(n_rows, n, generator=gen, dtype=A.dtype, device=dev) * scale
        delta_abs = (rows - A[idx]).abs()
        for kind, kernel, ulps in [("gaussian", "fused_gaussian_sketch", ULP_BOUND),
                                   ("uniform_dense", "sketch_matmul", 0)]:
            name = f"session_{kind}"
            torch.cuda.synchronize()
            start = torch.cuda.memory_allocated()

            def build_and_solve():
                sess = self._session(A, gen, sketch=kind)
                return sess, sess.solve(b)

            s, res = self.run_path(name, build_and_solve)
            e = _rel(res.x, p.x_true)
            _p(f"phase 11: {name} m=2^16: solve itn {int(res.itn)} rel.err {e:.3e}; qr_solve rel.err "
               f"{e_qr:.3e}; launches {self.paths[name]} (card: {self.smi})")
            if not (e < 1e-5 and e <= 100 * max(e_qr, 1e-12) and self.paths[name][kernel] >= 2):
                raise AssertionError(f"{name}: rel.err {e}, launches {self.paths[name]}")
            S_abs = s._sketch_op.as_dense().abs()

            def tol(A_new, S_abs=S_abs, ulps=ulps):
                # 2·γ_{m+2}·|S|(|A_new| + |ΔA|), plus the kernel's Gaussians
                # against the generator's (≤ ulps f32 ulps) on the delta
                g = 2 * _gamma(torch, m + 2, A.dtype)
                on_delta = S_abs[:, idx] @ delta_abs
                return g * (S_abs @ A_new.abs() + on_delta) + ulps * 2.0**-23 * on_delta

            A_new = self._update(f"{name}_update", s, A, idx, rows, start, tol)
            if self.paths[f"{name}_update"]["sketch_matmul"] != 1:
                raise AssertionError(f"{name}: the delta-sketch did not launch B6 once")
            x_qr = qr_solve(A_new, b)
            gap = _rel(s.solve(b).x, x_qr)
            _p(f"phase 11: {name}: next solve ‖x − x_qr‖/‖x_qr‖ on the new A {gap:.3e}")
            if not gap < 1e-8:
                raise AssertionError(f"{name}: solve after update_rows off qr_solve by {gap}")
            del s, S_abs, A_new, x_qr
        del p, A, b, delta_abs
        torch.cuda.empty_cache()

    def metrics(self):
        """The registry's session counters equal the sums of the sessions'
        stats (every session this phase built)."""
        from repro_torch.obs import prometheus_text

        lines = [ln for ln in prometheus_text().splitlines() if ln.startswith("repro_session_")]
        _p("phase 11: prometheus_text() session lines:\n" + "\n".join(lines))
        for key in ("sketches", "qr_factorizations", "solves"):
            total = sum(s[key] for s in self.stats_seen)
            if f"repro_session_{key} {total}" not in lines:
                raise AssertionError(f"registry's session.{key} is not the sessions' sum {total}: {lines}")


def _coo_check(torch, rows, cols, vals, shape, h, w, d, what):
    """The coordinate scatter on these entries: bitwise its plain version on
    the CPU, two calls bitwise equal, and within 2·γ_K·|S||A| of its plain
    version on the card (index_add_'s atomics; K = the most products in a
    cell).  Returns (out, max|Δ| from the card's plain version)."""
    from repro_torch.kernels import countsketch_coo_apply, countsketch_coo_plan, countsketch_coo_ref

    out = countsketch_coo_apply(rows, cols, vals, shape, h, w, d)
    again = countsketch_coo_apply(rows, cols, vals, shape, h, w, d)
    cpu = countsketch_coo_ref(rows.cpu(), cols.cpu(), vals.cpu(), shape, h.cpu(), w.cpu(), d)
    card = countsketch_coo_ref(rows, cols, vals, shape, h, w, d)
    torch.cuda.synchronize()
    if out.dtype != vals.dtype or out.shape != cpu.shape:
        raise AssertionError(f"coordinate scatter {what}: got {out.dtype} {tuple(out.shape)}")
    if not torch.equal(out.cpu(), cpu):
        raise AssertionError(f"coordinate scatter {what}: not bitwise equal to the CPU plain version")
    if not torch.equal(out, again):
        raise AssertionError(f"coordinate scatter {what}: two calls differ")
    n = shape[1] if len(shape) == 2 else 1
    K = int(countsketch_coo_plan(rows, cols, n, h, d).offsets.diff().max()) if vals.numel() else 0
    mag = countsketch_coo_ref(rows, cols, vals.abs(), shape, h, w.abs(), d)
    err = (out - card).abs()
    if not bool((err <= 2 * _gamma(torch, K, vals.dtype) * mag).all()):
        raise AssertionError(f"coordinate scatter {what}: off the card's plain version by {float(err.max())}")
    return out, float(err.max()) if err.numel() else 0.0


def _coo_sketch(torch, gen, dev, kind, m, d):
    """(buckets, weights) of a bucket sketch over m rows: the CountSketch's
    ±1, the uniform-sparse sketch's U(−√3, √3) or the sparse-sign sketch's
    k = 8 ±1 per row."""
    k = 8 if kind == "sparse_sign" else 1
    shape = (k, m) if k > 1 else (m,)
    h = torch.randint(0, d, shape, generator=gen, dtype=torch.int32, device=dev)
    if kind == "uniform_sparse":
        w = torch.empty(shape, dtype=torch.float64, device=dev).uniform_(-3 ** 0.5, 3 ** 0.5, generator=gen)
    else:
        w = (torch.randint(0, 2, shape, generator=gen, device=dev) * 2 - 1).to(torch.float64)
    return h, w


def _coo_edges(torch, dev, gen):
    """Phase 2's checks of the coordinate scatter at its edges, for each
    bucket kind in f64 and f32: an empty column and an empty bucket,
    repeated coordinates, unsorted entries, nnz = 0 and a sparse vector b.
    Returns the largest max|Δ| from the card's plain version."""
    m, n, d = 1000, 37, 64
    worst = 0.0
    for kind in ("clarkson_woodruff", "uniform_sparse", "sparse_sign"):
        for dtype in (torch.float64, torch.float32):
            h, w = _coo_sketch(torch, gen, dev, kind, m, d)
            h = torch.where(h == 3, 4, h)  # bucket 3 stays empty
            nnz = 3 * m
            rows = torch.randint(0, m, (nnz,), generator=gen, device=dev)
            cols = torch.randint(0, n, (nnz,), generator=gen, device=dev)
            cols = torch.where(cols == 5, 6, cols)  # column 5 stays empty
            vals = torch.randn(nnz, generator=gen, dtype=torch.float64, device=dev).to(dtype)
            dup = torch.randint(0, nnz, (nnz // 4,), generator=gen, device=dev)  # repeated (r, c)
            rows, cols = torch.cat([rows, rows[dup]]), torch.cat([cols, cols[dup]])
            vals = torch.cat([vals, torch.randn(dup.numel(), generator=gen, dtype=torch.float64,
                                                device=dev).to(dtype)])
            out, err = _coo_check(torch, rows, cols, vals, (m, n), h, w, d, f"{kind} {dtype} edges")
            k = h.numel() // m
            if bool(out.reshape(d, n)[3].any()) or bool(out.reshape(d, n)[:, 5].any()):
                raise AssertionError(f"coordinate scatter {kind} {dtype}: an empty bucket or column is not 0")
            worst = max(worst, err)
            empty = rows[:0]
            out0, _ = _coo_check(torch, empty, empty, vals[:0], (m, n), h, w, d, f"{kind} {dtype} nnz=0")
            if bool(out0.any()):
                raise AssertionError(f"coordinate scatter {kind} {dtype}: nnz = 0 is not all 0")
            vec_rows = torch.randperm(m, generator=gen, device=dev)[: m // 3]  # unsorted, sparse b
            vec_vals = torch.randn(vec_rows.numel(), generator=gen, dtype=torch.float64, device=dev).to(dtype)
            _, err = _coo_check(torch, vec_rows, torch.zeros_like(vec_rows), vec_vals, (m,), h, w, d,
                                f"{kind} {dtype} vector")
            worst = max(worst, err)
            _p(f"phase 2: coordinate scatter {kind} (k = {k}) {str(dtype)[6:]} A({m}, {n}) d={d}: "
               f"{rows.numel()} unsorted entries with {dup.numel()} repeated coordinates, an empty column "
               f"and an empty bucket, nnz = 0, a sparse vector b: bitwise = CPU plain, two calls bitwise; "
               f"max|Δ| vs card plain {worst:.3e}")
    return worst


class _Phase12:
    """Phase 12: sparse, Tikhonov (``reg=``) and matrix-free inputs.

    (a) the coordinate scatter (``countsketch_coo_apply``) at the sparse
    problem's shape against its plain version, with its times; (b) the
    sparse problem (m = 2^20, n = 1000, 10 entries a row, κ ≈ 1e6) through
    the default call, ``saa`` with four sketch kinds, ``sap`` and the
    certified tier; (c) the ridge problem on the main problem with
    λ = 1e-8; (d) a ``CustomOperator`` over the main problem; (e) sessions
    on (b)'s A and on (c)'s ridge system.  ``run_path`` counts launches as
    for phase 10."""

    LAM = 1e-8
    K_SOLVES = 8

    def __init__(self, torch, dev, gen, smi, run_path, paths, stats_seen):
        self.torch, self.dev, self.gen, self.smi = torch, dev, gen, smi
        self.run_path, self.paths = run_path, paths
        self.stats_seen = stats_seen  # phase 11 sums every session's stats
        self.walls, self.peaks = {}, {}
        self.t_coo, self.err_coo = None, 0.0

    def run(self, name, fn):
        """One counted run with its peak memory, then the median warm wall
        of 3."""
        torch = self.torch
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        res = self.run_path(name, fn)
        self.peaks[name] = (torch.cuda.max_memory_allocated() - base) / 2**30
        self.walls[name] = sorted(_sync_time(torch, fn)[1] for _ in range(3))[1]
        return res

    def _report(self, name, res, e, e_ref, what="qr_solve rel.err"):
        _p(f"phase 12: {name}: method {res.method} itn {res.itn.tolist()} istop {res.istop.tolist()} "
           f"rel.err {e:.3e}; {what} {e_ref:.3e}; median warm wall of 3 {self.walls[name]:.4f} s; "
           f"peak above the inputs {self.peaks[name]:.3f} GiB; launches {self.paths[name]} (card: {self.smi})")

    # ---- (a) ---------------------------------------------------------------
    def kernel(self, rows, cols, vals, shape):
        """The coordinate scatter at the sparse problem's entries (shuffled:
        unsorted), d = 4000, for each bucket kind in f64 and f32; its times
        in f64 beside its set-up, bound, plain version and index_add_."""
        from repro_torch.kernels import countsketch_coo_apply, countsketch_coo_plan, countsketch_coo_ref
        from repro_torch.kernels.countsketch.ref import coo_keys

        torch, gen, dev = self.torch, self.gen, self.dev
        m, n = shape
        d = 4 * n
        ordered = rows, cols, vals  # in row order, as the sparse problem holds them
        shuffle = torch.randperm(rows.numel(), generator=gen, device=dev)
        rows, cols, vals = rows[shuffle], cols[shuffle], vals[shuffle]
        times = {}
        for kind in ("clarkson_woodruff", "uniform_sparse", "sparse_sign"):
            h, w = _coo_sketch(torch, gen, dev, kind, m, d)
            k = h.numel() // m
            for dtype in (torch.float64, torch.float32):
                v = vals.to(dtype)
                _, err = _coo_check(torch, rows, cols, v, shape, h, w, d, f"{kind} {dtype} A{shape}")
                self.err_coo = max(self.err_coo, err)
                _p(f"phase 12: coordinate scatter {kind} (k = {k}) {str(dtype)[6:]} A{shape} nnz={rows.numel()} "
                   f"d={d}: bitwise = CPU plain, two calls bitwise; max|Δ| vs card plain {err:.3e}")
            plan = countsketch_coo_plan(rows, cols, n, h, d)
            keys = coo_keys(rows, cols, n, h)
            prods = (w.reshape(k, m)[:, rows] * vals).reshape(-1)
            out_lib = torch.zeros(d * n, dtype=vals.dtype, device=dev)
            nprod = k * rows.numel()
            t = dict(
                ms=_event_ms(torch, lambda: countsketch_coo_apply(rows, cols, vals, shape, h, w, d, plan=plan)),
                setup_ms=_event_ms(torch, lambda: countsketch_coo_plan(rows, cols, n, h, d)),
                plain_ms=_event_ms(torch, lambda: countsketch_coo_ref(rows, cols, vals, shape, h, w, d)),
                library_ms=_event_ms(torch, lambda: out_lib.zero_().index_add_(0, keys, prods)),
            )
            # read once: each sorted product's id, value and weight; write the d·n cells
            t["bound_ms"], t["bound_by"] = _bound(2 * nprod, nprod * 24 + d * n * 8)
            plan_o = countsketch_coo_plan(ordered[0], ordered[1], n, h, d)
            t["row_order_ms"] = _event_ms(
                torch, lambda: countsketch_coo_apply(*ordered, shape, h, w, d, plan=plan_o))
            times[kind] = t
            del plan, plan_o, keys, prods, out_lib
        _p(f"phase 12: coordinate scatter times at A{shape} nnz={rows.numel()} d={d} f64, entries shuffled "
           f"(ms; set-up = the stable sort and offsets; library = one index_add_ of the precomputed products, "
           f"atomic; row_order = the kernel on the entries in row order; card: {self.smi}): {json.dumps(times)}")
        self.t_coo = times["clarkson_woodruff"]

    # ---- (b) and (e) sparse ------------------------------------------------
    def sparse(self):
        """The sparse problem: m = 2^20, n = 1000, 10 entries a row at
        random columns, N(0, 1) values, columns scaled from 1 to 1e-6
        (κ ≈ 1e6), b = A x_true + noise of 1e-10 ‖A x_true‖."""
        from repro_torch.core import SparseOperator, lstsq

        torch, gen, dev = self.torch, self.gen, self.dev
        m, n, per = M_MAIN, N_MAIN, 10
        rows = torch.arange(m, device=dev).repeat_interleave(per)
        cols = torch.randint(0, n, (m * per,), generator=gen, device=dev)
        scale = torch.logspace(0, -6, n, dtype=torch.float64, device=dev)
        vals = torch.randn(m * per, generator=gen, dtype=torch.float64, device=dev) * scale[cols]
        (A, t_op) = _sync_time(torch, lambda: SparseOperator.from_entries(rows, cols, vals, (m, n), device=dev))
        self.kernel(rows, cols, vals, (m, n))
        del rows, cols, vals
        x_true = torch.randn(n, generator=gen, dtype=torch.float64, device=dev)
        Ax = A.matvec(x_true)
        noise = torch.randn(m, generator=gen, dtype=torch.float64, device=dev)
        b = Ax + (1e-10 * Ax.norm() / noise.norm()) * noise
        del Ax, noise
        dense = A.materialize()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        Q, R = torch.linalg.qr(dense)  # qr_solve's steps, keeping R for κ
        del dense
        x_qr = torch.linalg.solve_triangular(R, (Q.T @ b)[:, None], upper=True)[:, 0]
        torch.cuda.synchronize()
        t_qr = time.perf_counter() - t0
        sv = torch.linalg.svdvals(R)
        del Q, R
        torch.cuda.empty_cache()
        e_qr = _rel(x_qr, x_true)
        _p(f"phase 12: sparse A({m}, {n}) nnz {A.nse} (10 a row), κ {float(sv[0] / sv[-1]):.3e}; "
           f"SparseOperator (CSR of A and of Aᵀ) built in {t_op:.3f} s; qr_solve on the densified A "
           f"{t_qr:.2f} s, rel.err {e_qr:.3e}")
        x0 = torch.randn(n, generator=gen, dtype=torch.float64, device=dev)
        u0 = torch.randn(m, generator=gen, dtype=torch.float64, device=dev)
        X0 = torch.randn(n, 8, generator=gen, dtype=torch.float64, device=dev)
        same = dict(matvec=torch.equal(A.matvec(x0), A.matvec(x0)),
                    rmatvec=torch.equal(A.rmatvec(u0), A.rmatvec(u0)),
                    matmat=torch.equal(A.matmat(X0), A.matmat(X0)),
                    rmatmat=torch.equal(A.rmatmat(A.matmat(X0)), A.rmatmat(A.matmat(X0))))
        t_mv = _event_ms(torch, lambda: A.matvec(x0))
        t_rmv = _event_ms(torch, lambda: A.rmatvec(u0))
        _p(f"phase 12: SparseOperator products two calls bitwise {json.dumps(same)}; matvec {t_mv:.4f} ms, "
           f"rmatvec {t_rmv:.4f} ms (card: {self.smi})")
        if not all(same.values()):
            raise AssertionError(f"SparseOperator products are not bitwise across two calls: {same}")
        # The segment sum's two forms (SparseOperator picks one by row
        # length) and cuSPARSE's SpMV (timed only; the port never calls
        # it), each with whether 30 more calls gave the first call's bits.
        routes = {}
        for name, csr, v in (("A", A.csr, x0), ("At", A.csr_t, u0)):
            lib = csr.to_torch()
            forms = {
                "flat": lambda: torch.segment_reduce(csr.val * v[csr.col], "sum", offsets=csr.crow),
                "column": lambda: torch.segment_reduce(
                    (csr.val * v[csr.col])[:, None], "sum", offsets=csr.crow, axis=0),
                "cusparse": lambda: lib @ v,
            }
            for form, fn in forms.items():
                first = fn()
                routes[f"{name}_{form}"] = dict(ms=_event_ms(torch, fn, reps=20),
                                                bitwise_30=all(torch.equal(fn(), first) for _ in range(30)))
        _p(f"phase 12: CSR product routes (ms, 30 calls bitwise; card: {self.smi}): {json.dumps(routes)}")
        del x0, u0, X0, lib

        good = lambda e: e < 1e-5 and e <= 100 * max(e_qr, 1e-12)  # noqa: E731
        runs = [("sparse_default", {})] + [
            (f"sparse_saa_{kind}", dict(method="saa", sketch=kind))
            for kind in ("clarkson_woodruff", "sparse_sign", "uniform_sparse", "srht")
        ] + [("sparse_sap", dict(method="sap")), ("sparse_certified", dict(accuracy="certified"))]
        for name, kw in runs:
            res = self.run(name, lambda: lstsq(A, b, gen, **kw))
            e = _rel(res.x, x_true)
            self._report(name, res, e, e_qr)
            if not good(e):
                raise AssertionError(f"{name}: rel.err {e} (qr_solve {e_qr})")
            if name == "sparse_default" and res.method != "iterative":
                raise AssertionError(f"the default call on a sparse A selected {res.method}")
            if name == "sparse_certified" and res.method == "direct":
                raise AssertionError("the certified ladder densified the sparse A (direct rung)")
        want = dict(sparse_default="countsketch_coo_apply", sparse_saa_clarkson_woodruff="countsketch_coo_apply",
                    sparse_saa_sparse_sign="countsketch_coo_apply",
                    sparse_saa_uniform_sparse="countsketch_coo_apply", sparse_saa_srht="srht_apply")
        for name, kernel in want.items():
            if self.paths[name][kernel] < 1:
                raise AssertionError(f"{name} did not launch {kernel}: {self.paths[name]}")
        _p(f"phase 12: sparse walls (s) {json.dumps({k: v for k, v in self.walls.items() if k.startswith('sparse')})}")
        self.session("session_sparse", A, b, x_true, x_qr, None)

    # ---- (c) and (e) ridge ---------------------------------------------------
    def ridge(self, A, b):
        """Ridge on the main problem with λ = 1e-8: the default call, saa
        and certified against the QR of the materialized (m + n, n) system
        [A; √λI] (also the session's truth)."""
        from repro_torch.core import TikhonovAugmented, lstsq

        torch, gen, dev = self.torch, self.gen, self.dev
        m, n = A.shape
        D = torch.randn(n, self.K_SOLVES, generator=gen, dtype=A.dtype, device=dev)
        B = b[:, None] + A @ D
        rhs = torch.cat([b[:, None], B], dim=1)
        rhs = torch.cat([rhs, rhs.new_zeros((n, rhs.shape[1]))])
        A_aug = TikhonovAugmented.wrap(A, self.LAM).materialize()
        Q, R = torch.linalg.qr(A_aug)
        del A_aug
        X = torch.linalg.solve_triangular(R, Q.T @ rhs, upper=True)
        del Q, R, rhs
        torch.cuda.empty_cache()
        x_ridge = X[:, 0]
        bnorm = float(b.norm())
        for name, kw in [("ridge_default", {}), ("ridge_saa", dict(method="saa")),
                         ("ridge_certified", dict(accuracy="certified"))]:
            res = self.run(name, lambda: lstsq(A, b, gen, reg=self.LAM, **kw))
            e = _rel(res.x, x_ridge)
            self._report(name, res, e, float(res.arnorm) / bnorm, "arnorm/‖b‖")
            if not (e < 1e-5 and float(res.arnorm) <= 1e-8 * bnorm):
                raise AssertionError(f"{name}: rel.err {e} against the augmented QR, arnorm {float(res.arnorm)}")
        if self.paths["ridge_saa"]["countsketch_apply"] < 2:
            raise AssertionError(f"ridge saa did not launch B1 on A and b: {self.paths['ridge_saa']}")
        self.session("session_ridge", A, B, None, X[:, 1:], self.LAM)

    # ---- (d) ---------------------------------------------------------------
    def matrix_free(self, A, b, x_true, e_qr):
        """A ``CustomOperator`` over the main problem's A (closures A @ v and
        A.T @ u): the default call and saa, each sketching through panels of
        Sᵀ and ``rmatmat`` under ``torch.vmap``."""
        from repro_torch.core import CustomOperator, lstsq
        from repro_torch.core.sketch import t_panel_cols

        torch, gen = self.torch, self.gen
        m, n = A.shape
        op = CustomOperator(lambda v: A @ v, lambda u: A.T @ u, (m, n), A.dtype, A.device)
        w = t_panel_cols(m, 4 * n, A.dtype)
        for name, kw in [("matrix_free_default", {}), ("matrix_free_saa", dict(method="saa"))]:
            res = self.run(name, lambda: lstsq(op, b, gen, **kw))
            e = _rel(res.x, x_true)
            self._report(name, res, e, e_qr)
            if not (e < 1e-5 and e <= 100 * max(e_qr, 1e-12)):
                raise AssertionError(f"{name}: rel.err {e} (qr_solve {e_qr})")
        _p(f"phase 12: matrix-free sketch: Sᵀ in panels of {w} columns ({-(-4 * n // w)} rmatmat calls of "
           f"{m * w * 8 / 2**30:.2f} GiB panels at d = {4 * n})")

    # ---- (e) ---------------------------------------------------------------
    def session(self, name, A, b, x_true, x_ref, reg):
        """``SketchedSolver`` on A (with ``reg``): one build, 8 solves, one
        solve_many of 8, certify.  Without reg the right-hand sides are
        b + A·δ_j (solution x_true + δ_j, qr_solve's error kept); with reg, b
        is the (m, 8) block and ``x_ref`` its ridge solutions."""
        from repro_torch.core import SketchedSolver

        torch, gen, dev = self.torch, self.gen, self.dev
        m, n = A.shape
        k = self.K_SOLVES
        if reg is None:
            D = torch.randn(n, k, generator=gen, dtype=torch.float64, device=dev)
            B = b[:, None] + A.matmat(D)
            X_true = x_true[:, None] + D
            e_qr = [float((x_ref - x_true).norm() / X_true[:, j].norm()) for j in range(k)]
        else:
            B, X_true = b, x_ref
        t = {}

        def serve():
            s, t["build"] = _sync_time(torch, lambda: SketchedSolver(A, gen, reg=reg))
            self.stats_seen.append(s.stats)
            out, walls = [], []
            for j in range(k):
                res, wall = _sync_time(torch, lambda: s.solve(B[:, j]))
                out.append(res)
                walls.append(wall)
            t["solve"] = sorted(walls)[k // 2]
            many, t["solve_many"] = _sync_time(torch, lambda: s.solve_many(B))
            return s, out, many

        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        s, singles, many = self.run_path(name, serve)
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        cols = []
        for j in range(k):
            e1, e8 = _rel(singles[j].x, X_true[:, j]), _rel(many.x[:, j], X_true[:, j])
            if reg is None:
                ok = e1 < 1e-5 and e8 < 1e-5 and max(e1, e8) <= 100 * max(e_qr[j], 1e-12)
            else:
                bn = float(B[:, j].norm())
                ok = (e1 < 1e-5 and e8 < 1e-5 and float(singles[j].arnorm) <= 1e-8 * bn
                      and float(many.arnorm[j]) <= 1e-8 * bn)
            cols.append(dict(solve_itn=int(singles[j].itn), solve_err=e1, many_itn=int(many.itn[j]), many_err=e8))
            if not ok:
                raise AssertionError(f"{name} column {j}: {cols[-1]}")
        cert, t["certify"] = _sync_time(torch, s.certify)
        cert_x = s.certify(B[:, 0], singles[0])
        stats = dict(s.stats)
        _p(f"phase 12: {name}: columns {json.dumps(cols)}; stats {stats}; certify() passed {bool(cert.passed)} "
           f"distortion {float(cert.distortion):.3f}; certify(b, x) passed {bool(cert_x.passed)} rel_error_bound "
           f"{float(cert_x.rel_error_bound):.3e}; walls: build {t['build']:.4f} s, median solve {t['solve']:.4f} s, "
           f"solve_many (k = {k}) {t['solve_many']:.4f} s, certify {t['certify']:.4f} s; peak above the inputs "
           f"{peak:.3f} GiB; launches {self.paths[name]} (card: {self.smi})")
        if stats != {"sketches": 1, "qr_factorizations": 1, "solves": 2 * k}:
            raise AssertionError(f"{name} sketched or factored more than once: {stats}")
        if not bool(cert.passed):
            raise AssertionError(f"{name}: the embedding's certificate failed: {cert}")


# The device kernels each wrapper launches on the traced solves' routes
# (f64 A with n = 1000, and the vector b), by name.
_SYMBOLS = {
    "countsketch_apply": ("countsketch_csr_kernel",),
    "countsketch_gram": ("countsketch_csr_kernel",),
    "panel_gram": ("gram_upper_kernel", "dmma_gram_kernel"),
    "fused_gaussian_sketch": ("dmma_gen_sketch_kernel", "dense_sketch_tile_kernel", "dense_sketch_vec_kernel"),
    "gaussian_gram": ("dmma_gen_sketch_kernel", "dense_sketch_tile_kernel"),
    "sketch_matmul": ("dmma_sketch_kernel", "dense_sketch_tile_kernel", "dense_sketch_vec_kernel"),
    "matmul_gram": ("dmma_sketch_kernel", "dense_sketch_tile_kernel"),
    "hadamard_transform": ("hadamard_pass_kernel",),
    "srht_apply": ("hadamard_pass_kernel",),
    "countsketch_coo_apply": ("coo_scatter_kernel",),
}


def _trace(torch, label, fn):
    """Device time by kernel, and the device's busy share, of one warm call.

    A port kernel that the traced call launched (its wrapper's count) but
    that has no device record in the trace is reported as lost, and the
    busy share, which would leave it out, is not printed."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import KERNELS, reset_launches

    fn()  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launched = {f.__name__: f.launches for f in KERNELS if f.launches}
    rows = []  # device kernels and copies only: operator rows repeat their time
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = e.self_cuda_time_total
        rows.append((dev_us, e.count, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    lost = [name for name in launched
            if not any(sym in key for _, _, key in rows for sym in _SYMBOLS[name])]
    if lost:
        _p(f"profile {label}: wall {wall:.4f} s; the trace lost the device record of "
           f"{', '.join(f'{k} ({launched[k]} launches)' for k in lost)}: no busy share "
           f"(the recorded kernels sum to {busy:.4f} s)")
    else:
        _p(f"profile {label}: wall {wall:.4f} s, device busy {busy:.4f} s "
           f"({100 * busy / wall:.1f}%), idle {100 * (1 - busy / wall):.1f}%; port launches {launched}")
    # the 15 longest rows, and every kernel of the port (all in a top-level
    # anonymous namespace) however short
    own = [r for r in rows[15:] if r[2].startswith("void (anonymous namespace)::")]
    for dev_us, count, key in rows[:15] + own:
        _p(f"profile {label}: {dev_us / 1e3:10.3f} ms {count:6d}x  {key[:110]}")


def _profile(torch, dev, generate_problem, lstsq) -> int:
    """Device time by kernel for one warm plain and one warm fused solve."""
    gen = torch.Generator(device=dev).manual_seed(0)
    prob = generate_problem(gen, M_MAIN, N_MAIN, cond=COND, beta=BETA, device=dev)
    for fused in (False, True):
        _trace(torch, f"fused={fused}", lambda: lstsq(prob.A, prob.b, gen, method="saa", fused=fused))
    _trace(torch, "sketch=srht", lambda: lstsq(prob.A, prob.b, gen, method="saa", sketch="srht"))
    _trace(torch, "default (iterative)", lambda: lstsq(prob.A, prob.b, gen))

    # Warm wall time of the main solve, on the same sketch each time, at the
    # paper's size and at a size where the host's launches bound the solve.
    for m, n in ((M_MAIN, N_MAIN), (2**16, 200)):
        p = prob if m == M_MAIN else generate_problem(gen, m, n, cond=COND, beta=BETA, device=dev)
        walls = []
        for _ in range(6):  # the first is a warm-up
            gen.manual_seed(1)
            res, wall = _sync_time(torch, lambda: lstsq(p.A, p.b, gen, method="saa"))
            walls.append(wall)
        walls = sorted(walls[1:])
        _p(f"solve m={m} n={n}: itn {int(res.itn)} istop {int(res.istop)} "
           f"warm wall min {walls[0]:.4f} s median {walls[2]:.4f} s max {walls[-1]:.4f} s")

    # The dense-sketch solves at m = 2^16 (phase 8's size).
    del prob
    p = generate_problem(gen, M_DENSE, N_MAIN, cond=COND, beta=BETA, device=dev)
    for sketch in ("gaussian", "uniform_dense", "clarkson_woodruff"):
        _trace(torch, f"m=2^16 sketch={sketch}", lambda: lstsq(p.A, p.b, gen, method="saa", sketch=sketch))
    for sketch in ("gaussian", "uniform_dense"):
        _trace(torch, f"m=2^16 sketch={sketch} fused=True",
               lambda: lstsq(p.A, p.b, gen, method="saa", sketch=sketch, fused=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
