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
   against its plain version at A (2^20, 1000) and timed there and on b;
   B1 on the sparse-sign and uniform-sparse CSRs at A (2^20, 1000), held
   against its plain version there; ``hadamard_transform`` through
   ``SRHTSketch.as_dense_t``; and, on phase 6's κ = 1e4 problem, one mixed
   SRHT solve (B8 on bf16 A, held against its plain version on that A).

Phase 2 also holds B8 (``hadamard_transform``, ``srht_apply``) bitwise
against its plain version on the card and on the CPU, in f64 and f32 and on
half inputs (f32 out), and B1 bitwise against the CPU on the sparse-sign
CSR (k·m entries) and on uniform weights.  It drives the f64 tensor-core
engine of B6 and B2 (``csrc/dense_mma.cuh``) at each edge of its design
(ragged d, n, m and s; m and s shorter than one ring stage; both sides of a
change of the split plan; n = 2..8 and odd n; operands not 16-byte
aligned), holds each call to the same bounds, checks that two calls are
bitwise equal, and that B7's B is bitwise B6's there.  Phases 7 and 8 print
each kernel's TFLOP/s and its share of its bound beside its time.

``python3 chip_smoke.py --profile`` instead builds the kernels, draws the
main problem and traces one warm plain, one warm fused and one warm SRHT
solve with ``torch.profiler``: device time by kernel and the device's busy
share of the wall time (the breakdown in PERF.md).  Then it times the warm
main solve at the paper's size and at a smaller, host-bound size, and
traces one warm Gaussian, uniform-dense (plain and fused) and CountSketch
solve at m = 2^16.  Each trace lists its 15 longest rows and every kernel
of the port, so the tensor-core kernels show by name.  It prints no result
line.

Each path runs with every kernel's launch count set to 0 just before it and
read just after.  TF32 is off for matmuls and cuDNN, so f32 products run in
full f32.  Any failure raises and exits non-zero; without CUDA, or without
the rest of the repository beside it, it exits 2 and prints no result.  The
last line is ``{"ok": true, "device": {...}}``; the line before it lists the
kernels as JSON.
"""
from __future__ import annotations

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
    from repro_torch.kernels.common import gram_split, sketch_split, sm_count
    from repro_torch.kernels.sketch_matmul import default_scale

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
    ]:
        A = torch.randn((m, n) if n > 1 else (m,), generator=gen, dtype=torch.float64, device=dev).to(dtype)
        signs, rows = srht_draw(m, d)
        check_b8(A, signs, rows, d)
        _p(f"phase 2: B8 srht_apply{' / hadamard_transform' if m & (m - 1) == 0 else ''} {str(dtype)[6:]} "
           f"A{tuple(A.shape)} d={d}{' (rows with replacement)' if d > 1 << (m - 1).bit_length() else ''}: "
           f"bitwise = plain on the card and on the CPU")
    # A row index outside [0, m_pad) is not checked on the host on the card
    # (a round trip per call): the gather writes NaN into that row instead.
    A = torch.randn((1024, 5), generator=gen, dtype=torch.float64, device=dev)
    signs, rows = srht_draw(1024, 8)
    bad = rows.clone()
    bad[3], bad[5] = 1024, -1
    out, good = srht_apply(A, signs, bad, 8), srht_apply(A, signs, rows, 8)
    keep = torch.ones(8, dtype=torch.bool, device=dev)
    keep[[3, 5]] = False
    if not (bool(torch.isnan(out[~keep]).all()) and torch.equal(out[keep], good[keep])):
        raise AssertionError("B8 with rows out of range: expected NaN rows there and the rest unchanged")
    _p("phase 2: B8 srht_apply with two rows out of [0, m_pad): NaN rows there, the rest bitwise unchanged")
    del bad, good, keep
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
        _, walls9[name] = _sync_time(torch, lambda: lstsq(A, b, gen, method="saa", **kw))
        _p(f"phase 9: lstsq(method='saa', {', '.join(f'{k}={v!r}' for k, v in kw.items())}) m=2^20: "
           f"itn {int(res9.itn)} istop {int(res9.istop)} used_fallback {bool(res9.used_fallback)} "
           f"rel.err {e9:.3e}; qr_solve rel.err {e_qr:.3e}; warm wall {walls9[name]:.4f} s; "
           f"launches {paths[name]}")
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
    # bytes: the input read once, the output written once (plus signs and
    # rows); operations: p·m adds per column, the signs' products, the
    # divisions by √d
    t8 = dict(
        ms=_event_ms(torch, lambda: srht_apply(A, s9, rows9, d9)),
        plain_ms=_event_ms(torch, lambda: srht_ref(A, s9, rows9, d9)),
        library_ms=None,
    )
    t8["bound_ms"], t8["bound_by"] = _bound(
        (p_bits + 1) * M_MAIN * N_MAIN + d9 * N_MAIN, (M_MAIN * N_MAIN + M_MAIN + d9 + d9 * N_MAIN) * esz)
    t8["vec_ms"] = _event_ms(torch, lambda: srht_apply(b, s9, rows9, d9))
    t8["vec_plain_ms"] = _event_ms(torch, lambda: srht_ref(b, s9, rows9, d9))
    t8["vec_bound_ms"], _ = _bound((p_bits + 1) * M_MAIN + d9, (2 * M_MAIN + 2 * d9) * esz)
    tH = dict(
        ms=_event_ms(torch, lambda: hadamard_transform(A)),
        plain_ms=_event_ms(torch, lambda: hadamard_ref(A)),
        library_ms=None,
    )
    tH["bound_ms"], tH["bound_by"] = _bound(p_bits * M_MAIN * N_MAIN, 2 * M_MAIN * N_MAIN * esz)
    _p(f"phase 9: B8 srht_apply {t8}; hadamard_transform {tH} (ms; f64, m=2^20, n=1000, d=4000; "
       f"no single PyTorch call computes a Walsh-Hadamard transform; card: {smi})")
    del s9, rows9

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
        t_b1[sparse_kind] = _event_ms(torch, lambda: countsketch_apply(A, op9.buckets, w9, d9, csr=csr9))
        _p(f"phase 9: B1 on the {sparse_kind} CSR ({op9.buckets.numel()} entries) at A(2^20, 1000) d=4000: "
           f"max|Δ| vs card plain {e_b1:.3e} (tol 2γ_{k}|S||A|), bitwise = CPU plain "
           f"on 64 columns; {t_b1[sparse_kind]:.3f} ms (card: {smi})")
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
    del op_t, St, prob, A, b, x_true
    torch.cuda.empty_cache()

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

    # phase 9's mixed SRHT solve, on this κ = 1e4 problem: B8 on bf16 A.
    # iter_lim=200 for the reason given at phase 8's mixed run.
    kw_m = dict(method="saa", sketch="srht", precision="mixed", iter_lim=200)
    res_m = run_path("srht_mixed", lambda: lstsq(p6.A, p6.b, gen, **kw_m))
    e_m = _rel(res_m.x, p6.x_true)
    e_qr6 = _rel(qr_solve(p6.A, p6.b), p6.x_true)
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
    }
    rows = []
    for f in KERNELS:
        name = f.__name__
        src, replaces, path, t, err = table[name]
        src, replaces = f"src/repro_torch/csrc/{src}", f"src/repro/kernels/{replaces}"
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


def _trace(torch, label, fn):
    """Device time by kernel, and the device's busy share, of one warm call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
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
    _p(f"profile {label}: wall {wall:.4f} s, device busy {busy:.4f} s "
       f"({100 * busy / wall:.1f}%), idle {100 * (1 - busy / wall):.1f}%")
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
    _trace(torch, "m=2^16 sketch=uniform_dense fused=True",
           lambda: lstsq(p.A, p.b, gen, method="saa", sketch="uniform_dense", fused=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
