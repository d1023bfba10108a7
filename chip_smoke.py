#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It puts
``src`` on ``sys.path``, builds the CUDA kernels from
``src/repro_torch/csrc``, and then:

1. prints the device, the card's name and power limit, and the build time;
2. holds every kernel against its plain PyTorch version on the card
   (B1 also bitwise against the plain version run on the CPU);
3. drives the main path, paper Algorithm 1 through ``lstsq(...,
   method="saa")``, at the paper's size (m = 2^20, n = 1000, κ = 1e10, f64);
4. the fused factor route (``fused=True``, kernel B3);
5. the perturbation fallback (``iter_lim=1``, m = 2^18);
6. mixed precision (bf16 sketch, κ = 1e4);
7. the tsqr CholeskyQR path (kernel B2) on the main path's sketch, and
   per-kernel times at the main path's shapes beside their bounds, their
   plain versions and a one-call library yardstick.  Phase 7 runs right
   after phase 4, on the main path's problem, before that is freed.

``python3 chip_smoke.py --profile`` instead builds the kernels, draws the
main problem and traces one warm plain and one warm fused solve with
``torch.profiler``: device time by kernel and the device's busy share of
the wall time (the breakdown in PERF.md).  Then it times the warm main
solve at the paper's size and at a smaller, host-bound size.  It prints no
result line.

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
        generate_problem,
        lsqr_dense,
        lstsq,
        qr_solve,
        saa_sas,
    )
    from repro_torch.kernels import (
        MAX_FUSED_COLS,
        _build,
        countsketch_apply,
        countsketch_csr,
        countsketch_gram,
        countsketch_gram_ref,
        countsketch_ref,
        panel_gram,
        panel_gram_ref,
        reset_launches,
        tsqr,
    )

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

    errs = {"countsketch_apply": 0.0, "panel_gram": 0.0, "countsketch_gram": 0.0}

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
    _p(f"phase 2: kernels {json.dumps({k: {'launches': f.launches, 'match': True} for k, f in [('countsketch_apply', countsketch_apply), ('panel_gram', panel_gram), ('countsketch_gram', countsketch_gram)]})}")
    del A, h, s, B, G, B_cpu, out, cpu, card

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
        paths[name] = {f.__name__: f.launches for f in (countsketch_apply, panel_gram, countsketch_gram)}
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
    t1["bound_ms"] = max(bytes1 / PEAK_BYTES_PER_S, M_MAIN * N_MAIN / PEAK_FLOPS["float64"]) * 1e3
    t1["bound_by"] = "bytes" if bytes1 / PEAK_BYTES_PER_S >= M_MAIN * N_MAIN / PEAK_FLOPS["float64"] else "operations"
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
    t2["bound_ms"] = max(bytes2 / PEAK_BYTES_PER_S, ops2 / PEAK_FLOPS["float64"]) * 1e3
    t2["bound_by"] = "operations" if ops2 / PEAK_FLOPS["float64"] >= bytes2 / PEAK_BYTES_PER_S else "bytes"

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
    t3["bound_ms"] = max(bytes3 / PEAK_BYTES_PER_S, (M_MAIN * N_MAIN + ops2) / PEAK_FLOPS["float64"]) * 1e3
    t3["bound_by"] = "bytes" if bytes3 / PEAK_BYTES_PER_S >= (M_MAIN * N_MAIN + ops2) / PEAK_FLOPS["float64"] else "operations"
    _p(f"phase 7: B1 {t1}; B2 {t2}; B3 {t3} (ms; f64, m=2^20, n=1000, d=4000; card: {smi})")
    del SA, Sb, Q2, R2, G_ref, csr, h, s, res, res_f, A_f
    del prob, A, b, x_true
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
    del p6, res6, op6
    _p(f"phase 6: B1 ran on bf16 input; peak device memory "
       f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")

    rows = []
    for name, src, replaces, path, t, err in [
        ("countsketch_apply", "src/repro_torch/csrc/countsketch.cuh",
         "src/repro/kernels/countsketch/kernel.py:27", "main", t1, err1),
        ("panel_gram", "src/repro_torch/csrc/gram.cuh",
         "src/repro/kernels/tsqr/kernel.py:51", "tsqr_cholqr", t2, err2),
        ("countsketch_gram", "src/repro_torch/csrc/countsketch_gram.cu",
         "src/repro/kernels/tsqr/kernel.py:68", "fused", t3, err3),
    ]:
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


def _profile(torch, dev, generate_problem, lstsq) -> int:
    """Device time by kernel for one warm plain and one warm fused solve."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device=dev).manual_seed(0)
    prob = generate_problem(gen, M_MAIN, N_MAIN, cond=COND, beta=BETA, device=dev)
    for fused in (False, True):
        lstsq(prob.A, prob.b, gen, method="saa", fused=fused)  # warm-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            lstsq(prob.A, prob.b, gen, method="saa", fused=fused)
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
        _p(f"profile fused={fused}: wall {wall:.4f} s, device busy {busy:.4f} s "
           f"({100 * busy / wall:.1f}%), idle {100 * (1 - busy / wall):.1f}%")
        for dev_us, count, key in rows[:15]:
            _p(f"profile fused={fused}: {dev_us / 1e3:10.3f} ms {count:6d}x  {key[:110]}")

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
    return 0


if __name__ == "__main__":
    sys.exit(main())
