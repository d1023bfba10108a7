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
   at the same size, and the times of B4–B7 at those shapes, B6 and B7
   also on bf16 (the half engine) and f32, B6 on bf16, f16 and f32 held
   entry by entry within √m·u of the f64 product of its inputs, a limit
   that two faults planted on its output read past;
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
   (``countsketch_coo_apply``) at its entries in f64 and f32, in row
   order (its plan by row) for each bucket kind and shuffled (its plan by
   product) for the sparse sign's, bitwise its plain version on the CPU,
   two calls bitwise equal,
   within 2·γ·|S||A| of its plain version on the card, timed for k = 1 and
   8 beside its plan (B1's CSR and the row pointer, or the sort by
   bucket), its bound, its plain version and one atomic ``index_add_``;
   ``SparseOperator``'s products bitwise across two calls;
   the default call, ``saa`` with four kinds (the SRHT on A densified),
   ``sap`` and the certified tier (never its ``direct`` rung), each within
   1e-5 and 100x ``qr_solve``'s error on the densified A; and a session
   on that A.  Each run prints its median warm wall of 3 and its peak;
13. streaming (class ``_Phase13``, on the main problem before it is freed):
   pass 1 from a device-resident ``ArraySource`` (tiles of 8192 rows) for
   the CountSketch, uniform-sparse and SRHT sketches bitwise the monolithic
   B1/B8 apply over the default and an uneven ``boundaries=`` tiling, two
   passes bitwise, B1's fold mode bitwise the CPU plain fold; the
   sparse-sign B bitwise the CPU plain streamed fold and within
   2·γ_K·|S||A| of the monolithic k·m-entry route; B4 with ``col0``
   tile by tile at m = 2^16 against ``gaussian_matrix_ref(col_offset=…)``,
   its ``col0 = 0`` launch bitwise the whole-A entry, the streamed
   Gaussian and uniform-dense B against B4/B6; pass-1, fold and col0 times
   beside their bounds; ``stream_lstsq`` (``saa``, ``iterative``,
   ``sketch_and_solve``, ``reg=1e-8``, ``certify=True``) on the device
   source beside the in-memory ``lstsq`` from the same seed, gated as
   phases 10 and 12 gate them (``sketch_and_solve``, not forward stable,
   held to the monolithic sketch-and-solve on the same S); a numpy source
   through the pinned stager and a ``MemmapSource`` at m = 2^18, each
   bitwise the device-resident run, with their GB/s; a
   ``StreamingSolver`` serving 8 solves and a ``solve_many`` of 8 (stats
   {1, 1, 16}).  The streamed runs pass through ``_NoPlain``: a plain
   version, ``index_add_`` or ``torch.cuda.synchronize`` reached there on
   the card fails the run.
14. serving (class ``_Phase14``, last, on problems of its own): two
   tenants at m = 2^20, n = 1000, κ = 1e4, β = 1e-6 with 64 right-hand
   sides each, one ``SolveService`` (24 GiB cache, 2 ms window, rtol
   1e-6): the digest of a full A (GB/s) and its memo hit, an in-place
   write changing a fingerprint; a closed loop of 64 requests cold and
   warm (one batch each, certified, 4 columns against the QR of A) beside
   a per-request certified ``lstsq``; ``prewarm`` and an open loop of
   Poisson arrivals at 50/s for 4 s (p50/p99, solves/s, hit rate 1.0,
   occupancy); 256 small problems through the shape buckets (each within
   1e-10 of its own QR); an expired deadline, a request at rtol 1e-13
   through the slow path; ``update_rows`` of 4096 rows re-keying the
   session and a request on the updated A answered by it.  Each part runs
   through ``_NoPlain`` with B1's launches held to the count the code
   implies, and prints its peak device memory.
15. the cluster (class ``_Phase15``, right after phase 13, on the main
   problem as a device-resident ``ArraySource`` of 128 tiles): 4 workers,
   a checkpoint every 8 tiles into a temporary directory.  The
   CountSketch's pass 1 with b riding along bitwise ``merge_all`` of the
   four range partials built on one thread and within 2·γ_m·|S||A| of the
   serial stream, one B1 fold a tile; a worker killed at its tenth tile
   recovered from its checkpoint (bitwise; B1 again for the tiles past the
   watermark only), restarted without checkpoints (bitwise), a duplicate
   submission dropped (bitwise); ``stream_lstsq`` ``saa``/``iterative`` and
   ``lstsq(A, b, gen, cluster=...)`` within 1e-5 and 100× ``qr_solve``'s
   error, the ``saa`` solve with the kill bitwise the clean one; a
   ``StreamingSolver`` (8 solves and a ``solve_many`` of 8) with its passes
   fed through the engine's counters; the SRHT at m = 2^18 bitwise the
   serial stream (peak memory), the Gaussian at m = 2^16 and the
   sparse-sign sketch within their bounds; the reference's acceptance demo
   at m = 2^16 (tiles of 2048 rows) from a ``.npy`` memmap (a kill, both certified answers
   passing and agreeing to 1e-9; a stalled worker evicted by its
   heartbeat).  It prints walls beside phase 13's serial streamed and
   in-memory ones, the heartbeat gaps and checkpoint times of a traced
   pass, the pass-2 poll floor, the engine's stats and B1's launches by
   part; after every part no worker thread or checkpoint directory is
   left.
16. the distributed solve (class ``_Phase16``, right after phase 15 on the
   main problem): ``sketched_lstsq`` over a world of one NCCL rank, then
   four gloo processes sharing the card (each given its 2^18-row block of
   A by CUDA IPC; the kernels they launch were built here): every scatter
   kind's solve bitwise on every rank and gated as phase 3, its assembled
   SA within 2·γ·|S||A| of the monolithic B1 apply, ``sharded_sketch`` of
   every additive kind (B1; B6 for the dense kinds at m = 2^16) against
   the monolithic apply of the same S, the SRHT refused, and one
   compressed all-reduce step (``sketched_psum_grads``) on llama3.2-1b's
   tied embedding and one layer's seven matrices, gated as the
   reference's test gates it, rank 0's B1 sketch of the embedding bitwise
   its plain version on the CPU.  Launches a rank are held exactly; walls
   and the bytes each rank hands to ``all_reduce`` and ``broadcast`` are
   printed; every process started is joined or terminated.
17. the LM substrate (class ``_Phase17``, last, after phase 14, with every
   other buffer and process freed): llama3.2-1b at full width from the
   port's ``configs.get_config``, seeded random weights.  ``lm_serve``:
   ``generate`` (prefill + greedy decode) on 8 prompts of 2048 tokens, 64
   new tokens, against a teacher-forced ``forward``; in f32 on 4 prompts
   ``prefill`` and one ``decode_step`` against ``forward`` to 2e-3.
   ``lm_train``: 12 steps of ``train_loop`` (bf16, f32 master, seq 512,
   batch 8, ``n_micro`` 2), the loss falling; at depth 2 in f32 the
   micro-batch equivalence and exact resume through the checkpoint store.
   ``lm_dp_nccl_p1``: ``make_dp_train_step`` over a world of one NCCL rank,
   compressed (B1 once per large gradient, 8 a step, the embedding's
   sketch bitwise its CPU plain version) and not.  ``lm_dp_gloo_p4``: four
   gloo ranks on the card at depth 2, parameters bitwise on every rank
   after every step.  The `countsketch_apply` row gains `lm_launches`.
18. the LM families (class ``_Phase18``, last): mixtral-8x7b (MoE, 4 of 32
   periods), deepseek-v2-236b (MLA + MoE with shared experts, its dense
   prefix + 2 of 59 periods), mamba2-2.7b (SSD, all 64 layers),
   recurrentgemma-9b (RG-LRU + local MQA, all 38 layers) and
   llama-3.2-vision-11b (cross-attention, all 40 layers) at their
   published widths from ``configs.get_config``, one at a time, seeded bf16
   weights.  Each serves 8 prompts of 2048 tokens and 32 new tokens
   (``generate``; the vision model through ``prefill`` +
   ``decode_step(img=)`` with 1600 patch embeddings a prompt), prefill and
   decode timed apart, the MoE models at capacity factor 1.25 with the
   dropped share printed and two prefills bitwise equal; the greedy tokens
   against a teacher-forced ``forward`` (phase 17's bf16 rule at positions
   routed alike, its ceiling raised to twice the bf16 forward's distance
   from the f32 forward where that is larger, both read where decode and
   the bf16 and f32 forwards all route alike; MoE at the drop-free 8.0); in
   f32 at one period, 16 cached ``decode_step``s
   against ``forward`` to 2e-3; 5 steps of ``train_loop`` (deepseek: one
   ``loss_fn`` forward and backward), the loss falling.  No port kernel is
   launched on any of these paths, which is held.
19. the mesh (class ``_Phase19``, last): eight gloo ranks sharing the card
   on a (2, 4) ``("data", "model")`` mesh, each drawing the weights a leaf
   at a time and keeping its blocks.  ``lm_mesh_2x4``: llama3.2-1b at full
   width, 4 of its 16 layers, 3 steps of ``jit_train_step`` (FSDP × TP), each rank's
   state at most 1/8 of the whole plus what the rules leave unsplit over
   ``model``, step 1 against the one-process
   step; ``lm_mesh_gates``: depth 2 in f32 against it (m, v, parameters
   after 3 steps); ``moe_mesh_2x4``: mixtral's expert-parallel MoE at its
   published widths (f32 forward within 1e-4 of the global dispatch, 3
   train steps at 1.25); ``elastic_2x4_to_2x2``: the state saved from 2×4
   and restored by a world of 4 onto (2, 2), bitwise, and the next step;
   ``lm_mesh_serve_2x4``: llama3.2-1b at 4 layers served on the same
   mesh (8 prompts of 2048 tokens, 4 new), each rank 1/8 of the KV cache
   exactly, the logits teacher-forced on the one-process greedy tokens
   (phase 17's bf16 rule), depth 2 in f32 against the one-process run
   under a fixed limit that the fault (one model rank's positions left
   out of the combine) exceeds, and ``launch.dryrun`` run beside it on the
   CPU: its bytes by kind equal to the ranks' counts for this cell and for
   ``lm_mesh_2x4``, its peaks within 25%; ``families_tp_2x4`` (first in
   the world of 8): deepseek-v2, mamba2, recurrentgemma and the vision model
   tensor-parallel at their published widths, bf16 serving and one train
   step against one process, an f32 prefill against its computed fault;
   ``zero1_2x2x2``: llama3.2-1b at depth 2 with ZeRO-1 over ``pod`` on a
   (2, 2, 2) mesh, 3 steps against one process.  No port kernel is
   launched on the mesh path, which is held.

Phase 2 also holds B8 (``hadamard_transform``, ``srht_apply``) bitwise
against its plain version on the card and on the CPU, in f64 and f32 and on
half inputs (f32 out), at one, two and three passes and at n not a multiple
of the panel width, checks that other panel widths, an unaligned A and a
second call give the same bits and that rows out of range give NaN rows,
the coordinate scatter at its edges (an empty column and bucket, repeated
coordinates, nnz = 0, a sparse vector b, each with the entries shuffled and
in row order), and B1 bitwise
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
card.  It holds B6 and B7 on bf16 and f16 inputs, the half engine
(``csrc/half_mma.cuh``), at that engine's edges (ragged d, m and n, m and
n not multiples of 8, n = 2..9, both sides of a split-plan change, grids
padded to whole clusters, operands off 16-byte alignment), within
2·γ_m·|S||A| with γ at f32, two calls bitwise equal, B7's B bitwise B6's
and its G exactly symmetric.  Phases 7 and 8 print each kernel's TFLOP/s and its share of its
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
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

M_MAIN, N_MAIN = 2**20, 1000
COND, BETA = 1e10, 1e-10
# The dense sketches cost 2·d·m·n operations per apply, m/n times a
# CountSketch apply's reads: their paths run at m = 2^16, a point of the
# paper's own m sweep at n = 1000 (PERF.md, section 4).
M_DENSE = 2**16
# 32-bit operations to generate one Gaussian in csrc/threefry.cuh: threefry2x32
# (20 rounds of add, rotate and xor, 5 key injections of 2 adds, 3 to set up:
# 73 integer operations) and Box–Muller (2 shifts, 2 conversions, 3 products
# and sums, the accurate logf, sqrtf and cosf at about 15 each, 2 products:
# about 54 f32 operations).  An estimate from the source, not a count of the
# compiled instructions.
GAUSS_OPS = 127
# Largest gap, in f32 ulps, allowed between the Gaussians the kernels
# generate and those of the plain versions (on the card and on the CPU).
# The plain version on the CPU is within 3 ulps of the reference's.
ULP_BOUND = 3


def _p(*args):
    print(*args, flush=True)


def _rel(x, y):
    return float((x - y).norm() / y.norm())


def _max_rel(x, y):
    """max|x − y| / max|y|."""
    return float((x - y).abs().max() / y.abs().max())


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
    operations at the FP64 peak, or ``nbytes`` at the HBM rate (the port's
    one formula, ``repro_torch.kernels.autotune.bound``)."""
    from repro_torch.kernels.autotune import bound

    return bound(ops, nbytes)


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


def _product_gate(torch, out, S, A, step, tile, shortcut=None):
    """Phase 8's hold of a product on half or f32 inputs at the main path's
    shape, where 2·γ_m·|S||A| (≈ 1.4 typical |SA| entries at m = 2^16) is
    too wide to see a fault: ``out`` against the f64 product of the same
    inputs, entry by entry and normwise, each relative to |S||A|, within
    √m·u (u at f32, 1.5e-5 at m = 2^16).  The same readings are taken of two
    faults planted on ``out``: the reduction's first ``step`` rows left out
    of one block tile (``tile`` = its rows and columns), and one stage in
    16 left out of every tile.  Raises unless the sound readings are within
    the limit and each fault's entrywise reading is past it; returns the
    readings.  ``shortcut``, a third fault (f32: the product as one TF32
    product would give it), is read and reported but not held: at this
    size it may read within the limit, and phase 2's exact probe is what
    catches it."""
    m = A.shape[0]
    S64, A64 = S.to(torch.float64), A.to(torch.float64)
    sound = out.to(torch.float64) - S64 @ A64
    mag = (S64.abs() @ A64.abs()).clamp_min(torch.finfo(torch.float64).tiny)  # 0/0 reads 0
    norm = float(torch.linalg.norm(mag))
    limit = math.sqrt(m) * torch.finfo(torch.float32).eps / 2

    def reading(delta):
        return {"entry": float((delta.abs() / mag).max()), "norm": float(torch.linalg.norm(delta)) / norm}

    rows, cols = tile
    one_stage = sound.clone()
    one_stage[:rows, :cols] -= S64[:rows, :step] @ A64[:step, :cols]
    every_16th = (torch.arange(m, device=A.device) // step) % 16 == 15
    got = {"limit": limit, "sound": reading(sound), "stage_left_out": reading(one_stage),
           "sixteenth_left_out": reading(sound - S64[:, every_16th] @ A64[every_16th])}
    del one_stage
    if shortcut is not None:
        got["one_tf32"] = reading(shortcut - S64 @ A64)
    if not max(got["sound"].values()) <= limit:  # a NaN reading fails too
        raise AssertionError(f"{out.dtype} product at S{tuple(S.shape)}: past √m·u of the f64 product: {got}")
    if not min(got["stage_left_out"]["entry"], got["sixteenth_left_out"]["entry"]) > limit:
        raise AssertionError(f"{out.dtype} product at S{tuple(S.shape)}: a planted fault reads within √m·u: {got}")
    return got



def _one_tf32(torch, X, Y):
    """X·Y as one TF32 product would give it, with exact sums: X and Y
    rounded to TF32 (the big parts of ``tf32_split``), the product in f64.
    The shortcut the f32 engines must not take; its readings stand beside
    theirs."""
    from repro_torch.kernels.common import tf32_split

    return tf32_split(X)[0].double() @ tf32_split(Y)[0].double()


def _tf32_probe(torch, dev, gen, sketch_matmul, matmul_gram, panel_gram):
    """The exact probe of the f32 engines: an S with one ±1 a row gives ±rows
    of A, whose random full 24-bit significands the three TF32 products keep
    within 2^-20·|A| (at most about 2^-22: A's rounded split) and one TF32
    product does not (up to 2^-11); an A with one ±1 a column gives ±columns
    of S, kept within 2^-20·|S| (at most about 2^-21: S's truncated split,
    its big part S's own word as the tensor cores read it); a B with one
    full-mantissa nonzero a row has a Gram whose off-diagonal is exactly 0
    and whose diagonal is each column's sum of squares, held within 2^-20
    of the f64 sums.  Raises unless the engines' readings are within 2^-20
    and one TF32 product's past it; returns the readings."""
    limit = 2.0**-20
    m, n, d = 4096, 256, 512
    A = torch.randn((m, n), generator=gen, dtype=torch.float64, device=dev).float()
    rows = torch.randint(0, m, (d,), generator=gen, device=dev)
    sign = (torch.randint(0, 2, (d,), generator=gen, device=dev) * 2 - 1).float()
    S = torch.zeros((d, m), device=dev)
    S[torch.arange(d, device=dev), rows] = sign
    want, scale = sign[:, None].double() * A[rows].double(), A[rows].abs().double()
    reading = lambda got: float(((got.double() - want).abs() / scale).max())  # noqa: E731
    got = {"selection_b6": reading(sketch_matmul(S, A)), "selection_b7": reading(matmul_gram(S, A)[0]),
           "selection_one_tf32": reading(_one_tf32(torch, S, A))}
    d, n = 256, 300
    S = torch.randn((d, m), generator=gen, dtype=torch.float64, device=dev).float()
    cols = torch.randint(0, m, (n,), generator=gen, device=dev)
    sign = (torch.randint(0, 2, (n,), generator=gen, device=dev) * 2 - 1).float()
    A = torch.zeros((m, n), device=dev)
    A[cols, torch.arange(n, device=dev)] = sign
    want, scale = S[:, cols].double() * sign[None, :].double(), S[:, cols].abs().double()
    got.update(columns_b6=reading(sketch_matmul(S, A)), columns_b7=reading(matmul_gram(S, A)[0]),
               columns_one_tf32=reading(_one_tf32(torch, S, A)))
    s_rows, cols_n = 4000, 300
    cols = torch.randint(0, cols_n, (s_rows,), generator=gen, device=dev)
    vals = torch.randn(s_rows, generator=gen, dtype=torch.float64, device=dev).float()
    B = torch.zeros((s_rows, cols_n), device=dev)
    B[torch.arange(s_rows, device=dev), cols] = vals
    sums = torch.zeros(cols_n, dtype=torch.float64, device=dev).index_add_(0, cols, vals.double() ** 2)
    G = panel_gram(B)
    diag = lambda g: float(((g.diagonal().double() - sums).abs() / sums).max())  # noqa: E731
    off = G - torch.diag(G.diagonal())
    got.update(gram_diagonal=diag(G), gram_off_diagonal_max=float(off.abs().max()),
               gram_diagonal_one_tf32=diag(_one_tf32(torch, B.T, B)), limit=limit)
    if not (max(got["selection_b6"], got["selection_b7"], got["columns_b6"], got["columns_b7"],
                got["gram_diagonal"]) <= limit and got["gram_off_diagonal_max"] == 0 and torch.equal(G, G.T)):
        raise AssertionError(f"the f32 engines read past 2^-20 on the exact probe: {got}")
    if not min(got["selection_one_tf32"], got["columns_one_tf32"], got["gram_diagonal_one_tf32"]) > limit:
        raise AssertionError(f"one TF32 product reads within the probe's limit: {got}")
    return got


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
    t_phase2 = time.perf_counter()
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

    # B6 and B7 on bf16 and f16 inputs run on the half engine
    # (csrc/half_mma.cuh): wgmma with f32 accumulators, operands by TMA in
    # thread-block clusters of 2.  Its edges: d and n not multiples of its
    # 256 x 128 tile, m not a multiple of its 64-row stage (nor of 16), n
    # not a multiple of 8 (a padded copy of A; S too where m is not), n =
    # 2..9, m shorter than a stage, both sides of a change of its split
    # plan, a grid padded to whole clusters (3 and 5 n-tiles), operands 2
    # bytes past a 16-byte boundary.  Each call within 2·γ_m·|S||A| of the
    # plain product with γ at f32 (the products of half inputs are exact in
    # f32), two calls bitwise equal, B7's B bitwise B6's and its G exactly
    # symmetric.  The inputs come from a generator of their own, so the
    # draws of every later phase (and the passes of its iterative solves)
    # do not depend on these checks.
    gen_half = torch.Generator(device=dev).manual_seed(2)
    half_shapes = [(300, 1007, 130), (37, 5, 3), (200, 9, 17), (257, 4096, 257), (129, 300, 640)]
    half_shapes += [(100, 300, n) for n in range(2, 10)]
    half_shapes += [(300, m, 130) for m in plan_edge(
        lambda m: sketch_split(torch.bfloat16, 300, m, 130, sms).parts, 4000)]
    for dtype in (torch.bfloat16, torch.float16):
        for d, m, n in half_shapes + [("misaligned", 504, 40)]:
            if d == "misaligned":
                d = 77
                S = torch.randn(d * m + 1, generator=gen_half, dtype=torch.float64, device=dev).to(dtype)[1:].view(d, m)
                A = torch.randn(m * n + 1, generator=gen_half, dtype=torch.float64, device=dev).to(dtype)[1:].view(m, n)
            else:
                S = torch.randn((d, m), generator=gen_half, dtype=torch.float64, device=dev).to(dtype)
                A = torch.randn((m, n), generator=gen_half, dtype=torch.float64, device=dev).to(dtype)
            out = sketch_matmul(S, A)
            err6 = check_product(f"B6 half engine {dtype} S({d}, {m}) A({m}, {n})", out,
                                 sketch_matmul_ref(S, A), S, A, m)
            if not torch.equal(out, sketch_matmul(S, A)):
                raise AssertionError(f"B6 half engine {dtype} S({d}, {m}) A({m}, {n}): two calls differ")
            errs["sketch_matmul"] = max(errs["sketch_matmul"], err6)
            B, G = matmul_gram(S, A)
            if not torch.equal(B, out):
                raise AssertionError(f"B7 half engine {dtype} S({d}, {m}) A({m}, {n}): B differs from B6's")
            errs["matmul_gram"] = max(errs["matmul_gram"], _check_gram(torch, G, panel_gram_ref(B), B, "B7 G"))
            split = sketch_split(dtype, d, m, n, sms)
            _p(f"phase 2: B6 half engine S({d}, {m}) A({m}, {n}) {str(dtype)[6:]}"
               f"{' misaligned' if S.data_ptr() % 16 else ''}, split (slab, parts) {split[:2]}: max|Δ| vs card "
               f"plain {err6:.3e} (tol 2γ_m|S||A|, γ at f32); two calls bitwise equal; B7's B bitwise B6's, "
               f"its G exactly symmetric")

    # B6 and B7 in f32 run on the split-TF32 engine (csrc/tf32_mma.cuh):
    # A^T's two parts written by a split kernel, then wgmma TF32 with both
    # operands K-major from shared memory, S's small part written beside its
    # tile each stage, operands by TMA in clusters of 2; the f32 Gram of B2,
    # B3, B5 and B7 on mma.sync TF32.  Its edges: d and n ragged (d = 1, n =
    # 2..9), m shorter than its 32-row stage, m not a multiple of 4 (S's
    # padded copy), both sides of a split-plan change, padded cluster grids,
    # operands 4 bytes past a 16-byte boundary, an inf and a NaN in A; the
    # Gram at ragged s and n (s = 1 and 2 too, where 2·γ_s leaves about an
    # ulp) and both sides of its plan's change.  Each within 2·γ_m·|S||A|
    # (γ at f32), two calls bitwise equal, B7's B bitwise B6's and its G
    # exactly symmetric.  Then the exact probe, which separates the split
    # products from one TF32 product.  A generator of its own.
    gen_f32 = torch.Generator(device=dev).manual_seed(3)
    f32_shapes = [(300, 1007, 130), (37, 20, 3), (200, 9, 17), (257, 4096, 257), (129, 300, 640), (1, 300, 2)]
    f32_shapes += [(100, 300, n) for n in range(2, 10)]
    f32_shapes += [(300, m, 130) for m in plan_edge(
        lambda m: sketch_split(torch.float32, 300, m, 130, sms).parts, 4000)]
    for d, m, n in f32_shapes + [("misaligned", 502, 41)]:
        if d == "misaligned":
            d = 77
            S = torch.randn(d * m + 1, generator=gen_f32, dtype=torch.float64, device=dev).float()[1:].view(d, m)
            A = torch.randn(m * n + 1, generator=gen_f32, dtype=torch.float64, device=dev).float()[1:].view(m, n)
        else:
            S = torch.randn((d, m), generator=gen_f32, dtype=torch.float64, device=dev).float()
            A = torch.randn((m, n), generator=gen_f32, dtype=torch.float64, device=dev).float()
        out = sketch_matmul(S, A)
        err6 = check_product(f"B6 f32 engine S({d}, {m}) A({m}, {n})", out, sketch_matmul_ref(S, A), S, A, m)
        if not torch.equal(out, sketch_matmul(S, A)):
            raise AssertionError(f"B6 f32 engine S({d}, {m}) A({m}, {n}): two calls differ")
        errs["sketch_matmul"] = max(errs["sketch_matmul"], err6)
        B, G = matmul_gram(S, A)
        if not torch.equal(B, out):
            raise AssertionError(f"B7 f32 engine S({d}, {m}) A({m}, {n}): B differs from B6's")
        errs["matmul_gram"] = max(errs["matmul_gram"], _check_gram(torch, G, panel_gram_ref(B), B, "B7 f32 G"))
        _p(f"phase 2: B6 f32 engine S({d}, {m}) A({m}, {n}){' misaligned' if S.data_ptr() % 16 else ''}, split "
           f"(slab, parts) {sketch_split(torch.float32, d, m, n, sms)[:2]}: max|Δ| vs card plain {err6:.3e} (tol "
           f"2γ_m|S||A|); two calls bitwise equal; B7's B bitwise B6's, its G exactly symmetric")
    S = torch.randn((64, 200), generator=gen_f32, device=dev)
    A = torch.randn((200, 40), generator=gen_f32, device=dev)
    A[7, 3], A[9, 4] = float("inf"), float("nan")
    out, plain = sketch_matmul(S, A), sketch_matmul_ref(S, A)
    B, _ = matmul_gram(S, A)
    finite, infinite = plain.isfinite(), plain.isinf()
    if not (torch.equal(out.isnan(), plain.isnan()) and torch.equal(out[infinite], plain[infinite])
            and torch.equal(B.nan_to_num(), out.nan_to_num()) and bool(plain[:, 3].isinf().all())):
        raise AssertionError("B6/B7 f32 engine with an inf and a NaN in A: not the plain version's inf and NaN")
    check_product("B6 f32 engine, the finite columns", out[:, finite.all(0)], plain[:, finite.all(0)], S,
                  A[:, finite.all(0)], 200)
    _p("phase 2: B6/B7 f32 engine with an inf and a NaN in A: the plain version's ±inf and NaN entries, its "
       "finite columns within 2γ_m|S||A|")
    gram_f32 = [(4000, 130), (1007, 777), (3, 5), (9, 70), (333, 1), (31, 64), (33, 65), (1, 130), (2, 65)]
    gram_f32 += [(300, n) for n in range(2, 9)]
    gram_f32 += [(s_rows, n) for n, start in ((130, 500), (1000, 4000)) for s_rows in plan_edge(
        lambda s_rows: gram_split(torch.float32, s_rows, n, sms).parts, start)]
    for s_rows, n in gram_f32 + [("misaligned", 65)]:
        if s_rows == "misaligned":
            s_rows = 1001
            B = torch.randn(s_rows * n + 1, generator=gen_f32, dtype=torch.float64, device=dev).float()[1:].view(s_rows, n)
        else:
            B = torch.randn((s_rows, n), generator=gen_f32, dtype=torch.float64, device=dev).float()
        G = panel_gram(B)
        err = _check_gram(torch, G, panel_gram_ref(B), B, f"B2 f32 engine B({s_rows}, {n})")
        if not torch.equal(G, panel_gram(B)):
            raise AssertionError(f"B2 f32 engine B({s_rows}, {n}): two calls differ")
        errs["panel_gram"] = max(errs["panel_gram"], err)
        _p(f"phase 2: B2 f32 engine B({s_rows}, {n}){' misaligned' if B.data_ptr() % 16 else ''}, split (slab, "
           f"parts) {gram_split(torch.float32, s_rows, n, sms)[:2]}: max|Δ| vs card plain {err:.3e} (tol "
           f"2γ_s|B|ᵀ|B|), exactly symmetric, two calls bitwise equal")
    probe = _tf32_probe(torch, dev, gen_f32, sketch_matmul, matmul_gram, panel_gram)
    _p(f"phase 2: the exact probe (limit 2^-20; one TF32 product of the same inputs beside it): {json.dumps(probe)}")

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
    _p(f"phase 2: {time.perf_counter() - t_phase2:.1f} s")
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

    # ---- phase 13: streaming, on the main problem before it is freed ------
    phase13 = _Phase13(torch, dev, gen, smi, run_path, paths, root)
    _, t13 = _sync_time(torch, lambda: phase13.main_problem(A, b, x_true, e_qr, phase12.x_ridge))
    errs["fused_gaussian_sketch"] = max(errs["fused_gaussian_sketch"], phase13.err_col0)
    _p(f"phase 13: {t13:.1f} s")

    # ---- phase 15: the cluster, on the main problem before it is freed -----
    phase15 = _Phase15(torch, dev, gen, smi, run_path, paths, root, phase13)
    _, t15 = _sync_time(torch, lambda: phase15.main_problem(A, b, x_true, e_qr))
    _p(f"phase 15: {t15:.1f} s")

    # ---- phase 16: the distributed solve, on the main problem before it is freed
    phase16 = _Phase16(torch, dev, smi, run_path, paths, root)
    _, t16 = _sync_time(torch, lambda: phase16.main_problem(A, b, x_true, e_qr, t_saa))
    _p(f"phase 16: {t16:.1f} s")
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
    del ab8, out, plain, err, tol, S  # S: the last row's S_u (2.1 GB), or it outlives the phase
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
    # B4's vector route on b: b read once and S·b written, and the d·m
    # Gaussians it generates (GAUSS_OPS 32-bit operations each) at the f32
    # rate outside the tensor cores, beside the 2·d·m f64 operations
    from repro_torch.kernels.autotune import PEAK_BYTES_PER_S, PEAK_FLOPS

    vec_ops = GAUSS_OPS * d8 * M_DENSE
    t_dense["fused_gaussian_sketch"]["vec_bound_ms"] = max(
        (M_DENSE + d8) * 8 / PEAK_BYTES_PER_S, vec_ops / PEAK_FLOPS["float32"], 2 * d8 * M_DENSE / PEAK_FLOPS["float64"]
    ) * 1e3
    t_dense["fused_gaussian_sketch"]["vec_bound_by"] = "operations"
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
    # B6 and B7 on bf16, f16 and f32 inputs at the same shapes (S_u and A8
    # rounded to the dtype): half inputs on the half engine
    # (csrc/half_mma.cuh), f32 on the split-TF32 engine (csrc/tf32_mma.cuh),
    # the f32 Gram of either on B2's split-TF32 engine.  Each held as phase 2
    # holds them (γ at f32) and by _product_gate against the f64 product
    # (its limit between the sound reading and two planted faults'; on f32
    # one TF32 product beside them), then bf16 and f32 timed beside the
    # plain version, the bound (kernels/autotune.py: the product at 989
    # TFLOP/s on bf16, three TF32 products at 495 on f32; B7's Gram six
    # TF32 products) and one library call, S @ A in the dtype (bf16 in,
    # bf16 out; f32 in full f32: allow_tf32 is printed).
    from repro_torch.kernels.autotune import PEAK_BYTES_PER_S, peak, work
    from repro_torch.kernels.common import (
        HALF_MMA_COLS, HALF_MMA_ROWS, HALF_MMA_STEP, TF32_MMA_COLS, TF32_MMA_ROWS, TF32_MMA_STEP,
    )

    t_half, gates, t0_half = {}, {}, time.perf_counter()
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        S_x, A_x = S_u.to(dtype), A8.to(dtype)
        name = str(dtype).removeprefix("torch.")
        out6 = sketch_matmul(S_x, A_x)
        err6 = check_product(f"B6 {name} at A(2^16, 1000) d=4000", out6, sketch_matmul_ref(S_x, A_x), S_x, A_x,
                             M_DENSE)
        # the engine's stage and block tile
        f32 = dtype == torch.float32
        step, tile = ((TF32_MMA_STEP, (TF32_MMA_ROWS, TF32_MMA_COLS)) if f32
                      else (HALF_MMA_STEP, (HALF_MMA_ROWS, HALF_MMA_COLS)))
        gates[name] = _product_gate(torch, out6, S_x, A_x, step, tile, _one_tf32(torch, S_x, A_x) if f32 else None)
        B, G = matmul_gram(S_x, A_x)
        if not torch.equal(B, out6) or not torch.equal(out6, sketch_matmul(S_x, A_x)):
            raise AssertionError(f"B6/B7 {name} at A(2^16, 1000): two calls, or B7's B, differ from B6's")
        err7 = _check_gram(torch, G, panel_gram_ref(B), B, f"B7 {name} G at A(2^16, 1000)")
        errs["sketch_matmul"] = max(errs["sketch_matmul"], err6)
        errs["matmul_gram"] = max(errs["matmul_gram"], err7)
        del out6, B, G
        if dtype == torch.float16:
            del S_x, A_x
            continue
        # the product on A's dtype's units, B7's f32 Gram on the TF32 ones
        # (its f32 B read once, G written once); B7's time on its operations
        # is the sum of the two halves'
        ops6, bytes6 = work("sketch_matmul", M_DENSE, N_MAIN, d8, dtype)
        ops_g32, _ = work("tsqr", M_DENSE, N_MAIN, d8, torch.float32)
        t_ops6 = ops6 / PEAK_FLOPS[peak("sketch_matmul", dtype)]
        t_ops7 = t_ops6 + ops_g32 / PEAK_FLOPS[peak("tsqr", torch.float32)]
        rows_t = {}
        for kname, fn, plain, library, ops, t_ops, nbytes in [
            ("sketch_matmul", lambda: sketch_matmul(S_x, A_x), lambda: sketch_matmul_ref(S_x, A_x),
             lambda: S_x @ A_x, ops6, t_ops6, bytes6),
            ("matmul_gram", lambda: matmul_gram(S_x, A_x), lambda: matmul_gram_ref(S_x, A_x), None,
             ops6 + ops_g32, t_ops7, bytes6 + N_MAIN * N_MAIN * 4),
        ]:
            t_bytes = nbytes / PEAK_BYTES_PER_S
            rows_t[kname] = _rates(dict(
                ms=_event_ms(torch, fn), plain_ms=_event_ms(torch, plain),
                library_ms=None if library is None else _event_ms(torch, library),
                bound_ms=max(t_ops, t_bytes) * 1e3, bound_by="operations" if t_ops >= t_bytes else "bytes",
            ), ops)
        t_half[name] = rows_t
        del S_x, A_x
    _p(f"phase 8: B6 at A(2^16, 1000) d=4000 against the f64 product of the same inputs, max |Δ|/(|S||A|) "
       f"entrywise and ‖Δ‖/‖|S||A|‖ normwise, within √m·u(f32), beside two planted faults (one stage left out of "
       f"one tile: 64 rows of a 256 x 128 tile on half inputs, 32 of a 128 x 128 tile on f32; one stage in 16 left out of every tile; "
       f"on f32 one TF32 product of the same inputs, read, not held): {json.dumps(gates)}")
    _p(f"phase 8: B6/B7 on bf16 (half engine) and f32 (split-TF32 engine) inputs at A(2^16, 1000) d=4000 (ms, "
       f"TFLOP/s counting the TF32 engines' products, three a product for B6 and six for the Gram, share of the "
       f"bound; library: S @ A in the dtype, "
       f"allow_tf32 {torch.backends.cuda.matmul.allow_tf32}; card: {smi}): "
       f"{json.dumps(t_half)}; checked and timed in {time.perf_counter() - t0_half:.1f} s")
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

    # The f32 uniform-dense solve: the solvers work in A's dtype, so an f32
    # A runs B6 (and, fused, B7) on the split-TF32 engine, b on the vector
    # kernel.  κ = 1e3, A and b rounded to f32 from the f64 problem; each
    # route within 10× qr_solve's error on the same f32 data, with no
    # fallback and no iteration-limit stop.  A generator of its own, so no
    # later draw moves.
    gen32 = torch.Generator(device=dev).manual_seed(30)
    p32 = generate_problem(gen32, M_DENSE, N_MAIN, cond=1e3, beta=BETA, device=dev)
    A32, b32, x32 = p32.A.float(), p32.b.float(), p32.x_true
    del p32
    e_qr32 = _rel(qr_solve(A32, b32).double(), x32)
    for name, kw, kernel in [("uniform_dense_f32", {}, "sketch_matmul"),
                             ("uniform_dense_f32_fused", dict(fused=True), "matmul_gram")]:
        call = lambda: lstsq(A32, b32, gen32, method="saa", sketch="uniform_dense", **kw)  # noqa: E731
        res32 = run_path(name, call)
        e32 = _rel(res32.x.double(), x32)
        _p(f"phase 8: lstsq(A f32, sketch='uniform_dense'{', fused=True' if kw else ''}) cond=1e3 m=2^16: itn "
           f"{int(res32.itn)} istop {int(res32.istop)} used_fallback {bool(res32.used_fallback)} x {res32.x.dtype} "
           f"rel.err {e32:.3e}; qr_solve (f32) rel.err {e_qr32:.3e}; launches {paths[name]}")
        if not e32 <= 10 * e_qr32 or bool(res32.used_fallback) or int(res32.istop) == 7:
            raise AssertionError(f"{name}: rel.err {e32} against qr_solve's {e_qr32}, or a fallback or limit stop")
        if paths[name][kernel] < (1 if kw else 2) or paths[name]["sketch_matmul"] < 1:
            raise AssertionError(f"{name} path did not launch its kernels: {paths[name]}")
        _, walls[name] = _sync_time(torch, call)
    _, op32, B32 = SketchedFactor.build_full(A32, gen32, sketch="uniform_dense")
    if not torch.equal(B32, sketch_matmul(op32.S, A32)) or B32.dtype != torch.float32:
        raise AssertionError("the f32 solve did not feed f32 to B6")
    _p(f"phase 8: f32 solves: B bitwise B6 on the f32 A; warm walls (s) {walls['uniform_dense_f32']:.4f} "
       f"unfused, {walls['uniform_dense_f32_fused']:.4f} fused")
    del A32, b32, x32, res32, op32, B32
    torch.cuda.empty_cache()

    # ---- phase 14: serving, last, on problems of its own -------------------
    phase14 = _Phase14(torch, dev, smi, paths)
    _, t14 = _sync_time(torch, phase14.run)
    _p(f"phase 14: {t14:.1f} s")
    torch.cuda.empty_cache()

    # ---- phase 17: the LM substrate, last, once everything else is freed ---
    phase17 = _Phase17(torch, dev, smi, root)
    _, t17 = _sync_time(torch, phase17.run)
    _p(f"phase 17: {t17:.1f} s")

    # ---- phase 18: the LM families at their published widths, last -----------
    phase18 = _Phase18(torch, dev, smi)
    _, t18 = _sync_time(torch, phase18.run)
    _p(f"phase 18: {t18:.1f} s")

    # ---- phase 19: the mesh, last ----------------------------------------------
    phase19 = _Phase19(torch, dev, smi, root)
    _, t19 = _sync_time(torch, phase19.run)
    _p(f"phase 19: {t19:.1f} s")

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
        if name == "countsketch_apply":  # phase 14's serving parts and phase 15's cluster parts
            rows[-1]["serve_launches"] = {part: v["launches"] for part, v in phase14.b1.items()}
            rows[-1]["cluster_launches"] = dict(phase15.b1)
        if name in ("sketch_matmul", "matmul_gram"):  # bf16 (the half engine) and f32, phase 8
            # launches a solve: B6 on bf16 in the mixed uniform-dense solve,
            # on f32 in the f32 solve; B7 on f32 in the fused f32 solve; no
            # solve of the script takes B7 on bf16
            by_path = {("bfloat16", "sketch_matmul"): "uniform_dense_mixed",
                       ("float32", "sketch_matmul"): "uniform_dense_f32",
                       ("float32", "matmul_gram"): "uniform_dense_f32_fused"}
            rows[-1]["by_dtype"] = {dt: dict(t_half[dt][name], launches=paths[by_path[dt, name]][name]
                                             if (dt, name) in by_path else 0) for dt in t_half}
        if name in ("countsketch_apply", "sketch_matmul"):  # phase 16's parts, a rank each
            rows[-1]["dist_launches"] = {part: v[name] for part, v in phase16.launches.items() if name in v}
        if name == "countsketch_apply":  # phase 17's compressed train steps, a step (and a rank)
            rows[-1]["lm_launches"] = {part: v[name] for part, v in phase17.launches.items() if name in v}
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
                               bound_ms_per_pair=_bound(0, 2 * m * n * A.element_size())[0])
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
    from repro_torch.kernels import countsketch_coo_apply, countsketch_coo_ref
    from repro_torch.kernels.countsketch.ref import coo_keys

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
    K = int(torch.bincount(coo_keys(rows, cols, n, h), minlength=d * n).max()) if vals.numel() else 0
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


def _by_row(torch, rows, *rest):
    """The same entries in row order, each row's in their given order (a
    stable sort by row: the order a coalesced COO or a CSR holds)."""
    order = torch.sort(rows, stable=True).indices
    return (rows[order],) + tuple(t[order] for t in rest)


def _coo_edges(torch, dev, gen):
    """Phase 2's checks of the coordinate scatter at its edges, for each
    bucket kind in f64 and f32, on the entries shuffled (its plan by
    product) and in row order (its plan by row): an empty column and an
    empty bucket, repeated coordinates, nnz = 0 and a sparse vector b.
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
            k = h.numel() // m
            vec_rows = torch.randperm(m, generator=gen, device=dev)[: m // 3]  # a sparse b
            vec_vals = torch.randn(vec_rows.numel(), generator=gen, dtype=torch.float64, device=dev).to(dtype)
            for order, (r, c, v, vr, vv) in (
                ("shuffled", (rows, cols, vals, vec_rows, vec_vals)),
                ("in row order", _by_row(torch, rows, cols, vals) + _by_row(torch, vec_rows, vec_vals)),
            ):
                out, err = _coo_check(torch, r, c, v, (m, n), h, w, d, f"{kind} {dtype} edges {order}")
                if bool(out.reshape(d, n)[3].any()) or bool(out.reshape(d, n)[:, 5].any()):
                    raise AssertionError(f"coordinate scatter {kind} {dtype} {order}: an empty bucket or column "
                                         f"is not 0")
                worst = max(worst, err)
                empty = r[:0]
                out0, _ = _coo_check(torch, empty, empty, v[:0], (m, n), h, w, d, f"{kind} {dtype} nnz=0")
                if bool(out0.any()):
                    raise AssertionError(f"coordinate scatter {kind} {dtype}: nnz = 0 is not all 0")
                _, err = _coo_check(torch, vr, torch.zeros_like(vr), vv, (m,), h, w, d,
                                    f"{kind} {dtype} vector {order}")
                worst = max(worst, err)
            _p(f"phase 2: coordinate scatter {kind} (k = {k}) {str(dtype)[6:]} A({m}, {n}) d={d}: "
               f"{rows.numel()} entries with {dup.numel()} repeated coordinates, shuffled and in row order, an "
               f"empty column and an empty bucket, nnz = 0, a sparse vector b: bitwise = CPU plain, two calls "
               f"bitwise; max|Δ| vs card plain {worst:.3e}")
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
        """The coordinate scatter at the sparse problem's entries, d = 4000,
        in f64 and f32, for each bucket kind in row order (as the problem
        holds them: the plan by row, B1's bucket CSR of the sketch and a row
        pointer over the entries) and for the sparse sign's (k = 8) also
        shuffled (the plan by product, a stable sort of the products by
        bucket).  Its times in f64 beside its plan, bound, plain version
        and index_add_; the kernel row of the kernels line is the
        CountSketch's in row order, the sparse solves' case."""
        from repro_torch.kernels import countsketch_coo_apply, countsketch_coo_plan, countsketch_coo_ref
        from repro_torch.kernels.autotune import bound
        from repro_torch.kernels.countsketch import coo_rowptr, countsketch_csr
        from repro_torch.kernels.countsketch.ref import coo_keys

        torch, gen, dev = self.torch, self.gen, self.dev
        m, n = shape
        d = 4 * n
        shuffle = torch.randperm(rows.numel(), generator=gen, device=dev)
        forms = {"by_row": (rows, cols, vals), "shuffled": (rows[shuffle], cols[shuffle], vals[shuffle])}
        times = {}
        for kind in ("clarkson_woodruff", "uniform_sparse", "sparse_sign"):
            h, w = _coo_sketch(torch, gen, dev, kind, m, d)
            k = h.numel() // m
            for form, (r, c, v) in forms.items():
                # shuffled entries checked for one kind, the sparse sign's
                # k = 8 (phase 2 holds every kind in both orders at its edges)
                for dtype in (torch.float64, torch.float32) if form == "by_row" or k == 8 else ():
                    _, err = _coo_check(torch, r, c, v.to(dtype), shape, h, w, d, f"{kind} {dtype} A{shape} {form}")
                    self.err_coo = max(self.err_coo, err)
                    _p(f"phase 12: coordinate scatter {kind} (k = {k}) {str(dtype)[6:]} A{shape} nnz={r.numel()} "
                       f"d={d} {form}: bitwise = CPU plain, two calls bitwise; max|Δ| vs card plain {err:.3e}")
                if kind == "uniform_sparse":
                    continue  # timed for k = 1 (the CountSketch) and k = 8
                build = lambda: countsketch_coo_plan(r, h, w, d, v.dtype)  # noqa: E731
                plan = build()
                if (plan.rowptr is not None) != (form == "by_row"):
                    raise AssertionError(f"coordinate scatter {form}: took the other plan")
                keys = coo_keys(r, c, n, h)
                prods = (w.reshape(k, m)[:, r] * v).reshape(-1)
                out_lib = torch.zeros(d * n, dtype=v.dtype, device=dev)
                t = dict(
                    ms=_event_ms(torch, lambda: countsketch_coo_apply(r, c, v, shape, h, w, d, plan=plan)),
                    plan_ms=_event_ms(torch, build),
                    plain_ms=_event_ms(torch, lambda: countsketch_coo_ref(r, c, v, shape, h, w, d)),
                    library_ms=_event_ms(torch, lambda: out_lib.zero_().index_add_(0, keys, prods)),
                )
                if form == "by_row":  # the plan's parts: the sketch's CSR, the entries' row pointer
                    t["csr_ms"] = _event_ms(torch, lambda: countsketch_csr(h, w, d, v.dtype))
                    t["rowptr_ms"] = _event_ms(torch, lambda: coo_rowptr(r, m))
                # each input read once (the entries' rows, columns and values;
                # the sketch's int32 buckets and f64 weights), the d·n cells
                # written once; a multiply and an add a product
                t["bound_ms"], t["bound_by"] = bound(2 * k * r.numel(), r.numel() * 24 + k * m * 12 + d * n * 8)
                times[f"k{k}_{form}"] = t
                del plan, keys, prods, out_lib
        _p(f"phase 12: coordinate scatter times at A{shape} nnz={rows.numel()} d={d} f64 (ms; ms = the wrapper "
           f"on a plan built beforehand, its checks included; plan = countsketch_coo_plan, by row B1's CSR + the "
           f"row pointer (csr_ms, rowptr_ms), shuffled the stable sort by bucket; library = one index_add_ of the "
           f"precomputed products, atomic; card: {self.smi}): {json.dumps(times)}")
        self.t_coo = times["k1_by_row"]

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
        _, t_kernel = _sync_time(torch, lambda: self.kernel(rows, cols, vals, (m, n)))
        _p(f"phase 12: the coordinate scatter's checks and times took {t_kernel:.1f} s")
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
        x_ridge = self.x_ridge = X[:, 0].clone()
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


class _NoPlain:
    """Within ``with``: the plain versions the streaming path could reach,
    torch's (atomic, on CUDA) ``index_add_`` and a device-wide
    ``torch.cuda.synchronize`` raise when they are reached with a CUDA
    tensor — so a streamed run that passes through here went through the
    kernels only, and its host staging waited on copy events alone."""

    PLAIN = (
        ("repro_torch.core.sketch", "gaussian_cols_ref"),
        ("repro_torch.core.sketch", "countsketch_ref"),
        ("repro_torch.core.sketch", "srht_ref"),
        ("repro_torch.kernels.sketch_matmul.ops", "fused_gaussian_ref"),
        ("repro_torch.kernels.countsketch.ops", "countsketch_ref"),
        ("repro_torch.kernels.countsketch.ops", "countsketch_fold_ref"),
        ("repro_torch.kernels.sketch_matmul.ops", "sketch_matmul_ref"),
        ("repro_torch.kernels.srht.ops", "srht_ref"),
        ("repro_torch.streaming.accumulate", "countsketch_fold_ref"),
        ("repro_torch.streaming.accumulate", "srht_ref"),
    )

    def __init__(self, torch):
        self.torch = torch

    def __enter__(self):
        import importlib

        torch = self.torch
        self.saved = []

        def guard(name, real):
            def guarded(*args, **kw):
                if any(isinstance(a, torch.Tensor) and a.is_cuda for a in args):
                    raise AssertionError(f"the streaming path reached {name} on the card")
                return real(*args, **kw)
            return guarded

        for mod_name, attr in self.PLAIN:
            mod = importlib.import_module(mod_name)
            real = getattr(mod, attr)
            self.saved.append((mod, attr, real))
            setattr(mod, attr, guard(f"{mod_name}.{attr}", real))
        real_add = torch.Tensor.index_add_
        self.saved.append((torch.Tensor, "index_add_", real_add))
        torch.Tensor.index_add_ = guard("index_add_", real_add)

        def no_sync(*a, **kw):
            raise AssertionError("the streaming path synchronized the device")

        self.saved.append((torch.cuda, "synchronize", torch.cuda.synchronize))
        torch.cuda.synchronize = no_sync
        return self

    def __exit__(self, *exc):
        for obj, attr, real in reversed(self.saved):
            setattr(obj, attr, real)
        return False


class _Phase13:
    """Phase 13: streaming (``repro_torch.streaming``) on the card.

    (a) pass 1 on a device-resident ``ArraySource`` of the main problem:
    the CountSketch, uniform-sparse and SRHT streamed B over the default
    tiling and an uneven ``boundaries=`` tiling bitwise the monolithic
    B1/B8 apply on the same S, two passes bitwise equal; the sparse-sign B
    bitwise the CPU plain streamed fold of the same tiles and within
    2·γ_K·|S||A| of the monolithic k·m-entry B1 route; B1's fold mode
    bitwise the CPU plain fold; pass-1, fold and monolithic times against
    their bounds.  (b) B4 with ``col0`` at m = 2^16, tile by tile, against
    ``gaussian_matrix_ref(col_offset=…)`` times the tile, its ``col0 = 0``
    launch bitwise B4's whole-A entry, and the streamed Gaussian and
    uniform-dense B against the monolithic B4/B6.  (c) ``stream_lstsq``
    (``saa``, ``iterative``, ``sketch_and_solve``, ``reg=1e-8``,
    ``certify=True``) on the device source, each beside the in-memory
    ``lstsq`` from the same generator seed.  (d) a numpy ``ArraySource``
    (the pinned stager) and (e) a ``MemmapSource`` at m = 2^18, each bitwise
    the device-resident run.  (f) a ``StreamingSolver`` serving 8 solves
    and a ``solve_many`` of 8.  The streamed runs go through ``_NoPlain``;
    ``run_path`` counts launches as for phase 10."""

    SEED = 1301
    LAM = 1e-8
    K_SOLVES = 8
    TILE = 8192  # the sources' tile rows (DEFAULT_TILE_ROWS)
    MEMMAP_ROWS = 2**18

    def __init__(self, torch, dev, gen, smi, run_path, paths, root):
        self.torch, self.dev, self.gen, self.smi = torch, dev, gen, smi
        self.run_path, self.paths, self.root = run_path, paths, root
        self.walls, self.peaks, self.times = {}, {}, {}
        self.err_fold = self.err_col0 = 0.0

    def seeded(self):
        return self.torch.Generator(device=self.dev).manual_seed(self.SEED)

    def run(self, name, fn, reps=3):
        """One counted run (through ``_NoPlain``) with its peak memory above
        the inputs, then the median warm wall of ``reps`` (none for 0)."""
        torch = self.torch
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()

        def guarded():
            with _NoPlain(torch):
                return fn()

        res = self.run_path(name, guarded)
        self.peaks[name] = (torch.cuda.max_memory_allocated() - base) / 2**30
        if reps:
            self.walls[name] = sorted(_sync_time(torch, fn)[1] for _ in range(reps))[reps // 2]
        return res

    def main_problem(self, A, b, x_true, e_qr, x_ridge):
        self.pass1(A)
        self.gaussian(A)
        self.solves(A, b, x_true, e_qr, x_ridge)
        self.host(A, b)
        self.session(A, b, x_true)
        self.memmap()
        _p(f"phase 13: peaks above the inputs (GiB): {json.dumps(self.peaks)}")
        _p(f"phase 13: median warm walls of 3, device-resident source (s): {json.dumps(self.walls)}")

    # ---- (a) -----------------------------------------------------------------
    def pass1(self, A):
        from repro_torch.core import SparseSignSketch
        from repro_torch.core import sketch as sketch_lib
        from repro_torch.kernels import countsketch_apply, countsketch_csr, countsketch_fold_ref
        from repro_torch.streaming import ArraySource, accumulate_source

        torch, gen, dev = self.torch, self.gen, self.dev
        m, n = A.shape
        d = 4 * n
        T = self.TILE
        src = ArraySource(A, tile_rows=T)
        cuts = torch.randint(1, m, (200,), generator=gen, device=dev).tolist()
        uneven = ArraySource(A, boundaries=cuts + [1, 2, 3, T + 1])  # single-row tiles too
        tiles = src.num_tiles
        cols = A[:, :16].contiguous()  # the fold is column by column: the CPU checks 16
        cols_cpu = cols.cpu()
        report = {}
        for kind in ("countsketch", "uniform_sparse", "srht", "sparse_sign"):
            op = sketch_lib.sample(kind, gen, d, m, device=dev)

            def stream(s=src, op=op):
                return accumulate_source(op, s).finalize()

            B, t_first = _sync_time(torch, lambda: self.run(f"stream_pass1_{kind}", stream, reps=0))
            again, B_u = stream(), stream(uneven)
            launches = self.paths[f"stream_pass1_{kind}"]
            if not (torch.equal(B, again) and torch.equal(B_u.cpu(), B.cpu())):
                raise AssertionError(f"stream pass 1 {kind}: two passes, or two tilings, differ")
            mono = op.apply(A)
            # ms: a pass with the tiles' CSRs cached (a re-stream); first_ms the
            # counted first pass, which builds them (host clock)
            t = dict(ms=_event_ms(torch, stream), first_ms=t_first * 1e3,
                     mono_ms=_event_ms(torch, lambda: op.apply(A)))
            if kind == "srht":
                # A read and placed once (the state written), B8 over the state
                nbytes = 2 * op.m_pad * n * 8 + op.m_pad * n * 8 + d * n * 8
                if not (torch.equal(B, mono) and launches["srht_apply"] >= 1
                        and launches["countsketch_apply"] == 0):
                    raise AssertionError(f"stream pass 1 srht: not bitwise B8's apply; {launches}")
                err = 0.0
            else:
                k = op.k if isinstance(op, SparseSignSketch) else 1
                rows = k * d
                nbytes = m * n * 8
                for o in range(0, m, src.tile_rows):
                    h = op._csr[("stream", o, min(src.tile_rows, m - o), A.dtype, "auto")][0]
                    live = int(torch.unique(h).numel())  # buckets the tile has an entry in
                    nbytes += 2 * live * n * 8 + h.numel() * 12 + (rows + 1) * 8
                # the CPU plain fold of the same tiles, 16 columns
                op_cpu = type(op)(**{f.name: (getattr(op, f.name).cpu() if torch.is_tensor(getattr(op, f.name))
                                              else getattr(op, f.name))
                                     for f in op.__dataclass_fields__.values() if f.init and f.name != "_csr"})
                B_cpu = accumulate_source(op_cpu, ArraySource(cols_cpu, tile_rows=T)).finalize()
                B_cols = accumulate_source(op, ArraySource(cols, tile_rows=T)).finalize()
                if not (torch.equal(B_cols.cpu(), B_cpu) and torch.equal(B[:, :16].cpu(), B_cpu)):
                    raise AssertionError(f"stream pass 1 {kind}: B1's fold is not bitwise the CPU plain fold")
                if launches["countsketch_apply"] != tiles:
                    raise AssertionError(f"stream pass 1 {kind}: {launches} (one B1 fold a tile: {tiles})")
                if k == 1:
                    if not torch.equal(B, mono):
                        raise AssertionError(f"stream pass 1 {kind}: not bitwise B1's apply")
                    err = 0.0
                else:
                    # another order of the same sums (ROADMAP §B item 1): within
                    # 2·γ_K·|S||A|, K the most entries of a bucket
                    K = int(op.csr(A.dtype).offsets.diff().max())
                    op_abs = SparseSignSketch(buckets=op.buckets, signs=op.signs.abs(), d=d, m=m, k=k)
                    err = 0.0
                    for c0 in range(0, n, 125):
                        mag = op_abs.apply(A[:, c0:c0 + 125].abs())
                        gap = (B[:, c0:c0 + 125] - mono[:, c0:c0 + 125]).abs()
                        if not bool((gap <= 2 * _gamma(torch, K, A.dtype) * mag).all()):
                            raise AssertionError(f"stream pass 1 sparse_sign: {float(gap.max())} off B1's apply")
                        err = max(err, float(gap.max()))
                        del mag, gap
                self.err_fold = max(self.err_fold, err)
                if kind == "countsketch":
                    # one fold launch on one tile, its CSR cached
                    h, w, dd, csr = op._csr[("stream", T, T, A.dtype, "auto")]
                    tile, state = A[T:2 * T], B.clone()
                    live = int(torch.unique(h).numel())
                    prods = w[:, None] * tile
                    f = dict(ms=_event_ms(torch, lambda: countsketch_apply(tile, h, w, dd, csr=csr, out=state)),
                             plain_ms=_event_ms(torch, lambda: countsketch_fold_ref(state, tile, h, w)),
                             library_ms=_event_ms(torch, lambda: state.index_add_(0, h, prods)),
                             csr_ms=_event_ms(torch, lambda: countsketch_csr(h, w, dd, A.dtype)))
                    del prods
                    f["bound_ms"], f["bound_by"] = _bound(2 * T * n, T * n * 8 + 2 * live * n * 8
                                                          + T * 12 + (d + 1) * 8)
                    self.times["fold_tile"] = f
            t["bound_ms"], t["bound_by"] = _bound(0, nbytes)
            t["max_abs_err_vs_mono"] = err
            report[kind] = t
            del B, again, B_u, mono, op
            torch.cuda.empty_cache()
        self.times["pass1"] = report
        _p(f"phase 13: pass 1 from a device-resident ArraySource A({m}, {n}) d={d}, {tiles} tiles of "
           f"{src.tile_rows} rows and {uneven.num_tiles} uneven ones: countsketch, uniform_sparse, srht bitwise "
           f"the monolithic B1/B8 apply over both tilings; two passes bitwise; B1's fold bitwise the CPU plain "
           f"fold (16 columns); sparse_sign bitwise the CPU plain streamed fold, max|Δ| from the k·m-entry B1 "
           f"route {report['sparse_sign']['max_abs_err_vs_mono']:.3e}")
        _p(f"phase 13: pass-1 times (ms; mono = the one-call apply; bound = A once, each tile's live state "
           f"read and written, its CSR; card: {self.smi}): {json.dumps(report)}")
        _p(f"phase 13: B1 fold of one tile ({T}, {n}) into the (d, n) state, CSR cached (ms; plain = "
           f"countsketch_fold_ref on the card; library = one index_add_ of the precomputed products, atomic; "
           f"csr = the tile's set-up): {json.dumps(self.times['fold_tile'])}")

    # ---- (b) -----------------------------------------------------------------
    def gaussian(self, A):
        from repro_torch.core import GaussianSketch, UniformDenseSketch
        from repro_torch.kernels import (
            fused_gaussian_sketch,
            gaussian_matrix_ref,
            key_to_u32,
            sketch_matmul,
        )
        from repro_torch.kernels.sketch_matmul import default_scale
        from repro_torch.streaming import ArraySource, accumulate_source

        torch, gen, dev = self.torch, self.gen, self.dev
        m, n = M_DENSE, A.shape[1]
        d, T = 4 * n, self.TILE
        A16 = A[:m]
        key = key_to_u32(gen)
        # the generated columns: col0 far out in the counter space
        for c0 in (2**20 - 700, 3 * 10**9):
            G = fused_gaussian_sketch(torch.eye(700, dtype=torch.float32, device=dev), key, 300, scale=1.0, col0=c0)
            u_card = _ulps(torch, G, gaussian_matrix_ref(*key, 300, 700, col_offset=c0, device=dev))
            u_cpu = _ulps(torch, G, gaussian_matrix_ref(*key, 300, 700, col_offset=c0))
            G64 = fused_gaussian_sketch(torch.eye(700, dtype=torch.float64, device=dev), key, 300, scale=1.0, col0=c0)
            e7 = torch.zeros(700, dtype=torch.float32, device=dev)
            e7[7] = 1
            Gv = fused_gaussian_sketch(e7, key, 300, scale=1.0, col0=c0)
            if max(u_card, u_cpu) > ULP_BOUND or not (torch.equal(G64, G.double()) and torch.equal(Gv, G[:, 7])):
                raise AssertionError(f"B4 col0={c0}: {u_card}/{u_cpu} ulps, or the f64/vector routes differ")
        scale = default_scale(d)
        worst = 0.0
        for o in range(0, m, T):
            tile = A16[o:o + T]
            out = fused_gaussian_sketch(tile, key, d, col0=o)
            S = (gaussian_matrix_ref(*key, d, T, col_offset=o, device=dev) * scale).to(torch.float64)
            gap = (out - S @ tile).abs()
            # the sums' rounding, and the kernel's Gaussians within ULP_BOUND f32 ulps of the plain ones
            tol = (2 * _gamma(torch, T, A.dtype) + ULP_BOUND * 2.0**-23) * (S.abs() @ tile.abs())
            if not bool((gap <= tol).all()):
                raise AssertionError(f"B4 col0={o}: {float(gap.max())} off the plain version")
            worst = max(worst, float(gap.max()))
            del out, S, gap, tol
        self.err_col0 = worst
        tile0, b16 = A16[:T], A16[:, 0].contiguous()
        zero = (torch.equal(fused_gaussian_sketch(tile0, key, d, col0=0), fused_gaussian_sketch(tile0, key, d))
                and torch.equal(fused_gaussian_sketch(b16, key, d, col0=0), fused_gaussian_sketch(b16, key, d)))
        if not zero:
            raise AssertionError("B4's col0 = 0 launch is not bitwise its whole-A entry")
        tile1 = A16[T:2 * T]
        S1 = (gaussian_matrix_ref(*key, d, T, col_offset=T, device=dev) * scale).to(torch.float64)
        c = dict(ms=_event_ms(torch, lambda: fused_gaussian_sketch(tile1, key, d, col0=T)),
                 plain_ms=_event_ms(torch, lambda: (gaussian_matrix_ref(*key, d, T, col_offset=T, device=dev)
                                                   * scale).to(torch.float64) @ tile1),
                 library_ms=_event_ms(torch, lambda: S1 @ tile1))  # the product half alone
        c["bound_ms"], c["bound_by"] = _bound(2 * d * T * n, T * n * 8 + d * n * 8)
        self.times["col0_tile"] = c
        del S1
        # the streamed dense kinds against their monolithic kernels
        dense = {}
        for kind, op in (("gaussian", GaussianSketch(S=None, key=key, d=d, m=m, dev=dev)),
                         ("uniform_dense", UniformDenseSketch.sample(gen, d, m, device=dev))):
            src = ArraySource(A16, tile_rows=T)
            B = self.run(f"stream_{kind}", lambda op=op: accumulate_source(op, src).finalize(), reps=0)
            mono = op.apply(A16)
            S_abs = (op.as_dense() if kind == "gaussian" else op.S).abs()
            gap = (B - mono).abs()
            if not bool((gap <= 2 * _gamma(torch, m, A.dtype) * (S_abs @ A16.abs())).all()):
                raise AssertionError(f"streamed {kind}: {float(gap.max())} off the monolithic apply")
            kern = "fused_gaussian_sketch" if kind == "gaussian" else "sketch_matmul"
            launched = self.paths[f"stream_{kind}"][kern]
            if launched != (m // T if kind == "gaussian" else 0):
                raise AssertionError(f"streamed {kind}: {self.paths[f'stream_{kind}']}")
            dense[kind] = dict(max_abs_err=float(gap.max()), ms=_event_ms(torch, lambda op=op: accumulate_source(
                op, src).finalize()), mono_ms=_event_ms(torch, lambda op=op: op.apply(A16)),
                launches=self.paths[f"stream_{kind}"])
            del B, mono, S_abs, gap
        self.times["dense"] = dense
        torch.cuda.empty_cache()
        _p(f"phase 13: B4 with col0 at A({m}, {n}) d={d}, {m // T} tiles of {T}: within (2·γ_t + "
           f"{ULP_BOUND} f32 ulps)·|S||A| of gaussian_matrix_ref(col_offset=…)·tile, max|Δ| {worst:.3e}; col0 = 0 "
           f"bitwise the whole-A entry (matrix and vector); generated columns at col0 = 2^20 − 700 and 3e9 "
           f"within {ULP_BOUND} ulps of the plain ones, f64 and vector routes bitwise the same G")
        _p(f"phase 13: B4 col0 on one tile ({T}, {n}) d={d} (ms; library = S @ tile on a pre-generated S; "
           f"card: {self.smi}): {json.dumps(c)}")
        _p(f"phase 13: streamed dense kinds at A({m}, {n}) against the monolithic B4/B6 (within "
           f"2·γ_m·|S||A|; ms): {json.dumps(dense)}")

    # ---- (c) -----------------------------------------------------------------
    def solves(self, A, b, x_true, e_qr, x_ridge):
        from repro_torch.core import SketchedFactor, lstsq, qr_solve
        from repro_torch.streaming import ArraySource, stream_lstsq

        torch = self.torch
        m, n = A.shape
        src = ArraySource(A, tile_rows=self.TILE)
        x_qr = qr_solve(A, b)
        bnorm = float(b.norm())
        g = self.seeded
        runs = [
            ("stream_saa", dict(method="saa"), lambda: lstsq(A, b, g(), method="saa")),
            ("stream_iterative", dict(method="iterative"), lambda: lstsq(A, b, g(), method="iterative")),
            ("stream_sketch_and_solve", dict(method="sketch_and_solve"), None),
            ("stream_ridge", dict(reg=self.LAM), lambda: lstsq(A, b, g(), reg=self.LAM)),
            ("stream_certified", dict(certify=True), lambda: lstsq(A, b, g(), accuracy="certified")),
        ]
        self.results = {}
        rows = {}
        for name, kw, in_memory in runs:
            res = self.run(name, lambda kw=kw: stream_lstsq(src, b, g(), **kw))
            self.results[name] = res
            if in_memory is None:  # the monolithic sketch-and-solve on the same S
                factor, op = SketchedFactor.build(A, g())
                x_mem = factor.sketch_and_solve(op.apply(b))
                t_mem = sorted(_sync_time(torch, lambda: SketchedFactor.build(A, g()))[1] for _ in range(3))[1]
            else:
                x_mem = in_memory().x
                t_mem = sorted(_sync_time(torch, in_memory)[1] for _ in range(3))[1]
            gap = _rel(res.x, x_mem)
            e = _rel(res.x, x_true if name != "stream_ridge" else x_ridge)
            row = dict(itn=int(res.itn), istop=int(res.istop), err=e, qr_err=e_qr, vs_in_memory=gap,
                       wall=self.walls[name], in_memory_wall=t_mem, peak_gib=self.peaks[name],
                       b1_launches=self.paths[name]["countsketch_apply"])
            if name == "stream_sketch_and_solve":
                # one pass; not forward stable (its error is O(ε·κ·‖r‖/‖A‖‖x‖)):
                # held to the monolithic sketch-and-solve on the same S
                ok = gap <= 1e-12 and math.isnan(float(res.rnorm))
            elif name == "stream_ridge":
                ok = e < 1e-5 and float(res.arnorm) <= 1e-8 * bnorm
                row["arnorm_over_b"] = float(res.arnorm) / bnorm
            else:
                bound = 10 if name == "stream_iterative" else 100
                ok = e < 1e-5 and e <= bound * max(e_qr, 1e-12)
            if name == "stream_certified":
                cert = res.certificate
                row.update(passed=bool(cert.passed), error_bound=float(cert.error_bound),
                           gap_to_qr=float((res.x - x_qr).norm()))
                ok = ok and bool(cert.passed) and row["gap_to_qr"] <= 10 * row["error_bound"]
            ok = ok and row["b1_launches"] == src.num_tiles  # pass 1 only: b rides along
            rows[name] = row
            _p(f"phase 13: {name}: {json.dumps(row)} (card: {self.smi})")
            if not ok:
                raise AssertionError(f"{name}: {row}")
        self.times["solves"] = rows

    # ---- (d) -----------------------------------------------------------------
    def host(self, A, b):
        from repro_torch.streaming import ArraySource, device_tiles, stream_lstsq
        from repro_torch.streaming.solve import _CountingSource

        torch = self.torch
        m, n = A.shape
        A_np, t_d2h = _sync_time(torch, lambda: A.cpu().numpy())
        src = ArraySource(A_np, tile_rows=self.TILE)
        nbytes = m * n * 8

        def stage():
            for _ in device_tiles(src, self.dev):
                pass

        _, t_stage = _sync_time(torch, stage)
        # the two halves of staging apart, on one tile: the host's copy into
        # pinned memory, and the pinned → device copy
        T = self.TILE
        tile = torch.from_numpy(A_np[:T])
        pinned = torch.empty((T, n), dtype=A.dtype, pin_memory=True)
        on_dev = torch.empty((T, n), dtype=A.dtype, device=self.dev)
        t0 = time.perf_counter()
        for _ in range(8):
            pinned.copy_(tile)
        t_memcpy = (time.perf_counter() - t0) / 8
        t_h2d = _event_ms(torch, lambda: on_dev.copy_(pinned, non_blocking=True)) / 1e3
        rows = dict(d2h_s=t_d2h, staging_pass_s=t_stage, staging_gbps=nbytes / t_stage / 1e9,
                    host_memcpy_gbps=T * n * 8 / t_memcpy / 1e9, h2d_gbps=T * n * 8 / t_h2d / 1e9)
        del tile, pinned, on_dev
        for method in ("sketch_and_solve", "iterative"):
            name = f"stream_host_{method}"
            stats = {"passes": 0, "tiles": 0}
            counted = _CountingSource(src, stats)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = self.run(name, lambda: stream_lstsq(counted, b, self.seeded(), method=method), reps=0)
            wall = time.perf_counter() - t0
            same = torch.equal(res.x, self.results[f"stream_{method}"].x)
            rows[method] = dict(wall=wall, passes=stats["passes"], gbps=stats["passes"] * nbytes / wall / 1e9,
                                itn=int(res.itn), peak_gib=self.peaks[name],
                                bitwise_device_source=same)
            if not same:
                raise AssertionError(f"{name}: x is not bitwise the device-resident run's: {rows[method]}")
        del A_np, src
        self.times["host"] = rows
        _p(f"phase 13: host source (numpy A({m}, {n}), pinned staging, side copy stream; each run timed once "
           f"around its counted run; gbps = passes × {nbytes / 1e9:.2f} GB / wall; staging = one pass that only "
           f"stages; host_memcpy = the host's copy of one tile into pinned memory, h2d = its pinned → device copy; "
           f"card: {self.smi}): {json.dumps(rows)}")

    # ---- (e) -----------------------------------------------------------------
    def memmap(self):
        import tempfile

        import numpy as np

        from repro_torch.core import generate_problem, qr_solve
        from repro_torch.streaming import ArraySource, MemmapSource, stream_lstsq

        torch, gen, dev = self.torch, self.gen, self.dev
        m, n = self.MEMMAP_ROWS, N_MAIN
        p = generate_problem(gen, m, n, cond=COND, beta=BETA, device=dev)
        e_qr = _rel(qr_solve(p.A, p.b), p.x_true)
        (self.root / "build").mkdir(exist_ok=True)
        with tempfile.TemporaryDirectory(dir=self.root / "build") as tmp:
            path = Path(tmp) / "A.npy"
            _, t_save = _sync_time(torch, lambda: np.save(path, p.A.cpu().numpy()))
            src = MemmapSource(path, tile_rows=self.TILE)
            t0 = time.perf_counter()
            res = self.run("stream_memmap_saa", lambda: stream_lstsq(src, p.b, self.seeded(), method="saa"), reps=0)
            wall = time.perf_counter() - t0
        ref = stream_lstsq(ArraySource(p.A, tile_rows=self.TILE), p.b, self.seeded(), method="saa")
        e = _rel(res.x, p.x_true)
        row = dict(itn=int(res.itn), err=e, qr_err=e_qr, wall=wall, save_s=t_save,
                   bitwise_device_source=torch.equal(res.x, ref.x), peak_gib=self.peaks["stream_memmap_saa"])
        _p(f"phase 13: MemmapSource A({m}, {n}) (.npy in a temporary directory, removed; page-cached after the "
           f"save), saa once: {json.dumps(row)} (card: {self.smi})")
        if not (row["bitwise_device_source"] and e < 1e-5 and e <= 100 * max(e_qr, 1e-12)):
            raise AssertionError(f"memmap saa: {row}")
        self.times["memmap"] = row
        del p, res, ref
        torch.cuda.empty_cache()

    # ---- (f) -----------------------------------------------------------------
    def session(self, A, b, x_true):
        from repro_torch.streaming import ArraySource, StreamingSolver

        torch, gen, dev = self.torch, self.gen, self.dev
        m, n = A.shape
        k = self.K_SOLVES
        D = torch.randn(n, k, generator=gen, dtype=A.dtype, device=dev)
        B = b[:, None] + A @ D
        X_true = x_true[:, None] + D
        Qa, Ra = torch.linalg.qr(A)
        X_qr = torch.linalg.solve_triangular(Ra, Qa.T @ B, upper=True)
        del Qa, Ra
        torch.cuda.empty_cache()
        e_qrs = [_rel(X_qr[:, j], X_true[:, j]) for j in range(k)]
        src = ArraySource(A, tile_rows=self.TILE)
        t = {}

        def serve():
            s, t["build"] = _sync_time(torch, lambda: StreamingSolver(src, self.seeded()))
            out, walls = [], []
            for j in range(k):
                res, w = _sync_time(torch, lambda: s.solve(B[:, j]))
                out.append(res)
                walls.append(w)
            t["solve"] = sorted(walls)[k // 2]
            many, t["solve_many"] = _sync_time(torch, lambda: s.solve_many(B))
            return s, out, many

        s, singles, many = self.run_path("stream_session", serve)
        stats = dict(s.stats)
        cols = []
        for j in range(k):
            e1, e8 = _rel(singles[j].x, X_true[:, j]), _rel(many.x[:, j], X_true[:, j])
            cols.append(dict(solve_itn=int(singles[j].itn), solve_err=e1, many_itn=int(many.itn),
                             many_err=e8, qr_err=e_qrs[j]))
            ok = lambda e: e < 1e-5 and e <= 100 * max(e_qrs[j], 1e-12)  # noqa: E731
            if not (ok(e1) and ok(e8)):
                raise AssertionError(f"stream session column {j}: {cols[-1]}")
        launches = self.paths["stream_session"]
        _p(f"phase 13: StreamingSolver at A({m}, {n}): columns {json.dumps(cols)}")
        _p(f"phase 13: StreamingSolver stats {stats}; walls: build {t['build']:.4f} s, median solve "
           f"{t['solve']:.4f} s, solve_many (k = {k}) {t['solve_many']:.4f} s; launches {launches} "
           f"(card: {self.smi})")
        if {key: stats[key] for key in ("sketches", "qr_factorizations", "solves")} != \
                {"sketches": 1, "qr_factorizations": 1, "solves": 2 * k}:
            raise AssertionError(f"the streaming session sketched or factored more than once: {stats}")
        if launches["countsketch_apply"] != src.num_tiles * (k + 2):
            raise AssertionError(f"the streaming session's B1 folds: {launches} (a tile each for A, each b, B)")
        self.times["session"] = dict(stats=stats, **t)
        del singles, many, D, B, X_true, X_qr, s
        torch.cuda.empty_cache()

class _Phase15:
    """Phase 15: the cluster (``repro_torch.cluster``) on the card, on the
    main problem as a device-resident ``ArraySource`` of 128 tiles of 8192
    rows, 4 workers, a checkpoint every 8 tiles into a temporary directory
    (removed after).

    (1) pass 1 of the CountSketch with b riding along: B and c bitwise
    ``merge_all`` of the four range partials built on one thread, within
    2·γ_m·|S||A| of the serial streamed B, one B1 fold a tile; the walls
    with and without checkpoints beside the serial stream; a traced pass's
    longest heartbeat gap and checkpoint times; the pass-2 poll floor.
    (2) a worker killed at its tenth tile: one recovery, one restore, B and
    c bitwise the clean run's, B1 launched again for the tiles past the
    watermark only; the same kill without checkpoints (the range restarts);
    a duplicate submission dropped.  (3) ``stream_lstsq`` ``saa`` and
    ``iterative``, ``lstsq(A, b, gen, method="saa", cluster=...)`` on the
    card tensor, each within 1e-5 and 100× ``qr_solve``'s error; the ``saa``
    solve with the kill bitwise the clean solve; a ``StreamingSolver``
    serving 8 solves and a ``solve_many`` of 8 with its passes and tiles
    fed through the engine's counters.  (4) the SRHT at m = 2^18 (bitwise
    the serial stream), the Gaussian at m = 2^16 and the sparse-sign
    sketch on the main problem (within their regrouping bounds).  (5) the
    reference's acceptance demo at m = 2^16 in 32 tiles of 2048 rows (κ =
    1e6, β = 1e-4) from a ``.npy`` memmap: a kill with checkpoints every 3
    tiles, the sketch
    bitwise the clean run's, both certified answers passing and agreeing;
    a stalled worker evicted by its heartbeat.  (6) after every part no
    worker thread is alive and no checkpoint namespace or engine-made
    temporary directory is left.  Counted runs go through ``_NoPlain``."""

    SEED = 1501
    TILE = 8192  # the sources' tile rows (DEFAULT_TILE_ROWS)
    WORKERS = 4
    EVERY = 8  # tiles between checkpoints
    KILL = (1, 10)  # (worker, at_tile)
    M_SRHT = 2**18
    M_DEMO = 2**16  # at 2^18 the demo alone took 86 s on the H100; the phase aims at 90 s
    DEMO_TILE = 2048  # 32 tiles, 8 a worker, so the kill at tile 5 fires
    DEMO_EVERY = 3
    DEMO_KILL = (2, 5)
    DELAY_S, HEARTBEAT_S = 3.0, 0.5
    K_SOLVES = 8

    def __init__(self, torch, dev, gen, smi, run_path, paths, root, phase13):
        self.torch, self.dev, self.gen, self.smi = torch, dev, gen, smi
        self.run_path, self.paths, self.root, self.phase13 = run_path, paths, root, phase13
        self.b1, self.walls, self.times, self.stats = {}, {}, {}, {}

    def seeded(self):
        return self.torch.Generator(device=self.dev).manual_seed(self.SEED)

    def spec(self, name, **kw):
        from repro_torch.cluster import ClusterSpec

        kw.setdefault("checkpoint_every", self.EVERY)
        return ClusterSpec(num_workers=self.WORKERS, ckpt_dir=str(Path(self.ckpt_root) / name), **kw)

    def counted(self, name, fn, guard=True):
        """One run with every launch counted, through ``_NoPlain`` unless it
        times its own steps (as phase 13's session does); B1's kept."""
        torch = self.torch

        def guarded():
            with _NoPlain(torch):
                return fn()

        out = self.run_path(name, guarded if guard else fn)
        self.b1[name] = self.paths[name]["countsketch_apply"]
        return out

    def median(self, fn, reps=3):
        return sorted(_sync_time(self.torch, fn)[1] for _ in range(reps))[reps // 2]

    def teardown(self, part):
        """No worker thread alive (a zombie is given 30 s to wake into its
        closed engine), no namespace left in the part's checkpoint dir, no
        temporary dir an engine made."""
        import tempfile
        import threading

        deadline = time.monotonic() + 30
        for t in threading.enumerate():
            if t.name.startswith("repro-cluster-w"):
                t.join(timeout=max(0.0, deadline - time.monotonic()))
        alive = [t.name for t in threading.enumerate() if t.name.startswith("repro-cluster-w") and t.is_alive()]
        made = set(Path(tempfile.gettempdir()).glob("repro-cluster-*")) - self.tmp_before
        left = list(Path(self.ckpt_root).rglob("pass1-*"))
        if alive or made or left:
            raise AssertionError(f"phase 15 {part}: threads {alive}, temporary dirs {made}, namespaces {left}")

    def main_problem(self, A, b, x_true, e_qr):
        import shutil
        import tempfile

        (self.root / "build").mkdir(exist_ok=True)
        self.ckpt_root = tempfile.mkdtemp(prefix="phase15-", dir=self.root / "build")
        self.tmp_before = set(Path(tempfile.gettempdir()).glob("repro-cluster-*"))
        try:
            self.pass1(A, b)
            self.faults(A, b)
            self.solves(A, b, x_true, e_qr)
            self.session(A, b, x_true)
            self.kinds(A, b)
            self.demo()
        finally:
            shutil.rmtree(self.ckpt_root, ignore_errors=True)
            self.src = self.op = self.B = self.c = None  # the main A's source: freed with A
        _p(f"phase 15: B1 launches by part {json.dumps(self.b1)}")
        _p(f"phase 15: engine stats by part {json.dumps(self.stats)}")
        _p(f"phase 15: walls (s; card: {self.smi}) {json.dumps(self.walls)}")

    def _cluster_pass1(self, name, src, op, b, **kw):
        """One counted cluster pass 1 on a fresh engine → (B, c, stats, wall)."""
        from repro_torch.cluster import ClusterEngine
        from repro_torch.streaming import stream_sketch

        eng = ClusterEngine(src, self.spec(name, **kw))
        try:
            (B, _, c), wall = _sync_time(self.torch, lambda: self.counted(
                name, lambda: stream_sketch(eng, op=op, rhs=b)))
        finally:
            eng.close()
        self.stats[name] = dict(eng.stats)
        self.teardown(name)
        return B, c, dict(eng.stats), wall

    # ---- (1) -----------------------------------------------------------------
    def pass1(self, A, b):
        from repro_torch.cluster import ClusterEngine, RowRangeSource, partition_rows
        from repro_torch.core import CountSketch
        from repro_torch.core import sketch as sketch_lib
        from repro_torch.obs import trace as obs_trace
        from repro_torch.streaming import ArraySource, device_tiles, make_accumulator, merge_all, stream_sketch
        from repro_torch.streaming.solve import _stream_matvec, _stream_rmatvec

        torch, dev = self.torch, self.dev
        m, n = A.shape
        d, T = 4 * n, self.TILE
        src = ArraySource(A, tile_rows=T)
        tiles = src.num_tiles
        op = sketch_lib.sample("countsketch", self.gen, d, m, device=dev)
        self.src, self.op = src, op
        B, c, st, t_first = self._cluster_pass1("cluster_pass1", src, op, b)
        self.B, self.c = B, c
        ckpts = sum((r.tiles(T) - 1) // self.EVERY for r in partition_rows(m, self.WORKERS, T))
        if self.b1["cluster_pass1"] != tiles or st["tiles"] != tiles or st["checkpoints"] != ckpts:
            raise AssertionError(f"cluster pass 1: B1 {self.b1['cluster_pass1']} (one fold a tile: {tiles}); {st}")
        # the four range partials on this thread, merged in range order
        accs = []
        for r in partition_rows(m, self.WORKERS, T):
            acc = make_accumulator(op, n + 1, dtype=A.dtype)
            for o, tile in device_tiles(RowRangeSource(src, r.start, r.stop, tile_rows=T), dev):
                gl = r.start + o
                acc.update(torch.cat([tile, b[gl:gl + tile.shape[0], None]], dim=1), gl)
            accs.append(acc)
        Bc = merge_all(accs).finalize()
        if not (torch.equal(B, Bc[:, :n]) and torch.equal(c, Bc[:, n])):
            raise AssertionError("cluster pass 1: B, c not bitwise merge_all of the range partials")
        del accs, Bc
        # the serial stream: the same sums, grouped by range
        Bs, _, cs = stream_sketch(src, op=op, rhs=b)
        op_abs = CountSketch(buckets=op.buckets, signs=op.signs.abs(), d=d, m=m)
        g = 2 * _gamma(torch, m, A.dtype)
        err = float((c - cs).abs().max())
        if not bool(((c - cs).abs() <= g * op_abs.apply(b.abs())).all()):
            raise AssertionError(f"cluster pass 1: c {err} off the serial stream")
        for c0 in range(0, n, 125):
            gap = (B[:, c0:c0 + 125] - Bs[:, c0:c0 + 125]).abs()
            if not bool((gap <= g * op_abs.apply(A[:, c0:c0 + 125].abs())).all()):
                raise AssertionError(f"cluster pass 1: B {float(gap.max())} off the serial stream")
            err = max(err, float(gap.max()))
        self.err_serial = err
        # walls: with checkpoints, without, serial
        walls = {"first_counted": t_first}
        for name, kw in (("cluster", {}), ("cluster_no_ckpt", {"checkpoint_every": 0})):
            eng = ClusterEngine(src, self.spec(f"walls_{name}", **kw))
            walls[name] = self.median(lambda: stream_sketch(eng, op=op, rhs=b))
            eng.close()
        walls["serial"] = self.median(lambda: stream_sketch(src, op=op, rhs=b))
        self.teardown("pass1 walls")
        # a traced pass: heartbeat gaps and checkpoint times (host clock)
        eng = ClusterEngine(src, self.spec("traced"))
        with obs_trace.tracing() as tracer:
            mark = len(tracer.events)
            stream_sketch(eng, op=op, rhs=b)
            ev = tracer.timeline(mark).instants()
        eng.close()
        self.teardown("pass1 traced")
        last, gaps, ckpt = {}, [], []
        for e in sorted(ev, key=lambda e: e["ts"]):
            w = e["args"].get("worker")
            if e["name"] == "cluster.heartbeat":
                if w in last:
                    gaps.append((e["ts"] - last[w]) / 1e6)
                last[w] = e["ts"]
            elif e["name"] == "cluster.checkpoint":  # the gap to the next beat spans it
                ckpt.append((e["ts"] - last[w]) / 1e6)
        walls["heartbeat_gap_max"] = max(gaps)
        walls["heartbeat_gap_median"] = sorted(gaps)[len(gaps) // 2]
        walls["checkpoint_max"] = max(ckpt)
        walls["checkpoint_median"] = sorted(ckpt)[len(ckpt) // 2]
        # one checkpoint's parts apart, each the median of 3: the draw's
        # digest, the state's copy to the host, the atomic write of the file
        from repro_torch.cluster import op_digest
        from repro_torch.train import checkpoint as ckpt_lib

        state = make_accumulator(op, n + 1, dtype=A.dtype).state
        host = state.cpu().numpy()
        walls["checkpoint_digest"] = self.median(lambda: op_digest(op))
        walls["checkpoint_d2h"] = self.median(lambda: state.cpu())
        walls["checkpoint_write"] = self.median(lambda: ckpt_lib.save(
            str(Path(self.ckpt_root) / "write_probe"), 0, {"state": host}))
        del state, host
        # the poll floor: a pass-2 product through the pool, polled every
        # 10 ms (the default) and every 1 ms, beside the serial stream
        x, u = self.torch.ones(n, dtype=A.dtype, device=dev), b
        for name, kw in (("matvec_cluster", {}), ("matvec_cluster_poll_1ms", {"poll_interval": 0.001})):
            eng = ClusterEngine(src, self.spec(name, checkpoint_every=0, **kw))
            walls[name] = self.median(lambda: eng.matvec(x), 5)
            walls[name.replace("matvec", "rmatvec")] = self.median(lambda: eng.rmatvec(u), 5)
            eng.close()
        walls["matvec_serial"] = self.median(lambda: _stream_matvec(src, x), 5)
        walls["rmatvec_serial"] = self.median(lambda: _stream_rmatvec(src, u), 5)
        self.teardown("pass1 poll")
        self.walls["pass1"] = walls
        self.times["pass1"] = dict(max_abs_err_vs_serial=err, ckpt_bytes=d * (n + 1) * 8, checkpoints=len(ckpt))
        _p(f"phase 15: pass 1 (countsketch, b riding along) on {self.WORKERS} workers, {tiles} tiles of {T}: B, c "
           f"bitwise merge_all of the four range partials; max|Δ| from the serial stream {err:.3e} (within "
           f"2·γ_m·|S||A|); B1 launches {self.b1['cluster_pass1']}; stats {json.dumps(st)}")
        _p(f"phase 15: pass 1 walls (s; checkpoint every {self.EVERY} tiles, {d * (n + 1) * 8 / 1e6:.1f} MB each; "
           f"heartbeat gaps and checkpoint times from one traced pass; matvec/rmatvec: pass-2 products, median of "
           f"5; card: {self.smi}): {json.dumps(walls)}")
        del Bs, cs, op_abs

    # ---- (2) -----------------------------------------------------------------
    def faults(self, A, b):
        from repro_torch.cluster import DuplicateMerge, KillWorker

        src, op, tiles = self.src, self.op, self.src.num_tiles
        w, at = self.KILL
        again = at - (at // self.EVERY) * self.EVERY  # folds past the last watermark
        runs = (
            ("cluster_kill", dict(faults=[KillWorker(worker=w, at_tile=at)]),
             dict(recoveries=1, restores=1, reassignments=1), tiles + again),
            ("cluster_kill_restart", dict(faults=[KillWorker(worker=w, at_tile=at)], checkpoint_every=0),
             dict(recoveries=1, restores=0, checkpoints=0), tiles + at),
            ("cluster_duplicate", dict(faults=[DuplicateMerge(worker=0)]), dict(duplicates_dropped=1), tiles),
        )
        walls = {}
        for name, kw, want, launches in runs:
            B, c, st, walls[name] = self._cluster_pass1(name, src, op, b, **kw)
            got = {k: st[k] for k in want}
            same = self.torch.equal(B, self.B) and self.torch.equal(c, self.c)
            _p(f"phase 15: {name}: B, c bitwise the clean run's {same}; stats {json.dumps(st)}; B1 launches "
               f"{self.b1[name]} (expected {launches}); wall {walls[name]:.4f} s")
            if not (same and got == want and self.b1[name] == launches):
                raise AssertionError(f"phase 15 {name}: bitwise {same}, stats {got} (want {want}), B1 "
                                     f"{self.b1[name]} (want {launches})")
            del B, c
        self.walls["faults"] = walls

    # ---- (3) -----------------------------------------------------------------
    def solves(self, A, b, x_true, e_qr):
        from repro_torch.cluster import ClusterSpec, KillWorker
        from repro_torch.core import lstsq
        from repro_torch.streaming import DEFAULT_TILE_ROWS, stream_lstsq

        torch, src, g = self.torch, self.src, self.seeded
        tiles = src.num_tiles
        coerced = -(-A.shape[0] // DEFAULT_TILE_ROWS)  # lstsq's own tiling of a card tensor
        own = ClusterSpec(num_workers=self.WORKERS, checkpoint_every=self.EVERY)  # the engine makes its dir
        runs = (
            ("cluster_saa", "stream_saa", lambda: stream_lstsq(src, b, g(), method="saa",
                                                               cluster=self.spec("saa"))),
            ("cluster_iterative", "stream_iterative", lambda: stream_lstsq(src, b, g(), method="iterative",
                                                                           cluster=self.spec("iterative"))),
            ("cluster_lstsq_saa", "stream_saa", lambda: lstsq(A, b, g(), method="saa", cluster=own)),
        )
        rows, self.results = {}, {}
        p13 = self.phase13.times["solves"]
        for name, serial, fn in runs:
            res = self.counted(name, fn)
            self.teardown(name)
            wall = self.median(fn)
            self.teardown(name)
            e = _rel(res.x, x_true)
            row = dict(itn=int(res.itn), istop=int(res.istop), err=e, qr_err=e_qr, wall=wall,
                       serial_stream_wall=p13[serial]["wall"], in_memory_wall=p13[serial]["in_memory_wall"],
                       b1_launches=self.b1[name], method=res.method)
            rows[name] = row
            self.results[name] = res
            _p(f"phase 15: {name}: {json.dumps(row)} (card: {self.smi})")
            if not (e < 1e-5 and e <= 100 * max(e_qr, 1e-12)
                    and self.b1[name] == (coerced if name == "cluster_lstsq_saa" else tiles)):
                raise AssertionError(f"phase 15 {name}: {row}")
        w, at = self.KILL
        again = at - (at // self.EVERY) * self.EVERY
        res = self.counted("cluster_saa_kill", lambda: stream_lstsq(
            src, b, g(), method="saa", cluster=self.spec("saa_kill", faults=[KillWorker(worker=w, at_tile=at)])))
        self.teardown("cluster_saa_kill")
        same = torch.equal(res.x, self.results["cluster_saa"].x) and int(res.itn) == rows["cluster_saa"]["itn"]
        rows["cluster_saa_kill"] = dict(bitwise_clean=same, itn=int(res.itn), b1_launches=self.b1["cluster_saa_kill"])
        _p(f"phase 15: cluster_saa_kill (worker {w} killed at its tile {at}): x bitwise the clean cluster solve's "
           f"{same}; {json.dumps(rows['cluster_saa_kill'])}")
        if not (same and self.b1["cluster_saa_kill"] == tiles + again):
            raise AssertionError(f"phase 15 cluster_saa_kill: {rows['cluster_saa_kill']}")
        self.times["solves"] = rows
        self.walls["solves"] = {k: v["wall"] for k, v in rows.items() if "wall" in v}

    def session(self, A, b, x_true):
        from repro_torch.streaming import StreamingSolver

        torch, gen, dev, src = self.torch, self.gen, self.dev, self.src
        m, n = A.shape
        k = self.K_SOLVES
        D = torch.randn(n, k, generator=gen, dtype=A.dtype, device=dev)
        Bm = b[:, None] + A @ D
        X_true = x_true[:, None] + D
        Qa, Ra = torch.linalg.qr(A)
        X_qr = torch.linalg.solve_triangular(Ra, Qa.T @ Bm, upper=True)
        del Qa, Ra
        torch.cuda.empty_cache()
        e_qrs = [_rel(X_qr[:, j], X_true[:, j]) for j in range(k)]
        t = {}

        def serve():
            s, t["build"] = _sync_time(torch, lambda: StreamingSolver(src, self.seeded(), cluster=self.spec("session")))
            try:
                out, walls = [], []
                for j in range(k):
                    res, wj = _sync_time(torch, lambda: s.solve(Bm[:, j]))
                    out.append(res)
                    walls.append(wj)
                t["solve"] = sorted(walls)[k // 2]
                many, t["solve_many"] = _sync_time(torch, lambda: s.solve_many(Bm))
                return dict(s.stats), out, many
            finally:
                s.close()

        stats, singles, many = self.counted("cluster_session", serve, guard=False)
        self.teardown("cluster_session")
        cols = []
        for j in range(k):
            e1, e8 = _rel(singles[j].x, X_true[:, j]), _rel(many.x[:, j], X_true[:, j])
            cols.append(dict(solve_itn=int(singles[j].itn), solve_err=e1, many_err=e8, qr_err=e_qrs[j]))
            if not all(e < 1e-5 and e <= 100 * max(e_qrs[j], 1e-12) for e in (e1, e8)):
                raise AssertionError(f"phase 15 cluster session column {j}: {cols[-1]}")
        passes = 1 + sum(3 + 2 * int(r.itn) for r in singles) + 3 + 2 * int(many.itn)
        want = dict(sketches=1, qr_factorizations=1, solves=2 * k, passes=passes, tiles=passes * src.num_tiles)
        _p(f"phase 15: StreamingSolver(cluster=...) at A({m}, {n}): columns {json.dumps(cols)}")
        _p(f"phase 15: StreamingSolver stats {stats} (expected {want}: the sketch pass, then 3 + 2·itn streams a "
           f"solve, fed through the engine's counters); walls build {t['build']:.4f} s, median solve "
           f"{t['solve']:.4f} s, solve_many (k = {k}) {t['solve_many']:.4f} s; B1 launches "
           f"{self.b1['cluster_session']} (card: {self.smi})")
        if stats != want or self.b1["cluster_session"] != src.num_tiles * (k + 2):
            raise AssertionError(f"phase 15 cluster session: stats {stats}, B1 {self.b1['cluster_session']}")
        self.walls["session"] = t
        del singles, many, D, Bm, X_true, X_qr

    # ---- (4) -----------------------------------------------------------------
    def kinds(self, A, b):
        from repro_torch.core import SparseSignSketch
        from repro_torch.core import sketch as sketch_lib
        from repro_torch.streaming import ArraySource, stream_sketch
        from repro_torch.streaming.sources import solve_device

        torch, gen, dev = self.torch, self.gen, self.dev
        n, T = A.shape[1], self.TILE
        d = 4 * n
        rows = {}
        # the SRHT at m = 2^18: placement, an exact merge
        m4 = self.M_SRHT
        src4 = ArraySource(A[:m4], tile_rows=T)
        op = sketch_lib.sample("srht", gen, d, m4, device=dev)
        Bs, _, cs = stream_sketch(src4, op=op, rhs=b[:m4])
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        B, c, st, wall = self._cluster_pass1("cluster_srht", src4, op, b[:m4], checkpoint_every=0)
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        launched = self.paths["cluster_srht"]
        rows["srht"] = dict(m=m4, bitwise_serial=torch.equal(B, Bs) and torch.equal(c, cs), peak_gib=peak,
                            wall=wall, srht_apply=launched["srht_apply"], b1=launched["countsketch_apply"])
        if not (rows["srht"]["bitwise_serial"] and launched["srht_apply"] >= 1 and launched["countsketch_apply"] == 0):
            raise AssertionError(f"phase 15 cluster srht: {rows['srht']}")
        del B, c, Bs, cs, op
        torch.cuda.empty_cache()
        # the Gaussian at m = 2^16: B4 with col0, one launch a tile
        m16 = M_DENSE
        A16, b16 = A[:m16], b[:m16]
        src16 = ArraySource(A16, tile_rows=T)
        # the device with its index, as the streaming drivers check an operator's
        op = sketch_lib.sample("gaussian", gen, d, m16, device=solve_device(dev), materialize=False)
        Bs, _, cs = stream_sketch(src16, op=op, rhs=b16)
        B, c, st, wall = self._cluster_pass1("cluster_gaussian", src16, op, b16, checkpoint_every=0)
        S_abs = op.as_dense().abs()
        g = 2 * _gamma(torch, m16, A.dtype)
        ok = bool(((B - Bs).abs() <= g * (S_abs @ A16.abs())).all()) and bool(
            ((c - cs).abs() <= g * (S_abs @ b16.abs())).all())
        launched = self.paths["cluster_gaussian"]["fused_gaussian_sketch"]
        rows["gaussian"] = dict(m=m16, max_abs_err_vs_serial=float((B - Bs).abs().max()), within=ok, wall=wall,
                                b4_launches=launched)
        if not (ok and launched == src16.num_tiles):
            raise AssertionError(f"phase 15 cluster gaussian: {rows['gaussian']}")
        del B, c, Bs, cs, S_abs, op
        torch.cuda.empty_cache()
        # sparse-sign on the main problem: the (k·d, n + 1) state per worker
        m = A.shape[0]
        op = sketch_lib.sample("sparse_sign", gen, d, m, device=dev)
        Bs, _, cs = stream_sketch(self.src, op=op, rhs=b)
        B, c, st, wall = self._cluster_pass1("cluster_sparse_sign", self.src, op, b, checkpoint_every=0)
        K = int(op.csr(A.dtype).offsets.diff().max())
        op_abs = SparseSignSketch(buckets=op.buckets, signs=op.signs.abs(), d=d, m=m, k=op.k)
        gK = 2 * _gamma(torch, K, A.dtype)
        ok = bool(((c - cs).abs() <= gK * op_abs.apply(b.abs())).all())
        err = float((c - cs).abs().max())
        for c0 in range(0, n, 125):
            gap = (B[:, c0:c0 + 125] - Bs[:, c0:c0 + 125]).abs()
            ok = ok and bool((gap <= gK * op_abs.apply(A[:, c0:c0 + 125].abs())).all())
            err = max(err, float(gap.max()))
            del gap
        rows["sparse_sign"] = dict(m=m, K=K, max_abs_err_vs_serial=err, within=ok, wall=wall,
                                   b1=self.b1["cluster_sparse_sign"],
                                   state_mb_per_worker=op.k * d * (n + 1) * 8 / 1e6)
        if not (ok and self.b1["cluster_sparse_sign"] == self.src.num_tiles):
            raise AssertionError(f"phase 15 cluster sparse_sign: {rows['sparse_sign']}")
        del B, c, Bs, cs, op, op_abs
        torch.cuda.empty_cache()
        self.times["kinds"] = rows
        _p(f"phase 15: other kinds on {self.WORKERS} workers, no checkpoints (srht bitwise the serial stream; "
           f"gaussian within 2·γ_m·|S||A|, sparse_sign within 2·γ_K·|S||A| of it; card: {self.smi}): "
           f"{json.dumps(rows)}")

    # ---- (5) -----------------------------------------------------------------
    def demo(self):
        import numpy as np

        from repro_torch.cluster import ClusterEngine, DelayWorker, KillWorker
        from repro_torch.core import generate_problem, lstsq, qr_solve
        from repro_torch.streaming import MemmapSource, stream_sketch

        torch, gen, dev = self.torch, self.gen, self.dev
        m, n = self.M_DEMO, N_MAIN
        p = generate_problem(gen, m, n, cond=1e6, beta=1e-4, device=dev)
        e_qr = _rel(qr_solve(p.A, p.b), p.x_true)
        path = Path(self.ckpt_root) / "A.npy"
        _, t_save = _sync_time(torch, lambda: np.save(path, p.A.cpu().numpy()))

        def solve(name, faults, certify=True, **kw):
            eng = ClusterEngine(MemmapSource(path, tile_rows=self.DEMO_TILE),
                                self.spec(name, faults=faults, checkpoint_every=self.DEMO_EVERY, **kw))

            def run():
                # the sketch first: the injected fault fires here
                B, _, c = stream_sketch(eng, self.seeded(), sketch_size=8 * n, rhs=p.b)
                if not certify:
                    return B, c, None
                return B, c, lstsq(eng, p.b, self.seeded(), accuracy="certified", sketch_size=8 * n)

            try:
                (B, c, res), wall = _sync_time(torch, lambda: self.counted(name, run))
            finally:
                eng.close()
            self.stats[name] = dict(eng.stats)
            self.teardown(name)
            return B, c, res, dict(eng.stats), wall

        B0, c0, r0, st0, t0 = solve("demo_clean", None)
        w, at = self.DEMO_KILL
        B1, c1, r1, st1, t1 = solve("demo_kill", [KillWorker(worker=w, at_tile=at)])
        row = dict(m=m, n=n, tiles=-(-m // self.DEMO_TILE), err=_rel(r1.x, p.x_true), qr_err=e_qr,
                   sketch_bitwise=torch.equal(B0, B1) and torch.equal(c0, c1),
                   passed=[bool(r0.certificate.passed), bool(r1.certificate.passed)],
                   rel_error_bound=float(r1.certificate.rel_error_bound),
                   x_gap=float((r0.x - r1.x).abs().max()), x_bitwise=torch.equal(r0.x, r1.x),
                   recoveries=st1["recoveries"], restores=st1["restores"], wall_clean=t0, wall_kill=t1,
                   save_s=t_save, method=r1.method, itn=int(r1.itn))
        _p(f"phase 15: acceptance demo (MemmapSource, {self.WORKERS} workers, checkpoint every {self.DEMO_EVERY} "
           f"tiles, worker {w} killed at its tile {at}; each run: the cluster sketch, then lstsq(accuracy="
           f"'certified'); card: {self.smi}): {json.dumps(row)}")
        if not (row["sketch_bitwise"] and all(row["passed"]) and row["x_gap"] <= 1e-9
                and st1["recoveries"] == 1 and st1["restores"] == 1
                and row["err"] < max(row["rel_error_bound"], 1e-6)):
            raise AssertionError(f"phase 15 demo: {row}")
        B2, c2, _, st2, t2 = solve("demo_delay", [DelayWorker(worker=w, seconds=self.DELAY_S, at_tile=1)],
                                   certify=False, heartbeat_timeout=self.HEARTBEAT_S)
        delay = dict(heartbeat_evictions=st2["heartbeat_evictions"], recoveries=st2["recoveries"],
                     sketch_bitwise=torch.equal(B0, B2) and torch.equal(c0, c2), wall=t2,
                     b1=self.b1["demo_delay"])
        _p(f"phase 15: demo_delay (worker {w} stalls {self.DELAY_S} s at its tile 1, heartbeat timeout "
           f"{self.HEARTBEAT_S} s; the sketch only): {json.dumps(delay)}")
        if not (delay["sketch_bitwise"] and st2["heartbeat_evictions"] >= 1):
            raise AssertionError(f"phase 15 demo_delay: {delay}")
        self.times["demo"] = dict(row, delay=delay)
        del p, B0, B1, B2, r0, r1
        torch.cuda.empty_cache()


class _Collectives:
    """Within ``with``: the bytes this process hands to ``all_reduce`` and
    ``broadcast`` (each call's tensor once: a rank's share of the traffic)."""

    NAMES = ("all_reduce", "broadcast")

    def __init__(self):
        import torch.distributed as dist

        self.dist, self.bytes = dist, {name: 0 for name in self.NAMES}

    def __enter__(self):
        self.saved = {name: getattr(self.dist, name) for name in self.NAMES}
        for name, real in self.saved.items():
            def counting(tensor, *a, _name=name, _real=real, **kw):
                self.bytes[_name] += tensor.numel() * tensor.element_size()
                return _real(tensor, *a, **kw)
            setattr(self.dist, name, counting)
        return self

    def __exit__(self, *exc):
        for name, real in self.saved.items():
            setattr(self.dist, name, real)
        return False


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _llama_matrices():
    """llama3.2-1b's tied embedding and one layer's seven matrices, their
    shapes from the port's config (``repro_torch.configs``)."""
    from repro_torch.configs import get_config

    c = get_config("llama3.2-1b")
    D, F, Q, KV = c.d_model, c.d_ff, c.n_heads * c.head_dim, c.n_kv_heads * c.head_dim
    return {"embed": (c.vocab, D), "q": (D, Q), "k": (D, KV), "v": (D, KV), "o": (Q, D), "gate": (D, F),
            "up": (D, F), "down": (F, D)}


def _phase16_rank(rank, world, init, plan, A, b, A_dense, grads, ef, queue):
    """One rank of phase 16's gloo world, a process of its own on ``A``'s
    device: its results (arrays as numpy, sent by value), or its traceback,
    go to ``queue``.  The kernels were built by the parent; ``_build.load``
    finds the library in ``build/repro_torch``."""
    import multiprocessing
    import traceback

    try:
        part = _Phase16Rank(rank, world, init, plan, A, b, A_dense, grads, ef)
        # only ``part`` holds the parent's shared blocks now, and lets go of
        # them when it is done, so the parent can release them (ipc_collect)
        del A, b, A_dense, grads, ef
        multiprocessing.current_process()._args = ()
        queue.put((rank, part.run(), None))
    except BaseException:
        queue.put((rank, None, traceback.format_exc()))
        raise


class _Phase16Rank:
    """The parts of phase 16 one gloo rank runs (``_Phase16`` judges them):
    its row block of the parent's A (shared by CUDA IPC, not copied), the
    three scatter kinds' ``sketched_lstsq``, ``sharded_sketch`` of every
    additive kind and one step of ``sketched_psum_grads``.  Each counted part
    runs under ``_NoPlain`` with its launches and collective bytes read."""

    def __init__(self, rank, world, init, plan, A, b, A_dense, grads, ef):
        import datetime
        import os

        import torch
        import torch.distributed as dist

        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))  # the host's cores, shared out
        self.torch, self.dist, self.rank, self.world, self.plan = torch, dist, rank, world, plan
        self.A, self.b, self.A_dense, self.grads, self.ef = A, b, A_dense, grads, ef
        self.dev = A.device
        if self.dev.type == "cuda":
            torch.cuda.set_device(self.dev)
        dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=plan["timeout_s"]))
        self.out = {"launches": {}, "bytes": {}, "walls": {}}

    def run(self):
        try:
            for part in (self.collectives, self.solves, self.sharded, self.compress):
                t0 = time.perf_counter()
                part()
                row = self.out.setdefault("parts", {})[part.__name__] = {"s": time.perf_counter() - t0}
                if self.dev.type == "cuda":  # hand this rank's cached blocks back to the card
                    self.torch.cuda.empty_cache()
                    row.update(card_free_gib=self.torch.cuda.mem_get_info()[0] / 2**30,
                               peak_gib=self.torch.cuda.max_memory_allocated() / 2**30)
        finally:
            self.dist.destroy_process_group()
            self.A = self.b = self.A_dense = self.grads = self.ef = None
        return self.out

    def counted(self, name, fn):
        from repro_torch.kernels import KERNELS, reset_launches

        torch = self.torch
        _sync(torch, self.dev)
        reset_launches()
        with _Collectives() as coll, _NoPlain(torch):
            out = fn()
        _sync(torch, self.dev)
        self.out["launches"][name] = {f.__name__: f.launches for f in KERNELS if f.launches}
        self.out["bytes"][name] = dict(coll.bytes)
        return out

    def timed(self, name, fn, reps=3):
        """Median wall of ``reps`` runs, each started together on every rank."""
        walls = []
        for _ in range(reps):
            self.dist.barrier()
            _sync(self.torch, self.dev)
            t0 = time.perf_counter()
            fn()
            _sync(self.torch, self.dev)
            walls.append(time.perf_counter() - t0)
        self.out["walls"][name] = sorted(walls)[reps // 2]

    def collectives(self):
        """gloo's all_reduce and broadcast on the device's tensors (what the
        port uses; PyTorch documents gloo as running these two on CUDA)."""
        from repro_torch import sharding

        torch, dev, world = self.torch, self.dev, self.world
        t = torch.full((3,), float(self.rank + 1), dtype=torch.float64, device=dev)
        s = sharding.psum(t)
        u = sharding.broadcast_first(torch.arange(5, dtype=torch.int32, device=dev) + 100 * self.rank)
        self.out["collectives"] = dict(
            device=str(dev), all_reduce=bool((s == world * (world + 1) / 2).all()) and bool((t == self.rank + 1).all()),
            broadcast=bool(torch.equal(u, torch.arange(5, dtype=torch.int32, device=dev))))

    def solves(self):
        from repro_torch import sharding
        from repro_torch.core import distributed, sketched_lstsq
        from repro_torch.core import sketch as sketch_lib

        torch, dev, plan = self.torch, self.dev, self.plan
        A_i, b_i = distributed.shard_rows(self.A, self.b)
        m, row0 = sharding.row_offset(A_i.shape[0], None, dev)
        self.out["rows"] = (m, row0, A_i.shape[0])
        for kind in plan["kinds"]:
            def solve(kind=kind):
                gen = torch.Generator(device=dev).manual_seed(plan["seed"])
                return sketched_lstsq(A_i, b_i, gen, sketch=kind, sketch_size=plan["d"], device=dev)

            res = self.counted(f"dist_{kind}", solve)
            self.timed(f"dist_{kind}", solve)
            gen = torch.Generator(device=dev).manual_seed(plan["seed"])
            op = sketch_lib.SKETCH_KINDS[kind].sample(gen, plan["d"], m, dtype=A_i.dtype, device=dev)
            SA, _ = distributed._local_sketch(A_i, b_i, op, row0, None)  # the solve's assembly again
            self.out[f"dist_{kind}"] = dict(x=res.x.cpu().numpy(), itn=int(res.itn), istop=int(res.istop),
                                            SA=SA.cpu().numpy() if self.rank == 0 else None)
            del SA, op

    def sharded(self):
        from repro_torch.core import sketch as sketch_lib
        from repro_torch.streaming import sharded_sketch

        torch, dev, plan = self.torch, self.dev, self.plan
        for kind, A in [(k, self.A) for k in plan["bucket_kinds"]] + [(k, self.A_dense) for k in plan["dense_kinds"]]:
            A_i = A.tensor_split(self.world)[self.rank]
            op = sketch_lib.sample(kind, plan["seed"], plan["d"], A.shape[0], dtype=A.dtype, device=dev)
            B = self.counted(f"sharded_{kind}", lambda: sharded_sketch(A_i, op))
            self.timed(f"sharded_{kind}", lambda: sharded_sketch(A_i, op))
            self.out[f"sharded_{kind}"] = B.cpu().numpy() if self.rank == 0 else None
            del op, B
        op = sketch_lib.SRHTSketch.sample(plan["seed"], plan["d"], self.A_dense.shape[0], device=dev)
        try:
            sharded_sketch(self.A_dense.tensor_split(self.world)[self.rank], op)
            self.out["srht_raises"] = "no error"
        except ValueError as e:  # the gate: the SRHT must refuse
            self.out["srht_raises"] = str(e)

    def compress(self):
        from repro_torch.kernels import countsketch_apply, countsketch_ref
        from repro_torch.models.common import tree_paths
        from repro_torch.optim import CompressionConfig, compression, sketched_psum_grads

        torch, dev, plan = self.torch, self.dev, self.plan
        cfg = CompressionConfig(**plan["compress"])
        grads, ef = self.grads, self.ef

        def step():
            return sketched_psum_grads(cfg, grads, ef, step=0)

        out, ne = self.counted("compress", step)
        g, r, e = grads["embed"], out["embed"], ne["embed"]
        gd, rd = g.double().flatten(), r.double().flatten()
        gc, rc = gd - gd.mean(), rd - rd.mean()
        corr = float((gc @ rc) / (gc.norm() * rc.norm()))
        gain = float(rd.mean() / gd.mean())
        del gd, rd, gc, rc
        ef_err = float((g - r - e).abs().max())
        digest = [float(t.double().sum()) for t in (r, e)]
        del out, ne, r, e
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        self.timed("compress", step)

        def plain():  # the uncompressed all-reduce of the same gradients
            from repro_torch import sharding
            return {k: sharding.psum(v) / self.world for k, v in grads.items()}

        self.counted("uncompressed", plain)
        self.timed("uncompressed", plain)
        row = dict(corr=corr, gain=gain, ef_err=ef_err, digest=digest)
        if self.rank == 0:  # B1's sketch of the embedding against its plain version on the CPU
            paths = list(tree_paths(grads))
            i = paths.index(("embed",))
            numel = g.numel()
            s = numel // cfg.ratio
            h, w = compression._buckets_signs(cfg.seed, i, 0, numel, s, dev)
            gf = (g.reshape(-1) + ef["embed"].reshape(-1)).to(torch.float32)
            sk = countsketch_apply(gf, h, w, s)
            row["b1_bitwise_cpu"] = bool(torch.equal(sk.cpu(), countsketch_ref(gf.cpu(), h.cpu(), w.cpu(), s)))
            del h, w, gf, sk
        self.out["compress"] = row


class _Phase16:
    """Phase 16: the distributed solve (``repro_torch.core.distributed``,
    ``repro_torch.streaming.sharded_sketch``) and the CountSketch-compressed
    gradient all-reduce (``repro_torch.optim``), right after phase 15 on the
    main problem.

    (1) ``dist_nccl_p1``: ``sketched_lstsq`` on the main problem (s = 4000)
    over a world of one NCCL rank in this process, gated as phase 3, B1
    launched twice (A, b).  (2) a gloo world of 4 processes on the same
    card (NCCL refuses two ranks on one device), each given its row block
    of the main A (2^18 rows) by CUDA IPC and not copied: first a check that
    gloo all-reduces and broadcasts the card's tensors; ``dist_gloo_p4``,
    ``sketched_lstsq`` with the CountSketch, sparse-sign and uniform-sparse
    sketches, x, itn and istop bitwise on every rank, phase 3's error gates,
    the assembled SA within 2·γ·|S||A| of this process's monolithic B1
    apply on the same S, B1 launched twice a rank a solve;
    ``sharded_sketch_p4``: the three bucket kinds on the main A and the
    Gaussian and uniform-dense kinds at m = 2^16 (B6 on (4000, 16384) ×
    (16384, 1000) a rank; the Gaussian's restriction is a stored S, as in
    the reference), each within 2·γ·|S||A| of the monolithic apply of the
    same S, one launch a rank; the SRHT refused; ``compress_p4``: one step
    of ``sketched_psum_grads`` on llama3.2-1b's tied embedding and one
    layer's seven matrices (f32, N(0, 1) + 0.5, the same on every rank,
    ratio 8, min_size 65536, error feedback on): the reference test's three
    gates on the embedding, every rank's output the same, rank 0's B1
    sketch of the embedding bitwise its plain version on the CPU, B1
    launched 8 times a rank.  Counted parts run under ``_NoPlain``, their
    launches held exactly; walls and each rank's collective bytes are
    printed.  Every process is joined or terminated before the phase ends;
    the group's timeout turns a diverged rank into a failure."""

    SEED = 1601
    D = 4000
    WORLD = 4
    TIMEOUT_S = 120  # the groups' timeout: a rank left waiting fails, never hangs
    DEADLINE_S = 600  # the gloo world's whole run, start-up included
    P1_BACKEND = "nccl"
    KINDS = ("clarkson_woodruff", "sparse_sign", "uniform_sparse")
    BUCKET_KINDS = ("countsketch", "sparse_sign", "uniform_sparse")
    DENSE_KINDS = ("gaussian", "uniform_dense")
    COMPRESS = dict(ratio=8, min_size=65536, error_feedback=True)
    # the gradients' shapes: None takes llama3.2-1b's tied embedding and one
    # layer's seven matrices from the port's config (``_llama_matrices``)
    LLAMA = None
    TARGET = staticmethod(_phase16_rank)  # the ranks' entry point

    def __init__(self, torch, dev, smi, run_path, paths, root):
        self.torch, self.dev, self.smi, self.run_path, self.paths, self.root = torch, dev, smi, run_path, paths, root
        self.launches, self.walls, self.bytes = {}, {}, {}
        self.llama = self.LLAMA or _llama_matrices()

    def seeded(self):
        return self.torch.Generator(device=self.dev).manual_seed(self.SEED)

    def main_problem(self, A, b, x_true, e_qr, t_saa):
        import shutil
        import tempfile

        torch = self.torch
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info()
        _p(f"phase 16: this process holds {torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card; "
           f"{free / 2**30:.1f} of {total / 2**30:.1f} GiB free")
        (self.root / "build").mkdir(exist_ok=True)
        self.tmp = tempfile.mkdtemp(prefix="phase16-", dir=self.root / "build")
        try:
            self.nccl_p1(A, b, x_true, e_qr, t_saa)
            self.gloo_p4(A, b, x_true, e_qr)
        finally:
            shutil.rmtree(self.tmp, ignore_errors=True)
        _p(f"phase 16: launches a rank by part {json.dumps(self.launches)}")
        _p(f"phase 16: bytes a rank hands to all_reduce/broadcast by part {json.dumps(self.bytes)}")
        _p(f"phase 16: walls (s; the slowest rank's median of 3; card: {self.smi}) {json.dumps(self.walls)}")

    def counted(self, name, fn):
        torch = self.torch

        def guarded():
            with _Collectives() as coll, _NoPlain(torch):
                out = fn()
            self.bytes[name] = dict(coll.bytes)
            return out

        out = self.run_path(name, guarded)
        self.launches[name] = {k: v for k, v in self.paths[name].items() if v}
        return out

    def nccl_p1(self, A, b, x_true, e_qr, t_saa):
        import datetime

        import torch.distributed as dist
        from repro_torch.core import sketched_lstsq

        torch, dev = self.torch, self.dev
        kw = {"device_id": torch.device(dev.type, torch.cuda.current_device())} if dev.type == "cuda" else {}
        dist.init_process_group(self.P1_BACKEND, init_method=f"file://{self.tmp}/p1", rank=0, world_size=1,
                                timeout=datetime.timedelta(seconds=self.TIMEOUT_S), **kw)
        try:
            def solve():
                return sketched_lstsq(A, b, self.seeded(), sketch_size=self.D, device=dev)

            res = self.counted("dist_nccl_p1", solve)
            self.walls["dist_nccl_p1"] = sorted(_sync_time(torch, solve)[1] for _ in range(3))[1]
        finally:
            dist.destroy_process_group()
        e = _rel(res.x, x_true)
        row = dict(backend=self.P1_BACKEND, itn=int(res.itn), istop=int(res.istop), err=e, qr_err=e_qr,
                   wall=self.walls["dist_nccl_p1"], saa_wall=t_saa, launches=self.launches["dist_nccl_p1"],
                   bytes=self.bytes["dist_nccl_p1"])
        _p(f"phase 16: dist_nccl_p1 (world 1, m=2^20, n={A.shape[1]}, s={self.D}): {json.dumps(row)} (card: {self.smi})")
        if not (e < 1e-5 and e <= 100 * max(e_qr, 1e-12) and row["launches"] == {"countsketch_apply": 2}):
            raise AssertionError(f"phase 16 dist_nccl_p1: {row}")

    def _monolithic(self, op, A):
        """(S·A by the whole operator, |S||A|, the longest sum) of a draw on
        this process's card: B1 for the bucket kinds, B6 on the stored S
        for the dense ones."""
        from repro_torch.core import sketch as sketch_lib
        from repro_torch.kernels import countsketch_ref

        if isinstance(op, sketch_lib._BucketSketch):
            w = op._weights().abs()
            mag = countsketch_ref(self.absA, op.buckets, w, op.d)
            k = op.k if isinstance(op, sketch_lib.SparseSignSketch) else 1
            return op.apply(A), mag / math.sqrt(k), k * A.shape[0] + 1
        dense = op.restrict_cols(slice(None))  # the stored S (the Gaussian's as the ranks restrict it)
        return dense.apply(A), dense.S.abs() @ A.abs(), A.shape[0]

    def _within(self, B, ref, what):
        B_mono, mag, K = ref
        err = (self.torch.as_tensor(B) - B_mono).abs()
        ratio = float((err / (2 * _gamma(self.torch, K, B_mono.dtype) * mag).clamp_min(1e-300)).max())
        if not ratio <= 1:
            raise AssertionError(f"phase 16 {what}: max|Δ| {float(err.max())} is {ratio} × 2·γ·|S||A|")
        return ratio

    def gloo_p4(self, A, b, x_true, e_qr):
        import queue as queue_lib

        import torch.multiprocessing as mp
        from repro_torch.core import sketch as sketch_lib
        from repro_torch.optim import CompressionConfig, compress_state_init

        torch, dev = self.torch, self.dev
        gen = self.seeded()
        A_dense = torch.randn((M_DENSE, A.shape[1]), generator=gen, dtype=A.dtype, device=dev)
        grads = {k: torch.randn(s, generator=gen, dtype=torch.float32, device=dev) + 0.5 for k, s in self.llama.items()}
        ef = compress_state_init(CompressionConfig(**self.COMPRESS), grads)

        # the monolithic applies the ranks are held to, before the ranks start
        refs = {}
        self.absA = A.abs()
        for kind in self.KINDS:
            op = sketch_lib.SKETCH_KINDS[kind].sample(self.seeded(), self.D, A.shape[0], dtype=A.dtype, device=dev)
            refs[f"dist_{kind}"] = self._monolithic(op, A)
        for kind in self.BUCKET_KINDS:
            refs[f"sharded_{kind}"] = self._monolithic(
                sketch_lib.sample(kind, self.SEED, self.D, A.shape[0], dtype=A.dtype, device=dev), A)
        del self.absA
        for kind in self.DENSE_KINDS:
            refs[f"sharded_{kind}"] = self._monolithic(
                sketch_lib.sample(kind, self.SEED, self.D, M_DENSE, dtype=A.dtype, device=dev), A_dense)
        # the references wait on the host: a small tensor left in a freed 8.4 GB
        # block would keep the whole block from the ranks
        refs = {k: tuple(t.cpu() if isinstance(t, torch.Tensor) else t for t in v) for k, v in refs.items()}
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        free, _ = torch.cuda.mem_get_info()
        _p(f"phase 16: this process holds {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
           f"({torch.cuda.memory_reserved() / 2**30:.2f} reserved) as the ranks start; {free / 2**30:.1f} GiB free")

        plan = dict(seed=self.SEED, d=self.D, kinds=self.KINDS, bucket_kinds=self.BUCKET_KINDS,
                    dense_kinds=self.DENSE_KINDS, compress=self.COMPRESS, timeout_s=self.TIMEOUT_S)
        ctx = mp.get_context("spawn")
        results = ctx.Queue()
        procs = [ctx.Process(target=self.TARGET, name=f"phase16-rank{r}",
                             args=(r, self.WORLD, f"file://{self.tmp}/p4", plan, A, b, A_dense, grads, ef, results))
                 for r in range(self.WORLD)]
        ranks = {}
        t0 = time.perf_counter()
        try:
            for p in procs:
                p.start()
            while len(ranks) < self.WORLD:
                left = self.DEADLINE_S - (time.perf_counter() - t0)
                try:
                    rank, out, err = results.get(timeout=max(left, 1.0))
                except queue_lib.Empty:
                    raise AssertionError(f"phase 16: the gloo world gave {len(ranks)} of {self.WORLD} results "
                                         f"in {self.DEADLINE_S} s") from None
                if err is not None:
                    raise AssertionError(f"phase 16: gloo rank {rank} failed:\n{err}")
                ranks[rank] = out
            for p in procs:
                p.join(timeout=60)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=10)
        t_world = time.perf_counter() - t0
        torch.cuda.ipc_collect()  # the blocks the ranks shared, released by them
        codes = [p.exitcode for p in procs]
        if codes != [0] * self.WORLD:
            raise AssertionError(f"phase 16: gloo ranks exited {codes}")
        ranks = [ranks[r] for r in range(self.WORLD)]
        del grads, ef
        self.judge(ranks, refs, x_true, e_qr, t_world)

    def judge(self, ranks, refs, x_true, e_qr, t_world):
        import numpy as np

        torch, W = self.torch, self.WORLD
        coll = [r["collectives"] for r in ranks]
        _p(f"phase 16: gloo world of {W} on one card ({t_world:.1f} s, start-up and teardown included); "
           f"collectives on {coll[0]['device']} tensors: {json.dumps(coll)}")
        _p(f"phase 16: each rank's parts (s, the card's free GiB after, the rank's own peak GiB): "
           f"{json.dumps([r.get('parts') for r in ranks])}")
        if not all(c["all_reduce"] and c["broadcast"] for c in coll):
            raise AssertionError(f"phase 16: gloo collectives on the card: {coll}")
        rows = [r["rows"] for r in ranks]
        if [r[1] for r in rows] != [sum(k for _, _, k in rows[:i]) for i in range(W)] or rows[0][0] != sum(
                k for _, _, k in rows):
            raise AssertionError(f"phase 16: row blocks {rows}")

        def per_rank(name):
            """The part's launches and bytes, the same on every rank."""
            for key, store in (("launches", self.launches), ("bytes", self.bytes)):
                got = [r[key][name] for r in ranks]
                if key == "launches" and any(g != got[0] for g in got):
                    raise AssertionError(f"phase 16 {name}: launches by rank {got}")
                store[name] = got[0]
            self.walls[name] = max(r["walls"][name] for r in ranks)

        table = {}
        for kind in self.KINDS:
            name = f"dist_{kind}"
            per_rank(name)
            res = [r[name] for r in ranks]
            same = all(np.array_equal(r["x"], res[0]["x"]) and (r["itn"], r["istop"]) == (res[0]["itn"], res[0]["istop"])
                       for r in res)
            e = _rel(torch.as_tensor(res[0]["x"], device=x_true.device), x_true)
            row = dict(itn=res[0]["itn"], istop=res[0]["istop"], err=e, qr_err=e_qr, bitwise_ranks=same,
                       sa_bound_share=self._within(res[0]["SA"], refs[name], name),
                       wall=self.walls[name], nccl_p1_wall=self.walls["dist_nccl_p1"],
                       launches=self.launches[name], bytes=self.bytes[name])
            table[name] = row
            _p(f"phase 16: {name} (world {W}, gloo, {rows[0][2]} rows a rank): {json.dumps(row)}")
            if not (same and e < 1e-5 and e <= 100 * max(e_qr, 1e-12)
                    and self.launches[name] == {"countsketch_apply": 2}):
                raise AssertionError(f"phase 16 {name}: {row}")
        for kind in self.BUCKET_KINDS + self.DENSE_KINDS:
            name = f"sharded_{kind}"
            per_rank(name)
            want = {"sketch_matmul" if kind in self.DENSE_KINDS else "countsketch_apply": 1}
            share = self._within(ranks[0][name], refs[name], name)
            table[name] = dict(bound_share=share, wall=self.walls[name], launches=self.launches[name],
                               bytes=self.bytes[name])
            if self.launches[name] != want:
                raise AssertionError(f"phase 16 {name}: launches {self.launches[name]}, want {want}")
        _p(f"phase 16: sharded_sketch_p4 (d={self.D}; bucket kinds on the main A, dense kinds at "
           f"A({M_DENSE}, 1000); max|Δ| as a share of 2·γ·|S||A| from the monolithic apply of the same S): "
           f"{json.dumps({k: v for k, v in table.items() if k.startswith('sharded_')})}")
        refused = [r["srht_raises"] for r in ranks]
        if not all("stream_semantics" in msg for msg in refused):
            raise AssertionError(f"phase 16: sharded_sketch of the SRHT: {refused}")
        _p(f"phase 16: sharded_sketch of the SRHT refused on every rank: {refused[0]!r}")

        for name in ("compress", "uncompressed"):
            per_rank(name)
        comp = [r["compress"] for r in ranks]
        row = dict(comp[0], wall=self.walls["compress"], uncompressed_wall=self.walls["uncompressed"],
                   launches=self.launches["compress"], bytes=self.bytes["compress"],
                   uncompressed_bytes=self.bytes["uncompressed"], ranks_equal=all(c["digest"] == comp[0]["digest"]
                                                                                   for c in comp))
        _p(f"phase 16: compress_p4 (llama3.2-1b embedding {self.llama['embed']} + one layer's 7 matrices, f32, "
           f"ratio {self.COMPRESS['ratio']}; gates on the embedding): {json.dumps(row)} (card: {self.smi})")
        ratio = self.COMPRESS["ratio"]
        if not (all(0.3 < c["corr"] < 0.7 and abs(c["gain"] - 1 / ratio) < 0.05 and c["ef_err"] < 1e-5 for c in comp)
                and row["ranks_equal"] and row["b1_bitwise_cpu"]
                and self.launches["compress"] == {"countsketch_apply": len(self.llama)}):
            raise AssertionError(f"phase 16 compress_p4: {row}")


def _bits_digest(torch, tensors):
    """Exact integer sums of each tensor's 16-bit words and of their
    squares (an f32 tensor is read as twice as many int16 words), summed on
    the tensors' device: two ranks whose bits differ agree on a tensor's
    digest only if the differing words cancel in both sums."""
    sums = []
    for t in tensors:
        bits = t.detach().reshape(-1).view(torch.int16)
        acc = torch.zeros(2, dtype=torch.int64, device=t.device)
        for chunk in bits.split(1 << 24):
            c = chunk.long()
            acc[0] += c.sum()
            acc[1] += (c * c).sum()
        sums.append(acc)
    return torch.stack(sums).tolist()


def _n_compressed(cfg, min_size):
    """How many tensors of ``cfg``'s parameter tree the compressed all-reduce
    sketches (those of ``min_size`` entries or more): one B1 launch each."""
    from repro_torch.models import params_shapes
    from repro_torch.models.common import is_shape, tree_leaves

    return sum(math.prod(shape) >= min_size for shape, _ in tree_leaves(params_shapes(cfg), is_leaf=is_shape))


def _phase17_rank(rank, world, init, plan, queue):
    """One rank of phase 17's gloo world, a process of its own on the card:
    its results (numbers only), or its traceback, go to ``queue``.  The
    kernels were built by the parent; ``_build.load`` finds the library in
    ``build/repro_torch``."""
    import traceback

    try:
        queue.put((rank, _Phase17Rank(rank, world, init, plan).run(), None))
    except BaseException:
        queue.put((rank, None, traceback.format_exc()))
        raise


class _Phase17Rank:
    """One gloo rank of ``lm_dp_gloo_p4``: the whole depth-2 state drawn from
    the shared seed, its quarter of each global batch, ``make_dp_train_step``
    compressed and not; per step the loss, the wall, B1's launches, the bytes
    handed to ``all_reduce`` and a digest of the parameters and the master."""

    def __init__(self, rank, world, init, plan):
        import datetime
        import os

        import torch
        import torch.distributed as dist

        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))  # the host's cores, shared out
        self.torch, self.dist, self.rank, self.world, self.plan = torch, dist, rank, world, plan
        self.dev = torch.device(plan["device"])
        if self.dev.type == "cuda":
            # four ranks share the card: each caps its caching allocator at its
            # share (it frees its cached blocks before it would take more),
            # and expandable segments keep that share unfragmented
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
            torch.cuda.set_device(self.dev)
            torch.cuda.set_per_process_memory_fraction(plan["mem_fraction"], self.dev)
        dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=plan["timeout_s"]))

    def run(self):
        from repro_torch.data import SyntheticConfig, batch_at
        from repro_torch.kernels import KERNELS, reset_launches
        from repro_torch.models.common import tree_leaves
        from repro_torch.optim import AdamWConfig, CompressionConfig, compress_state_init
        from repro_torch.train import init_train_state, make_dp_train_step

        torch, dev, plan = self.torch, self.dev, self.plan
        cfg = plan["cfg"]
        dcfg = SyntheticConfig(vocab=cfg.vocab, seq_len=plan["seq"], global_batch=plan["batch"])
        rows = plan["batch"] // self.world
        out = {}
        try:
            for mode in ("compressed", "uncompressed"):
                comp = CompressionConfig(**plan["compress"]) if mode == "compressed" else None
                state = init_train_state(cfg, plan["seed"], device=dev)
                ef = compress_state_init(comp, state.params) if comp else None
                step = make_dp_train_step(cfg, AdamWConfig(**plan["opt"]), compression=comp)
                if dev.type == "cuda":
                    torch.cuda.reset_peak_memory_stats()
                steps = []
                for i in range(plan["steps"]):
                    batch = {k: v[self.rank * rows:(self.rank + 1) * rows]
                             for k, v in batch_at(dcfg, i, device=dev).items()}
                    self.dist.barrier()
                    _sync(torch, dev)
                    reset_launches()
                    t0 = time.perf_counter()
                    with _Collectives() as coll, _NoPlain(torch):
                        (state, ef), m = step(state, ef, batch)
                    _sync(torch, dev)
                    wall = time.perf_counter() - t0
                    steps.append(dict(
                        loss=float(m["loss"]), wall=wall, bytes=coll.bytes["all_reduce"],
                        launches={f.__name__: f.launches for f in KERNELS if f.launches},
                        digest=_bits_digest(torch, tree_leaves(state.params) + tree_leaves(state.opt["master"]))))
                out[mode] = dict(steps=steps, peak_gib=torch.cuda.max_memory_allocated() / 2**30
                                 if dev.type == "cuda" else None,
                                 reserved_gib=torch.cuda.max_memory_reserved() / 2**30 if dev.type == "cuda" else None)
                del state, ef, step
                if dev.type == "cuda":
                    torch.cuda.empty_cache()
        finally:
            self.dist.destroy_process_group()
        return out


class _Phase17:
    """Phase 17: the LM substrate (``repro_torch.models``, ``train``,
    ``optim``, ``data``) on llama3.2-1b at full width from the port's own
    ``configs.get_config``, last, after every other phase's buffers and
    processes are freed.

    (1) ``lm_serve``: bf16 parameters from ``init_params`` on a seeded
    generator; ``generate`` on 8 prompts of 2048 tokens (4 query blocks and
    2 kv blocks of ``flash_attention``), 64 new tokens; prefill and the
    decode loop timed apart as ``generate`` runs them (their tokens bitwise
    ``generate``'s); the greedy tokens against a teacher-forced ``forward``
    over the prompts and the generated tokens: where they differ, forward's
    top logit exceeds its logit at the generated token by at most twice the
    largest |decode − forward| logit gap measured over all positions, and
    that gap is at most 0.2.  In f32 on 4 prompts: ``prefill`` of their
    first 2032 tokens (4 query and 2 kv blocks), then 16 cached
    ``decode_step``s fed their next tokens; the prefill's last logits and
    each step's against ``forward`` over all 2048 tokens, to the reference
    test's 2e-3.  (2) ``lm_train``: 12 steps of ``train_loop`` at
    full depth (bf16 parameters, f32 master, the bigram stream at seq 512,
    global batch 8, ``n_micro`` 2, AdamW lr 3e-3 with 5 warmup steps), no
    checkpoints: the loss finite and falling by 0.05; at depth 2 in f32,
    ``n_micro`` 1 against 2 on one batch (the master within 1e-5; m within
    1e-4 of its largest entry) and exact resume (5 steps, 5 more after a
    resume from its checkpoint, against 10 straight: final loss within
    1e-4), each checkpoint write timed apart.  (3) ``lm_dp_nccl_p1``:
    ``make_dp_train_step`` over a world of one NCCL rank at full depth, 5
    steps with ``CompressionConfig(ratio=8, min_size=65536)`` (B1 launched
    exactly 8 times a step, the first sketch of the embedding's gradient
    bitwise its plain version on the CPU) and 5 without.  (4)
    ``lm_dp_gloo_p4``: four gloo processes sharing the card at depth 2
    (four full states do not fit one card), each its quarter of every
    batch, 5 steps compressed and 5 not: the parameters and the master
    bitwise equal on every rank after every step (``_bits_digest``), the
    loss falling, B1 launched 8 times a compressed step a rank and no kernel
    otherwise.  The LM's own products are torch matmuls: serving and the
    single-process steps launch no port kernel, which is held.  Walls, peaks
    and rates print beside the card's name and power limit."""

    ARCH = "llama3.2-1b"
    CFG = None  # a config in place of get_config(ARCH) (CPU rehearsals)
    SEED = 1701
    PROMPTS, PROMPT_LEN, NEW, GATE_PROMPTS = 8, 2048, 64, 4
    SERVE_TOL = 2e-3  # tests/test_serving_consistency.py
    GATE_DECODE_STEPS = 16  # cached f32 decode steps held to SERVE_TOL
    # bf16: the largest |decode − teacher-forced forward| logit over the 64
    # cached steps; 0.0859 measured on the H100, the prediction's ceiling 0.2
    TF_GAP_MAX = 0.2
    # few steps, so that the phase stays near two minutes: a depth-2 f32
    # checkpoint (6.15 GB) takes ≈25 s to write and restore alone
    SEQ, BATCH, MICRO, STEPS, SHALLOW = 512, 8, 2, 12, 2
    RESUME_AT, RESUME_STEPS = 5, 10
    OPT = dict(lr=3e-3, warmup_steps=5)
    COMPRESS = dict(ratio=8, min_size=65536)
    DP_STEPS = 5
    WORLD = 4
    RANK_MEM_FRACTION = 0.235  # of the card, a gloo rank's cap (four ranks and this process share it)
    TIMEOUT_S = 120  # the groups' timeout: a rank left waiting fails, never hangs
    DEADLINE_S = 600  # the gloo world's whole run, start-up included
    P1_BACKEND = "nccl"
    TARGET = staticmethod(_phase17_rank)  # the ranks' entry point

    def __init__(self, torch, dev, smi, root):
        self.torch, self.dev, self.smi, self.root = torch, dev, smi, root
        self.launches, self.walls = {}, {}

    def config(self, **kw):
        from repro_torch.configs import get_config

        return (self.CFG or get_config(self.ARCH)).replace(**kw)

    def data(self):
        from repro_torch.data import SyntheticConfig

        return SyntheticConfig(vocab=self.config().vocab, seq_len=self.SEQ, global_batch=self.BATCH)

    def opt(self):
        from repro_torch.optim import AdamWConfig

        return AdamWConfig(**self.OPT)

    def counted(self, name, fn):
        """``fn()`` with every kernel's launch count set to 0 just before and
        read just after; the counts are kept under ``name``."""
        from repro_torch.kernels import KERNELS, reset_launches

        _sync(self.torch, self.dev)
        reset_launches()
        out = fn()
        _sync(self.torch, self.dev)
        self.launches[name] = {f.__name__: f.launches for f in KERNELS if f.launches}
        return out

    def run(self):
        import gc
        import shutil
        import tempfile

        torch = self.torch
        gc.collect()
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info()
        _p(f"phase 17: this process holds {torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card as the LM "
           f"phase starts; {free / 2**30:.1f} of {total / 2**30:.1f} GiB free")
        (self.root / "build").mkdir(exist_ok=True)
        self.tmp = tempfile.mkdtemp(prefix="phase17-", dir=self.root / "build")
        try:
            for part in (self.serve, self.train, self.nccl_p1, self.gloo_p4):
                t0 = time.perf_counter()
                part()
                gc.collect()
                torch.cuda.empty_cache()
                self.walls[part.__name__] = time.perf_counter() - t0
        finally:
            shutil.rmtree(self.tmp, ignore_errors=True)
        _p(f"phase 17: parts' walls (s; card: {self.smi}) {json.dumps(self.walls)}; launches by part "
           f"{json.dumps(self.launches)}")

    # ---- lm_serve ------------------------------------------------------------

    def serve(self):
        from repro_torch.models import decode_step, init_params, prefill
        from repro_torch.models.common import tree_leaves, tree_map
        from repro_torch.models.transformer import _embed_inputs, _logits, _tables, backbone
        from repro_torch.train import generate

        torch, dev = self.torch, self.dev
        cfg = self.config()
        gen = torch.Generator(device=dev).manual_seed(self.SEED)
        params = init_params(cfg, gen, device=dev)
        P, S, N = self.PROMPTS, self.PROMPT_LEN, self.NEW
        prompts = torch.randint(0, cfg.vocab, (P, S), generator=gen, dtype=torch.int32, device=dev)
        generate(cfg, params, prompts[:, : S // 16], max_new=2)  # warm-up: the library's handles
        torch.cuda.reset_peak_memory_stats()
        out, t_gen = _sync_time(torch, lambda: self.counted("lm_serve", lambda: generate(cfg, params, prompts,
                                                                                          max_new=N)))
        peak = torch.cuda.max_memory_allocated() / 2**30
        # prefill and the decode loop apart, as generate runs them
        (logits, cache), t_pre = _sync_time(torch, lambda: prefill(cfg, params, {"tokens": prompts}, S_cache=S + N))
        kv_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(cache))
        toks, dec = [torch.argmax(logits, -1).to(torch.int32)], [logits]

        def loop():
            nonlocal cache
            for i in range(N - 1):
                lg, cache = decode_step(cfg, params, cache, toks[-1], S + i)
                toks.append(torch.argmax(lg, -1).to(torch.int32))
                dec.append(lg)

        _, t_dec = _sync_time(torch, loop)
        if not torch.equal(torch.stack(toks, 1), out):
            raise AssertionError("phase 17 lm_serve: prefill + decode_step gave other tokens than generate")
        del cache
        # teacher-forced forward over the prompts and every generated token
        # (S + N = 2112 = 6 · 352 keeps the reference's blocks)
        with torch.no_grad():
            tables = _tables(cfg, params)
            h, _ = backbone(cfg, params, *_embed_inputs(cfg, tables, {"tokens": torch.cat([prompts, out], 1)}))
            tf = _logits(tables, h[:, S - 1:S - 1 + N])  # (P, N, V)
        dec = torch.stack(dec, 1)
        gap = float((dec - tf).abs().max())
        excess = tf.amax(-1) - tf.gather(-1, out.long()[..., None])[..., 0]
        differ = torch.argmax(tf, -1) != out
        worst = float(excess[differ].max()) if bool(differ.any()) else 0.0
        del h, tf, dec
        row = dict(prompts=P, prompt_len=S, new=N, params=sum(t.numel() for t in tree_leaves(params)),
                   generate_s=t_gen, prefill_ms=1e3 * t_pre, prefill_tok_s=P * S / t_pre,
                   decode_ms_per_token=1e3 * t_dec / (N - 1), generated_tok_s=P * (N - 1) / t_dec,
                   kv_cache_bytes=kv_bytes, peak_gib=peak, launches=self.launches["lm_serve"],
                   tf_gap=gap, tf_mismatches=int(differ.sum()), tf_worst_excess=worst)
        _p(f"phase 17: lm_serve ({cfg.name} bf16, {row['params']} parameters; generate = prefill + greedy decode; "
           f"card: {self.smi}): {json.dumps(row)}")
        if not (gap <= self.TF_GAP_MAX and worst <= 2 * gap and self.launches["lm_serve"] == {}):
            raise AssertionError(f"phase 17 lm_serve: {row}")

        # f32 gates on GATE_PROMPTS prompts: prefill S - K tokens (S - K = 2032
        # keeps 4 query and 2 kv blocks), then K cached decode steps fed the
        # prompts' next tokens, each against forward over all S tokens
        cfg32 = cfg.replace(dtype="float32")
        p32 = tree_map(lambda t: t.float(), params)
        del params
        torch.cuda.empty_cache()
        K = self.GATE_DECODE_STEPS
        pr = prompts[: self.GATE_PROMPTS]

        def share(got, want):
            return float(((got - want).abs() / (self.SERVE_TOL + self.SERVE_TOL * want.abs())).max())

        pre, cache = prefill(cfg32, p32, {"tokens": pr[:, : S - K]}, S_cache=S)
        with torch.no_grad():  # forward's logits at the K + 1 positions read
            tables = _tables(cfg32, p32)
            h, _ = backbone(cfg32, p32, *_embed_inputs(cfg32, tables, {"tokens": pr}))
            want = _logits(tables, h[:, S - K - 1:])  # (GATE_PROMPTS, K + 1, V)
        del h
        e_pre, e_dec = share(pre, want[:, 0]), []
        for i in range(K):
            dlg, cache = decode_step(cfg32, p32, cache, pr[:, S - K + i], S - K + i)
            e_dec.append(share(dlg, want[:, 1 + i]))
        row = dict(prompts=self.GATE_PROMPTS, prompt_len=S - K, decode_steps=K, prefill_share=e_pre,
                   decode_share_max=max(e_dec), decode_shares=e_dec)
        _p(f"phase 17: lm_serve f32 gates (|Δ| as a share of {self.SERVE_TOL}·(1 + |forward|), allclose's "
           f"bound): {json.dumps(row)}")
        if not (e_pre <= 1 and max(e_dec) <= 1):
            raise AssertionError(f"phase 17 lm_serve f32: {row}")
        del p32, cache, pre, dlg, want

    # ---- lm_train ------------------------------------------------------------

    def train(self):
        from repro_torch.data import batch_at
        from repro_torch.models.common import tree_leaves
        from repro_torch.train import checkpoint as ckpt_lib
        from repro_torch.train import init_train_state, make_train_step, train_loop

        torch, dev = self.torch, self.dev
        cfg, dcfg, ocfg = self.config(), self.data(), self.opt()
        stamps = []
        torch.cuda.reset_peak_memory_stats()
        state, losses = self.counted("lm_train", lambda: train_loop(
            cfg, dcfg, ocfg, steps=self.STEPS, n_micro=self.MICRO, log_every=1, seed=self.SEED,
            log=lambda line: stamps.append(time.perf_counter()), device=dev))
        peak = torch.cuda.max_memory_allocated() / 2**30
        del state
        gaps = sorted(b - a for a, b in zip(stamps[1:], stamps[2:]))  # warm steps (each log reads the loss)
        step_s = gaps[len(gaps) // 2]
        first, last = losses[0][1], losses[-1][1]
        row = dict(steps=self.STEPS, seq=self.SEQ, global_batch=self.BATCH, n_micro=self.MICRO, first_loss=first,
                   last_loss=last, step_ms=1e3 * step_s, tok_s=self.SEQ * self.BATCH / step_s, peak_gib=peak,
                   launches=self.launches["lm_train"])
        _p(f"phase 17: lm_train ({cfg.name} full depth, bf16 parameters, f32 master; median warm step; card: "
           f"{self.smi}): {json.dumps(row)}")
        if not (all(math.isfinite(v) for _, v in losses) and last < first - 0.05 and row["launches"] == {}):
            raise AssertionError(f"phase 17 lm_train: {row}")
        torch.cuda.empty_cache()

        # depth 2, f32: the micro-batch equivalence ...
        cfg2 = cfg.replace(n_periods=self.SHALLOW, dtype="float32")
        batch = batch_at(dcfg, 0, device=dev)
        s1, _ = make_train_step(cfg2, ocfg, n_micro=1)(init_train_state(cfg2, self.SEED, device=dev), batch)
        s2, _ = make_train_step(cfg2, ocfg, n_micro=self.MICRO)(init_train_state(cfg2, self.SEED, device=dev), batch)
        d_master = max(float((a - b).abs().max()) for a, b in zip(tree_leaves(s1.opt["master"]),
                                                                   tree_leaves(s2.opt["master"])))
        d_m = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                  for a, b in zip(tree_leaves(s1.opt["m"]), tree_leaves(s2.opt["m"])))
        del s1, s2, batch
        torch.cuda.empty_cache()

        # ... and exact resume through the checkpoint store, each write timed
        writes, restores = [], []
        real_write, real_restore = ckpt_lib._write, ckpt_lib.restore

        def timed_write(ckpt_dir, step, host):
            t0 = time.perf_counter()
            out = real_write(ckpt_dir, step, host)
            writes.append(dict(step=int(step), s=time.perf_counter() - t0,
                               gb=sum(a.nbytes for a in host.values()) / 1e9))
            return out

        def timed_restore(*a, **kw):
            out, t = _sync_time(torch, lambda: real_restore(*a, **kw))
            restores.append(t)
            return out

        d = f"{self.tmp}/resume"
        quiet = dict(seed=self.SEED, device=dev, log=lambda line: None, ckpt_every=10**9)
        _, straight = train_loop(cfg2, dcfg, ocfg, steps=self.RESUME_STEPS, log_every=self.RESUME_STEPS, **quiet)
        ckpt_lib._write, ckpt_lib.restore = timed_write, timed_restore
        try:
            _, t_a = _sync_time(torch, lambda: train_loop(cfg2, dcfg, ocfg, steps=self.RESUME_AT, ckpt_dir=d,
                                                          log_every=self.RESUME_STEPS, **quiet))
            (_, resumed), t_b = _sync_time(torch, lambda: train_loop(cfg2, dcfg, ocfg, steps=self.RESUME_STEPS,
                                                                     ckpt_dir=d, log_every=self.RESUME_STEPS, **quiet))
        finally:
            ckpt_lib._write, ckpt_lib.restore = real_write, real_restore
        gap = abs(straight[-1][1] - resumed[-1][1])
        row = dict(n_periods=self.SHALLOW, micro_master_max_abs=d_master, micro_m_rel=d_m,
                   straight_loss=straight[-1][1], resumed_loss=resumed[-1][1], resume_gap=gap,
                   writes=writes, restore_s=restores, first_leg_s=t_a, second_leg_s=t_b)
        _p(f"phase 17: lm_train gates (full width, depth {self.SHALLOW}, f32; n_micro 1 against {self.MICRO}; "
           f"{self.RESUME_AT} steps + {self.RESUME_STEPS - self.RESUME_AT} after a resume against {self.RESUME_STEPS} "
           f"straight; card: {self.smi}): {json.dumps(row)}")
        if not (d_master < 1e-5 and d_m < 1e-4 and gap < 1e-4 and len(writes) == 2 and len(restores) == 1):
            raise AssertionError(f"phase 17 lm_train gates: {row}")

    # ---- lm_dp_nccl_p1 -------------------------------------------------------

    def nccl_p1(self):
        import datetime

        import torch.distributed as dist
        from repro_torch.data import batch_at
        from repro_torch.kernels import countsketch_ref
        from repro_torch.optim import CompressionConfig, compress_state_init
        from repro_torch.optim import compression as comp_mod
        from repro_torch.train import init_train_state, make_dp_train_step

        torch, dev = self.torch, self.dev
        cfg, dcfg, ocfg = self.config(), self.data(), self.opt()
        kw = {"device_id": torch.device(dev.type, torch.cuda.current_device())} if dev.type == "cuda" else {}
        dist.init_process_group(self.P1_BACKEND, init_method=f"file://{self.tmp}/p1", rank=0, world_size=1,
                                timeout=datetime.timedelta(seconds=self.TIMEOUT_S), **kw)
        first = {}
        real_apply = comp_mod.countsketch_apply

        def capture(A, buckets, signs, d, *a, **k):  # the step's first sketch: the embedding's gradient
            out = real_apply(A, buckets, signs, d, *a, **k)
            if not first:
                first.update(A=A.clone(), h=buckets.clone(), w=signs.clone(), d=d, out=out.clone())
            return out

        rows = {}
        try:
            for mode in ("compressed", "uncompressed"):
                comp = CompressionConfig(**self.COMPRESS) if mode == "compressed" else None
                state = init_train_state(cfg, self.SEED, device=dev)
                ef = compress_state_init(comp, state.params) if comp else None
                step = make_dp_train_step(cfg, ocfg, compression=comp)
                torch.cuda.reset_peak_memory_stats()
                walls, losses, launches, nbytes = [], [], [], []
                for i in range(self.DP_STEPS):
                    batch = batch_at(dcfg, i, device=dev)
                    comp_mod.countsketch_apply = capture if (comp and i == 0) else real_apply
                    try:
                        def one():
                            with _Collectives() as coll, _NoPlain(torch):
                                res = step(state, ef, batch)
                            nbytes.append(coll.bytes["all_reduce"])
                            return res
                        ((state, ef), m), t = _sync_time(torch, lambda: self.counted(f"lm_dp_nccl_p1_{mode}", one))
                    finally:
                        comp_mod.countsketch_apply = real_apply
                    walls.append(t)
                    losses.append(float(m["loss"]))
                    launches.append(self.launches.pop(f"lm_dp_nccl_p1_{mode}"))
                rows[mode] = dict(step_ms=[1e3 * w for w in walls], losses=losses, launches=launches[0],
                                  all_reduce_bytes=nbytes[0], peak_gib=torch.cuda.max_memory_allocated() / 2**30)
                want = {"countsketch_apply": _n_compressed(cfg, comp.min_size)} if comp else {}
                if not (all(lc == want for lc in launches) and all(math.isfinite(v) for v in losses)):
                    raise AssertionError(f"phase 17 lm_dp_nccl_p1 {mode}: launches {launches} (want {want} a "
                                         f"step), losses {losses}")
                del state, ef, step, batch
                torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()
        plain = countsketch_ref(first["A"].cpu(), first["h"].cpu(), first["w"].cpu(), first["d"])
        rows["b1_embed_bitwise_cpu"] = bool(torch.equal(first["out"].cpu(), plain))
        rows["b1_embed_entries"] = first["A"].numel()
        del first, plain
        self.launches["lm_dp_nccl_p1"] = rows["compressed"]["launches"]
        self.launches["lm_dp_nccl_p1_uncompressed"] = rows["uncompressed"]["launches"]
        ms = {k: sorted(rows[k]["step_ms"][1:])[len(rows[k]["step_ms"][1:]) // 2] for k in ("compressed",
                                                                                             "uncompressed")}
        rows["median_warm_step_ms"] = ms
        _p(f"phase 17: lm_dp_nccl_p1 ({cfg.name} full depth, world of one {self.P1_BACKEND} rank, "
           f"{self.DP_STEPS} steps each, ratio {self.COMPRESS['ratio']}; card: {self.smi}): {json.dumps(rows)}")
        if not rows["b1_embed_bitwise_cpu"]:
            raise AssertionError("phase 17 lm_dp_nccl_p1: B1's sketch of the embedding's gradient differs from its "
                                 "plain version on the CPU")
        self.nccl_rows = rows

    # ---- lm_dp_gloo_p4 -------------------------------------------------------

    def gloo_p4(self):
        import queue as queue_lib

        import torch.multiprocessing as mp

        torch = self.torch
        cfg = self.config(n_periods=self.SHALLOW)
        if self.dev.type == "cuda":
            free, total = torch.cuda.mem_get_info()
            need = self.WORLD * self.RANK_MEM_FRACTION * total
            if free < need:
                raise AssertionError(f"phase 17 lm_dp_gloo_p4: {free / 2**30:.1f} GiB free on the card, the "
                                     f"ranks' caps take {need / 2**30:.1f}; this process holds "
                                     f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
        plan = dict(cfg=cfg, seed=self.SEED, seq=self.SEQ, batch=self.BATCH, opt=self.OPT, compress=self.COMPRESS,
                    steps=self.DP_STEPS, timeout_s=self.TIMEOUT_S, mem_fraction=self.RANK_MEM_FRACTION,
                    device=f"cuda:{torch.cuda.current_device()}" if self.dev.type == "cuda" else str(self.dev))
        ctx = mp.get_context("spawn")
        results = ctx.Queue()
        procs = [ctx.Process(target=self.TARGET, name=f"phase17-rank{r}",
                             args=(r, self.WORLD, f"file://{self.tmp}/p4", plan, results))
                 for r in range(self.WORLD)]
        ranks = {}
        t0 = time.perf_counter()
        try:
            for p in procs:
                p.start()
            while len(ranks) < self.WORLD:
                left = self.DEADLINE_S - (time.perf_counter() - t0)
                try:
                    rank, out, err = results.get(timeout=max(left, 1.0))
                except queue_lib.Empty:
                    raise AssertionError(f"phase 17: the gloo world gave {len(ranks)} of {self.WORLD} results "
                                         f"in {self.DEADLINE_S} s") from None
                if err is not None:
                    raise AssertionError(f"phase 17: gloo rank {rank} failed:\n{err}")
                ranks[rank] = out
            for p in procs:
                p.join(timeout=60)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=10)
        t_world = time.perf_counter() - t0
        codes = [p.exitcode for p in procs]
        if codes != [0] * self.WORLD:
            raise AssertionError(f"phase 17: gloo ranks exited {codes}")
        ranks = [ranks[r] for r in range(self.WORLD)]
        n_big = _n_compressed(cfg, self.COMPRESS["min_size"])
        table = {}
        for mode, want in (("compressed", {"countsketch_apply": n_big}), ("uncompressed", {})):
            steps = [r[mode]["steps"] for r in ranks]
            bitwise = all(s[i]["digest"] == steps[0][i]["digest"] for s in steps for i in range(self.DP_STEPS))
            losses = [s["loss"] for s in steps[0]]
            same_loss = all([s["loss"] for s in st] == losses for st in steps)
            launches_ok = all(s["launches"] == want for st in steps for s in st)
            walls = [max(st[i]["wall"] for st in steps) for i in range(self.DP_STEPS)]
            table[mode] = dict(losses=losses, bitwise_ranks=bitwise, same_loss=same_loss, launches=steps[0][0]["launches"],
                               step_s=walls, median_warm_step_s=sorted(walls[1:])[len(walls[1:]) // 2],
                               all_reduce_bytes=steps[0][0]["bytes"], peak_gib=[r[mode]["peak_gib"] for r in ranks],
                               reserved_gib=[r[mode]["reserved_gib"] for r in ranks])
            if not (bitwise and same_loss and launches_ok and losses[-1] < losses[0]):
                raise AssertionError(f"phase 17 lm_dp_gloo_p4 {mode}: {table[mode]}")
        self.launches["lm_dp_gloo_p4"] = table["compressed"]["launches"]
        _p(f"phase 17: lm_dp_gloo_p4 ({cfg.name} full width, depth {self.SHALLOW}, {self.WORLD} gloo ranks on one "
           f"card, {self.BATCH // self.WORLD} rows a rank, {self.DP_STEPS} steps each; the slowest rank's walls; "
           f"world {t_world:.1f} s with start-up; card: {self.smi}): {json.dumps(table)}")


class _MoEWatch:
    """Watches the MoE dispatch of a run: wraps ``models.moe._capacity``,
    ``_rank_in_expert`` and ``_route`` (the dispatch calls them by module
    name), keeps each dispatch's dropped count on the device and, with
    ``routes=True``, each routing call's (probabilities, expert ids) in
    call order."""

    def __init__(self, torch, routes=False):
        self.torch, self.keep_routes = torch, routes
        self.dropped, self.total, self.capacity, self.routes = [], 0, None, []

    def __enter__(self):
        from repro_torch.models import moe

        self.moe = moe
        self.real = (moe._capacity, moe._rank_in_expert, moe._route)

        def capacity(T, m):
            self.capacity = self.real[0](T, m)
            return self.capacity

        def rank(flat_e, E):
            r = self.real[1](flat_e, E)
            self.dropped.append((r >= self.capacity).sum())
            self.total += r.numel()
            return r

        def route(p_router, h, m):
            out = self.real[2](p_router, h, m)
            if self.keep_routes:
                self.routes.append((out[0], out[2]))
            return out

        moe._capacity, moe._rank_in_expert, moe._route = capacity, rank, route
        return self

    def __exit__(self, *exc):
        self.moe._capacity, self.moe._rank_in_expert, self.moe._route = self.real

    def share(self):
        """The dropped share of the assignments the dispatches saw."""
        return float(self.torch.stack(self.dropped).sum()) / self.total if self.total else 0.0


class _Phase18:
    """Phase 18: the LM families (``repro_torch.models`` MoE, MLA, SSD,
    RG-LRU and cross-attention) at their published widths from the port's
    own ``configs.get_config``, last, one family at a time on the card, each
    freed before the next; only the depth is cut, keeping at least one
    whole period of the layer pattern.  Weights are bf16 from
    ``init_params`` on a seeded generator; the vision model's tanh gates
    (zero at init, where cross-attention adds nothing) are set to seeded
    values in [0.3, 0.7].

    For each family: (1) serve 8 prompts of 2048 tokens and 32 new tokens:
    ``generate`` (the vision model: ``prefill`` + ``decode_step(img=)``
    with 1600 seeded patch embeddings a prompt, as the reference's serving
    test drives it), then prefill and the decode loop timed apart (their
    tokens bitwise ``generate``'s); the MoE models at their published
    capacity factor 1.25 print the share of assignments dropped in prefill,
    and two prefills give bitwise-equal logits.  (2) The bf16
    teacher-forced gate: the greedy tokens against a ``forward`` over the
    prompts and the generated tokens.  Phase 17's rule (the largest
    |decode − forward| logit gap ≤ 0.2, and where the tokens differ,
    forward's top logit exceeds its logit at the generated token by at most
    twice that gap) is read at the positions whose top-k routing agrees in
    every MoE layer between decode and forward and between the bf16 and
    the f32 forward (the count printed), and its 0.2 becomes max(0.2, 2e),
    e the bf16 forward's own largest distance from the f32 forward of the
    same weights there (decode and forward are both bf16 roundings of one
    function; at 38–64 layers e passes 0.1); each position's first routing
    difference between decode and forward must be a near-tie (TIE_MARGIN).
    The MoE models run it at capacity factor 8.0, the drop-free regime of
    the reference's serving test (capacity drops depend on the batch), with
    the drops counted.  (3) The f32 gate at one period
    (deepseek: its dense prefix + one period): 2 prompts of 512 tokens,
    ``prefill`` of the first 496, then 16 cached ``decode_step``s, each
    within phase 17's 2e-3 of ``forward`` over all 512 (MoE at 8.0).  (4)
    ``train_loop``, 5 steps (bf16 parameters, f32 master, the bigram stream
    at seq 512, global batch 8, ``n_micro`` 2; the vision model with
    seeded image embeddings in each batch): the loss finite and falling;
    deepseek, whose one full-width MoE period needs more AdamW state than
    the card holds, gets one ``loss_fn`` forward and backward at its prefix
    + one period instead.  None of these paths launches a port kernel (the
    families' products are torch matmuls, as the reference's are outside
    Pallas), which is held.  Walls, rates, cache bytes and peaks print
    beside the card's name and power limit."""

    # (cell, arch, serve depth, gate depth, train depth or None: one loss_fn)
    FAMILIES = (
        ("moe_serve", "mixtral-8x7b", dict(n_periods=4), dict(n_periods=1), dict(n_periods=1)),
        ("mla_moe_serve", "deepseek-v2-236b", dict(n_periods=2), dict(n_periods=1), None),
        ("ssd_serve", "mamba2-2.7b", {}, dict(n_periods=1), {}),
        ("rglru_serve", "recurrentgemma-9b", {}, dict(n_periods=1), dict(n_periods=1)),
        ("xattn_serve", "llama-3.2-vision-11b", {}, dict(n_periods=1), dict(n_periods=1)),
    )
    CFGS = None  # {arch: config} in place of get_config(arch) (CPU rehearsals)
    SEED = 1802
    PROMPTS, PROMPT_LEN, NEW = 8, 2048, 32
    GATE_PROMPTS, GATE_LEN, GATE_DECODE_STEPS = 2, 512, 16
    SERVE_TOL = 2e-3  # tests/test_serving_consistency.py
    TF_GAP_MAX = 0.2  # phase 17's bf16 ceiling: the floor of the bound
    # a routing difference between decode and forward must be a near-tie: the
    # forward's probability of an expert only it chose exceeds that of one only
    # the decode chose by at most this share of it
    TIE_MARGIN = 0.1
    DROP_FREE = 8.0  # the reference serving test's capacity factor
    TF_GROUP = 2  # prompts a teacher-forced forward takes at once (bounds its MoE buffers)
    SEQ, BATCH, MICRO, STEPS = 512, 8, 2, 5
    OPT = dict(lr=1e-3, warmup_steps=1)  # full rate from the second step; 3e-3 overshot at step 5

    def __init__(self, torch, dev, smi):
        self.torch, self.dev, self.smi = torch, dev, smi
        self.launches, self.walls, self.rows = {}, {}, {}

    def config(self, arch, **kw):
        from repro_torch.configs import get_config

        return ((self.CFGS or {}).get(arch) or get_config(arch)).replace(**kw)

    def drop_free(self, cfg):
        if cfg.moe is None:
            return cfg
        return cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=self.DROP_FREE))

    def counted(self, name, fn):
        """``fn()`` with every kernel's launch count set to 0 just before and
        read just after; the counts are kept under ``name``."""
        from repro_torch.kernels import KERNELS, reset_launches

        _sync(self.torch, self.dev)
        reset_launches()
        out = fn()
        _sync(self.torch, self.dev)
        self.launches[name] = {f.__name__: f.launches for f in KERNELS if f.launches}
        return out

    def free(self):
        import gc

        gc.collect()
        self.torch.cuda.empty_cache()

    def run(self):
        torch = self.torch
        self.free()
        free, total = torch.cuda.mem_get_info()
        _p(f"phase 18: {free / 2**30:.1f} of {total / 2**30:.1f} GiB free on the card as the families start")
        for cell, arch, serve_kw, gate_kw, train_kw in self.FAMILIES:
            t0 = time.perf_counter()
            self.serve(cell, arch, serve_kw)
            self.free()
            self.gates(cell, arch, gate_kw)
            self.free()
            if train_kw is None:
                self.loss_once(cell, arch, gate_kw)
            else:
                self.train(cell, arch, train_kw)
            self.free()
            self.walls[cell] = time.perf_counter() - t0
        _p(f"phase 18: families' walls (s; card: {self.smi}) {json.dumps(self.walls)}; launches by part "
           f"{json.dumps(self.launches)}")
        if any(self.launches.values()):
            raise AssertionError(f"phase 18: a family's path launched a port kernel: {self.launches}")

    # ---- inputs ----------------------------------------------------------------

    def weights(self, cfg, gen):
        from repro_torch.models import init_params

        params = init_params(cfg, gen, device=self.dev)
        for i, spec in enumerate(cfg.pattern):
            if spec.mixer == "cross_attn":
                gate = params["pattern"][i]["mixer"]["gate"]
                u = self.torch.rand(gate.shape, generator=gen, device=gate.device)
                gate.copy_(0.3 + 0.4 * u)
        return params

    def image(self, cfg, n, gen):
        """{"image_embeds": (n, n_patches, D) seeded f32} for the vision model."""
        if cfg.frontend != "vision":
            return {}
        return {"image_embeds": self.torch.randn((n, cfg.n_patches, cfg.d_model), generator=gen, device=self.dev)}

    # ---- serving ---------------------------------------------------------------

    def decode_loop(self, cfg, params, batch, N):
        """prefill + N − 1 greedy ``decode_step``s, timed apart: (tokens (P, N),
        logits (P, N, V), cache bytes, prefill s, decode s)."""
        from repro_torch.models import decode_step, prefill
        from repro_torch.models.common import tree_leaves

        torch = self.torch
        S = batch["tokens"].shape[1]
        img = batch.get("image_embeds")
        (logits, cache), t_pre = _sync_time(torch, lambda: prefill(cfg, params, batch, S_cache=S + N))
        nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(cache))
        toks, dec = [torch.argmax(logits, -1).to(torch.int32)], [logits]

        def loop():
            nonlocal cache
            for i in range(N - 1):
                lg, cache = decode_step(cfg, params, cache, toks[-1], S + i, img=img)
                toks.append(torch.argmax(lg, -1).to(torch.int32))
                dec.append(lg)

        _, t_dec = _sync_time(torch, loop)
        return torch.stack(toks, 1), torch.stack(dec, 1), nbytes, t_pre, t_dec

    def teacher_forced(self, cfg, params, batch, out):
        """forward's logits at the positions whose next tokens are ``out``:
        (P, N, V), TF_GROUP prompts at a time."""
        from repro_torch.models.transformer import _embed_inputs, _logits, _tables, backbone

        torch = self.torch
        S, N = batch["tokens"].shape[1], out.shape[1]
        seq = torch.cat([batch["tokens"], out], 1)
        tf = []
        with torch.no_grad():
            for g in range(0, seq.shape[0], self.TF_GROUP):
                part = {k: v[g:g + self.TF_GROUP] for k, v in batch.items()}
                part["tokens"] = seq[g:g + self.TF_GROUP]
                tables = _tables(cfg, params)
                h, _ = backbone(cfg, params, *_embed_inputs(cfg, tables, part))
                tf.append(_logits(tables, h[:, S - 1:S - 1 + N]))
                del h
        return torch.cat(tf)

    def serve(self, cell, arch, kw):
        from repro_torch.models import prefill
        from repro_torch.models.common import tree_leaves, tree_map
        from repro_torch.train import generate

        torch, dev = self.torch, self.dev
        cfg = self.config(arch, **kw)
        gen = torch.Generator(device=dev).manual_seed(self.SEED)
        params = self.weights(cfg, gen)
        P, S, N = self.PROMPTS, self.PROMPT_LEN, self.NEW
        batch = {"tokens": torch.randint(0, cfg.vocab, (P, S), generator=gen, dtype=torch.int32, device=dev),
                 **self.image(cfg, P, gen)}
        token = cfg.frontend == "token"
        short = dict(batch, tokens=batch["tokens"][:, : S // 16])
        self.decode_loop(cfg, params, short, 2)  # warm-up: the library's handles
        torch.cuda.reset_peak_memory_stats()
        if token:  # the user's entry point
            out, t_gen = _sync_time(torch, lambda: self.counted(cell, lambda: generate(cfg, params, batch["tokens"],
                                                                                        max_new=N)))
        with _MoEWatch(torch) as drops:
            toks, dec, cache_bytes, t_pre, t_dec = self.counted(f"{cell}_parts", lambda: self.decode_loop(
                cfg, params, batch, N))
        peak = torch.cuda.max_memory_allocated() / 2**30
        if token and not torch.equal(toks, out):
            raise AssertionError(f"phase 18 {cell}: prefill + decode_step gave other tokens than generate")
        row = dict(arch=cfg.name, n_layers=cfg.n_layers, params=sum(t.numel() for t in tree_leaves(params)),
                   prompts=P, prompt_len=S, new=N, prefill_ms=1e3 * t_pre, prefill_tok_s=P * S / t_pre,
                   decode_ms_per_token=1e3 * t_dec / (N - 1), generated_tok_s=P * (N - 1) / t_dec,
                   cache_bytes=cache_bytes, peak_gib=peak)
        if token:
            row["generate_s"] = t_gen
        if cfg.moe is not None:
            row["capacity_factor"] = cfg.moe.capacity_factor
            row["dropped_share_prefill"] = drops.share()
            again, _ = prefill(cfg, params, batch, S_cache=S + N)
            row["prefill_bitwise_repeat"] = bool(torch.equal(again, dec[:, 0]))
            del again
        # the teacher-forced gate; the MoE models drop-free (capacity drops
        # depend on the batch), their routing recorded on all three sides
        cfg = self.drop_free(cfg)
        w_dec, w_tf, w_32 = (_MoEWatch(torch, routes=True) for _ in range(3))
        if cfg.moe is not None:
            with w_dec:
                toks, dec, _, _, _ = self.counted(f"{cell}_drop_free", lambda: self.decode_loop(cfg, params, batch, N))
        with w_tf:
            tf = self.teacher_forced(cfg, params, batch, toks)
        agree, flips, margin = self.routing_agreement(cfg, w_dec.routes, w_tf.routes, P, S, N)
        # the bf16 model's own rounding error at these positions: the
        # distance of its forward from the f32 forward of the same weights,
        # read only where the f32 forward routes alike too (the bf16 forward
        # itself can flip a near-tie the f32 forward does not)
        cfg32 = cfg.replace(dtype="float32")
        params = tree_map(lambda t: t.float(), params)
        self.free()
        with w_32:
            tf32 = self.teacher_forced(cfg32, params, batch, toks)
        del params
        alike_f32 = self.forward_agreement(cfg, w_tf.routes, w_32.routes, P, S, N)
        agree_decode = int(agree.sum())
        agree = agree & alike_f32
        drop_free_share = max(w_dec.share(), w_tf.share(), w_32.share())
        del w_dec, w_tf, w_32
        if not bool(agree.any()):
            raise AssertionError(f"phase 18 {cell}: no position routed alike by decode and both forwards")
        gaps, errs = (dec - tf).abs().amax(-1), (tf - tf32).abs().amax(-1)  # (P, N)
        gap = float(gaps[agree].max())
        bf16_err = float(errs[agree].max())
        excess = tf.amax(-1) - tf.gather(-1, toks.long()[..., None])[..., 0]
        differ = (torch.argmax(tf, -1) != toks) & agree
        worst = float(excess[differ].max()) if bool(differ.any()) else 0.0
        bound = max(self.TF_GAP_MAX, 2 * bf16_err)
        row.update(tf_gap=gap, tf_gap_all=float(gaps.max()), bf16_forward_err=bf16_err, tf_bound=bound,
                   tf_mismatches=int(differ.sum()), tf_worst_excess=worst, launches=self.launches.get(cell, {}))
        if cfg.moe is not None:
            row.update(dropped_share_drop_free=drop_free_share, routing_differences=flips,
                       positions=P * N, positions_alike_decode=agree_decode,
                       positions_alike_all_three=int(agree.sum()), worst_tie_margin=margin)
        self.rows[cell] = row
        _p(f"phase 18: {cell} ({cfg.name} bf16 at published widths, {cfg.n_layers} layers; card: {self.smi}): "
           f"{json.dumps(row)}")
        ok = gap <= bound and worst <= 2 * gap
        if cfg.moe is not None:
            ok = ok and row["prefill_bitwise_repeat"] and row["dropped_share_drop_free"] == 0.0 \
                and margin <= self.TIE_MARGIN
        if not ok:
            raise AssertionError(f"phase 18 {cell}: {row}")

    def routing_agreement(self, cfg, dec_routes, tf_routes, P, S, N):
        """Which compared positions every MoE layer routed alike in decode and
        in the teacher-forced forward: ((P, N) bool, the count of differing
        (position, layer) decisions, the largest relative margin in the
        forward's probabilities between an expert only it chose and one only
        the decode chose, at each position's first differing layer: past it
        the two hidden states differ by an expert's output, and the later
        layers' choices with them).  Decode's calls run prefill (row
        p·S + S − 1 for position 0), then a step a position (row p); the
        forward's run TF_GROUP prompts a call (row (p mod G)·(S + N) + S − 1
        + j)."""
        torch = self.torch
        agree = torch.ones((P, N), dtype=torch.bool)
        if cfg.moe is None:
            return agree.to(self.dev), 0, 0.0
        n_moe = len(dec_routes) // N
        G, flips, margin = self.TF_GROUP, 0, 0.0
        for p in range(P):
            for j in range(N):
                for layer in range(n_moe):
                    _, idx_d = dec_routes[j * n_moe + layer]
                    probs_f, idx_f = tf_routes[(p // G) * n_moe + layer]
                    d = idx_d[p * S + S - 1 if j == 0 else p]
                    row_f = (p % G) * (S + N) + S - 1 + j
                    f, pf = idx_f[row_f], probs_f[row_f]
                    only_f = sorted(set(f.tolist()) - set(d.tolist()))
                    if not only_f:
                        continue
                    flips += 1
                    if bool(agree[p, j]):  # the first differing layer
                        agree[p, j] = False
                        only_d = sorted(set(d.tolist()) - set(f.tolist()))
                        low = float(pf[only_f].min())
                        margin = max(margin, (low - float(pf[only_d].max())) / low)
        return agree.to(self.dev), flips, margin

    def forward_agreement(self, cfg, routes_a, routes_b, P, S, N):
        """Which compared positions every MoE layer routed alike in two
        teacher-forced forwards of the same tokens (the bf16 and the f32
        one): (P, N) bool.  Both run TF_GROUP prompts a call, each call's
        layers in order (row (p mod G)·(S + N) + S − 1 + j)."""
        torch = self.torch
        agree = torch.ones((P, N), dtype=torch.bool, device=self.dev)
        if cfg.moe is None:
            return agree
        G = self.TF_GROUP
        n_moe = len(routes_a) // -(-P // G)
        cols = S - 1 + torch.arange(N, device=self.dev)
        for c, ((_, ia), (_, ib)) in enumerate(zip(routes_a, routes_b)):
            same = (ia.sort(-1).values == ib.sort(-1).values).all(-1)
            for pl in range(G):
                p = (c // n_moe) * G + pl
                if p < P:
                    agree[p] &= same[pl * (S + N) + cols]
        return agree

    # ---- the f32 gate --------------------------------------------------------

    def gates(self, cell, arch, kw):
        from repro_torch.models import decode_step, prefill
        from repro_torch.models.transformer import _embed_inputs, _logits, _tables, backbone

        torch, dev = self.torch, self.dev
        cfg = self.drop_free(self.config(arch, dtype="float32", **kw))
        gen = torch.Generator(device=dev).manual_seed(self.SEED + 1)
        params = self.weights(cfg, gen)
        L, K = self.GATE_LEN, self.GATE_DECODE_STEPS
        pr = torch.randint(0, cfg.vocab, (self.GATE_PROMPTS, L), generator=gen, dtype=torch.int32, device=dev)
        img = self.image(cfg, self.GATE_PROMPTS, gen)

        def share(got, want):
            return float(((got - want).abs() / (self.SERVE_TOL + self.SERVE_TOL * want.abs())).max())

        def run():
            pre, cache = prefill(cfg, params, {"tokens": pr[:, : L - K], **img}, S_cache=L)
            with torch.no_grad():
                tables = _tables(cfg, params)
                h, _ = backbone(cfg, params, *_embed_inputs(cfg, tables, {"tokens": pr, **img}))
                want = _logits(tables, h[:, L - K - 1:])  # (GATE_PROMPTS, K + 1, V)
            del h
            shares = [share(pre, want[:, 0])]
            for i in range(K):
                dlg, cache = decode_step(cfg, params, cache, pr[:, L - K + i], L - K + i,
                                         img=img.get("image_embeds"))
                shares.append(share(dlg, want[:, 1 + i]))
            return shares

        with _MoEWatch(torch) as drops:
            shares = self.counted(f"{cell}_f32_gate", run)
        row = dict(n_layers=cfg.n_layers, prompts=self.GATE_PROMPTS, prompt_len=L - K, decode_steps=K,
                   prefill_share=shares[0], decode_share_max=max(shares[1:]), dropped_share=drops.share())
        _p(f"phase 18: {cell} f32 gate (|Δ| as a share of {self.SERVE_TOL}·(1 + |forward|), allclose's bound; "
           f"card: {self.smi}): {json.dumps(row)}")
        if not (max(shares) <= 1 and drops.share() == 0.0):
            raise AssertionError(f"phase 18 {cell} f32 gate: {row}")

    # ---- training --------------------------------------------------------------

    def train(self, cell, arch, kw):
        from repro_torch.data import SyntheticConfig
        from repro_torch.models.common import tree_leaves
        from repro_torch.optim import AdamWConfig
        from repro_torch.train import loop as loop_mod

        torch, dev = self.torch, self.dev
        cfg = self.config(arch, **kw)
        dcfg = SyntheticConfig(vocab=cfg.vocab, seq_len=self.SEQ, global_batch=self.BATCH)
        real_batch_at = loop_mod.batch_at

        def with_image(dcfg, step, *, device=None):  # the vision model's batches carry seeded image embeddings
            batch = real_batch_at(dcfg, step, device=device)
            gen = torch.Generator(device=dev).manual_seed(self.SEED + 100 + step)
            return {**batch, **self.image(cfg, self.BATCH, gen)}

        stamps = []
        torch.cuda.reset_peak_memory_stats()
        loop_mod.batch_at = with_image
        try:
            state, losses = self.counted(f"{cell}_train", lambda: loop_mod.train_loop(
                cfg, dcfg, AdamWConfig(**self.OPT), steps=self.STEPS, n_micro=self.MICRO, log_every=1,
                seed=self.SEED, log=lambda line: stamps.append(time.perf_counter()), device=dev))
        finally:
            loop_mod.batch_at = real_batch_at
        peak = torch.cuda.max_memory_allocated() / 2**30
        n_params = sum(t.numel() for t in tree_leaves(state.params))
        del state
        gaps = sorted(b - a for a, b in zip(stamps[1:], stamps[2:]))  # warm steps (each log reads the loss)
        step_s = gaps[len(gaps) // 2]
        first, last = losses[0][1], losses[-1][1]
        row = dict(arch=cfg.name, n_layers=cfg.n_layers, params=n_params, steps=self.STEPS, seq=self.SEQ,
                   global_batch=self.BATCH, n_micro=self.MICRO, losses=[v for _, v in losses], step_ms=1e3 * step_s,
                   tok_s=self.SEQ * self.BATCH / step_s, peak_gib=peak, launches=self.launches[f"{cell}_train"])
        _p(f"phase 18: {cell} train ({cfg.name} bf16 parameters, f32 master, {cfg.n_layers} layers; median warm "
           f"step; card: {self.smi}): {json.dumps(row)}")
        if not (all(math.isfinite(v) for _, v in losses) and last < first):
            raise AssertionError(f"phase 18 {cell} train: {row}")

    def loss_once(self, cell, arch, kw):
        """One ``loss_fn`` forward and backward at ``kw``'s depth, bf16, no
        optimizer."""
        from repro_torch.data import SyntheticConfig, batch_at
        from repro_torch.models import loss_fn
        from repro_torch.models.common import tree_leaves
        from repro_torch.optim import global_norm

        torch, dev = self.torch, self.dev
        cfg = self.config(arch, **kw)
        params = self.weights(cfg, torch.Generator(device=dev).manual_seed(self.SEED + 2))
        leaves = tree_leaves(params)
        for t in leaves:
            t.requires_grad_()
        batch = batch_at(SyntheticConfig(vocab=cfg.vocab, seq_len=self.SEQ, global_batch=self.BATCH), 0, device=dev)
        torch.cuda.reset_peak_memory_stats()

        def step():
            loss, metrics = loss_fn(cfg, params, batch)
            return loss.detach(), metrics["aux"].detach(), torch.autograd.grad(loss, leaves)

        (loss, aux, grads), t = _sync_time(torch, lambda: self.counted(f"{cell}_loss", step))
        row = dict(arch=cfg.name, n_layers=cfg.n_layers, params=sum(t.numel() for t in leaves), seq=self.SEQ,
                   batch=self.BATCH, loss=float(loss), aux=float(aux), grad_norm=float(global_norm(grads)),
                   forward_backward_ms=1e3 * t, tok_s=self.SEQ * self.BATCH / t,
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30, launches=self.launches[f"{cell}_loss"])
        _p(f"phase 18: {cell} loss_fn forward + backward ({cfg.name} bf16, {cfg.n_layers} layers, no optimizer; "
           f"card: {self.smi}): {json.dumps(row)}")
        if not (math.isfinite(row["loss"]) and row["aux"] > 0 and math.isfinite(row["grad_norm"])):
            raise AssertionError(f"phase 18 {cell} loss: {row}")


_MESH_AXES = {1: ("data",), 2: ("data", "model"), 3: ("pod", "data", "model")}  # a mesh shape's axes


def _open_cross_gates(torch, cfg, tree, seed):
    """Set the cross-attention layers' tanh gates of a parameter tree (or of
    its master) to seeded values in [0.3, 0.7]: zero at init, where
    cross-attention adds nothing.  The same values on every rank."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    for i, spec in enumerate(cfg.pattern):
        if spec.mixer == "cross_attn":
            gate = tree["pattern"][i]["mixer"]["gate"]
            with torch.no_grad():
                gate.copy_(0.3 + 0.4 * torch.rand(gate.shape, generator=gen))
    return tree


def _images(torch, cfg, n, seed):
    """(n, n_patches, D) seeded f32 image embeddings on the CPU, or None for
    a model with no vision front end."""
    if cfg.frontend != "vision":
        return None
    return torch.randn((n, cfg.n_patches, cfg.d_model), generator=torch.Generator(device="cpu").manual_seed(seed))


def _train_batch(torch, cfg, dcfg, i, seed, dev):
    """The bigram stream's global batch ``i`` (``batch_at``), with seeded
    image embeddings for the vision model (seed + i)."""
    from repro_torch.data import batch_at

    batch = batch_at(dcfg, i, device=dev)
    img = None if seed is None else _images(torch, cfg, dcfg.global_batch, seed + i)
    if img is not None:
        batch["image_embeds"] = img.to(dev)
    return batch


def _phase19_rank(rank, world, init, plan, refs, queue):
    """One rank of phase 19's gloo world, a process of its own on the card:
    its results (numbers only), or its traceback, go to ``queue``.
    ``refs``: the one-process references on the card (CUDA IPC), held by
    the parent until the world ends."""
    import traceback

    try:
        queue.put((rank, _Phase19Rank(rank, world, init, plan, refs).run(), None))
    except BaseException:
        queue.put((rank, None, traceback.format_exc()))
        raise


class _Phase19Rank:
    """One gloo rank of phase 19: the parts ``plan["parts"]`` in order, each
    on a mesh made over the world, every state this rank's blocks only."""

    def __init__(self, rank, world, init, plan, refs):
        import datetime
        import os

        import torch
        import torch.distributed as dist

        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))  # the host's cores, shared out
        self.torch, self.dist, self.rank, self.world, self.plan, self.refs = torch, dist, rank, world, plan, refs
        self.dev = torch.device(plan["device"])
        self.cuda = self.dev.type == "cuda"
        if self.cuda:
            # the ranks share the card: each caps its caching allocator at its share
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
            torch.cuda.set_device(self.dev)
            torch.cuda.set_per_process_memory_fraction(plan["mem_fraction"], self.dev)
        dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=plan["timeout_s"]))

    def run(self):
        import gc

        from repro_torch.launch.mesh import make_mesh

        out = {}
        try:
            self.meshes = {tuple(s): make_mesh(s, _MESH_AXES[len(s)]) for s in self.plan["meshes"]}
            for part in self.plan["parts"]:
                t0 = time.perf_counter()
                out[part] = getattr(self, part)()
                gc.collect()
                if self.cuda:
                    self.torch.cuda.empty_cache()
                out[part]["part_s"] = time.perf_counter() - t0
        finally:
            self.dist.destroy_process_group()
        return out

    # ---- helpers ---------------------------------------------------------------

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize()

    def gib(self, fn_name):
        return getattr(self.torch.cuda, fn_name)() / 2**30 if self.cuda else None

    def reset_peak(self):
        if self.cuda:
            self.torch.cuda.reset_peak_memory_stats()

    def data(self, cfg):
        from repro_torch.data import SyntheticConfig

        return SyntheticConfig(vocab=cfg.vocab, seq_len=self.plan["seq"], global_batch=self.plan["batch"])

    def steps(self, cfg, mesh, state, step_fn, first, n, watch=None, seed=None):
        """Steps ``first`` … ``first + n − 1`` on this rank's rows of each
        global batch (``_train_batch``; ``seed`` the image embeddings'):
        per step the metrics, the wall (after a barrier), the bytes handed to
        ``all_reduce`` and ``broadcast`` by kind, and the kernels launched."""
        from repro_torch.kernels import KERNELS, reset_launches
        from repro_torch.sharding import collectives as col
        from repro_torch.train import batch_pspec

        dcfg, recs = self.data(cfg), []
        for i in range(first, first + n):
            batch = {k: col.shard_block(v.to(self.dev), batch_pspec(mesh), mesh)
                     for k, v in _train_batch(self.torch, cfg, dcfg, i, seed, self.dev).items()}
            self.dist.barrier()
            self.sync()
            reset_launches()
            col.reset_bytes()
            t0 = time.perf_counter()
            with _Collectives() as coll:
                state, m = step_fn(state, batch)
                self.sync()
            wall = time.perf_counter() - t0
            rec = {k: float(v) for k, v in m.items()}
            rec.update(wall=wall, bytes=dict(col.BYTES), collective_bytes=coll.bytes["all_reduce"] + coll.bytes["broadcast"],
                       launches={f.__name__: f.launches for f in KERNELS if f.launches},
                       gather_axes=sorted({"+".join(c[1]) for c in col.CALLS["gather"]}))
            if watch is not None:
                rec["dropped_share"] = watch.share()
                watch.reset()
            recs.append(rec)
        return state, recs

    def state_bytes(self, state):
        from repro_torch.models.common import tree_leaves

        return sum(t.numel() * t.element_size() for t in tree_leaves(state.params) + tree_leaves(state.opt))

    # ---- lm_mesh_2x4 -----------------------------------------------------------

    def lm_mesh_2x4(self):
        """llama3.2-1b at full width, LM_PERIODS layers, bf16 with an f32
        master, sharded 8 ways: this rank's resident state, then STEPS
        steps."""
        from repro_torch.optim import AdamWConfig
        from repro_torch.train import init_sharded_state, jit_train_step

        plan, mesh = self.plan, self.meshes[tuple(self.plan["mesh"])]
        cfg = plan["llama"]
        self.reset_peak()
        base = self.gib("memory_allocated")
        state = init_sharded_state(cfg, plan["seed"], mesh, device=self.dev)
        self.sync()
        resident = None if base is None else self.gib("memory_allocated") - base
        init_peak = self.gib("max_memory_allocated")
        step_fn = jit_train_step(cfg, AdamWConfig(**plan["opt"]), mesh, n_micro=plan["micro"])
        self.reset_peak()
        state, recs = self.steps(cfg, mesh, state, step_fn, 0, plan["steps"])
        return dict(resident_gib=resident, state_bytes=self.state_bytes(state), init_peak_gib=init_peak,
                    peak_gib=self.gib("max_memory_allocated"), steps=recs)

    # ---- lm_mesh_gates ---------------------------------------------------------

    def lm_mesh_gates(self):
        """Depth 2 in f32 against the one-process step: m and v after step 1
        on this rank's blocks, the parameters after STEPS steps reassembled
        (rank 0 compares them), then the state saved sharded and one more
        step (elastic_2x4_to_2x2 compares its loss)."""
        from repro_torch.models.common import tree_leaves, tree_map
        from repro_torch.optim import AdamWConfig
        from repro_torch.sharding import NamedSharding, PartitionSpec
        from repro_torch.sharding import collectives as col
        from repro_torch.train import checkpoint as ckpt, init_sharded_state, jit_train_step, state_pspecs

        torch, plan, mesh, refs = self.torch, self.plan, self.meshes[tuple(self.plan["mesh"])], self.refs
        cfg = plan["gates_cfg"]
        is_spec = lambda x: isinstance(x, PartitionSpec)  # noqa: E731
        specs = state_pspecs(cfg, mesh)
        pspecs = tree_leaves(specs.params, is_leaf=is_spec)
        state = init_sharded_state(cfg, plan["gates_seed"], mesh, device=self.dev)
        step_fn = jit_train_step(cfg, AdamWConfig(**plan["gates_opt"]), mesh, n_micro=plan["micro"])
        state, recs = self.steps(cfg, mesh, state, step_fn, 0, 1)
        share = {}
        for tag in ("m", "v"):  # |Δ| as a share of 1e-4·|want| + 1e-5·max|want| (the CPU tests' rule)
            worst = 0.0
            for got, want, spec in zip(tree_leaves(state.opt[tag]), refs[tag], pspecs):
                w = want[col.block_slices(want.shape, spec, mesh)]
                bound = 1e-4 * w.abs() + 1e-5 * float(want.abs().max())
                worst = max(worst, float(((got - w).abs() / bound).max()))
            share[tag] = worst
        state, more = self.steps(cfg, mesh, state, step_fn, 1, plan["steps"] - 1)
        recs += more
        diff_sq, diff_max = 0.0, 0.0
        for got, want, spec in zip(tree_leaves(state.params), refs["params"], pspecs):
            whole = col.unshard(got, spec, mesh)  # every rank takes part; rank 0 compares
            if self.rank == 0:
                d = (whole - want).double()
                diff_sq += float((d * d).sum())
                diff_max = max(diff_max, float(d.abs().max()))
            del whole
        shardings = tree_map(lambda s: NamedSharding(mesh, s), specs, is_leaf=is_spec)
        self.sync()
        t0 = time.perf_counter()
        ckpt.save(plan["ckpt"], plan["steps"], state, shardings=shardings)
        save_s = time.perf_counter() - t0
        state, last = self.steps(cfg, mesh, state, step_fn, plan["steps"], 1)
        return dict(steps=recs, moment_share=share, param_diff_norm=math.sqrt(diff_sq), param_diff_max=diff_max,
                    save_s=save_s, next_step=last[0])

    # ---- moe_mesh_2x4 ----------------------------------------------------------

    def moe_mesh_2x4(self):
        """mixtral-8x7b at its published widths, one period, 2 experts a rank:
        the shard_map forward in f32 at the drop-free 4.0 against the
        parent's global dispatch, then STEPS train steps at 1.25."""
        from repro_torch.models import init_params
        from repro_torch.models import moe
        from repro_torch.models.common import tree_map
        from repro_torch.optim import AdamWConfig
        from repro_torch.sharding import PartitionSpec, use_mesh
        from repro_torch.sharding import collectives as col
        from repro_torch.train import init_sharded_state, jit_train_step, state_pspecs

        torch, plan, mesh = self.torch, self.plan, self.meshes[tuple(self.plan["mesh"])]
        cfg32 = plan["moe_fwd_cfg"]
        specs = dict(_tree_items(state_pspecs(cfg32, mesh).params))

        def keep(path, t):  # only the first MoE layer's blocks
            if path[:3] == ("pattern", 0, "ffn"):
                return col.shard_block(t, specs[path], mesh)
            return t.new_empty(0)

        params = init_params(cfg32, plan["moe_seed"], device=self.dev, keep=keep)
        p = tree_map(lambda a: a[0], params["pattern"][0]["ffn"])
        del params
        x = col.shard_block(plan["moe_x"].to(self.dev), PartitionSpec("data", None, None), mesh)
        want = col.shard_block(plan["moe_y"].to(self.dev), PartitionSpec("data", None, None), mesh)
        with torch.no_grad(), use_mesh(mesh):
            y = moe.moe_apply(p, x, cfg32)
        fwd_err = float((y - want).abs().max())
        experts_here = p["w_in"].shape[0]
        del p, x, y, want

        cfg = plan["moe_cfg"]
        state = init_sharded_state(cfg, plan["moe_seed"] + 1, mesh, device=self.dev)
        step_fn = jit_train_step(cfg, AdamWConfig(**plan["moe_opt"]), mesh, n_micro=plan["micro"])
        self.reset_peak()
        with _MoEDrops(torch) as watch:
            state, recs = self.steps(cfg, mesh, state, step_fn, 0, plan["steps"], watch=watch)
        return dict(fwd_err=fwd_err, experts_here=experts_here, state_bytes=self.state_bytes(state),
                    peak_gib=self.gib("max_memory_allocated"), steps=recs)

    # ---- lm_mesh_serve_2x4 -------------------------------------------------------

    def serve_blocks(self, cfg, seed, mesh):
        """This rank's blocks of ``init_params(cfg, seed)``, drawn a leaf at a
        time on the card."""
        from repro_torch.models import init_params
        from repro_torch.sharding import collectives as col
        from repro_torch.train import state_pspecs

        spec_of = dict(_tree_items(state_pspecs(cfg, mesh).params))
        return init_params(cfg, seed, device=self.dev, keep=lambda path, t: col.shard_block(t, spec_of[path], mesh))

    def call(self, mesh, fn):
        """(fn's output under ``use_mesh(mesh)``, {its wall, the peak GiB, the
        bytes by kind, the kernels launched, the axes of every FSDP gather})."""
        from repro_torch.kernels import KERNELS, reset_launches
        from repro_torch.sharding import collectives as col
        from repro_torch.sharding import use_mesh

        self.dist.barrier()
        self.sync()
        self.reset_peak()
        reset_launches()
        col.reset_bytes()
        t0 = time.perf_counter()
        with _Collectives() as coll, use_mesh(mesh):
            out = fn()
            self.sync()
        wall = time.perf_counter() - t0
        counted = dict(col.BYTES)
        if sum(counted.values()) != coll.bytes["all_reduce"] + coll.bytes["broadcast"]:
            raise AssertionError("the bytes by kind do not add up to all_reduce's and broadcast's")
        return out, dict(wall=wall, peak_gib=self.gib("max_memory_allocated"), bytes=counted,
                         launches={f.__name__: f.launches for f in KERNELS if f.launches},
                         gather_axes=sorted({"+".join(c[1]) for c in col.CALLS["gather"]}))

    def lm_mesh_serve_2x4(self):
        """llama3.2-1b at full width, LM_PERIODS layers, in bf16 served on the mesh:
        prefill of this rank's rows of the prompts into its blocks of the
        caches, then decode steps fed the one-process greedy tokens (teacher
        forcing); per call the wall, the peak, the bytes by kind.  Then the
        depth-2 f32 gate: prefill and decode steps fed the prompts' next
        tokens.  The logits come back from the ranks of model coordinate 0
        (the others hold the same)."""
        from repro_torch.models import decode_step, prefill
        from repro_torch.models.common import tree_leaves
        from repro_torch.sharding import PartitionSpec, use_mesh
        from repro_torch.sharding import collectives as col

        torch, plan, mesh = self.torch, self.plan, self.meshes[tuple(self.plan["mesh"])]
        first = mesh.coords["model"] == 0
        rows = lambda t: col.shard_block(t, PartitionSpec("data"), mesh).to(self.dev)  # noqa: E731
        cfg, S, N = plan["llama"], plan["serve_len"], plan["serve_new"]
        self.sync()
        base = self.gib("memory_allocated")
        params = self.serve_blocks(cfg, plan["serve_seed"], mesh)
        prompts, fed = rows(plan["serve_prompts"]), rows(plan["serve_tokens"])
        self.sync()
        resident = None if base is None else self.gib("memory_allocated") - base

        def call(fn):
            return self.call(mesh, fn)

        (logits, cache), pre = call(lambda: prefill(cfg, params, {"tokens": prompts}, S_cache=S + N))
        cache_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(cache))
        out, steps, greedy = [logits.float().cpu().numpy()], [], [torch.argmax(logits, -1).cpu()]
        for i in range(N - 1):
            (logits, cache), rec = call(lambda: decode_step(cfg, params, cache, fed[:, i], S + i))
            steps.append(rec)
            out.append(logits.float().cpu().numpy())
            greedy.append(torch.argmax(logits, -1).cpu())
        del params, cache, logits
        if self.cuda:
            torch.cuda.empty_cache()

        # the depth-2 f32 gate
        cfg32, S2, K = plan["serve_gate_cfg"], plan["serve_gate_len"], plan["serve_gate_steps"]
        params = self.serve_blocks(cfg32, plan["serve_gate_seed"], mesh)
        toks = rows(plan["serve_gate_tokens"])
        with torch.no_grad(), use_mesh(mesh):
            logits, cache = prefill(cfg32, params, {"tokens": toks[:, :S2]}, S_cache=S2 + plan["serve_gate_extra"])
            gate = [logits.cpu().numpy()]
            for i in range(K):
                logits, cache = decode_step(cfg32, params, cache, toks[:, S2 + i], S2 + i)
                gate.append(logits.cpu().numpy())
        return dict(resident_gib=resident, cache_bytes=cache_bytes, prefill=pre, decode=steps,
                    logits=out if first else None, greedy=torch.stack(greedy, 1).numpy() if first else None,
                    gate_logits=gate if first else None, coords=dict(mesh.coords))

    # ---- families_tp_2x4 ------------------------------------------------------------

    def families_tp_2x4(self):
        """Each family of ``plan["fam"]`` in turn, tensor-parallel on the
        (2, 4) mesh, each freed before the next (``family``)."""
        import gc

        out = {}
        for arch in self.plan["fam"]:
            out[arch] = self.family(arch)
            gc.collect()
            if self.cuda:
                self.torch.cuda.empty_cache()
        return out

    def family(self, arch):
        """One family at its published widths, only the depth cut: (1) bf16
        prefill of this rank's rows of the prompts and decode steps fed the
        one-process greedy tokens, per call the wall, peak, bytes by kind,
        launches and gather axes, its caches' bytes leaf by leaf; (2) the f32
        gate at one period (prefill and decode steps of short prompts); (3)
        one train step on the bigram stream (deepseek-v2: one ``loss_fn``
        forward and backward, its loss and gradient norm reduced as the
        step reduces them)."""
        from repro_torch.models import decode_step, prefill
        from repro_torch.models.common import tree_leaves, tree_map
        from repro_torch.optim import AdamWConfig, global_norm
        from repro_torch.sharding import PartitionSpec, use_mesh
        from repro_torch.sharding import collectives as col
        from repro_torch.train import init_sharded_state, jit_train_step, state_pspecs
        from repro_torch.train.step import _accumulated

        torch, plan, mesh = self.torch, self.plan, self.meshes[tuple(self.plan["mesh"])]
        f = plan["fam"][arch]
        first = mesh.coords["model"] == 0
        rows = lambda t: None if t is None else col.shard_block(t, PartitionSpec("data"), mesh).to(self.dev)  # noqa: E731
        cfg, S, N, seed = f["cfg"], plan["fam_len"], plan["fam_new"], f["seed"]
        t0 = time.perf_counter()
        params = _open_cross_gates(torch, cfg, self.drawn(cfg, lambda: self.serve_blocks(cfg, seed, mesh)), seed)
        img = rows(_images(torch, cfg, plan["fam_prompts"], seed))
        batch = {"tokens": rows(f["prompts"])}
        if img is not None:
            batch["image_embeds"] = img
        fed = rows(f["tokens"])
        drops = _MoEDrops(torch)
        with drops:
            (logits, cache), pre = self.call(mesh, lambda: prefill(cfg, params, batch, S_cache=S + plan["fam_extra"]))
            cache_bytes = [t.numel() * t.element_size() for t in tree_leaves(cache)]
            logits_out, steps = [logits.float().cpu().numpy()], []
            for i in range(N - 1):
                (logits, cache), rec = self.call(mesh, lambda: decode_step(cfg, params, cache, fed[:, i], S + i,
                                                                          img=img))
                steps.append(rec)
                logits_out.append(logits.float().cpu().numpy())
        dropped = {"serve": drops.share()}
        del params, cache, logits, batch, img
        self.free_card()
        t_serve = time.perf_counter() - t0

        # the f32 gate: a prefill
        cfg32 = f["cfg32"]
        params = _open_cross_gates(torch, cfg32, self.drawn(cfg32, lambda: self.serve_blocks(cfg32, seed + 1, mesh)),
                                   seed + 1)
        batch = {"tokens": rows(f["gate_tokens"])}
        img = rows(_images(torch, cfg32, plan["fam_gate_prompts"], seed + 1))
        if img is not None:
            batch["image_embeds"] = img
        with torch.no_grad(), use_mesh(mesh):
            logits, cache = prefill(cfg32, params, batch)
            gate = logits.cpu().numpy()
        del params, cache, logits, batch, img
        self.free_card()
        t_gate = time.perf_counter() - t0 - t_serve

        # one train step (deepseek-v2: one loss_fn forward and backward)
        opt, cfg = AdamWConfig(**plan["opt"]), f["cfg_train"]
        self.reset_peak()
        drops.reset()
        drops.__enter__()
        if f["train"] == "step":
            state = self.drawn(cfg, lambda: init_sharded_state(cfg, seed + 2, mesh, device=self.dev))
            _open_cross_gates(torch, cfg, state.params, seed + 2)
            _open_cross_gates(torch, cfg, state.opt["master"], seed + 2)
            step_fn = jit_train_step(cfg, opt, mesh, n_micro=plan["fam_micro"])
            state, recs = self.steps(cfg, mesh, state, step_fn, 0, 1, seed=seed + 3)
            train = dict(recs[0], peak_gib=self.gib("max_memory_allocated"))
            leaves = self.copy_to_leaves(state.opt["m"]) if first else None
            del state
        else:
            params = self.drawn(cfg, lambda: self.serve_blocks(cfg, seed + 2, mesh))
            dcfg = self.data(cfg)
            from repro_torch.train import batch_pspec

            shard = {k: col.shard_block(v, batch_pspec(mesh), mesh)
                     for k, v in _train_batch(torch, cfg, dcfg, 0, seed + 3, self.dev).items()}
            dp = col.dp_axes(mesh)
            n_dp = mesh.axis_size(dp)
            specs = state_pspecs(cfg, mesh).opt["master"]

            def fwd_bwd():
                loss, grads, metrics = _accumulated(cfg, params, shard, plan["fam_micro"])
                tree_map(lambda g: g.div_(n_dp), grads)
                both = col.psum_over(torch.stack([loss, metrics["ce"]]), dp, mesh, kind="mean") / n_dp
                return both, global_norm(grads, specs, mesh), grads

            (both, gnorm, grads), rec = self.call(mesh, fwd_bwd)
            train = dict(rec, loss=float(both[0]), ce=float(both[1]), grad_norm=float(gnorm))
            leaves = self.copy_to_leaves(grads) if first else None
            del params, grads
        drops.__exit__()
        dropped["train"] = drops.share()
        self.free_card()
        sections = dict(serve_s=t_serve, f32_gate_s=t_gate, train_s=time.perf_counter() - t0 - t_serve - t_gate)
        return dict(prefill=pre, decode=steps, cache_bytes=cache_bytes, train=train, copy_to_leaves=leaves,
                    sections=sections, dropped=dropped,
                    logits=logits_out if first else None, gate_logits=gate if first else None,
                    coords=dict(mesh.coords))

    def copy_to_leaves(self, tree):
        """{path: this rank's block of each leaf of ``tree`` a mixer takes
        through copy_to, f32 numpy}."""
        from repro_torch.models.common import tree_get, tree_paths

        return {"/".join(map(str, p)): tree_get(tree, p).float().cpu().numpy() for p in tree_paths(tree)
                if p[-1] in self.plan["copy_to_leaves"] and "mixer" in p}

    def drawn(self, cfg, fn):
        """``fn()``, a draw of this rank's blocks of ``cfg``'s weights
        (``init_params`` draws each leaf whole on the card, as an f32
        Gaussian and its scaled copy, and cuts it): where the largest leaf's
        two f32 copies take more than half a rank's cap (deepseek-v2's
        experts, recurrentgemma's tables), the ranks draw one at a time under
        a cap of DRAW_FRACTION, then return to theirs (two at a time filled
        the card beside six ranks holding recurrentgemma's train state, as
        measured on one H100)."""
        from repro_torch.models import transformer as tfm
        from repro_torch.models.common import is_shape, tree_leaves

        torch = self.torch
        largest = max(math.prod(s) for s, _ in tree_leaves(tfm.params_shapes(cfg), is_leaf=is_shape))
        if not self.cuda or 8 * largest <= self.plan["mem_fraction"] * torch.cuda.get_device_properties(
                self.dev).total_memory / 2:
            return fn()
        out = None
        for r in range(self.world):
            if r == self.rank:
                torch.cuda.set_per_process_memory_fraction(self.plan["draw_fraction"], self.dev)
                out = fn()
                self.free_card()
                torch.cuda.set_per_process_memory_fraction(self.plan["mem_fraction"], self.dev)
            self.dist.barrier()
        return out

    def free_card(self):
        import gc

        gc.collect()
        if self.cuda:
            self.torch.cuda.empty_cache()

    # ---- zero1_2x2x2 ----------------------------------------------------------------

    def zero1_2x2x2(self):
        """llama3.2-1b at full width, depth 2, f32, on a (2, 2, 2) ``("pod",
        "data", "model")`` mesh of the same world: ZeRO-1 over ``pod``, its
        parameters and optimizer state a rank's, STEPS steps, then the
        parameters reassembled (rank 0 compares them)."""
        from repro_torch.models.common import tree_leaves
        from repro_torch.optim import AdamWConfig
        from repro_torch.sharding import PartitionSpec
        from repro_torch.sharding import collectives as col
        from repro_torch.train import init_sharded_state, jit_train_step, state_pspecs

        plan, refs = self.plan, self.refs
        mesh = self.meshes[tuple(plan["zero_mesh"])]
        cfg = plan["gates_cfg"]
        state = init_sharded_state(cfg, plan["gates_seed"], mesh, device=self.dev)
        params_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(state.params))
        opt_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(state.opt))
        step_fn = jit_train_step(cfg, AdamWConfig(**plan["gates_opt"]), mesh, n_micro=plan["zero_micro"])
        self.reset_peak()
        state, recs = self.steps(cfg, mesh, state, step_fn, 0, plan["steps"])
        peak = self.gib("max_memory_allocated")
        pspecs = tree_leaves(state_pspecs(cfg, mesh).params, is_leaf=lambda x: isinstance(x, PartitionSpec))
        diff_sq, diff_max = 0.0, 0.0
        for got, want, spec in zip(tree_leaves(state.params), refs["params"], pspecs):
            whole = col.unshard(got, spec, mesh)  # every rank takes part; rank 0 compares
            if self.rank == 0:
                d = (whole - want).double()
                diff_sq += float((d * d).sum())
                diff_max = max(diff_max, float(d.abs().max()))
            del whole
        return dict(steps=recs, params_bytes=params_bytes, opt_bytes=opt_bytes, peak_gib=peak,
                    param_diff_norm=math.sqrt(diff_sq), param_diff_max=diff_max)

    # ---- elastic_2x4_to_2x2 (a world of 4) --------------------------------------

    def elastic_restore(self):
        """The 2×4 checkpoint restored onto (2, 2): every block bitwise its
        slice of the saved array, then the next step."""
        import numpy as np

        from repro_torch.optim import AdamWConfig
        from repro_torch.sharding import NamedSharding, PartitionSpec
        from repro_torch.sharding import collectives as col
        from repro_torch.train import checkpoint as ckpt, jit_train_step, restore_elastic, state_pspecs
        from repro_torch.models.common import tree_map

        plan, mesh = self.plan, self.meshes[tuple(self.plan["small_mesh"])]
        cfg = plan["gates_cfg"]
        self.sync()
        t0 = time.perf_counter()
        state, step = restore_elastic(plan["ckpt"], cfg, mesh, device=self.dev)
        self.sync()
        restore_s = time.perf_counter() - t0
        places = ckpt._flatten(tree_map(lambda s: NamedSharding(mesh, s), state_pspecs(cfg, mesh),
                                        is_leaf=lambda x: isinstance(x, PartitionSpec)))
        bitwise, n_leaves = True, 0
        with np.load(f"{plan['ckpt']}/step_{step}/arrays.npz") as saved:
            for key, block in ckpt._flatten(state).items():
                arr = saved[key]
                want = arr[col.block_slices(arr.shape, places[key].spec, mesh)]
                got = block.detach().cpu().numpy() if hasattr(block, "detach") else np.asarray(block)
                bitwise = bitwise and got.dtype == want.dtype and got.tobytes() == np.ascontiguousarray(want).tobytes()
                n_leaves += 1
                del arr, want, got
        step_fn = jit_train_step(cfg, AdamWConfig(**plan["gates_opt"]), mesh, n_micro=plan["micro"])
        state, recs = self.steps(cfg, mesh, state, step_fn, step, 1)
        return dict(step=int(step), restore_s=restore_s, bitwise=bitwise, leaves=n_leaves,
                    state_bytes=self.state_bytes(state), next_step=recs[0])


def _tree_items(tree):
    """(path, spec) pairs of a tree of ``PartitionSpec``s."""
    from repro_torch.models.common import tree_get, tree_paths
    from repro_torch.sharding import PartitionSpec

    is_spec = lambda x: isinstance(x, PartitionSpec)  # noqa: E731
    return [(p, tree_get(tree, p)) for p in tree_paths(tree, is_leaf=is_spec)]


class _MoEDrops:
    """Counts the assignments the MoE dispatch drops on this rank (wraps
    ``models.moe._capacity`` and ``_rank_in_expert``, which the dispatch
    calls by module name)."""

    def __init__(self, torch):
        self.torch = torch
        self.reset()

    def reset(self):
        self.dropped, self.total, self.capacity = [], 0, None

    def __enter__(self):
        from repro_torch.models import moe

        self.moe, self.real = moe, (moe._capacity, moe._rank_in_expert)

        def capacity(T, m):
            self.capacity = self.real[0](T, m)
            return self.capacity

        def rank(flat_e, E):
            r = self.real[1](flat_e, E)
            self.dropped.append((r >= self.capacity).sum())
            self.total += r.numel()
            return r

        moe._capacity, moe._rank_in_expert = capacity, rank
        return self

    def __exit__(self, *exc):
        self.moe._capacity, self.moe._rank_in_expert = self.real

    def share(self):
        return float(self.torch.stack(self.dropped).sum()) / self.total if self.total else 0.0


class _Phase19:
    """Phase 19: the mesh (``repro_torch.sharding``, ``launch.mesh``,
    ``train.jit_train_step``, ``restore_elastic``), last, after every other
    phase's buffers and processes are freed.  Eight gloo ranks share the
    card (NCCL refuses two ranks on one device), started as phase 17's are,
    on a (2, 4) ``("data", "model")`` mesh; every rank draws each weight
    whole, one leaf at a time, and keeps only its block
    (``init_sharded_state``), so no rank ever holds the whole state.

    (1) ``lm_mesh_2x4``: llama3.2-1b at full width, LM_PERIODS of its 16
    layers, bf16 parameters with an f32 master, 3 steps at seq 512, global batch 8,
    ``n_micro`` 2: each rank's state and resident bytes at most
    STATE_SHARE_MAX of the full state's (1/8 and a fixed margin); the loss
    finite and the same on every rank; at step 1 (learning rate 0) the loss
    and ``grad_norm`` within one bf16 ulp of a one-process
    ``make_train_step`` on the same weights and batch, run here first, where
    ``wk`` and ``wv``'s gradients taken ``tp`` times (a doubled sum over
    ``model``) would move ``grad_norm`` further, which is held too.  (2) ``lm_mesh_gates``: the same at depth 2 in f32 against the
    one-process step (whose m, v and parameters the ranks read from this
    process by CUDA IPC): loss and ``grad_norm`` within 1e-5 relative, every
    leaf of m and v within 1e-4 relative + 1e-5 of the leaf's largest
    entry, and after 3 steps the parameters reassembled from the blocks
    within PARAM_REL of the one-process run, as a share of how far that
    run moved them, below ``wk`` and ``wv``'s own share of that distance
    (the order of a dropped sum over ``model``'s effect), which is held too.  (3) ``moe_mesh_2x4``: mixtral-8x7b at its published
    widths, one period (phase 18's cut), 8 experts over tp 4: its first MoE
    layer's shard_map forward in f32 at the drop-free 4.0 within 1e-4 of
    the global dispatch run here (the reference test's tolerance), then 3
    train steps at 1.25, the loss finite and falling, the dropped share
    printed.  (4) ``elastic_2x4_to_2x2``: the depth-2 state saved from the
    2×4 mesh (assembled leaf by leaf, written by the first rank), restored
    by a world of 4 onto (2, 2): every block bitwise its slice of the saved
    array, and the next step's loss within 1e-5 relative of the same step
    on 2×4.  (5) ``lm_mesh_serve_2x4``: llama3.2-1b at LM_PERIODS layers in
    bf16 served on the mesh (``prefill`` and 3
    ``decode_step``s under ``use_mesh``, fed the one-process greedy tokens),
    each rank's caches exactly 1/8 of the one-process cache's, the logits
    against the one-process logits by phase 17's bf16 rule; at depth 2 in
    f32, the prefill's and 2 decode steps' logits within SERVE_F32_REL of
    the one-process run, below the fault's reading (model rank
    FAULT_MODEL_RANK's positions left out of every decode step's attention,
    run here); ``launch.dryrun`` run on the CPU beside the phase for this
    cell's prefill and decode step and ``lm_mesh_2x4``'s step: its bytes by
    kind equal to the ranks' counts, exactly, and its peaks within
    DRYRUN_PEAK_REL of ``max_memory_allocated``.  Per rank the resident
    and peak GiB, step walls (median and spread), the bytes handed to
    ``all_reduce`` and ``broadcast`` a step (or a call) by kind (FSDP
    gathers, gradient reduce-scatters, TP sums, the decode combine), the
    phase's time; no port kernel is launched on the mesh path, which is
    held.  (6) ``families_tp_2x4`` (``family``, ``judge_families``), first in
    the world of 8, while each rank's memory is fresh: each of FAMILIES at its published widths, only the depth cut, bf16:
    prefill of 8 prompts of 2048 tokens and a decode step fed the
    one-process greedy tokens (phase 17's bf16 rule; the MoE at DROP_FREE,
    its dropped share held at 0), an f32 prefill at one
    period (FAM_GATE_PROMPTS of FAM_GATE_LEN tokens) within FAM_F32_REL of
    one process below the reading of the
    family's fault (FAM_FAULTS, run here), one train step (deepseek-v2: one
    ``loss_fn`` forward and backward) with step 1's loss and ``grad_norm``
    within one bf16 ulp and each ``copy_to`` leaf's moment within
    FAM_LEAF_REL below the leaf taken tp times; each rank's caches its
    blocks under the rules, no FSDP gather over ``model``, the dry run's
    bytes by kind exact and its peaks within DRYRUN_PEAK_REL.  (7)
    ``zero1_2x2x2``, last in the world of 8: llama3.2-1b at depth 2 in f32
    with ZeRO-1 over ``pod`` on ZERO_MESH, 3 steps against lm_mesh_gates'
    one-process run (step 1 within 1e-5, the parameters within PARAM_REL),
    a rank's parameters and optimizer state within ZERO_PARAM_SHARE_MAX
    and ZERO_OPT_SHARE_MAX of the one-process state's, the dry run's bytes
    exact."""

    ARCH, MOE_ARCH = "llama3.2-1b", "mixtral-8x7b"
    CFGS = None  # {arch: config} in place of get_config(arch) (CPU rehearsals)
    SEED, GATES_SEED, MOE_SEED = 1901, 1902, 1903
    MESH, SMALL_MESH = (2, 4), (2, 2)
    SEQ, BATCH, MICRO, STEPS, SHALLOW = 512, 8, 2, 3, 2
    # lm_mesh_2x4's and lm_mesh_serve_2x4's depth: 4 of llama3.2-1b's 16
    # layers (the whole script's time limit; PRs 26–27 ran 16), its widths
    # whole
    LM_PERIODS = 4
    OPT = dict(lr=3e-3, warmup_steps=5)  # step 1 at learning rate 0
    GATES_OPT = dict(lr=3e-3, warmup_steps=2)
    MOE_OPT = dict(lr=1e-3, warmup_steps=1)  # phase 18's
    MOE_X = (8, 64)  # rows and tokens of the forward check's input
    # a rank's share of the state's bytes: 1/8, plus 0.0102 for wk and wv,
    # which the rules replicate over 'model' ('kv_heads'; 0.13520 in all on an
    # H100 80GB HBM3 at 700 W), plus 0.0018 of slack; a fixed limit, so that
    # rules which split less fail here
    STATE_SHARE_MAX = 0.137
    # against the one-process step in bf16: the loss and the gradient norm
    # within one bf16 ulp (3.8e-5 and 5.1e-4 read on an H100 80GB HBM3 at
    # 700 W)
    BF16_LOSS_REL = BF16_NORM_REL = 2.0**-8
    PARAM_REL = 1e-4  # 2.83e-5 read on an H100 80GB HBM3 at 700 W
    FAULT_LEAVES = ("wk", "wv")  # replicated over 'model' and used inside its region
    FWD_TOL = 1e-4  # tests/test_multidevice.py::test_moe_shard_map_matches_gspmd
    RANK_MEM_FRACTION = 0.115  # of the card, a gloo rank's cap (eight ranks and this process share it)
    DRAW_FRACTION = 0.3  # a rank's cap while it alone draws a family's weights (``_Phase19Rank.drawn``)
    TIMEOUT_S = 300
    DEADLINE_S = 900
    TARGET = staticmethod(_phase19_rank)
    # the world of 8's, in order: the families first, while each rank's
    # memory is fresh (after the other parts their f32 gates filled the card,
    # as measured on one H100)
    PARTS = ("families_tp_2x4", "lm_mesh_2x4", "lm_mesh_gates", "moe_mesh_2x4", "lm_mesh_serve_2x4", "zero1_2x2x2")
    # lm_mesh_serve_2x4: 8 prompts of 2048 tokens (4 a data rank), 4 new
    # tokens (prefill and 3 decode steps; each forward gathers ≈2.2 GB a rank)
    SERVE_SEED, SERVE_GATE_SEED = 1904, 1905
    SERVE_PROMPTS, SERVE_LEN, SERVE_NEW = 8, 2048, 4
    # the depth-2 f32 gate: 2 prompts (1 a data rank) of 1024 tokens, 2 decode
    # steps fed their next tokens, a cache of 1028 positions (257 a model rank)
    SERVE_GATE_PROMPTS, SERVE_GATE_LEN, SERVE_GATE_STEPS, SERVE_GATE_EXTRA = 2, 1024, 2, 4
    # the f32 gate's limit on max|mesh − one-process| / max|one-process| over
    # the prefill's and the decode steps' logits: fixed between the sound
    # reading (predicted ≤ 1e-5) and the fault's, one model rank's slice of
    # the positions left out of the combine (predicted ≥ 1e-2)
    SERVE_F32_REL = 1e-4
    FAULT_MODEL_RANK = 1  # the model rank whose positions the fault leaves out
    DRYRUN_PEAK_REL = 0.25  # the dry run's peak a rank against max_memory_allocated
    DRYRUN_TIMEOUT_S = 600
    # families_tp_2x4: (arch, the depth cut of its bf16 serving, of its
    # train step): deepseek-v2 its dense prefix + 1 period, mamba2 2 layers,
    # recurrentgemma 1 period + its suffix (its train step 1 period: with the
    # suffix a rank's step peaks at 9.01 GiB by the dry run, against its cap
    # of RANK_MEM_FRACTION of the card), the vision model 1 period with its
    # cross layer; the f32 gate at 1 period.  The MoE at DROP_FREE (the mesh
    # takes capacity from a rank's tokens, so only drop-free runs agree with
    # one process; at 2.0 deepseek-v2 dropped 0.6–1.7% of a rank's serving
    # assignments and 3.7–4.2% in training, measured on one H100), its
    # dropped share held at 0 on both sides.
    FAMILIES = (("deepseek-v2-236b", dict(n_periods=1), dict(n_periods=1)),
                ("mamba2-2.7b", dict(n_periods=2), dict(n_periods=2)),
                ("recurrentgemma-9b", dict(n_periods=1), dict(n_periods=1, suffix=())),
                ("llama-3.2-vision-11b", dict(n_periods=1), dict(n_periods=1)))
    # one micro-batch a step in the new parts: a micro-batch gathers every
    # weight twice (forward and the remat recomputation), and their bytes
    # through gloo set the parts' walls
    FAM_MICRO = ZERO_MICRO = 1
    FAM_SEED = 1910
    # prefill and 1 decode step fed the one-process greedy token (each bf16
    # decode step gathers 0.19–2.66 GB a rank through gloo; the whole script's
    # time limit)
    # a cache of 2052 positions (513 a model rank)
    FAM_PROMPTS, FAM_LEN, FAM_NEW, FAM_EXTRA = 8, 2048, 2, 4
    # the f32 gate: a prefill of 2 prompts (1 a data rank) of 256 tokens, no
    # decode step: each f32 forward gathers 2.2–5.3 GB a rank through gloo
    # (≈17 s for deepseek-v2 on an H100 80GB HBM3 at 700 W), and the bf16
    # run decodes
    FAM_GATE_PROMPTS, FAM_GATE_LEN = 2, 256
    # the f32 gate's limit on max|mesh − one-process| / max|one-process|
    # over the logits: fixed between the sound reading (predicted ≤ 1e-5)
    # and the family's fault (FAM_FAULTS, predicted ≥ 1e-3)
    FAM_F32_REL = 1e-4
    DROP_FREE = 8.0
    # the fault each family's f32 gate must tell apart: SSD's gated norm over
    # each model rank's columns alone, RG-LRU's gate products left without
    # the sum over model (each rank's rows only), and for MLA and
    # cross-attention model rank FAULT_MODEL_RANK's partial output left out
    # of the sum over model
    FAM_FAULTS = {"deepseek-v2-236b": "rank_left_out", "mamba2-2.7b": "ssd_norm_per_rank",
                  "recurrentgemma-9b": "gate_sum_left_out", "llama-3.2-vision-11b": "rank_left_out"}
    # the mixer leaves each family takes through copy_to (replicated over
    # model, used inside its tensor-parallel region): their gradients taken
    # tp times are the train step's fault
    # the limit on ‖mesh − one-process‖ / ‖one-process‖ of each such leaf's
    # moment (deepseek-v2: its gradient) after step 1 on a rank's block:
    # fixed between bf16's rounding (predicted ≤ 2e-2) and the fault's
    # reading (≈ tp − 1 = 3, computed here)
    FAM_LEAF_REL = 0.1
    COPY_TO_LEAVES = ("wk", "wv", "q_norm", "k_norm", "gate", "wq_a", "wkv_a", "q_ln", "kv_ln", "w_B", "w_C",
                      "conv_B", "conv_C", "conv_b_B", "conv_b_C", "w_dt", "A_log", "D_skip", "dt_bias", "rg_ba",
                      "rg_bx", "lam")
    # zero1_2x2x2: a rank's share of the one-process state's bytes, fixed
    # limits above the rules' shares (computed here; llama3.2-1b at depth 2 on
    # (2, 2, 2): the parameters 1/4 and the optimizer 1/8, each plus the
    # leaves the rules replicate over model, wk/wv and the norms)
    ZERO_MESH = (2, 2, 2)
    ZERO_PARAM_SHARE_MAX, ZERO_OPT_SHARE_MAX = 0.27, 0.14

    def __init__(self, torch, dev, smi, root):
        self.torch, self.dev, self.smi, self.root = torch, dev, smi, root
        self.rows = {}

    def config(self, arch, **kw):
        from repro_torch.configs import get_config

        return ((self.CFGS or {}).get(arch) or get_config(arch)).replace(**kw)

    def free(self):
        import gc

        gc.collect()
        if self.dev.type == "cuda":
            self.torch.cuda.empty_cache()

    def run(self):
        import shutil
        import tempfile

        torch = self.torch
        self.free()
        (self.root / "build").mkdir(exist_ok=True)
        self.tmp = tempfile.mkdtemp(prefix="phase19-", dir=self.root / "build")
        t0 = time.perf_counter()
        dryrun = self.start_dryrun()
        try:
            plan, refs = self.references()
            meshes = [self.MESH] + ([self.ZERO_MESH] if "zero1_2x2x2" in self.PARTS else [])
            world8 = self.world(8, dict(plan, parts=list(self.PARTS), meshes=meshes), refs)
            del refs
            self.free()
            world4 = self.world(4, dict(plan, parts=["elastic_restore"], meshes=[self.SMALL_MESH]), {})
            predicted = self.finish_dryrun(dryrun)
        finally:
            if dryrun[0].poll() is None:
                dryrun[0].kill()
                dryrun[0].wait()
            shutil.rmtree(self.tmp, ignore_errors=True)
        self.judge(plan, world8, world4, time.perf_counter() - t0)
        if "lm_mesh_serve_2x4" in self.PARTS:
            self.judge_serve(plan, world8[:-1], predicted)
        if "families_tp_2x4" in self.PARTS:
            self.judge_families(plan, world8[:-1], predicted)
        if "zero1_2x2x2" in self.PARTS:
            self.judge_zero1(plan, world8[:-1], predicted)

    # ---- lm_mesh_serve_2x4's gates ------------------------------------------------

    def judge_serve(self, plan, ranks, predicted):
        """The serve cell against the one-process runs and the dry run's
        predictions; prints its row and raises on a failed gate."""
        import numpy as np

        torch, part, one = self.torch, "lm_mesh_serve_2x4", self.serve_one
        rs = [r[part] for r in ranks]
        by_data = sorted((r for r in rs if r["logits"] is not None), key=lambda r: r["coords"]["data"])
        fails = []

        # the caches: each rank's bytes exactly 1/8 of the one-process cache's
        n = math.prod(self.MESH)
        cache_share = [r["cache_bytes"] / one["cache_bytes"] for r in rs]
        if any(n * r["cache_bytes"] != one["cache_bytes"] for r in rs):
            fails.append(f"cache share {cache_share} is not exactly 1/{n}")

        # bf16: phase 17's rule, the mesh's logits teacher-forced
        # on the one-process greedy tokens against the one-process logits
        mesh = torch.as_tensor(np.concatenate([np.stack(r["logits"], 1) for r in by_data]))  # (P, N, V)
        toks = one["tokens"].long()
        gap = float((mesh - one["logits"]).abs().max())
        differ = torch.argmax(mesh, -1) != toks
        excess = mesh.amax(-1) - mesh.gather(-1, toks[..., None])[..., 0]
        worst = float(excess[differ].max()) if bool(differ.any()) else 0.0
        greedy = torch.as_tensor(np.concatenate([r["greedy"] for r in by_data]))
        if not (gap <= _Phase17.TF_GAP_MAX and worst <= 2 * gap):
            fails.append(f"bf16 logits: gap {gap}, worst excess {worst}")

        # f32 at depth 2: a fixed limit between the sound reading and the fault's
        gate = torch.as_tensor(np.concatenate([np.stack(r["gate_logits"], 1) for r in by_data]))
        sound = [_max_rel(gate[:, i], one["gate"][:, i]) for i in range(gate.shape[1])]
        if not (max(sound) <= self.SERVE_F32_REL < one["fault_rel"]):
            fails.append(f"f32 gate: {sound} against {self.SERVE_F32_REL} (fault {one['fault_rel']})")

        # no port kernel on the serving path
        launched = [c["launches"] for r in rs for c in [r["prefill"]] + r["decode"] if c["launches"]]
        if launched:
            fails.append(f"the serving path launched a port kernel: {launched[0]}")

        # the dry run: bytes by kind exactly, peaks within DRYRUN_PEAK_REL
        want = {k: predicted[k]["full"]["handoff_by_kind"] for k in ("train", "prefill", "decode")}
        got = {"train": [r["lm_mesh_2x4"]["steps"][0]["bytes"] for r in ranks],
               "prefill": [r["prefill"]["bytes"] for r in rs],
               "decode": [c["bytes"] for r in rs for c in r["decode"]]}
        for k in want:
            if any(g != want[k] for g in got[k]):
                fails.append(f"dry run {k}: bytes by kind {want[k]} against the ranks' {got[k][0]}")
        peaks = {"train": max(r["lm_mesh_2x4"]["peak_gib"] or 0.0 for r in ranks),
                 "prefill": max(r["prefill"]["peak_gib"] or 0.0 for r in rs),
                 "decode": max(c["peak_gib"] or 0.0 for r in rs for c in r["decode"])}
        predicted_peak = {k: predicted[k]["full"]["memory"]["peak_bytes"] / 2**30 for k in want}
        peak_rel = {k: predicted_peak[k] / peaks[k] - 1 if peaks[k] else None for k in want}
        if self.dev.type == "cuda" and any(abs(v) > self.DRYRUN_PEAK_REL for v in peak_rel.values()):
            fails.append(f"dry-run peaks off by {peak_rel}")

        def roof_ms(k):
            r = predicted[k]["roofline"]
            return 1e3 * max(r["t_compute_s"], r["t_memory_s"], r["t_collective_s"])

        walls = [max(r["decode"][i]["wall"] for r in rs) for i in range(len(rs[0]["decode"]))]
        row = dict(arch=plan["llama"].name, n_layers=plan["llama"].n_layers, mesh=self.MESH, prompts=self.SERVE_PROMPTS,
                   prompt_len=self.SERVE_LEN, new=self.SERVE_NEW,
                   resident_gib=[r["resident_gib"] for r in rs],
                   cache_bytes=rs[0]["cache_bytes"], one_process_cache_bytes=one["cache_bytes"],
                   cache_share=cache_share, prefill_ms=1e3 * max(r["prefill"]["wall"] for r in rs),
                   decode_ms_per_token=1e3 * sorted(walls)[len(walls) // 2], decode_ms=[1e3 * w for w in walls],
                   peak_gib=peaks, bytes_prefill=rs[0]["prefill"]["bytes"], bytes_decode_step=rs[0]["decode"][0]["bytes"],
                   bf16_gap=gap, bf16_worst_excess=worst, bf16_mismatches=int(differ.sum()),
                   greedy_equal=bool(torch.equal(greedy, toks.to(greedy.dtype))),
                   f32_rel=sound, f32_limit=self.SERVE_F32_REL, f32_fault_rel=one["fault_rel"],
                   dryrun=dict(peak_gib=predicted_peak, peak_rel=peak_rel, bytes=want,
                               resident_gib={k: predicted[k]["full"]["memory"]["resident_bytes"] / 2**30 for k in want},
                               roofline_ms={k: roof_ms(k) for k in want},
                               bottleneck={k: predicted[k]["roofline"]["bottleneck"] for k in want},
                               cell_s={k: predicted[k]["t_cell_s"] for k in want}, wall_s=predicted["wall_s"]))
        self.rows[part] = row
        _p(f"phase 19: {part} (bf16 serving on 8 gloo ranks sharing the card, the logits teacher-"
           f"forced on the one-process tokens; the f32 gate at depth 2, f32_fault_rel: one model rank's positions "
           f"left out of the combine; dryrun: launch.dryrun's prediction for 8 H100s (roofline_ms) and for these "
           f"ranks (peaks, bytes), run on the CPU; card: {self.smi}): {json.dumps(row)}")
        if fails:
            raise AssertionError(f"phase 19 {part}: " + "; ".join(fails))

    # ---- families_tp_2x4's and zero1_2x2x2's gates --------------------------------

    def dryrun_held(self, name, predicted, bytes_got, peaks_got, fails):
        """The dry run's cell ``name`` against the ranks: its bytes by kind
        equal to every reading in ``bytes_got``, exactly; its peak within
        DRYRUN_PEAK_REL of the largest of ``peaks_got`` (None: not held).
        Returns (the predicted peak GiB, its distance)."""
        rec = predicted[name]["full"]
        want = rec["handoff_by_kind"]
        if any(g != want for g in bytes_got):
            fails.append(f"dry run {name}: bytes by kind {want} against the ranks' {bytes_got[0]}")
        pred = rec["memory"]["peak_bytes"] / 2**30
        if peaks_got is None or self.dev.type != "cuda":
            return pred, None
        rel = pred / max(peaks_got) - 1
        if abs(rel) > self.DRYRUN_PEAK_REL:
            fails.append(f"dry run {name}: peak {pred:.3f} GiB against {max(peaks_got):.3f}")
        return pred, rel

    def judge_families(self, plan, ranks, predicted):
        """Each family of families_tp_2x4 against its one-process runs, the
        rules and the dry run; prints a row a family and raises on a failed
        gate."""
        import numpy as np

        from repro_torch.models import transformer as tfm
        from repro_torch.models.common import is_shape, tree_leaves, tree_paths
        from repro_torch.sharding import Mesh, PartitionSpec
        from repro_torch.sharding import collectives as col

        torch, fails = self.torch, []
        for arch, _, _ in self.FAMILIES:
            one, f = self.fam_one[arch], plan["fam"][arch]
            rs = [r["families_tp_2x4"][arch] for r in ranks]
            by_data = sorted((r for r in rs if r["logits"] is not None), key=lambda r: r["coords"]["data"])
            calls = [r["prefill"] for r in rs] + [c for r in rs for c in r["decode"]] + [r["train"] for r in rs]

            # the caches: each rank's leaves exactly its blocks under the rules
            cfg, S = f["cfg"], self.FAM_LEN + self.FAM_EXTRA
            specs = tfm.cache_specs(cfg, self.FAM_PROMPTS, S, Mesh(self.MESH, _MESH_AXES[2]))
            shapes = tfm._cache_shapes(cfg, self.FAM_PROMPTS, S)
            names = ["/".join(map(str, p)) for p in tree_paths(shapes, is_leaf=is_shape)]
            want = [math.prod(col.block_shape(sh[0], sp, Mesh(self.MESH, _MESH_AXES[2]))) * sh[1].itemsize
                    for sh, sp in zip(tree_leaves(shapes, is_leaf=is_shape),
                                      tree_leaves(specs, is_leaf=lambda x: isinstance(x, PartitionSpec)))]
            if any(r["cache_bytes"] != want for r in rs):
                fails.append(f"{arch}: a rank's cache leaves {rs[0]['cache_bytes']} are not the rules' {want}")
            leaf_share = {n: w / o for n, w, o in zip(names, want, one["cache_leaves"])}

            # bf16 at the published widths: phase 17's rule, teacher-forced
            mesh_logits = torch.as_tensor(np.concatenate([np.stack(r["logits"], 1) for r in by_data]))
            toks = one["tokens"].long()
            gap = float((mesh_logits - one["logits"]).abs().max())
            differ = torch.argmax(mesh_logits, -1) != toks
            excess = mesh_logits.amax(-1) - mesh_logits.gather(-1, toks[..., None])[..., 0]
            worst = float(excess[differ].max()) if bool(differ.any()) else 0.0
            if not (gap <= _Phase17.TF_GAP_MAX and worst <= 2 * gap):
                fails.append(f"{arch} bf16 logits: gap {gap}, worst excess {worst}")

            # f32 at one period: a fixed limit between the sound reading and the fault's
            sound = _max_rel(torch.as_tensor(np.concatenate([r["gate_logits"] for r in by_data])), one["gate"])
            if not (sound <= self.FAM_F32_REL < one["fault_rel"]):
                fails.append(f"{arch} f32 gate: {sound} against {self.FAM_F32_REL} (fault {one['fault_rel']})")

            # the train step: step 1 within one bf16 ulp, below the copy_to fault
            # the train step: step 1 within one bf16 ulp; each copy_to leaf's
            # moment (gradient) below its fault, the leaf taken tp times
            tr, t1 = one["train"], rs[0]["train"]
            loss_rel = abs(t1["loss"] - tr["loss"]) / abs(tr["loss"])
            norm_rel = abs(t1["grad_norm"] - tr["grad_norm"]) / abs(tr["grad_norm"])
            if not (loss_rel <= self.BF16_LOSS_REL and norm_rel <= self.BF16_NORM_REL):
                fails.append(f"{arch} train: loss_rel {loss_rel}, grad_norm_rel {norm_rel}")
            from repro_torch.train import state_pspecs

            tspec_tree = state_pspecs(f["cfg_train"], Mesh(self.MESH, _MESH_AXES[2])).opt["master"]
            if len({r["train"]["loss"] for r in rs}) != 1:
                fails.append(f"{arch} train: the loss differs between ranks")
            leaf_rel = {}
            for r in rs:
                if r["copy_to_leaves"] is None:
                    continue
                placed = Mesh(self.MESH, _MESH_AXES[2], rank=r["coords"]["data"] * self.MESH[1] + r["coords"]["model"])
                tspecs = {"/".join(map(str, p)): spec for p, spec in _tree_items(tspec_tree)}
                for path, got in r["copy_to_leaves"].items():
                    w = one["copy_to_leaves"][path]
                    w = w[col.block_slices(w.shape, tspecs[path], placed)]
                    if float(w.norm()):
                        rel = float((torch.as_tensor(got) - w).norm() / w.norm())
                        leaf_rel[path] = max(leaf_rel.get(path, 0.0), rel)
            worst_leaf = max(leaf_rel.values()) if leaf_rel else float("inf")
            if not (worst_leaf <= self.FAM_LEAF_REL < tr["fault_leaf_rel"]):
                fails.append(f"{arch} train: copy_to leaves {leaf_rel} against {self.FAM_LEAF_REL} "
                             f"(fault {tr['fault_leaf_rel']})")

            # drop-free on both sides (the mesh's capacity comes from a rank's tokens)
            dropped = dict(one=one["dropped"], mesh=[r["dropped"] for r in rs])
            if any(v for d in [one["dropped"]] + dropped["mesh"] for v in d.values()):
                fails.append(f"{arch}: the MoE dropped assignments {dropped}")

            # no port kernel, no weight gathered over model
            if any(c["launches"] for c in calls):
                fails.append(f"{arch}: the mesh path launched a port kernel")
            axes = sorted({a for c in calls for a in c["gather_axes"]})
            if any("model" in a for a in axes):
                fails.append(f"{arch}: a weight was gathered over {axes}")

            # the dry run
            dry = {}
            for kind, got, peaks in (
                    ("prefill", [r["prefill"]["bytes"] for r in rs], [r["prefill"]["peak_gib"] or 0.0 for r in rs]),
                    ("decode", [c["bytes"] for r in rs for c in r["decode"]],
                     [c["peak_gib"] or 0.0 for r in rs for c in r["decode"]]),
                    ("train", [r["train"]["bytes"] for r in rs],
                     [r["train"]["peak_gib"] or 0.0 for r in rs] if f["train"] == "step" else None)):
                dry[kind] = self.dryrun_held(f"{arch}/{kind}", predicted, got, peaks, fails)
            walls = [max(r["decode"][i]["wall"] for r in rs) for i in range(len(rs[0]["decode"]))]
            row = dict(arch=arch, n_layers=cfg.n_layers, mesh=self.MESH, prompts=self.FAM_PROMPTS,
                       prompt_len=self.FAM_LEN, new=self.FAM_NEW, prefill_ms=1e3 * max(r["prefill"]["wall"] for r in rs),
                       decode_ms=[1e3 * w for w in walls], one_process_serve_s=one["serve_s"],
                       train_s=max(r["train"]["wall"] for r in rs),
                       train=dict(loss=t1["loss"], grad_norm=t1["grad_norm"], one_process=tr, loss_rel=loss_rel,
                                  grad_norm_rel=norm_rel, copy_to_leaf_rel=worst_leaf, leaf_limit=self.FAM_LEAF_REL,
                                  leaves=len(leaf_rel)),
                       cache_leaf_share=leaf_share, bf16_gap=gap, bf16_worst_excess=worst,
                       bf16_mismatches=int(differ.sum()), dropped_share=dropped, f32_rel=sound,
                       f32_limit=self.FAM_F32_REL,
                       f32_fault=self.FAM_FAULTS[arch], f32_fault_rel=one["fault_rel"], gather_axes=axes,
                       bytes_prefill=rs[0]["prefill"]["bytes"], bytes_decode_step=rs[0]["decode"][0]["bytes"],
                       bytes_train=t1["bytes"],
                       peak_gib={"prefill": max(r["prefill"]["peak_gib"] or 0.0 for r in rs),
                                 "decode": max(c["peak_gib"] or 0.0 for r in rs for c in r["decode"]),
                                 "train": max(r["train"]["peak_gib"] or 0.0 for r in rs)},
                       dryrun_peak={k: dict(gib=v[0], rel=v[1]) for k, v in dry.items()},
                       sections_s=rs[0]["sections"], part_s=ranks[0]["families_tp_2x4"].get("part_s"))
            self.rows[f"families_tp_2x4/{arch}"] = row
            _p(f"phase 19: families_tp_2x4 {arch} (bf16 at published widths, only the depth cut, tensor-parallel on "
               f"8 gloo ranks sharing the card, the logits teacher-forced on the one-process tokens; the f32 gate at "
               f"1 period against its fault; train: step 1 against one process, fault: the copy_to leaves' "
               f"gradients taken {self.MESH[1]} times; card: {self.smi}): {json.dumps(row)}")
        part_s = ranks[0]["families_tp_2x4"]["part_s"]
        _p(f"phase 19: families_tp_2x4 {part_s:.1f} s (card: {self.smi})")
        if fails:
            raise AssertionError("phase 19 families_tp_2x4: " + "; ".join(fails))

    def judge_zero1(self, plan, ranks, predicted):
        """zero1_2x2x2 against the one-process step (lm_mesh_gates'
        references), the rules' shares and the dry run."""
        part, fails = "zero1_2x2x2", []
        rs = [r[part] for r in ranks]
        want, first = plan["gates_one"], rs[0]["steps"][0]
        losses = [[s["loss"] for s in r["steps"]] for r in rs]
        if any(l != losses[0] for l in losses):
            fails.append("the loss differs between ranks")
        loss_rel = abs(first["loss"] - want[0]["loss"]) / abs(want[0]["loss"])
        norm_rel = abs(first["grad_norm"] - want[0]["grad_norm"]) / abs(want[0]["grad_norm"])
        diff = rs[0]["param_diff_norm"] / plan["gates_moved"]
        if not (loss_rel <= 1e-5 and norm_rel <= 1e-5 and diff <= self.PARAM_REL < plan["gates_fault_moved"]):
            fails.append(f"step 1 loss_rel {loss_rel}, grad_norm_rel {norm_rel}, params {diff}")
        split = self.zero_one["state_bytes"]
        param_share = [r["params_bytes"] / split["params"] for r in rs]
        opt_share = [r["opt_bytes"] / split["opt"] for r in rs]
        if max(param_share) > self.ZERO_PARAM_SHARE_MAX or max(opt_share) > self.ZERO_OPT_SHARE_MAX:
            fails.append(f"shares: parameters {max(param_share)}, optimizer {max(opt_share)}")
        steps = [s for r in rs for s in r["steps"]]
        if any(s["launches"] for s in steps):
            fails.append("the mesh path launched a port kernel")
        if any(sum(s["bytes"].values()) != s["collective_bytes"] for s in steps):
            fails.append("the bytes by kind do not add up to all_reduce's and broadcast's")
        pred, rel = self.dryrun_held("zero1", predicted, [r["steps"][0]["bytes"] for r in rs],
                                     [r["peak_gib"] or 0.0 for r in rs], fails)
        row = dict(arch=plan["gates_cfg"].name, n_layers=plan["gates_cfg"].n_layers, mesh=self.ZERO_MESH,
                   axes=_MESH_AXES[3], losses=losses[0], one_process_losses=[w["loss"] for w in want],
                   loss_rel=loss_rel, grad_norm_rel=norm_rel, param_diff_share=diff,
                   fault_moved_share=plan["gates_fault_moved"], param_share=param_share, opt_share=opt_share,
                   rules_param_share=split["rules_params"] / split["params"],
                   rules_opt_share=split["rules_opt"] / split["opt"],
                   share_max=dict(params=self.ZERO_PARAM_SHARE_MAX, opt=self.ZERO_OPT_SHARE_MAX),
                   bytes_per_step=first["bytes"], peak_gib=[r["peak_gib"] for r in rs], dryrun_peak_gib=pred,
                   dryrun_peak_rel=rel, **self.walls(ranks, part), part_s=ranks[0][part]["part_s"])
        self.rows[part] = row
        _p(f"phase 19: {part} (llama3.2-1b, f32, ZeRO-1 over pod on a (2, 2, 2) mesh of the same 8 gloo ranks, "
           f"against the one-process step of lm_mesh_gates; card: {self.smi}): {json.dumps(row)}")
        if fails:
            raise AssertionError(f"phase 19 {part}: " + "; ".join(fails))

    # ---- the dry run of the card's cells, on the CPU beside the phase ------------

    def dryrun_cells(self):
        """(name, arch, config, shape, seq, global batch, n_micro, mesh) of
        the cells the world runs, at the card's shapes: lm_mesh_2x4's step,
        lm_mesh_serve_2x4's prefill and decode step, each family's prefill,
        decode step and train step, and zero1_2x2x2's step."""
        S, N, mesh = self.SERVE_LEN, self.SERVE_NEW, "x".join(map(str, self.MESH))
        llama = self.config(self.ARCH, n_periods=self.LM_PERIODS)
        cells = [("train", self.ARCH, llama, "train_4k", self.SEQ, self.BATCH, self.MICRO, mesh),
                 ("prefill", self.ARCH, llama, "prefill_32k", S, self.SERVE_PROMPTS, None, mesh),
                 ("decode", self.ARCH, llama, "decode_32k", S + N, self.SERVE_PROMPTS, None, mesh)]
        if "families_tp_2x4" in self.PARTS:
            for arch, cut, train_cut in self.FAMILIES:
                cfg = self.family_cfg(arch, cut)
                cells += [(f"{arch}/prefill", arch, cfg, "prefill_32k", self.FAM_LEN, self.FAM_PROMPTS, None, mesh),
                          (f"{arch}/decode", arch, cfg, "decode_32k", self.FAM_LEN + self.FAM_EXTRA, self.FAM_PROMPTS,
                           None, mesh),
                          (f"{arch}/train", arch, self.family_cfg(arch, train_cut), "train_4k", self.SEQ, self.BATCH,
                           self.FAM_MICRO, mesh)]
        if "zero1_2x2x2" in self.PARTS:
            cells.append(("zero1", self.ARCH, llama.replace(n_periods=self.SHALLOW, dtype="float32"), "train_4k",
                          self.SEQ, self.BATCH, self.ZERO_MICRO, "x".join(map(str, self.ZERO_MESH))))
        return cells

    def start_dryrun(self):
        """``launch.dryrun.run_cell`` for dryrun_cells, under the fake group,
        in a process of its own on the CPU (no card visible), started before
        the world so that the two overlap."""
        import os

        import pickle

        out = self.root / "build" / f"phase19-dryrun-{os.getpid()}"
        out.mkdir(parents=True, exist_ok=True)
        (out / "cells.pkl").write_bytes(pickle.dumps(self.dryrun_cells()))
        code = (
            "import json, pickle, sys\n"
            "from repro_torch.launch.dryrun import run_cell\n"
            "cells = pickle.load(open(sys.argv[1] + '/cells.pkl', 'rb'))\n"
            "recs = {n: run_cell(arch, shape, False, sys.argv[1], force=True, micro=micro, mesh_shape=mesh, seq=seq,\n"
            "                    batch=batch, cfg=cfg) for n, arch, cfg, shape, seq, batch, micro, mesh in cells}\n"
            "json.dump(recs, open(sys.argv[1] + '/cells.json', 'w'), default=str)\n"
        )
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1", PYTHONPATH=str(self.root / "src"))
        log = open(out / "log.txt", "w")
        proc = subprocess.Popen([sys.executable, "-c", code, str(out)], cwd=self.root, env=env, stdout=log,
                                stderr=subprocess.STDOUT)
        return proc, out, log, time.perf_counter()

    def finish_dryrun(self, dryrun):
        import shutil

        proc, out, log, t0 = dryrun
        try:
            code = proc.wait(timeout=max(1.0, self.DRYRUN_TIMEOUT_S - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            raise AssertionError(f"phase 19: the dry run did not end in {self.DRYRUN_TIMEOUT_S} s") from None
        finally:
            log.close()
        text = (out / "log.txt").read_text()
        if code != 0:
            raise AssertionError(f"phase 19: the dry run exited {code}:\n{text[-3000:]}")
        recs = json.loads((out / "cells.json").read_text())
        shutil.rmtree(out, ignore_errors=True)
        bad = {n: r.get("error") for n, r in recs.items() if r["status"] != "ok"}
        if bad:
            raise AssertionError(f"phase 19: dry-run cells failed: {bad}")
        recs["wall_s"] = time.perf_counter() - t0
        return recs

    # ---- the one-process references, on the card before the world -----------

    def references(self):
        from repro_torch.data import SyntheticConfig, batch_at
        from repro_torch.models import init_params
        from repro_torch.models import moe
        from repro_torch.models.common import tree_leaves
        from repro_torch.optim import AdamWConfig
        from repro_torch.train import init_train_state, make_train_step

        torch, dev = self.torch, self.dev
        llama = self.config(self.ARCH, n_periods=self.LM_PERIODS)
        dcfg = SyntheticConfig(vocab=llama.vocab, seq_len=self.SEQ, global_batch=self.BATCH)
        state = init_train_state(llama, self.SEED, device=dev)
        full_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(state.params) + tree_leaves(state.opt))
        (state, m), wall = _sync_time(torch, lambda: make_train_step(llama, AdamWConfig(**self.OPT),
                                                                     n_micro=self.MICRO)(state, batch_at(dcfg, 0, device=dev)))
        one = dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]), wall=wall, state_bytes=full_bytes,
                   params=sum(t.numel() for t in tree_leaves(state.params)), rules_share=self.rules_share(llama, state),
                   fault_grad_share=self.fault_share(state.opt["m"]))  # at lr 0, m is (1 − β1)·the clipped gradient
        del state, m
        self.free()

        gates = llama.replace(n_periods=self.SHALLOW, dtype="float32")
        state = init_train_state(gates, self.GATES_SEED, device=dev)
        p0 = [t.detach().clone() for t in tree_leaves(state.params)]
        step = make_train_step(gates, AdamWConfig(**self.GATES_OPT), n_micro=self.MICRO)
        refs, gates_losses = {}, []
        for i in range(self.STEPS + 1):  # the last for elastic_2x4_to_2x2's next step
            state, m = step(state, batch_at(dcfg, i, device=dev))
            gates_losses.append(dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"])))
            if i == 0:
                refs["m"] = [t.clone() for t in tree_leaves(state.opt["m"])]
                refs["v"] = [t.clone() for t in tree_leaves(state.opt["v"])]
            if i == self.STEPS - 1:
                refs["params"] = [t.detach().clone() for t in tree_leaves(state.params)]
        moved = math.sqrt(sum(float(((a - b).double() ** 2).sum()) for a, b in zip(refs["params"], p0)))
        fault_moved = math.sqrt(self.fault_share(state.params, [a - b for a, b in zip(refs["params"], p0)]))
        del state, m, p0, step
        self.free()

        cfg32 = self.drop_free(self.config(self.MOE_ARCH, n_periods=1, dtype="float32"))
        params = init_params(cfg32, self.MOE_SEED, device=dev)
        p = {k: v[0] for k, v in params["pattern"][0]["ffn"].items()}
        gen = torch.Generator(device=dev).manual_seed(self.MOE_SEED + 7)
        x = torch.randn(self.MOE_X + (cfg32.d_model,), generator=gen, device=dev)
        with torch.no_grad():
            y = moe.moe_apply(p, x, cfg32.replace(moe_impl="gspmd"))
        moe_x, moe_y = x.cpu(), y.cpu()
        del params, p, x, y
        self.free()

        serve = self.serve_references(llama) if "lm_mesh_serve_2x4" in self.PARTS else {}
        fam = self.family_references() if "families_tp_2x4" in self.PARTS else {}
        if "zero1_2x2x2" in self.PARTS:
            self.zero_one = dict(state_bytes=self.state_split(gates, self.GATES_SEED))
        plan = dict(llama=llama, seed=self.SEED, opt=self.OPT, seq=self.SEQ, batch=self.BATCH, micro=self.MICRO,
                    steps=self.STEPS, gates_cfg=gates, gates_seed=self.GATES_SEED, gates_opt=self.GATES_OPT,
                    moe_fwd_cfg=cfg32.replace(moe_impl="shard_map"),
                    moe_cfg=self.config(self.MOE_ARCH, n_periods=1), moe_seed=self.MOE_SEED, moe_opt=self.MOE_OPT,
                    moe_x=moe_x, moe_y=moe_y, mesh=self.MESH, small_mesh=self.SMALL_MESH,
                    ckpt=f"{self.tmp}/ckpt", timeout_s=self.TIMEOUT_S, mem_fraction=self.RANK_MEM_FRACTION,
                    draw_fraction=self.DRAW_FRACTION,
                    device=f"cuda:{torch.cuda.current_device()}" if dev.type == "cuda" else str(dev),
                    one=one, gates_one=gates_losses, gates_moved=moved, gates_fault_moved=fault_moved,
                    fam=fam, fam_prompts=self.FAM_PROMPTS, fam_len=self.FAM_LEN, fam_new=self.FAM_NEW, fam_extra=self.FAM_EXTRA,
                    fam_gate_prompts=self.FAM_GATE_PROMPTS,
                    fam_micro=self.FAM_MICRO, copy_to_leaves=self.COPY_TO_LEAVES, zero_mesh=self.ZERO_MESH,
                    zero_micro=self.ZERO_MICRO, **serve)
        return plan, refs

    # ---- families_tp_2x4's one-process runs ---------------------------------------

    def family_cfg(self, arch, cut, **kw):
        """The family at its published widths, the depth cut, bf16 (or
        ``kw``), the MoE at DROP_FREE."""
        cfg = self.config(arch, **cut, **kw)
        return cfg if cfg.moe is None else cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=self.DROP_FREE))

    def family_references(self):
        """For each family, its one-process runs on the card (``family_one``),
        kept here for the judge; the ranks' plan gets the configs, seeds
        and token inputs only."""
        self.fam_one, plan = {}, {}
        for k, (arch, cut, train_cut) in enumerate(self.FAMILIES):
            plan[arch], self.fam_one[arch] = self.family_one(arch, cut, train_cut, self.FAM_SEED + 10 * k)
            self.free()
        return plan

    def family_one(self, arch, cut, train_cut, seed):
        """One family in one process: (1) bf16 prefill of the prompts and
        greedy decode; (2) the f32 gate at 1 period, sound and with the
        family's fault (FAM_FAULTS); (3) the train step's loss and gradient
        norm (deepseek-v2: the mean over the data shards of ``loss_fn``'s
        forward and backward, the mesh step's definition) and the reading of
        the copy_to leaves' gradients taken tp times."""
        from repro_torch.data import SyntheticConfig
        from repro_torch.models import decode_step, init_params, prefill
        from repro_torch.models.common import tree_leaves, tree_map, tree_paths
        from repro_torch.optim import AdamWConfig, global_norm
        from repro_torch.train import init_train_state, make_train_step
        from repro_torch.train.step import _accumulated

        torch, dev = self.torch, self.dev
        cfg = self.family_cfg(arch, cut)
        P, S, N = self.FAM_PROMPTS, self.FAM_LEN, self.FAM_NEW
        gen = torch.Generator(device="cpu").manual_seed(seed)
        prompts = torch.randint(0, cfg.vocab, (P, S), generator=gen, dtype=torch.int32)
        params = _open_cross_gates(torch, cfg, init_params(cfg, seed, device=dev), seed)
        img = _images(torch, cfg, P, seed)
        batch = {"tokens": prompts.to(dev)}
        if img is not None:
            img = batch["image_embeds"] = img.to(dev)
        t0 = time.perf_counter()
        drops = _MoEDrops(torch)
        with torch.no_grad(), drops:
            logits, cache = prefill(cfg, params, batch, S_cache=S + self.FAM_EXTRA)
            cache_leaves = [t.numel() * t.element_size() for t in tree_leaves(cache)]
            toks, out = [torch.argmax(logits, -1).to(torch.int32)], [logits.float().cpu()]
            for i in range(N - 1):
                logits, cache = decode_step(cfg, params, cache, toks[-1], S + i, img=img)
                toks.append(torch.argmax(logits, -1).to(torch.int32))
                out.append(logits.float().cpu())
        if dev.type == "cuda":
            torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        dropped = {"serve": drops.share()}
        del params, cache, logits, batch, img
        self.free()

        # the f32 gate, a prefill, sound and faulty
        cfg32 = self.family_cfg(arch, dict(n_periods=1), dtype="float32")
        gate_toks = torch.randint(0, cfg.vocab, (self.FAM_GATE_PROMPTS, self.FAM_GATE_LEN), generator=gen,
                                  dtype=torch.int32)
        params = _open_cross_gates(torch, cfg32, init_params(cfg32, seed + 1, device=dev), seed + 1)
        batch = {"tokens": gate_toks.to(dev)}
        img = _images(torch, cfg32, self.FAM_GATE_PROMPTS, seed + 1)
        if img is not None:
            batch["image_embeds"] = img.to(dev)
        runs = {}
        for name in ("sound", "fault"):
            with torch.no_grad(), (self.family_fault(arch) if name == "fault" else contextlib.nullcontext()):
                runs[name] = prefill(cfg32, params, batch)[0].cpu()
        del params, batch, img
        self.free()

        # the train step
        tp = self.MESH[1]
        cfg = self.family_cfg(arch, train_cut)
        dcfg = SyntheticConfig(vocab=cfg.vocab, seq_len=self.SEQ, global_batch=self.BATCH)
        batch = _train_batch(torch, cfg, dcfg, 0, seed + 3, dev)
        drops.reset()
        drops.__enter__()
        if cfg.moe is None:
            state = init_train_state(cfg, seed + 2, device=dev)
            _open_cross_gates(torch, cfg, state.params, seed + 2)
            _open_cross_gates(torch, cfg, state.opt["master"], seed + 2)
            state, m = make_train_step(cfg, AdamWConfig(**self.OPT), n_micro=self.FAM_MICRO)(state, batch)
            train = dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]))
            grads = state.opt["m"]  # at learning rate 0, (1 − β1)·the clipped gradient
            paths = list(tree_paths(grads))
        else:  # the mean over the data shards of loss_fn's forward and backward
            params = init_params(cfg, seed + 2, device=dev)
            n_dp, rows = self.MESH[0], self.BATCH // self.MESH[0]
            total, losses = None, []
            for d in range(n_dp):
                shard = {k: v[d * rows:(d + 1) * rows] for k, v in batch.items()}
                loss, g, _ = _accumulated(cfg, params, shard, self.FAM_MICRO)
                losses.append(float(loss))
                if total is None:
                    total = tree_map(lambda x: x.float(), g)
                else:
                    tree_map(lambda a, b: a.add_(b.float()), total, g)
                del g
            grads = tree_map(lambda x: x / n_dp, total)
            del total, params
            train = dict(loss=sum(losses) / n_dp, grad_norm=float(global_norm(grads)))
            paths = list(tree_paths(grads))
        drops.__exit__()
        dropped["train"] = drops.share()
        sq = [float((x.detach().double() ** 2).sum()) for x in tree_leaves(grads)]
        leaf_is_copy = [path[-1] in self.COPY_TO_LEAVES and "mixer" in path for path in paths]
        share = sum(v for v, c in zip(sq, leaf_is_copy) if c) / sum(sq)
        fault_norm = math.sqrt(1 + (tp**2 - 1) * share) - 1
        # a copy_to leaf's moment (or gradient) taken tp times: tp times the
        # leaf, under a clipping scale that the larger norm lowers
        train.update(fault_share=share, fault_grad_norm_rel=fault_norm,
                     fault_leaf_rel=(tp / (1 + fault_norm) if cfg.moe is None else tp) - 1)
        copy_leaves = {"/".join(map(str, p)): x.detach().float().cpu() for p, x, c in
                       zip(paths, tree_leaves(grads), leaf_is_copy) if c}
        del grads
        self.free()
        one = dict(logits=torch.stack(out, 1), tokens=torch.stack(toks, 1).cpu(), cache_leaves=cache_leaves,
                   gate=runs["sound"], serve_s=serve_s, train=train, copy_to_leaves=copy_leaves, dropped=dropped,
                   fault_rel=_max_rel(runs["fault"], runs["sound"]))
        plan = dict(cfg=self.family_cfg(arch, cut), cfg32=cfg32, cfg_train=cfg, seed=seed, prompts=prompts,
                    tokens=one["tokens"], gate_tokens=gate_toks, train="step" if cfg.moe is None else "loss")
        return plan, one

    @contextlib.contextmanager
    def family_fault(self, arch):
        """The family's fault (FAM_FAULTS) in the one-process port, as a mesh
        of MESH would make it."""
        import torch.nn.functional as F

        from repro_torch.models import attention, rglru, ssm
        from repro_torch.models.common import rms_norm

        torch, tp, kind = self.torch, self.MESH[1], self.FAM_FAULTS[arch]
        saved = []

        def patch(mod, name, fn):
            saved.append((mod, name, getattr(mod, name)))
            setattr(mod, name, fn)

        if kind == "ssd_norm_per_rank":
            def per_rank(y, z, scale, cfg, mesh):
                g = (y * F.silu(z))
                parts = g.reshape(*g.shape[:-1], tp, -1)
                normed = torch.cat([rms_norm(c, torch.zeros(c.shape[-1], device=c.device), cfg.norm_eps)
                                    for c in parts.unbind(-2)], -1)
                return normed * (1.0 + scale.to(g.dtype))

            patch(ssm, "_gated_norm", per_rank)
        elif kind == "gate_sum_left_out":
            real = rglru._gates

            def own_rows(p, u, cfg, mesh=None, chans=None):
                R = p["rg_wa"].shape[0]
                blk = torch.arange(R, device=u.device) // (R // tp)
                mask = (blk[:, None] == blk[None, :]).to(p["rg_wa"].dtype)
                return real(dict(p, rg_wa=p["rg_wa"] * mask, rg_wx=p["rg_wx"] * mask), u, cfg, mesh, chans)

            patch(rglru, "_gates", own_rows)
        else:
            for name in ("_mla_weights", "_cross_weights"):
                real_w = getattr(attention, name)

                def left_out(p, cfg, real_w=real_w):
                    w, mesh, heads = real_w(p, cfg)
                    wo = w["wo"].clone()
                    n = wo.shape[0] // tp
                    wo[self.FAULT_MODEL_RANK * n:(self.FAULT_MODEL_RANK + 1) * n] = 0
                    return dict(w, wo=wo), mesh, heads

                patch(attention, name, left_out)
        try:
            yield
        finally:
            for mod, name, fn in reversed(saved):
                setattr(mod, name, fn)

    def state_split(self, cfg, seed):
        """The bytes of a one-process state of ``cfg`` and the rules' bytes a
        rank of ZERO_MESH holds: parameters and optimizer state apart."""
        from repro_torch.models import transformer as tfm
        from repro_torch.models.common import is_shape, tree_leaves
        from repro_torch.sharding import Mesh, PartitionSpec
        from repro_torch.sharding import collectives as col
        from repro_torch.train import state_pspecs

        mesh = Mesh(self.ZERO_MESH, _MESH_AXES[len(self.ZERO_MESH)])
        specs = state_pspecs(cfg, mesh)
        is_spec = lambda x: isinstance(x, PartitionSpec)  # noqa: E731
        shapes = tree_leaves(tfm.params_shapes(cfg), is_leaf=is_shape)
        out = dict(params=0, opt=0, rules_params=0, rules_opt=0)
        for (shape, dtype), ps, os in zip(shapes, tree_leaves(specs.params, is_leaf=is_spec),
                                          tree_leaves(specs.opt["master"], is_leaf=is_spec)):
            n = math.prod(shape)
            out["params"] += n * dtype.itemsize
            out["opt"] += 3 * n * 4
            out["rules_params"] += math.prod(col.block_shape(shape, ps, mesh)) * dtype.itemsize
            out["rules_opt"] += 3 * math.prod(col.block_shape(shape, os, mesh)) * 4
        return out

    def serve_references(self, llama):
        """lm_mesh_serve_2x4's one-process runs on the card: in bf16 at full
        depth, prefill and greedy decode (``generate``'s loop) of the prompts,
        its tokens, logits and cache bytes; at depth 2 in f32, prefill and
        decode steps fed the prompts' next tokens, and the same with one
        model rank's slice of the cache's positions left out of every decode
        step's attention (the fault the combine must not make)."""
        from repro_torch.models import attention, decode_step, init_params, prefill
        from repro_torch.models.common import tree_leaves

        torch, dev = self.torch, self.dev
        S, N, P = self.SERVE_LEN, self.SERVE_NEW, self.SERVE_PROMPTS
        gen = torch.Generator(device="cpu").manual_seed(self.SERVE_SEED)
        prompts = torch.randint(0, llama.vocab, (P, S), generator=gen, dtype=torch.int32)
        params = init_params(llama, self.SERVE_SEED, device=dev)
        with torch.no_grad():
            logits, cache = prefill(llama, params, {"tokens": prompts.to(dev)}, S_cache=S + N)
            cache_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(cache))
            toks, out = [torch.argmax(logits, -1).to(torch.int32)], [logits.float().cpu()]
            for i in range(N - 1):
                logits, cache = decode_step(llama, params, cache, toks[-1], S + i)
                toks.append(torch.argmax(logits, -1).to(torch.int32))
                out.append(logits.float().cpu())
        del params, cache, logits
        self.free()

        cfg32 = llama.replace(n_periods=self.SHALLOW, dtype="float32")
        S2, K, extra = self.SERVE_GATE_LEN, self.SERVE_GATE_STEPS, self.SERVE_GATE_EXTRA
        gen = torch.Generator(device="cpu").manual_seed(self.SERVE_GATE_SEED)
        gate_toks = torch.randint(0, llama.vocab, (self.SERVE_GATE_PROMPTS, S2 + K), generator=gen, dtype=torch.int32)
        params = init_params(cfg32, self.SERVE_GATE_SEED, device=dev)
        t = gate_toks.to(dev)
        n = (S2 + extra) // self.MESH[1]
        drop = slice(self.FAULT_MODEL_RANK * n, (self.FAULT_MODEL_RANK + 1) * n)
        real = attention.decode_attention

        def faulty(q, k, v, valid, **kw):
            valid = valid.clone()
            valid[:, drop] = False
            return real(q, k, v, valid, **kw)

        runs = {}
        with torch.no_grad():
            for name in ("sound", "fault"):
                attention.decode_attention = faulty if name == "fault" else real
                try:
                    logits, cache = prefill(cfg32, params, {"tokens": t[:, :S2]}, S_cache=S2 + extra)
                    got = [logits.cpu()]
                    for i in range(K):
                        logits, cache = decode_step(cfg32, params, cache, t[:, S2 + i], S2 + i)
                        got.append(logits.cpu())
                finally:
                    attention.decode_attention = real
                runs[name] = got
        del params, cache, logits
        self.free()
        # what the judge reads (kept here: the ranks' plan stays small)
        self.serve_one = dict(logits=torch.stack(out, 1), tokens=torch.stack(toks, 1).cpu(), cache_bytes=cache_bytes,
                              gate=torch.stack(runs["sound"], 1),
                              fault_rel=max(_max_rel(f, g) for f, g in zip(runs["fault"][1:], runs["sound"][1:])))
        return dict(serve_seed=self.SERVE_SEED, serve_len=S, serve_new=N, serve_prompts=prompts,
                    serve_tokens=self.serve_one["tokens"], serve_gate_cfg=cfg32, serve_gate_seed=self.SERVE_GATE_SEED,
                    serve_gate_len=S2, serve_gate_steps=K, serve_gate_extra=extra, serve_gate_tokens=gate_toks)

    def drop_free(self, cfg):
        return cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=4.0))

    def fault_share(self, tree, leaves=None):
        """The share of Σ|x|² over the leaves of ``tree`` (or ``leaves``, in
        its order) held by those named FAULT_LEAVES."""
        from repro_torch.models.common import tree_leaves, tree_paths

        leaves = tree_leaves(tree) if leaves is None else leaves
        sq = [float((t.detach().double() ** 2).sum()) for t in leaves]
        named = [v for v, path in zip(sq, tree_paths(tree)) if path[-1] in self.FAULT_LEAVES]
        if not named:
            raise AssertionError(f"phase 19: no leaf named {self.FAULT_LEAVES}")
        return sum(named) / sum(sq)

    def rules_share(self, cfg, state):
        """The share of ``state``'s bytes one rank of MESH holds under the
        rules: each leaf's bytes (parameter, master, m, v) over the ranks its
        spec splits it across."""
        from repro_torch.models.common import tree_leaves
        from repro_torch.sharding import Mesh, PartitionSpec
        from repro_torch.train import state_pspecs

        mesh = Mesh(self.MESH, ("data", "model"))
        specs = tree_leaves(state_pspecs(cfg, mesh).params, is_leaf=lambda x: isinstance(x, PartitionSpec))
        held = total = 0
        for i, spec in enumerate(specs):
            nbytes = sum(t.numel() * t.element_size() for t in
                         [tree_leaves(state.params)[i]] + [tree_leaves(state.opt[k])[i] for k in ("master", "m", "v")])
            split = math.prod(mesh.axis_size(spec.axes(d)) for d in range(len(spec)))
            held, total = held + nbytes / split, total + nbytes
        return held / total

    # ---- a gloo world on the card ------------------------------------------------

    def world(self, n, plan, refs):
        import os
        import queue as queue_lib

        import torch.multiprocessing as mp

        torch = self.torch
        if self.dev.type == "cuda":
            free, total = torch.cuda.mem_get_info()
            _p(f"phase 19: a world of {n} starts with {free / 2**30:.1f} of {total / 2**30:.1f} GiB free; this "
               f"process holds {torch.cuda.memory_allocated() / 2**30:.2f} GiB (the references)")
        ctx = mp.get_context("spawn")
        results = ctx.Queue()
        procs = [ctx.Process(target=self.TARGET, name=f"phase19-rank{r}",
                             args=(r, n, f"file://{self.tmp}/world{n}", plan, refs, results))
                 for r in range(n)]
        ranks = {}
        t0 = time.perf_counter()
        # the ranks' allocator settings come from the environment they start
        # with: unpickling ``refs`` (CUDA IPC) initializes the card before a
        # rank's own code runs, and without expandable segments a rank holding
        # recurrentgemma's train state kept ≈8 GiB of the card (measured on
        # one H100)
        alloc_conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
        try:
            try:
                for p in procs:
                    p.start()
            finally:
                if alloc_conf is None:
                    del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
                else:
                    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc_conf
            while len(ranks) < n:
                left = self.DEADLINE_S - (time.perf_counter() - t0)
                try:
                    rank, out, err = results.get(timeout=min(max(left, 1.0), 10.0))
                except queue_lib.Empty:
                    dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                    if dead or left <= 0:  # a rank that died before it reported, or the deadline
                        raise AssertionError(f"phase 19: the world of {n} gave {len(ranks)} results in "
                                             f"{time.perf_counter() - t0:.0f} s; exit codes {dead}") from None
                    continue
                if err is not None:
                    raise AssertionError(f"phase 19: gloo rank {rank} of {n} failed:\n{err}")
                ranks[rank] = out
            for p in procs:
                p.join(timeout=60)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=10)
        codes = [p.exitcode for p in procs]
        if codes != [0] * n:
            raise AssertionError(f"phase 19: gloo ranks of the world of {n} exited {codes}")
        out = [ranks[r] for r in range(n)]
        out.append(dict(world_s=time.perf_counter() - t0))
        return out

    # ---- the gates -----------------------------------------------------------------

    @staticmethod
    def walls(ranks, part):
        """Each step's wall, the slowest rank's; the median and spread of the
        warm steps (after the first)."""
        steps = [max(r[part]["steps"][i]["wall"] for r in ranks) for i in range(len(ranks[0][part]["steps"]))]
        warm = sorted(steps[1:]) or steps
        return dict(step_s=steps, median_warm_s=warm[len(warm) // 2], spread_warm_s=warm[-1] - warm[0])

    def judge(self, plan, world8, world4, t_phase):
        ranks, t8 = world8[:-1], world8[-1]["world_s"]
        small, t4 = world4[:-1], world4[-1]["world_s"]
        fails = []

        def common(part, rows):
            losses = [[s["loss"] for s in r[part]["steps"]] for r in rows]
            if any(l != losses[0] for l in losses):
                fails.append(f"{part}: the loss differs between ranks")
            if not all(math.isfinite(v) for v in losses[0]):
                fails.append(f"{part}: a loss is not finite")
            launched = [s["launches"] for r in rows for s in r[part]["steps"] if s["launches"]]
            if launched:
                fails.append(f"{part}: the mesh path launched a port kernel: {launched[0]}")
            split = [s for r in rows for s in r[part]["steps"] if sum(s["bytes"].values()) != s["collective_bytes"]]
            if split:
                fails.append(f"{part}: the bytes by kind do not add up to all_reduce's and broadcast's")
            return losses[0]

        # (1) lm_mesh_2x4
        one, full = plan["one"], plan["one"]["state_bytes"]
        part = "lm_mesh_2x4"
        losses = common(part, ranks)
        first = ranks[0][part]["steps"][0]
        state_share = [r[part]["state_bytes"] / full for r in ranks]
        resident_share = [None if r[part]["resident_gib"] is None else r[part]["resident_gib"] * 2**30 / full
                          for r in ranks]
        row = dict(arch=plan["llama"].name, n_layers=plan["llama"].n_layers, params=one["params"], mesh=self.MESH,
                   full_state_bytes=full, state_share=state_share, resident_share=resident_share,
                   resident_gib=[r[part]["resident_gib"] for r in ranks],
                   init_peak_gib=[r[part]["init_peak_gib"] for r in ranks],
                   peak_gib=[r[part]["peak_gib"] for r in ranks], losses=losses,
                   grad_norms=[s["grad_norm"] for s in ranks[0][part]["steps"]],
                   one_process=dict(loss=one["loss"], grad_norm=one["grad_norm"], wall_s=one["wall"]),
                   loss_rel=abs(first["loss"] - one["loss"]) / abs(one["loss"]),
                   grad_norm_rel=abs(first["grad_norm"] - one["grad_norm"]) / abs(one["grad_norm"]),
                   bytes_per_step=first["bytes"], **self.walls(ranks, part), part_s=ranks[0][part]["part_s"])
        tp = self.MESH[1]
        row.update(rules_share=one["rules_share"], state_share_max=self.STATE_SHARE_MAX,
                   fault_grad_norm_rel=math.sqrt(1 + (tp**2 - 1) * one["fault_grad_share"]) - 1)
        self.rows[part] = row
        _p(f"phase 19: {part} (bf16 parameters, f32 master; 8 gloo ranks sharing the card; fault_grad_norm_rel: "
           f"grad_norm's distance were {'/'.join(self.FAULT_LEAVES)}'s gradients taken {tp} times; card: {self.smi}): "
           f"{json.dumps(row)}")
        if max(state_share) > self.STATE_SHARE_MAX or (resident_share[0] is not None
                                                       and max(resident_share) > self.STATE_SHARE_MAX):
            fails.append(f"{part}: a rank holds more than {self.STATE_SHARE_MAX} of the state")
        if not (row["loss_rel"] <= self.BF16_LOSS_REL and row["grad_norm_rel"] <= self.BF16_NORM_REL):
            fails.append(f"{part}: step 1 differs from the one-process step by more than its bound")
        if not self.BF16_NORM_REL < row["fault_grad_norm_rel"]:
            fails.append(f"{part}: BF16_NORM_REL would pass a doubled sum over model ({row['fault_grad_norm_rel']})")

        # (2) lm_mesh_gates
        part = "lm_mesh_gates"
        losses = common(part, ranks)
        g1, want = ranks[0][part]["steps"][0], plan["gates_one"]
        shares = {tag: max(r[part]["moment_share"][tag] for r in ranks) for tag in ("m", "v")}
        diff = ranks[0][part]["param_diff_norm"] / plan["gates_moved"]
        row = dict(n_layers=plan["gates_cfg"].n_layers, losses=losses, one_process_losses=[w["loss"] for w in want],
                   loss_rel=abs(g1["loss"] - want[0]["loss"]) / abs(want[0]["loss"]),
                   grad_norm_rel=abs(g1["grad_norm"] - want[0]["grad_norm"]) / abs(want[0]["grad_norm"]),
                   moment_share=shares, param_diff_share=diff, param_diff_max=ranks[0][part]["param_diff_max"],
                   fault_moved_share=plan["gates_fault_moved"],
                   save_s=max(r[part]["save_s"] for r in ranks), **self.walls(ranks, part))
        self.rows[part] = row
        _p(f"phase 19: {part} (f32, {plan['gates_cfg'].n_layers} layers; m and v as shares of 1e-4·|want| + "
           f"1e-5·max|want|; fault_moved_share: {'/'.join(self.FAULT_LEAVES)}'s share of the distance the "
           f"one-process run moved the parameters; card: {self.smi}): {json.dumps(row)}")
        if not (row["loss_rel"] <= 1e-5 and row["grad_norm_rel"] <= 1e-5 and max(shares.values()) <= 1
                and diff <= self.PARAM_REL < row["fault_moved_share"]):
            fails.append(f"{part}: {row}")

        # (3) moe_mesh_2x4
        part = "moe_mesh_2x4"
        losses = common(part, ranks)
        row = dict(arch=plan["moe_cfg"].name, n_layers=plan["moe_cfg"].n_layers,
                   experts_a_rank=ranks[0][part]["experts_here"],
                   fwd_err=max(r[part]["fwd_err"] for r in ranks), losses=losses,
                   dropped_share=[sum(r[part]["steps"][i]["dropped_share"] for r in ranks) / len(ranks)
                                  for i in range(self.STEPS)],
                   state_bytes=[r[part]["state_bytes"] for r in ranks], peak_gib=[r[part]["peak_gib"] for r in ranks],
                   bytes_per_step=ranks[0][part]["steps"][0]["bytes"], **self.walls(ranks, part))
        self.rows[part] = row
        _p(f"phase 19: {part} (bf16 train at capacity 1.25, the forward check in f32 at 4.0; card: {self.smi}): "
           f"{json.dumps(row)}")
        if not (row["fwd_err"] < self.FWD_TOL and losses[-1] < losses[0]):
            fails.append(f"{part}: {row}")

        # (4) elastic_2x4_to_2x2
        part = "elastic_2x4_to_2x2"
        before = ranks[0]["lm_mesh_gates"]["next_step"]
        after = [r["elastic_restore"]["next_step"] for r in small]
        launched = [s["launches"] for s in after if s["launches"]]
        row = dict(step=small[0]["elastic_restore"]["step"], bitwise=all(r["elastic_restore"]["bitwise"] for r in small),
                   leaves=small[0]["elastic_restore"]["leaves"],
                   restore_s=max(r["elastic_restore"]["restore_s"] for r in small),
                   state_bytes=[r["elastic_restore"]["state_bytes"] for r in small],
                   loss_2x4=before["loss"], loss_2x2=after[0]["loss"], one_process=plan["gates_one"][-1]["loss"],
                   loss_rel=abs(after[0]["loss"] - before["loss"]) / abs(before["loss"]))
        self.rows[part] = row
        _p(f"phase 19: {part} (the depth-2 f32 state saved from 2x4, restored by a world of 4 onto (2, 2); "
           f"card: {self.smi}): {json.dumps(row)}")
        if not (row["bitwise"] and row["loss_rel"] <= 1e-5 and len({s["loss"] for s in after}) == 1) or launched:
            fails.append(f"{part}: {row}")

        _p(f"phase 19: worlds' walls (s, start-up included; card: {self.smi}) 8 ranks {t8:.1f}, 4 ranks {t4:.1f}; "
           f"phase {t_phase:.1f}")
        if fails:
            raise AssertionError("phase 19: " + "; ".join(fails))


class _Phase14:
    """Phase 14: serving (``repro_torch.serve``) at the paper's size.

    Two tenants, each an A (M, N) f64 at κ = 1e4, β = 1e-6 with a pool of
    K right-hand sides (``benchmarks/serve_bench.py:_make_problem``'s
    regime), served by one ``SolveService`` (CACHE_BYTES, max_delay_s
    0.002, rtol 1e-6):

    1. the digest of tenant 1's A (ms, GB/s), a memo hit under 1 ms, and
       an in-place write on a (SMALL_M, N) card tensor changing the
       fingerprint, the saved value restoring it;
    2. a closed loop of K session requests, cold (one batch, one miss);
    3. the same K requests warm (one batch, a hit; median of 3) beside a
       per-request certified ``lstsq``;
    4. ``prewarm`` of both tenants (tenant 2 by ``token=``/``tenant=``) and
       an open loop of Poisson arrivals at RATE_HZ for DURATION_S on the
       pump thread (max_batch OPEN_BATCH);
    5. N_SMALL small problems through the bucket path (``mode="auto"``),
       each within 1e-10 of the QR of its own augmented problem, and one
       bucket's batched QR timed beside a loop of per-problem calls;
    6. an expired deadline, and two requests through the slow path, each
       with its B1 launches held to a replay of the same certified
       ``lstsq`` on the same derived generator: one at SLOW_RTOL, which
       the slow path must answer (ok, certified, within 10 × its bound of
       the QR solution), and one at TIGHT_RTOL, which it answers or
       rejects with the reference's reason;
    7. ``cache.update_rows`` of DRIFT_ROWS rows of tenant 1 re-keying the
       session, and a request on the updated A answered by it.

    Each part's service calls pass through ``_NoPlain`` and are counted as
    a path of their own; B1's launches are held to one per session build
    on A and one per dispatched session batch (prewarm: one per width of
    its ladder), plus the slow path's."""

    M, N = 2**20, 1000
    SMALL_M = 2**16
    SEED = 1401
    K = 64
    RTOL = 1e-6
    # below the ≈1.2e-12 relative bound the session's batches certify in
    # this regime, so both requests need the slow path; SLOW_RTOL is above
    # the ≈1.3e-13 its certified ladder reaches, TIGHT_RTOL below it
    SLOW_RTOL = 5e-13
    TIGHT_RTOL = 1e-13
    CACHE_BYTES = 24 << 30
    RATE_HZ, DURATION_S, OPEN_BATCH = 50.0, 4.0, 32
    N_SMALL = 256
    DRIFT_ROWS = 4096

    def __init__(self, torch, dev, smi, paths):
        self.torch, self.dev, self.smi, self.paths = torch, dev, smi, paths
        self.b1, self.peaks, self.walls = {}, {}, {}
        self.gen = torch.Generator(device=dev).manual_seed(self.SEED)

    def problem(self):
        """(A, RHS pool) in serve_bench's regime, on the card."""
        from repro_torch.core import generate_problem

        torch, gen = self.torch, self.gen
        A = generate_problem(gen, self.M, self.N, cond=1e4, beta=1e-6, device=self.dev).A
        X = torch.randn((self.N, self.K), generator=gen, dtype=A.dtype, device=self.dev)
        R = torch.randn((self.M, self.K), generator=gen, dtype=A.dtype, device=self.dev)
        P = A @ (X / X.norm(dim=0)) + 1e-6 * R / R.norm(dim=0)
        del X, R
        return A, P

    def counted(self, name, fn, expected):
        """``fn()`` through ``_NoPlain`` as a path of its own; hold B1's
        launches to ``expected`` (a number, or a function of ``fn``'s
        result) and keep the part's peak device memory."""
        from repro_torch.kernels import KERNELS, countsketch_apply, reset_launches

        torch = self.torch
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        with _NoPlain(torch):
            out = fn()
        torch.cuda.synchronize()
        self.paths[f"serve_{name}"] = {f.__name__: f.launches for f in KERNELS}
        self.peaks[name] = torch.cuda.max_memory_allocated() / 2**30
        launches = countsketch_apply.launches
        want = expected(out) if callable(expected) else expected
        self.b1[name] = dict(launches=launches, expected=want)
        if launches != want:
            raise AssertionError(f"phase 14 {name}: B1 launched {launches} times, the code implies {want}")
        others = {k: v for k, v in self.paths[f"serve_{name}"].items() if v and k != "countsketch_apply"}
        if others:
            raise AssertionError(f"phase 14 {name}: kernels off the CountSketch path launched: {others}")
        return out

    @staticmethod
    def certified(resps, rtol, what):
        for r in resps:
            c = r.certificate
            if not r.ok or c is None or not bool(c.passed) or float(c.target) > rtol * 1.001:
                raise AssertionError(f"phase 14 {what}: a response without a passing certificate "
                                     f"(status {r.status}, reason {r.reason}, path {r.path})")

    def qr_gate(self, A, B, resps, what):
        """‖x − x_qr‖ ≤ 10 × the certificate's bound for each column of B."""
        torch = self.torch
        Q, R = torch.linalg.qr(A)
        X_qr = torch.linalg.solve_triangular(R, Q.T @ B, upper=True).cpu()
        del Q, R
        torch.cuda.empty_cache()
        gaps = []
        for j, r in enumerate(resps):
            gap, bound = float((r.x - X_qr[:, j]).norm()), float(r.certificate.error_bound)
            gaps.append(dict(gap=gap, bound=bound, rel_bound=float(r.certificate.rel_error_bound)))
            if not gap <= 10 * bound:
                raise AssertionError(f"phase 14 {what}: column {j}: ‖x − x_qr‖ {gap} > 10 × bound {bound}")
        return gaps

    def run(self):
        import importlib

        from repro_torch.serve import SolveService

        torch = self.torch
        fp_mod = importlib.import_module("repro_torch.serve.fingerprint")
        A1, P1 = self.problem()
        torch.cuda.synchronize()
        svc = SolveService(self.SEED, cache_bytes=self.CACHE_BYTES, max_batch=self.K,
                           max_delay_s=0.002, default_rtol=self.RTOL, device=self.dev)
        self.fingerprint(fp_mod, A1)
        self.closed(svc, A1, P1)
        A2, P2 = self.problem()
        self.open_loop(svc, A1, P1, A2, P2)
        fp2 = fp_mod.fingerprint(A2, sketch=svc.sketch, sketch_size=svc._resolve_sketch_size(self.M, self.N),
                                 token="t2-v1", tenant="tenant-2")
        svc.cache.invalidate(fp2)
        del A2, P2
        torch.cuda.empty_cache()
        self.buckets(svc)
        self.rejections(svc, A1, P1)
        self.drift(svc, fp_mod, A1, P1)
        st = svc.stats()
        _p(f"phase 14: service stats {json.dumps({k: v for k, v in st.items() if k != 'cache'})}; cache "
           f"{json.dumps({k: v for k, v in st['cache'].items() if k != 'per_entry'})}")
        _p(f"phase 14: B1 launches by part (each held to the count the code implies) {json.dumps(self.b1)}")
        _p(f"phase 14: peak device memory by part (GiB) {json.dumps(self.peaks)} (card: {self.smi})")

    def fingerprint(self, fp_mod, A):
        torch = self.torch
        digest, t_cold = self._host_time(lambda: fp_mod.digest_array(A))
        again, t_memo = self._host_time(lambda: fp_mod.digest_array(A))
        if again != digest or t_memo >= 1e-3:
            raise AssertionError(f"phase 14: second digest of the same tensor: {t_memo * 1e3} ms, equal {again == digest}")
        small = torch.randn((self.SMALL_M, self.N), generator=self.gen, dtype=torch.float64, device=self.dev)
        fp0 = fp_mod.fingerprint(small)
        saved = small[0, 0].clone()
        small[0, 0] += 1.0
        fp1 = fp_mod.fingerprint(small)
        small[0, 0] = saved
        fp2 = fp_mod.fingerprint(small)
        if fp1 == fp0 or fp2 != fp0:
            raise AssertionError("phase 14: an in-place write did not change the fingerprint, or the restored value "
                                 "did not give it back")
        gbs = A.numel() * A.element_size() / t_cold / 1e9
        self.walls["digest_s"] = t_cold
        # the digest's two halves apart, on its first GiB: the chunked
        # device→host copies, and BLAKE2b over bytes already on the host
        import hashlib

        head = A.reshape(-1)[: (1 << 30) // A.element_size()]
        step = fp_mod._CHUNK_BYTES // A.element_size()
        chunks, t_d2h = self._host_time(lambda: [head[i:i + step].cpu().numpy() for i in range(0, head.numel(), step)])
        _, t_hash = self._host_time(lambda: [hashlib.blake2b(c, digest_size=16) for c in chunks])
        del chunks
        _p(f"phase 14: digest_array of A{tuple(A.shape)} f64 on the card: {t_cold * 1e3:.1f} ms "
           f"({gbs:.3f} GB/s, device→host in {fp_mod._CHUNK_BYTES >> 20} MiB chunks + BLAKE2b-128; on 1 GiB "
           f"apart: the copies {2**30 / t_d2h / 1e9:.3f} GB/s, the hash {2**30 / t_hash / 1e9:.3f} GB/s); memo hit "
           f"{t_memo * 1e3:.4f} ms; in-place A[0, 0] += 1 on A({self.SMALL_M}, {self.N}) changed the "
           f"fingerprint, the saved value restored it (card: {self.smi})")

    @staticmethod
    def _host_time(fn):
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0

    def closed(self, svc, A, P):
        from repro_torch.core import lstsq

        torch = self.torch
        K, rtol = self.K, self.RTOL

        def burst():
            futs = [svc.submit(A, P[:, j], certified_rtol=rtol, mode="session") for j in range(K)]
            svc.flush()
            return [f.result(timeout=600) for f in futs]

        def cold():
            return self._host_time(burst)

        before = svc.stats()
        resps, t_cold = self.counted("closed_cold", cold, 2)  # the build on A, the batch
        after = svc.stats()
        self.certified(resps, rtol, "closed loop, cold")
        if (after["session_batches"] - before["session_batches"], after["cache"]["misses"],
                any(r.cache_hit for r in resps), {r.batch_size for r in resps}) != (1, 1, False, {K}):
            raise AssertionError(f"phase 14: the cold burst was not one batch on one miss: {after}")
        gaps = self.qr_gate(A, P[:, :4], resps[:4], "closed loop, cold")
        itn = sorted({int(r.result.itn) for r in resps})
        _p(f"phase 14: closed loop cold: {K} requests, one batch, one miss, every certificate passed at rtol "
           f"{rtol:g}; itn {itn}; 4 columns against the QR of A: {json.dumps(gaps)}")

        walls = []
        for i in range(3):
            if i == 0:
                resps, w = self.counted("closed_warm", cold, 1)  # the batch
            else:
                with _NoPlain(torch):
                    resps, w = cold()
            walls.append(w)
            self.certified(resps, rtol, "closed loop, warm")
            if not all(r.cache_hit for r in resps) or {r.batch_size for r in resps} != {K}:
                raise AssertionError("phase 14: a warm burst missed the cache or split")
        t_warm = sorted(walls)[1]
        per = []
        for i in range(3):
            res, w = _sync_time(torch, lambda: lstsq(
                A, P[:, 0], torch.Generator(device=self.dev).manual_seed(i), accuracy="certified",
                certified_rtol=rtol))
            if not bool(res.certificate.passed):
                raise AssertionError("phase 14: the per-request certified lstsq failed its certificate")
            per.append(w)
        t_per = sorted(per)[1]
        self.walls.update(closed_cold_s=t_cold, closed_warm_s=t_warm, per_request_s=t_per)
        _p(f"phase 14: closed loop walls ({K} requests): cold {t_cold:.4f} s, warm {t_warm:.4f} s (median of 3: "
           f"{', '.join(f'{w:.4f}' for w in walls)}); per-request lstsq(accuracy='certified', certified_rtol="
           f"{rtol:g}) median of 3 {t_per:.4f} s (method {res.method}); speedup {K} × per-request / warm "
           f"{K * t_per / t_warm:.1f}x, / cold {K * t_per / t_cold:.1f}x (card: {self.smi})")

    def open_loop(self, svc, A1, P1, A2, P2):
        import numpy as np

        t2 = dict(token="t2-v1", tenant="tenant-2")
        widths = self.OPEN_BATCH.bit_length() - 1  # the ladder 2, 4, ..., OPEN_BATCH
        svc.sessions.max_batch = self.OPEN_BATCH  # the closed loops ran at K

        def prewarm():
            svc.prewarm(A1)
            svc.prewarm(A2, **t2)

        # tenant 1 is cached: a solve and the ladder; tenant 2 adds its build
        _, t_pre = self._host_time(lambda: self.counted("prewarm", prewarm, 2 * (1 + widths) + 1))
        rng = np.random.default_rng(self.SEED)
        n_req = int(self.RATE_HZ * self.DURATION_S)
        gaps = rng.exponential(1.0 / self.RATE_HZ, n_req)
        tenants = [(A1, P1, {}), (A2, P2, t2)]
        before = svc.stats()
        pending = []

        def loop():
            futs = []
            svc.start(poll_s=2e-4)
            try:
                t0 = time.perf_counter()
                t_next = 0.0
                for i in range(n_req):
                    t_next += gaps[i]
                    lag = t_next - (time.perf_counter() - t0)
                    if lag > 0:
                        time.sleep(lag)
                    A, P, kw = tenants[int(rng.integers(2))]
                    futs.append(svc.submit(A, P[:, int(rng.integers(self.K))], certified_rtol=self.RTOL,
                                           mode="session", **kw))
                    pending.append(svc.sessions.pending)
                t_sent = time.perf_counter() - t0
                resps = [f.result(timeout=600) for f in futs]
                wall = time.perf_counter() - t0
            finally:
                svc.stop()
            return resps, wall, t_sent

        def batches(out):
            after = svc.stats()
            if after["slow_path"] != before["slow_path"]:
                raise AssertionError("phase 14: the open loop took the slow path")
            return after["session_batches"] - before["session_batches"]

        resps, wall, t_sent = self.counted("open_loop", loop, batches)
        after = svc.stats()
        self.certified(resps, self.RTOL, "open loop")
        hits = after["cache"]["hits"] - before["cache"]["hits"]
        misses = after["cache"]["misses"] - before["cache"]["misses"]
        rejected = after["rejected"] - before["rejected"]
        if rejected or misses or hits == 0:
            raise AssertionError(f"phase 14: open loop: {rejected} rejected, {hits} hits, {misses} misses")
        lat = np.sort([r.latency_s for r in resps])
        sizes = np.array([r.batch_size for r in resps])
        n_batches = after["session_batches"] - before["session_batches"]
        mean_occ = float(n_req / n_batches / self.OPEN_BATCH)
        half = n_req // 2
        self.walls.update(open_p50_s=float(np.percentile(lat, 50)), open_p99_s=float(np.percentile(lat, 99)),
                          open_solves_per_s=n_req / wall)
        _p(f"phase 14: prewarm of both tenants (tenant 2 by token, no digest) {t_pre:.3f} s")
        _p(f"phase 14: open loop: {n_req} Poisson arrivals at {self.RATE_HZ:g}/s over {t_sent:.3f} s across 2 "
           f"tenants, max_batch {self.OPEN_BATCH}: {n_req / wall:.2f} solves/s achieved (last response at "
           f"{wall:.3f} s); latency p50 {np.percentile(lat, 50) * 1e3:.1f} ms p99 "
           f"{np.percentile(lat, 99) * 1e3:.1f} ms max {lat[-1] * 1e3:.1f} ms; hit rate "
           f"{hits / (hits + misses):.3f}; {n_batches} batches, mean occupancy {mean_occ:.3f} (mean batch "
           f"{n_req / n_batches:.2f}, per-request batch size median {int(np.median(sizes))} max {sizes.max()}); "
           f"queue at each arrival: median {int(np.median(pending))} (first half {int(np.median(pending[:half]))}, "
           f"second half {int(np.median(pending[half:]))}) max {max(pending)}, last {pending[-1]} "
           f"(card: {self.smi})")

    def buckets(self, svc):
        import numpy as np

        from repro_torch.serve import bucket_shape, pad_problem, solve_bucket

        torch, dev = self.torch, self.dev
        rng = np.random.default_rng(self.SEED + 5)
        probs = []
        for i in range(self.N_SMALL):
            m, n = int(rng.integers(40, 401)), int(rng.integers(3, 25))
            A = torch.as_tensor(rng.standard_normal((m, n)), device=dev)
            b = torch.as_tensor(rng.standard_normal(m), device=dev)
            probs.append((A, b, 0.25 if i % 2 else None))
        keys = {}
        for A, b, _ in probs:
            keys.setdefault(bucket_shape(*A.shape), []).append((A, b))
        before = svc.stats()

        def run():
            futs = [svc.submit(A, b, reg=lam, mode="auto") for A, b, lam in probs]
            svc.flush()
            return [f.result(timeout=600) for f in futs]

        resps, t_all = self._host_time(lambda: self.counted("buckets", run, 0))
        after = svc.stats()
        self.certified(resps, self.RTOL, "buckets")
        worst = 0.0
        for (A, b, lam), r in zip(probs, resps):
            n = A.shape[1]
            A_aug = torch.cat([A, (lam or 0.0) ** 0.5 * torch.eye(n, dtype=A.dtype, device=dev)])
            b_aug = torch.cat([b, b.new_zeros(n)])
            Q, R = torch.linalg.qr(A_aug)
            x_qr = torch.linalg.solve_triangular(R, (Q.T @ b_aug)[:, None], upper=True)[:, 0].cpu()
            worst = max(worst, _rel(r.x, x_qr))
            if r.path != "bucket" or _rel(r.x, x_qr) > 1e-10:
                raise AssertionError(f"phase 14: bucket answer {r.path} off its QR by {_rel(r.x, x_qr)}")
        want_batches = sum(-(-len(v) // self.K) for v in keys.values())
        if (after["bucket_executables"] - before["bucket_executables"],
                after["bucket_batches"] - before["bucket_batches"]) != (len(keys), want_batches):
            raise AssertionError(f"phase 14: buckets {after['bucket_executables']} / batches "
                                 f"{after['bucket_batches']}, want {len(keys)} / {want_batches}")
        shape, members = max(keys.items(), key=lambda kv: len(kv[1]))
        pads = [pad_problem(A, b, *shape) for A, b in members]
        A_stack = torch.stack([p[0] for p in pads])
        b_stack = torch.stack([p[1] for p in pads])

        def batched():
            return solve_bucket(A_stack, b_stack, certify=True)

        def looped():
            return [solve_bucket(A_stack[j:j + 1], b_stack[j:j + 1], certify=True) for j in range(len(members))]

        one, loop = batched(), looped()  # also the warm-up
        t_b = sorted(_sync_time(torch, batched)[1] for _ in range(3))[1]
        t_l = sorted(_sync_time(torch, looped)[1] for _ in range(3))[1]
        same = max(float((one["x"][j] - loop[j]["x"][0]).abs().max()) for j in range(len(members)))
        self.walls.update(bucket_batched_s=t_b, bucket_loop_s=t_l)
        _p(f"phase 14: buckets: {self.N_SMALL} problems (m 40–400, n 3–24, half at λ = 0.25) in {len(keys)} "
           f"buckets, {want_batches} batches, submit + flush {t_all:.4f} s; every x within {worst:.2e} of the QR of "
           f"its own augmented problem, every certificate passed")
        _p(f"phase 14: bucket {shape} of {len(members)} problems: one batched QR + certify {t_b * 1e3:.3f} ms, "
           f"a loop of {len(members)} single-problem calls {t_l * 1e3:.3f} ms (median of 3 warm; max|Δx| "
           f"{same:.2e}; card: {self.smi})")

    def rejections(self, svc, A, P):
        from repro_torch.core import lstsq
        from repro_torch.kernels import countsketch_apply, reset_launches
        from repro_torch.serve.service import derive_generator

        torch = self.torch

        def expired():
            fut = svc.submit(A, P[:, 0], mode="session", deadline_s=-1.0)
            svc.flush()
            return fut.result(timeout=600)

        r = self.counted("deadline", expired, 0)
        if r.ok or r.reason != "deadline expired while queued":
            raise AssertionError(f"phase 14: the expired request was answered: {r.status} {r.reason}")

        _p("phase 14: expired deadline: rejected with 'deadline expired while queued', nothing launched")

        def slow(name, rtol):
            def submit():
                fut = svc.submit(A, P[:, 1], certified_rtol=rtol, mode="session")
                svc.flush()
                return fut.result(timeout=600)

            replay = {}

            def expected(res):
                if res.path != "slow":
                    raise AssertionError(f"phase 14: the rtol {rtol:g} request took the {res.path} path")
                # the same certified lstsq on the same derived generator, counted
                counter = svc._session_counter
                torch.cuda.synchronize()
                reset_launches()
                with _NoPlain(torch):
                    again = lstsq(A, P[:, 1], derive_generator(svc._seed, counter, self.dev), accuracy="certified",
                                  certified_rtol=rtol, sketch=svc.sketch)
                torch.cuda.synchronize()
                replay.update(launches=countsketch_apply.launches, res=again)
                return 1 + countsketch_apply.launches  # the session batch, then the slow path

            before = svc.stats()
            r, t_slow = self._host_time(lambda: self.counted(name, submit, expected))
            if r.path != "slow" or svc.stats()["slow_path"] != before["slow_path"] + 1:
                raise AssertionError(f"phase 14: the slow path was not counted: {svc.stats()['slow_path']}")
            if not r.ok and "unattainable" not in r.reason:
                raise AssertionError(f"phase 14: slow path rejected without the reference's reason: {r.reason}")
            again = replay["res"]
            if r.ok:
                outcome = (f"passed: rel. bound {float(r.certificate.rel_error_bound):.3e} via {r.result.method}, "
                           f"{r.certificate.escalations} escalations; x bitwise the replay "
                           f"{bool(torch.equal(r.x, again.x.cpu()))}")
            else:
                outcome = f"rejected: {r.reason}"
            self.walls[f"{name}_s"] = t_slow
            return r, (f"phase 14: slow path at certified_rtol={rtol:g}: {outcome}; wall {t_slow:.3f} s; B1 launches "
                       f"{self.b1[name]['launches']} = 1 (the session batch) + {replay['launches']} (the replayed "
                       f"certified lstsq)")

        r, line = slow("slow_path", self.SLOW_RTOL)
        if not r.ok:
            raise AssertionError(f"phase 14: the slow path did not answer at rtol {self.SLOW_RTOL:g}: {r.reason}")
        self.certified([r], self.SLOW_RTOL, "slow path")
        (gap,) = self.qr_gate(A, P[:, 1:2], [r], "slow path")
        _p(f"{line}; ‖x − x_qr‖ {gap['gap']:.3e} against 10 × bound {10 * gap['bound']:.3e}")
        _, line = slow("slow_tight", self.TIGHT_RTOL)
        _p(line)

    def drift(self, svc, fp_mod, A, P):
        torch = self.torch
        m, n = A.shape
        fp = fp_mod.fingerprint(A, sketch=svc.sketch, sketch_size=svc._resolve_sketch_size(m, n))
        idx = torch.randperm(m, generator=self.gen, device=self.dev)[: self.DRIFT_ROWS]
        rows = A[idx] * (1 + 0.01 * torch.randn((idx.numel(), n), generator=self.gen, dtype=A.dtype,
                                                device=self.dev))
        b = P[:, 2]
        walls = {}

        def update():
            new_fp, walls["update_rows"] = self._host_time(lambda: svc.cache.update_rows(fp, idx, rows))
            A[idx] = rows  # the caller's copy takes the same update
            fut = svc.submit(A, b, certified_rtol=self.RTOL, mode="session")
            svc.flush()
            return new_fp, fut.result(timeout=600)

        before = svc.stats()["cache"]
        (new_fp, r), t_all = self._host_time(lambda: self.counted("drift", update, 2))  # delta-sketch, batch
        after = svc.stats()["cache"]
        if new_fp is None or new_fp == fp or new_fp not in svc.cache or fp in svc.cache:
            raise AssertionError("phase 14: update_rows did not re-key the session")
        if not r.cache_hit or after["hits"] != before["hits"] + 1:
            raise AssertionError("phase 14: the request on the updated A missed the re-keyed session")
        self.certified([r], self.RTOL, "drift")
        gaps = self.qr_gate(A, b[:, None], [r], "drift")
        _p(f"phase 14: drift: update_rows of {self.DRIFT_ROWS} rows of tenant 1 {walls['update_rows']:.3f} s "
           f"(delta-sketch, QR, Y and the new digest) re-keyed {fp.short()} → {new_fp.short()}; the request on "
           f"the updated A (one more digest of the caller's A) hit it: {json.dumps(gaps)}; part wall "
           f"{t_all:.3f} s (card: {self.smi})")


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
