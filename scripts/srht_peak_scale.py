#!/usr/bin/env python3
"""The SRHT's memory and B8 beyond the paper's size, for one version of the port.

Usage, on a machine with one NVIDIA card::

    python3 scripts/srht_peak_scale.py [SRC]

It imports ``repro_torch`` from SRC (default: the ``src`` beside this
script's directory), so that the same script measures two versions of the
port, each run in its own process, and uses only entry points that both
have.  It prints one JSON line:

- ``solve``: at the paper's size (m = 2^20, n = 1000, κ = 1e10, β = 1e-10,
  f64, seed 0), for ``saa_sas`` with the SRHT and, for reference, the
  CountSketch, each with Y = AR⁻¹ formed (the default for a dense A) and
  with ``materialize_y=False``: the peak device memory above the solve's
  start (bytes, ``torch.cuda.max_memory_allocated``, after one warm-up
  solve), the warm wall time (s) and the forward error;
- ``b8_2^21``: ``SRHTSketch.apply`` (kernel B8) on a random A (2^21, 1000)
  f64 with d = 4000 (three passes): its device time (ms, CUDA events, mean
  of 5 after a warm-up), its peak device memory beyond A and its output,
  and a SHA-256 of its output's bytes, equal between two versions that
  agree bit for bit.

Without CUDA it exits 2 and prints nothing.
"""
from __future__ import annotations

import hashlib
import json
import sys
import time
from pathlib import Path


def main() -> int:
    src = Path(sys.argv[1]) if len(sys.argv) > 1 else Path(__file__).resolve().parents[1] / "src"
    sys.path.insert(0, str(src.resolve()))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core import SRHTSketch, generate_problem, saa_sas

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    prob = generate_problem(gen, 2**20, 1000, cond=1e10, beta=1e-10, device=dev)
    A, b, x_true = prob.A, prob.b, prob.x_true
    del prob
    out = {"src": str(src), "card": torch.cuda.get_device_name(0), "solve": {}}
    for sketch in ("clarkson_woodruff", "srht"):
        for materialize_y in (True, False):

            def solve():
                return saa_sas(A, b, gen, sketch=sketch, materialize_y=materialize_y)

            solve()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            start = time.perf_counter()
            res = solve()
            torch.cuda.synchronize()
            wall = time.perf_counter() - start
            out["solve"][f"{sketch} materialize_y={materialize_y}"] = {
                "peak_bytes": torch.cuda.max_memory_allocated() - before,
                "wall_s": wall,
                "rel_err": float((res.x - x_true).norm() / x_true.norm()),
            }
            del res
    del A, b, x_true
    torch.cuda.empty_cache()

    gen.manual_seed(1)
    m, n, d = 2**21, 1000, 4000
    A = torch.randn((m, n), generator=gen, dtype=torch.float64, device=dev)
    op = SRHTSketch.sample(gen, d, m, device=dev)
    op.apply(A)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    B = op.apply(A)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - before - B.numel() * B.element_size()
    digest = hashlib.sha256(B.cpu().numpy().tobytes()).hexdigest()
    del B
    start_ev, stop_ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start_ev.record()
    for _ in range(5):
        op.apply(A)
    stop_ev.record()
    stop_ev.synchronize()
    out["b8_2^21"] = {"ms": start_ev.elapsed_time(stop_ev) / 5, "scratch_bytes": extra, "sha256": digest}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
