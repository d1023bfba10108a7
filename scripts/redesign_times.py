#!/usr/bin/env python3
"""Times of kernels B6 (``sketch_matmul``) and B7 (``matmul_gram``) on bf16,
f16 and f32 inputs at ``chip_smoke.py`` phase 8's shape, S (4000, 2^16) and
A (2^16, 1000), for the ``repro_torch`` of any tree.

Usage, from the root of a checkout on a machine with one NVIDIA card:

    python3 scripts/redesign_times.py [--src DIR] [--label NAME] [--json PATH]

``--src`` imports ``repro_torch`` from another tree's ``src`` (default: this
checkout's), whose kernels build from that tree's ``csrc``, so one call on
one card can time an earlier tree unpacked beside this one and this one in
turns (the two entries take the same arguments in every tree since B6's
f64 engine).  Each time is ``chip_smoke.py``'s ``_event_ms`` (CUDA events,
the mean of 5 calls after a warm-up), beside the plain version and one
library call, ``S @ A`` in the dtype (bf16/f16 in, bf16/f16 out).  The
bounds and the checks are ``chip_smoke.py``'s (phases 2 and 8).  It prints
one JSON line and writes it to ``--json`` if given.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
D, M, N = 4000, 2**16, 1000


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--json")
    args = ap.parse_args()
    sys.path[:0] = [str(Path(args.src).resolve()), str(ROOT)]
    import torch

    from chip_smoke import _event_ms

    if not torch.cuda.is_available():
        print("redesign_times.py: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import matmul_gram, matmul_gram_ref, sketch_matmul, sketch_matmul_ref

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    S64 = torch.empty((D, M), dtype=torch.float64, device=dev).uniform_(-(3 / D) ** 0.5, (3 / D) ** 0.5,
                                                                         generator=gen)
    A64 = torch.randn((M, N), generator=gen, dtype=torch.float64, device=dev)
    out = {"label": args.label, "src": args.src, "card": smi}
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        S, A = S64.to(dtype), A64.to(dtype)
        out[str(dtype).removeprefix("torch.")] = {
            "sketch_matmul": dict(ms=_event_ms(torch, lambda: sketch_matmul(S, A)),
                                  plain_ms=_event_ms(torch, lambda: sketch_matmul_ref(S, A)),
                                  library_ms=_event_ms(torch, lambda: S @ A)),
            "matmul_gram": dict(ms=_event_ms(torch, lambda: matmul_gram(S, A)),
                                plain_ms=_event_ms(torch, lambda: matmul_gram_ref(S, A))),
        }
        del S, A
    line = json.dumps(out)
    print(line, flush=True)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(line + "\n")
    return 0 if all(math.isfinite(t["ms"]) for v in out.values() if isinstance(v, dict)
                    for t in v.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
