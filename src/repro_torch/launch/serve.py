"""Serving launcher: batched prefill + greedy decode.

    python -m repro_torch.launch.serve --arch llama3.2-1b [--smoke] [--device cpu]

Port of ``repro/launch/serve.py``.  Runs on the card (``--device cuda``, the
default; no fallback) unless given another device.  Parameters are drawn
from seed 0, the prompts from seed 1.
"""
from __future__ import annotations

import argparse

import torch

from ..configs import get_config, smoke_config
from ..core.backend import resolve_device
from ..models import init_params
from ..train.serve import generate


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.frontend != "token":
        raise SystemExit(f"{args.arch}: stub frontend — serve a token arch")
    dev = resolve_device(args.device)
    params = init_params(cfg, 0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len), generator=gen, device=dev)
    out = generate(cfg, params, prompts, max_new=args.max_new).cpu()
    for i in range(args.batch):
        print(f"[{i}] {' '.join(map(str, out[i].tolist()))}")
    print(f"served batch={args.batch} prompt={args.prompt_len} new={args.max_new} on {dev}")


if __name__ == "__main__":
    main()
