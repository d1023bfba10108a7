"""Training launcher.

    python -m repro_torch.launch.train --arch qwen3-0.6b --smoke \\
        --mesh 1x1 --steps 50 --ckpt /tmp/ck [--device cpu]

Port of ``repro/launch/train.py`` for one process (``--mesh 1x1``) through
``train.loop.train_loop`` (``make_train_step``): a bigram synthetic stream,
AdamW, async checkpoints every ``--ckpt-every`` steps and resume from the
latest one (rerun the same command).  Runs on the card (``--device cuda``,
the default; no fallback) unless given another device.  Other meshes (2-D
FSDP/TP placement, elastic restore onto them) belong to the second half of
the ML stack (ROADMAP A14b).
"""
from __future__ import annotations

import argparse

from ..configs import get_config, smoke_config
from ..data import SyntheticConfig
from ..optim import AdamWConfig
from ..train.loop import train_loop


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--mesh", default="1x1", help="only 1x1 in this slice")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--micro", type=int, default=1)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if tuple(int(d) for d in args.mesh.split("x")) != (1, 1):
        raise NotImplementedError(
            f"--mesh {args.mesh}: sharded meshes arrive with the second half of the ML stack "
            "(ROADMAP A14b); this launcher runs --mesh 1x1"
        )
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    dcfg = SyntheticConfig(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch, kind="bigram")
    ocfg = AdamWConfig(lr=args.lr, warmup_steps=10, total_steps=args.steps)
    train_loop(cfg, dcfg, ocfg, steps=args.steps, ckpt_dir=args.ckpt, ckpt_every=args.ckpt_every,
               n_micro=args.micro, device=args.device)
    print("done")


if __name__ == "__main__":
    main()
