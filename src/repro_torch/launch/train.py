"""Training launcher.

    python -m repro_torch.launch.train --arch qwen3-0.6b --smoke \\
        --mesh 1x1 --steps 50 --ckpt /tmp/ck [--device cpu]
    torchrun --nproc-per-node 8 -m repro_torch.launch.train \\
        --arch llama3.2-1b --mesh 2x4 --backend gloo

Port of ``repro/launch/train.py``.  ``--mesh 1x1`` runs one process through
``train.loop.train_loop`` (``make_train_step``).  Any other mesh runs one
process a rank, started by ``torchrun`` (its ``RANK``, ``WORLD_SIZE`` and
rendezvous variables; ``--backend``, default ``nccl`` with one rank a
card; on one card pass ``gloo``, whose ranks share it — nothing switches
backends by itself): ``--mesh D`` names its axis ``("data",)``, ``--mesh
DxM`` ``("data", "model")`` and ``--mesh PxDxM`` ``("pod", "data",
"model")``.  Each rank draws the state from seed 0 a leaf at a time and
keeps its blocks (``init_sharded_state``: ``--mesh 1x1``'s weights),
trains with ``jit_train_step`` on its rows of the bigram stream, and every
``--ckpt-every`` steps the state is assembled and written by the first
rank; rerunning the command resumes through
``restore_elastic`` onto whatever mesh it names.  Runs on the card
(``--device cuda``, the default; no fallback) unless given another device.
"""
from __future__ import annotations

import argparse
import datetime
import os

from ..configs import get_config, smoke_config
from ..data import SyntheticConfig
from ..optim import AdamWConfig
from ..train.loop import train_loop


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--mesh", default="1x1", help="e.g. 2x4 (data x model) or 8 (data)")
    ap.add_argument("--backend", default="nccl", help="torch.distributed backend of a mesh other than 1x1")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--micro", type=int, default=1)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dims = tuple(int(d) for d in args.mesh.split("x"))
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    dcfg = SyntheticConfig(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch, kind="bigram")
    ocfg = AdamWConfig(lr=args.lr, warmup_steps=10, total_steps=args.steps)
    if dims == (1, 1):
        train_loop(cfg, dcfg, ocfg, steps=args.steps, ckpt_dir=args.ckpt, ckpt_every=args.ckpt_every,
                   n_micro=args.micro, device=args.device)
    else:
        _train_on_mesh(args, dims, cfg, dcfg, ocfg)
    print("done")


def _train_on_mesh(args, dims, cfg, dcfg, ocfg):
    import torch
    import torch.distributed as dist

    from ..core.backend import resolve_device
    from ..data import batch_at
    from ..models.common import tree_map
    from ..sharding import NamedSharding, PartitionSpec
    from ..sharding.collectives import shard_block
    from ..train import checkpoint as ckpt_lib
    from ..train.elastic import restore_elastic
    from ..train.step import batch_pspec, init_sharded_state, jit_train_step, state_pspecs
    from .mesh import make_mesh

    names = ("pod", "data", "model")[-len(dims):] if len(dims) > 1 else ("data",)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")) % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(args.backend, timeout=datetime.timedelta(seconds=600))
    try:
        mesh = make_mesh(dims, names)
        rank0 = mesh.rank == 0
        start = 0
        if args.ckpt and ckpt_lib.latest_step(args.ckpt) is not None:
            state, start = restore_elastic(args.ckpt, cfg, mesh, device=dev)
            if rank0:
                print(f"[resume] step {start} onto mesh {dims}")
        else:
            state = init_sharded_state(cfg, 0, mesh, device=dev)
        shardings = tree_map(lambda s: NamedSharding(mesh, s), state_pspecs(cfg, mesh),
                             is_leaf=lambda x: isinstance(x, PartitionSpec))
        step_fn = jit_train_step(cfg, ocfg, mesh, n_micro=args.micro)
        writer = ckpt_lib.AsyncCheckpointer(args.ckpt) if args.ckpt else None
        bspec = batch_pspec(mesh)
        for step in range(start, args.steps):
            batch = {k: shard_block(v, bspec, mesh) for k, v in batch_at(dcfg, step, device=dev).items()}
            state, metrics = step_fn(state, batch)
            if rank0 and ((step + 1) % 10 == 0 or step + 1 == args.steps):
                print(f"step {step + 1:5d} loss {float(metrics['loss']):.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f}", flush=True)
            if writer and (step + 1) % args.ckpt_every == 0:
                writer.submit(step + 1, state, shardings=shardings)
        if writer:
            writer.submit(args.steps, state, shardings=shardings)
            writer.finalize()
        dist.barrier()  # every rank returns once the first rank's checkpoint is in place
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
