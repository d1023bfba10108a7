"""Training driver: resume -> step loop -> async checkpoints -> metrics.

Port of ``repro/train/loop.py``.  It resumes through the port's atomic
store (``train/checkpoint.py``: the reference's layout and ``keystr``
names, so a checkpoint of either package resumes in the other), restoring
into the state's shapes with nothing allocated first.
"""
from __future__ import annotations

import time

from ..configs.base import ModelConfig
from ..core.backend import resolve_device
from ..data import SyntheticConfig, batch_at
from ..optim import AdamWConfig
from . import checkpoint as ckpt_lib
from .step import init_train_state, make_train_step, state_shapes

__all__ = ["train_loop"]


def train_loop(
    cfg: ModelConfig,
    data_cfg: SyntheticConfig,
    opt_cfg: AdamWConfig,
    *,
    steps: int,
    ckpt_dir: str | None = None,
    ckpt_every: int = 50,
    keep_n: int = 3,
    n_micro: int = 1,
    log_every: int = 10,
    seed: int = 0,
    log=print,
    device=None,
):
    """Single-process training loop on ``device`` (``None``: the card).
    Resumes from the latest checkpoint in ``ckpt_dir`` if one exists.
    Returns ``(state, [(step, loss), ...])`` at every ``log_every``-th step
    and the last."""
    dev = resolve_device(device)
    start = 0
    writer = None
    state = None
    if ckpt_dir:
        found = ckpt_lib.latest_step(ckpt_dir)
        if found is not None:
            state, start = ckpt_lib.restore(ckpt_dir, state_shapes(cfg), step=found, device=dev)
            state = state._replace(step=state.step.cpu())
            log(f"[resume] restored step {start} from {ckpt_dir}")
        writer = ckpt_lib.AsyncCheckpointer(ckpt_dir, keep_n=keep_n)
    if state is None:
        state = init_train_state(cfg, seed, device=dev)

    step_fn = make_train_step(cfg, opt_cfg, n_micro=n_micro)
    losses = []
    t0 = time.time()
    for step in range(start, steps):
        state, metrics = step_fn(state, batch_at(data_cfg, step, device=dev))
        if (step + 1) % log_every == 0 or step + 1 == steps:
            loss = float(metrics["loss"])
            losses.append((step + 1, loss))
            dt = (time.time() - t0) / max(step + 1 - start, 1)
            log(
                f"step {step+1:5d} loss {loss:.4f} "
                f"gnorm {float(metrics['grad_norm']):.3f} "
                f"lr {metrics['lr']:.2e} ({dt*1e3:.0f} ms/step)"
            )
        if writer and (step + 1) % ckpt_every == 0:
            writer.submit(step + 1, state)
    if writer:
        writer.submit(steps, state)
        writer.finalize()
    return state, losses
