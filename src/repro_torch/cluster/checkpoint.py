"""Mid-pass accumulator checkpoints: preemption loses a few tiles, not a pass.

Port of ``repro/cluster/checkpoint.py``.  A
:class:`~repro_torch.streaming.accumulate.SketchAccumulator` is a pure fold
over row tiles, so its full recovery state is small and exact:

- the per-kind state tensor (the (d, ncols) additive state, the sparse-sign
  sketch's (k·d, ncols) partial sums with bucket ids j·d + h_j, or the
  SRHT's (m_pad, ncols) D-signed placement buffer, a device tensor here),
- the ``rows_seen`` / ``tiles_seen`` counters,
- the **watermark**: the global row offset the stream has covered (cut on
  tile boundaries, so resuming re-reads nothing),
- a digest of the operator draw, so a checkpoint is never restored
  against another S.

Writes go through :func:`repro_torch.train.checkpoint.save` (the atomic
tmp-then-rename layout with a manifest) under
``<ckpt_dir>/<phase>/range_<start>_<stop>/step_<watermark>``, keyed by the
row RANGE, not the worker: ranges are the unit of reassignment, so a
replacement worker restores a dead worker's checkpoint by range alone.

Resume is bitwise the uninterrupted stream for every kind: ``np.savez``
round-trips the state bitwise, and continuing the fold from a bitwise
partial over the same remaining tiles does the same arithmetic (for the
bucket kinds, kernel B1's fold mode adds each tile into the restored
state in row order).  :func:`op_digest` hashes the port's operator
fields, so its digests differ from the reference's (which hash JAX
treedefs and PRNG key data); a checkpoint moves between the packages'
stores, not between their operators.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os

import numpy as np
import torch

from ..streaming.accumulate import SketchAccumulator, make_accumulator
from ..train import checkpoint as ckpt_lib

__all__ = [
    "op_digest",
    "pass_namespace",
    "save_accumulator",
    "restore_accumulator",
    "latest_watermark",
    "CheckpointMismatch",
]


class CheckpointMismatch(ValueError):
    """Checkpoint belongs to a different operator draw / stream layout."""


def _hash_tensor(h, t: torch.Tensor) -> None:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)  # numpy has no bf16: its bits
    arr = t.cpu().contiguous().numpy()
    h.update(str((tuple(arr.shape), arr.dtype.str)).encode())
    h.update(arr.tobytes())


def _hash_value(h, v) -> None:
    if isinstance(v, torch.Tensor):
        _hash_tensor(h, v)
    elif dataclasses.is_dataclass(v) and not isinstance(v, type):
        _hash_op(h, v)
    else:
        h.update(repr(v).encode())


def _hash_op(h, op) -> None:
    h.update(type(op).__name__.encode())
    for f in dataclasses.fields(op):
        if not f.compare:  # caches (_csr, _plan) and the device are not the draw
            continue
        h.update(f.name.encode())
        _hash_value(h, getattr(op, f.name))


def op_digest(op) -> bytes:
    """Content digest of an operator DRAW (not just its shape).

    Hashes the class name and each ``compare=True`` dataclass field in
    order: a tensor by its shape, dtype and bytes (taken through
    ``.cpu()``; bf16 as its 16-bit pattern), a nested operator field by
    field, anything else by its repr.  The per-operator caches are left
    out, so two objects holding the same draw digest equal and two draws
    differ: the predicate ``streaming.accumulate._same_draw`` checks with
    ``torch.equal``.
    """
    h = hashlib.blake2b(digest_size=16)
    _hash_op(h, op)
    return h.digest()


def pass_namespace(op, rhs=None, *, digest: bytes | None = None) -> str:
    """Checkpoint namespace (a ``phase`` directory name) for ONE pass-1
    sketch: a digest of the operator draw plus the rhs riding along.

    A different draw, or the same draw over a different right-hand side,
    lands in a different namespace, so leftovers from an earlier run in a
    persistent ``ckpt_dir`` restore ``None`` (a fresh start) instead of
    raising :class:`CheckpointMismatch` or resuming a partial that folded
    in another rhs column.  ``digest`` is ``op_digest(op)`` when the caller
    has it already.
    """
    h = hashlib.blake2b(digest if digest is not None else op_digest(op), digest_size=8)
    if rhs is not None:
        _hash_tensor(h, torch.as_tensor(rhs))
    return f"pass1-{h.hexdigest()}"


def _range_dir(ckpt_dir: str, start: int, stop: int, phase: str = "pass1") -> str:
    return os.path.join(ckpt_dir, phase, f"range_{start}_{stop}")


def save_accumulator(
    ckpt_dir: str,
    acc: SketchAccumulator,
    watermark: int,
    *,
    range_start: int,
    range_stop: int,
    phase: str = "pass1",
    digest: bytes | None = None,
) -> str:
    """Atomic checkpoint of a partial accumulator at a tile boundary.

    ``watermark`` is the exclusive global row offset covered so far; it
    doubles as the checkpoint step, so ``latest_step`` returns the
    furthest-progressed checkpoint of the range.  The state's copy to the
    host waits for the work queued on its stream.  ``digest`` is
    ``op_digest(acc.op)`` when the caller has it already (a pass saves many
    checkpoints of one draw).
    """
    tree = {
        "state": acc.state,
        "rows_seen": np.int64(acc.rows_seen),
        "tiles_seen": np.int64(acc.tiles_seen),
        "watermark": np.int64(watermark),
        "range": np.asarray([range_start, range_stop], np.int64),
        "op_digest": np.frombuffer(digest if digest is not None else op_digest(acc.op), np.uint8),
    }
    return ckpt_lib.save(_range_dir(ckpt_dir, range_start, range_stop, phase), int(watermark), tree)


def latest_watermark(ckpt_dir: str, range_start: int, range_stop: int, *, phase: str = "pass1") -> int | None:
    """Watermark of the newest checkpoint for the range, or None."""
    return ckpt_lib.latest_step(_range_dir(ckpt_dir, range_start, range_stop, phase))


def restore_accumulator(
    ckpt_dir: str,
    op,
    ncols: int,
    *,
    range_start: int,
    range_stop: int,
    phase: str = "pass1",
    dtype=torch.float64,
    backend: str = "auto",
    digest: bytes | None = None,
) -> tuple[SketchAccumulator, int] | None:
    """(accumulator, watermark) from the range's newest checkpoint, or
    ``None`` when the range has never checkpointed (start from scratch).

    The state comes back on ``op.device`` in the accumulation dtype, a
    fresh tensor the next ``update`` writes in place (the SRHT's placement
    buffer included).  Raises :class:`CheckpointMismatch` when the stored
    operator digest, state shape or range disagrees with the live draw:
    restoring another draw's partial would silently poison the merge.
    ``digest`` is ``op_digest(op)`` when the caller has it already.
    """
    rdir = _range_dir(ckpt_dir, range_start, range_stop, phase)
    if ckpt_lib.latest_step(rdir) is None:
        return None
    acc = make_accumulator(op, ncols, dtype=dtype, backend=backend)
    target = {
        "state": acc.state,
        "rows_seen": ((), torch.int64),
        "tiles_seen": ((), torch.int64),
        "watermark": ((), torch.int64),
        "range": ((2,), torch.int64),
        "op_digest": ((16,), torch.uint8),
    }
    try:
        tree, _ = ckpt_lib.restore(rdir, target, device="cpu")
    except ValueError as e:
        raise CheckpointMismatch(
            f"checkpoint for range [{range_start}, {range_stop}) does not "
            f"match the live accumulator: {e}"
        ) from e
    if bytes(tree["op_digest"].numpy()) != (digest if digest is not None else op_digest(op)):
        raise CheckpointMismatch(
            f"checkpoint for range [{range_start}, {range_stop}) was written "
            "by a different operator draw — refusing to resume into it"
        )
    if tuple(tree["range"].tolist()) != (range_start, range_stop):
        raise CheckpointMismatch(
            f"checkpoint range metadata {tree['range'].tolist()} does not "
            f"match [{range_start}, {range_stop})"
        )
    acc.state = tree["state"].to(acc.state.device)
    acc.rows_seen = int(tree["rows_seen"])
    acc.tiles_seen = int(tree["tiles_seen"])
    return acc, int(tree["watermark"])
