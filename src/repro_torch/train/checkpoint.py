"""Atomic checkpoint store.

Port of ``repro/train/checkpoint.py``.  The on-disk layout is the reference's, so
a checkpoint written by either package restores in the other:

- ``<dir>/step_<n>/arrays.npz`` holds one array per leaf, named as
  ``jax.tree_util.keystr`` names the leaf's path in the reference (a dict
  key ``"['state']"``, a list or tuple index ``"[0]"``, a namedtuple field
  ``".x"``; dict keys in sorted order, ``None`` holds no leaf);
  ``manifest.json`` records the step, the wall time, the sorted keys and
  the byte count.
- Atomic: a save writes ``<dir>/tmp.<step>.<pid>`` and then
  ``os.replace``-s it into place, so a crash mid-write never corrupts the
  latest checkpoint.  The next ``save`` into the directory removes staging
  dirs whose writer pid is gone (a live writer's tmp is left alone).
- Tensors reach ``np.savez`` through ``.cpu().numpy()``; a bf16 tensor is
  stored as f32 (exact, and restored to bf16 exactly).  ``restore`` loads
  on the host and puts each leaf on ``device=`` in the target's dtype.
- ``AsyncCheckpointer`` snapshots a tree to host memory in the caller's
  thread (a copy: a later in-place write to the tensor does not reach the
  file) and writes it in a background thread with keep-n garbage
  collection.

On a mesh (``shardings=``: a matching tree of ``sharding.NamedSharding``s,
as ``train.elastic.restore_elastic`` builds them from ``state_pspecs``):

- ``save`` and ``AsyncCheckpointer.submit`` take each rank's blocks; every
  rank calls them (a collective), each leaf is assembled in full one leaf
  at a time (``collectives.unshard``, exact) and the mesh's first rank
  writes it, so the file holds the same arrays as the unsharded state's;
- ``restore`` gives each rank its own block of every leaf, reading the
  ``.npz`` leaf by leaf (a whole state loaded by every rank at once would
  not fit the host).
"""
from __future__ import annotations

import json
import os
import queue
import re
import threading
import time

import numpy as np
import torch

from ..core import backend as backend_lib
from ..core.linop import _torch_dtype
from ..obs.lockcheck import make_lock
from ..sharding import NamedSharding, PartitionSpec

__all__ = ["save", "restore", "latest_step", "gc_checkpoints", "AsyncCheckpointer"]

_STEP_RE = re.compile(r"^step_(\d+)$")
_TMP_RE = re.compile(r"^tmp\.(\d+)\.(\d+)$")


def _is_spec(x) -> bool:
    """A ``(shape, dtype)`` restore target leaf: the reference's
    ``jax.ShapeDtypeStruct``."""
    if not (isinstance(x, tuple) and len(x) == 2):
        return False
    shape, dtype = x
    if not isinstance(dtype, (torch.dtype, np.dtype, type)):
        return False
    return isinstance(shape, (tuple, list, torch.Size)) and all(
        isinstance(s, (int, np.integer)) for s in shape
    )


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, prefix: str = "", out=None) -> dict:
    """``{keystr path: leaf}`` in the reference's flatten order (a
    ``NamedSharding`` or a ``PartitionSpec`` is a leaf)."""
    out = {} if out is None else out
    if tree is None:
        return out
    if isinstance(tree, (NamedSharding, PartitionSpec)):
        out[prefix] = tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], f"{prefix}[{k!r}]", out)
    elif _is_namedtuple(tree):
        for name in tree._fields:
            _flatten(getattr(tree, name), f"{prefix}.{name}", out)
    elif isinstance(tree, (list, tuple)) and not _is_spec(tree):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}[{i}]", out)
    else:
        out[prefix] = tree
    return out


def _unflatten(tree, leaves: dict, prefix: str = ""):
    """``tree``'s structure with each leaf replaced by ``leaves[path]``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], leaves, f"{prefix}[{k!r}]") for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(_unflatten(getattr(tree, f), leaves, f"{prefix}.{f}") for f in tree._fields))
    if isinstance(tree, (list, tuple)) and not _is_spec(tree):
        return type(tree)(_unflatten(v, leaves, f"{prefix}[{i}]") for i, v in enumerate(tree))
    return leaves[prefix]


def _to_host(x) -> np.ndarray:
    """A host copy of a leaf (a tensor, a numpy array or a scalar)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()  # exact; numpy has no bf16
        return x.to("cpu", copy=True).numpy()
    return np.array(x)


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True  # exists, owned by someone else
    return True


def _gc_orphan_tmps(ckpt_dir: str) -> list[str]:
    """Remove ``tmp.<step>.<pid>`` staging dirs whose writer died; returns
    the removed names.  A live pid may be mid-write: its tmp stays."""
    removed = []
    for d in os.listdir(ckpt_dir):
        m = _TMP_RE.match(d)
        if m and not _pid_alive(int(m.group(2))):
            _rmtree(os.path.join(ckpt_dir, d))
            removed.append(d)
    return removed


def _write(ckpt_dir: str, step: int, host: dict) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    _gc_orphan_tmps(ckpt_dir)
    tmp = os.path.join(ckpt_dir, f"tmp.{step}.{os.getpid()}")
    final = os.path.join(ckpt_dir, f"step_{step}")
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "arrays.npz"), **host)
    manifest = {
        "step": int(step),
        "time": time.time(),
        "keys": sorted(host.keys()),
        "nbytes": int(sum(a.nbytes for a in host.values())),
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        _rmtree(final)
    os.replace(tmp, final)
    return final


def _host_leaves(tree, shardings) -> tuple[dict | None, bool]:
    """(the host copies of ``tree``'s leaves, or ``None`` on a rank that
    does not write; whether this rank writes).  With ``shardings`` every
    leaf is assembled in full from the ranks' blocks, one at a time."""
    if shardings is None:
        return {k: _to_host(v) for k, v in _flatten(tree).items()}, True
    from ..sharding.collectives import unshard

    named, places = _flatten(tree), _flatten(shardings)
    if set(named) != set(places):
        raise ValueError("shardings= does not match the tree's leaves")
    writer = next(iter(places.values())).mesh.rank == 0
    host = {}
    for key, v in named.items():
        full = unshard(v, places[key].spec, places[key].mesh) if isinstance(v, torch.Tensor) else v
        if writer:
            host[key] = _to_host(full)
        del full
    return (host if writer else None), writer


def _barrier(shardings):
    if shardings is not None:
        import torch.distributed as dist

        dist.barrier()


def save(ckpt_dir: str, step: int, tree, shardings=None) -> str:
    """Blocking atomic save of a tree of tensors, arrays and scalars;
    returns the checkpoint's path.  Also sweeps staging dirs orphaned by
    crashed writers (the save after a crash is the safe point for it).
    ``shardings``: ``tree`` holds this rank's blocks; every rank calls
    ``save``, the mesh's first rank writes, and all return once the
    checkpoint is in place."""
    host, writer = _host_leaves(tree, shardings)
    path = _write(ckpt_dir, int(step), host) if writer else os.path.join(ckpt_dir, f"step_{int(step)}")
    _barrier(shardings)
    return path


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [
        int(m.group(1))
        for d in os.listdir(ckpt_dir)
        if (m := _STEP_RE.match(d)) and os.path.exists(os.path.join(ckpt_dir, d, "manifest.json"))
    ]
    return max(steps) if steps else None


def restore(ckpt_dir: str, target, step: int | None = None, shardings=None, *, device=None):
    """Restore into the structure of ``target`` → ``(tree, step)``.

    ``target``'s leaves are tensors or ``(shape, dtype)`` pairs (a torch or
    numpy dtype) of the full leaves; each restored
    leaf is a tensor of that shape and dtype on ``device`` (``None``: a
    tensor leaf's own device, else ``"cuda"``).  ``step=None`` takes the
    newest checkpoint.  ``shardings`` (a matching tree of
    ``NamedSharding``s): each leaf is this rank's block of it instead.
    """
    places = None if shardings is None else _flatten(shardings)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    named_target = _flatten(target)
    if places is not None and set(places) != set(named_target):
        raise ValueError("shardings= does not match the target's leaves")
    missing = set(named_target) - set(manifest["keys"])
    if missing:
        raise ValueError(f"checkpoint at step {step} missing keys: {sorted(missing)[:5]}")
    fixed = None if device is None else backend_lib.resolve_device(device)
    leaves = {}
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for key, tgt in named_target.items():
            arr = data[key]
            shape, dtype = (tgt[0], tgt[1]) if _is_spec(tgt) else (tgt.shape, tgt.dtype)
            if tuple(arr.shape) != tuple(shape):
                raise ValueError(f"shape mismatch for {key}: ckpt {arr.shape} vs target {tuple(shape)}")
            if fixed is not None:
                dev = fixed
            elif isinstance(tgt, torch.Tensor):
                dev = tgt.device
            else:
                dev = backend_lib.resolve_device(None)
            if places is not None:
                from ..sharding.collectives import block_slices

                arr = arr[block_slices(arr.shape, places[key].spec, places[key].mesh)]
            leaves[key] = torch.from_numpy(np.array(arr)).to(device=dev, dtype=_torch_dtype(dtype))
            del arr
    return _unflatten(target, leaves), step


def _rmtree(path):
    for root, dirs, files in os.walk(path, topdown=False):
        for f in files:
            os.remove(os.path.join(root, f))
        for d in dirs:
            os.rmdir(os.path.join(root, d))
    os.rmdir(path)


def gc_checkpoints(ckpt_dir: str, keep_n: int = 3):
    if not os.path.isdir(ckpt_dir):
        return
    steps = sorted(int(m.group(1)) for d in os.listdir(ckpt_dir) if (m := _STEP_RE.match(d)))
    for s in steps[:-keep_n]:
        _rmtree(os.path.join(ckpt_dir, f"step_{s}"))


class AsyncCheckpointer:
    """Snapshot-to-host in the caller's thread + a background writer with
    keep-n GC.  A write's error surfaces at the next ``submit`` or at
    ``finalize``."""

    # Checked by reprolint R1: the writer thread sets ``_err``, the
    # caller's thread reads and raises it.
    GUARDED_BY = {"_err": "_lock"}
    GUARDED_READS = frozenset({"_err"})

    def __init__(self, ckpt_dir: str, keep_n: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep_n = keep_n
        self._q: queue.Queue = queue.Queue(maxsize=2)
        self._lock = make_lock("AsyncCheckpointer._lock")
        self._err: Exception | None = None
        self._thread = threading.Thread(target=self._worker, name="repro-ckpt-writer", daemon=True)
        self._thread.start()

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            step, host = item
            try:
                _write(self.ckpt_dir, step, host)
                gc_checkpoints(self.ckpt_dir, self.keep_n)
            except Exception as e:  # surfaced on the next submit/finalize
                with self._lock:
                    self._err = e

    def _raise_pending(self):
        with self._lock:
            err = self._err
        if err is not None:
            raise err

    def submit(self, step: int, tree, shardings=None):
        """Snapshot ``tree`` to the host and queue its write.  ``shardings``:
        ``tree`` holds this rank's blocks; every rank calls ``submit`` (the
        leaves are assembled in full, a collective) and the mesh's first
        rank writes."""
        self._raise_pending()
        host, writer = _host_leaves(tree, shardings)  # the sync snapshot
        if writer:
            self._q.put((int(step), host))

    def finalize(self):
        self._q.put(None)
        self._thread.join()
        self._raise_pending()
