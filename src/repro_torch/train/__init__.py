"""repro_torch.train — the port of ``repro.train``'s atomic checkpoint store.

Only ``checkpoint`` is ported so far (the cluster's mid-pass accumulator
checkpoints write through it); the training stack (``step``, ``loop``,
``elastic``, ``serve``) is ROADMAP A14.
"""
from . import checkpoint
from .checkpoint import AsyncCheckpointer, latest_step, restore, save

__all__ = ["checkpoint", "AsyncCheckpointer", "latest_step", "restore", "save"]
