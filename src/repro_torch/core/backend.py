"""Backend, precision and device policy of the port.

Port of ``repro/core/backend.py``.  The reference picks between its
``"reference"`` jnp paths and its Pallas kernels; here:

- ``backend="auto"`` — call the kernel wrappers.  A wrapper given a CUDA
  tensor launches its hand-written kernel (or raises); given a CPU tensor
  it runs its plain PyTorch version.  The choice follows the tensor, never
  an environment variable, and nothing falls back when a kernel fails.
- ``backend="reference"`` — the plain PyTorch paths, on any device, only
  when the caller names it.

Device rule: every entry point takes ``device=None``, and ``None`` means
``"cuda"``.  Inputs given as numpy arrays or tensors elsewhere are moved to
that device; a machine without CUDA therefore raises unless the caller asks
for ``device="cpu"``.

``resolve_fused`` keeps reading ``REPRO_FUSED_QR``, as the reference does.
"""
from __future__ import annotations

import os

import numpy as np
import torch

__all__ = [
    "BACKENDS",
    "PRECISIONS",
    "check_backend",
    "check_precision",
    "uses_kernels",
    "resolve_fused",
    "resolve_device",
    "as_tensor",
    "as_generator",
]

BACKENDS = ("auto", "reference")

# Working precisions for the sketch/factor stage: "mixed" rounds the data
# matrix to bf16 for the sketch apply (accumulating in f32) and leaves all
# refinement at full precision.
PRECISIONS = ("full", "mixed")


def check_backend(backend: str) -> str:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; have {BACKENDS}")
    return backend


def check_precision(precision: str) -> str:
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; have {PRECISIONS}")
    return precision


def uses_kernels(backend: str) -> bool:
    """True when the sketch applies go through the kernel wrappers."""
    return check_backend(backend) == "auto"


def resolve_fused(fused: bool | None) -> bool:
    """Resolve the fused sketch->QR knob.  ``None`` reads ``REPRO_FUSED_QR``
    (default off, preserving the seed pipeline's exact numerics)."""
    if fused is None:
        return os.environ.get("REPRO_FUSED_QR", "0") not in ("0", "", "false")
    return bool(fused)


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda``; raise if the device is CUDA and there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run the plain versions"
        )
    return dev


def as_tensor(x, device=None, dtype: torch.dtype | None = None) -> torch.Tensor:
    """``x`` (tensor, numpy array or scalar) as a tensor on ``device``."""
    dev = resolve_device(device)
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=dtype)
    arr = np.asarray(x)
    if not arr.flags.writeable:  # e.g. a view of a JAX array: copy it
        arr = arr.copy()
    return torch.as_tensor(arr, device=dev, dtype=dtype)


def as_generator(key, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device``: ``key`` is one, or an int seed."""
    dev = torch.device(device)
    if isinstance(key, torch.Generator):
        if key.device.type != dev.type:
            raise ValueError(
                f"generator is on {key.device}, the data on {dev}; draw with "
                f"torch.Generator(device={dev.type!r})"
            )
        return key
    if isinstance(key, (int, np.integer)):
        return torch.Generator(device=dev).manual_seed(int(key))
    raise TypeError(
        f"key must be a torch.Generator or an int seed, got {type(key).__name__}"
    )
