"""repro_torch — the PyTorch/CUDA port of ``repro`` (Sketch 'n Solve).

A package of its own beside the JAX reference ``repro``: it imports
``torch``, numpy and the standard library only.  ``repro_torch.core``
mirrors ``repro.core``; ``repro_torch.kernels`` holds the hand-written
Hopper kernels (CUDA C++ in ``csrc/``) that replace the reference's Pallas
kernels, each beside its plain PyTorch version.  Entry points run on the
card unless the caller passes ``device="cpu"``.
"""
from . import convert, core, kernels
from .core import generate_problem, lsqr_dense, lstsq, qr_solve, saa_sas

__all__ = ["convert", "core", "kernels", "generate_problem", "lsqr_dense", "lstsq", "qr_solve", "saa_sas"]
