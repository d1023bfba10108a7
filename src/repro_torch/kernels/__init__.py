"""Hand-written Hopper kernels of the port, with their plain versions.

Each family has ``ops.py`` (the wrapper: checks, launch, launch counter)
and ``ref.py`` (the plain PyTorch version); the CUDA sources live in
``repro_torch/csrc`` and are built by ``_build.py`` at first use.

=======  ==========================  ====================================
kernel   wrapper                     replaces (TPU kernel)
=======  ==========================  ====================================
B1       ``countsketch_apply``       ``countsketch/kernel.py:27``
B2       ``panel_gram``              ``tsqr/kernel.py:51``
B3       ``countsketch_gram``        ``tsqr/kernel.py:68``
=======  ==========================  ====================================

A wrapper given a CUDA tensor launches its kernel or raises; given a CPU
tensor it runs the plain version.  ``wrapper.launches`` counts kernel
launches only.
"""
from .countsketch import countsketch_apply, countsketch_csr, countsketch_ref
from .tsqr import (
    MAX_FUSED_COLS,
    cholqr_finish,
    countsketch_gram,
    countsketch_gram_ref,
    panel_gram,
    panel_gram_ref,
    sketch_qr,
    tsqr,
    tsqr_ref,
)

KERNELS = (countsketch_apply, panel_gram, countsketch_gram)

__all__ = [
    "KERNELS",
    "MAX_FUSED_COLS",
    "cholqr_finish",
    "countsketch_apply",
    "countsketch_csr",
    "countsketch_gram",
    "countsketch_gram_ref",
    "countsketch_ref",
    "panel_gram",
    "panel_gram_ref",
    "reset_launches",
    "sketch_qr",
    "tsqr",
    "tsqr_ref",
]


def reset_launches() -> None:
    """Set every kernel wrapper's launch count to 0."""
    for fn in KERNELS:
        fn.launches = 0
