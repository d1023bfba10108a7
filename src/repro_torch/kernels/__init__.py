"""Hand-written Hopper kernels of the port, with their plain versions.

Each family has ``ops.py`` (the wrapper: checks, launch, launch counter)
and ``ref.py`` (the plain PyTorch version); the CUDA sources live in
``repro_torch/csrc`` and are built by ``_build.py`` at first use.

=======  ==========================  =========================================
kernel   wrapper                     replaces (TPU kernel)
=======  ==========================  =========================================
B1       ``countsketch_apply``       ``countsketch/kernel.py:27``
B2       ``panel_gram``              ``tsqr/kernel.py:51``
B3       ``countsketch_gram``        ``tsqr/kernel.py:68``
B4       ``fused_gaussian_sketch``   ``sketch_matmul/kernel.py:40``
B5       ``gaussian_gram``           ``tsqr/kernel.py:131`` (made at ``:121``)
B6       ``sketch_matmul``           ``sketch_matmul/kernel.py:27``
B7       ``matmul_gram``             ``tsqr/kernel.py:101``
B8       ``hadamard_transform``      ``srht/kernel.py:25`` and ``:32``
B8       ``srht_apply``              ``srht/kernel.py:25`` and ``:32``
—        ``countsketch_coo_apply``   no TPU kernel: the jnp scatter of
                                     ``core/sketch.py:506–518``
=======  ==========================  =========================================

A wrapper given a CUDA tensor launches its kernel or raises; given a CPU
tensor it runs the plain version.  ``wrapper.launches`` counts kernel
launches only.  :data:`KERNELS` lists every wrapper, in the table's order.
B1 also applies the sparse-sign and uniform-sparse sketches, which have no
TPU kernel of their own.  ``countsketch_coo_apply`` is the bucket sketches'
coordinate scatter for a sparse A (ROADMAP A8), deterministic where
``index_add_`` on CUDA is not.
"""
from .common import bits_to_gaussian, key_to_u32, sqrt_tensor, threefry2x32
from .countsketch import (
    countsketch_apply,
    countsketch_coo_apply,
    countsketch_coo_plan,
    countsketch_coo_ref,
    countsketch_csr,
    countsketch_ref,
)
from .sketch_matmul import (
    fused_gaussian_ref,
    fused_gaussian_sketch,
    gaussian_cols_ref,
    gaussian_matrix_ref,
    sketch_matmul,
    sketch_matmul_ref,
    threefry_bits,
)
from .srht import fwht, hadamard_matrix, hadamard_ref, hadamard_transform, srht_apply, srht_ref
from .tsqr import (
    MAX_FUSED_COLS,
    cholqr_finish,
    countsketch_gram,
    countsketch_gram_ref,
    gaussian_gram,
    gaussian_gram_ref,
    matmul_gram,
    matmul_gram_ref,
    panel_gram,
    panel_gram_ref,
    sketch_qr,
    tsqr,
    tsqr_ref,
)

KERNELS = (
    countsketch_apply,
    panel_gram,
    countsketch_gram,
    fused_gaussian_sketch,
    gaussian_gram,
    sketch_matmul,
    matmul_gram,
    hadamard_transform,
    srht_apply,
    countsketch_coo_apply,
)

__all__ = [
    "KERNELS",
    "MAX_FUSED_COLS",
    "bits_to_gaussian",
    "cholqr_finish",
    "countsketch_apply",
    "countsketch_coo_apply",
    "countsketch_coo_plan",
    "countsketch_coo_ref",
    "countsketch_csr",
    "countsketch_gram",
    "countsketch_gram_ref",
    "countsketch_ref",
    "fused_gaussian_ref",
    "fused_gaussian_sketch",
    "fwht",
    "gaussian_cols_ref",
    "gaussian_gram",
    "gaussian_gram_ref",
    "gaussian_matrix_ref",
    "hadamard_matrix",
    "hadamard_ref",
    "hadamard_transform",
    "key_to_u32",
    "matmul_gram",
    "matmul_gram_ref",
    "panel_gram",
    "panel_gram_ref",
    "reset_launches",
    "sketch_matmul",
    "sketch_matmul_ref",
    "sketch_qr",
    "sqrt_tensor",
    "srht_apply",
    "srht_ref",
    "threefry2x32",
    "threefry_bits",
    "tsqr",
    "tsqr_ref",
]


def reset_launches() -> None:
    """Set every kernel wrapper's launch count to 0."""
    for fn in KERNELS:
        fn.launches = 0
