from .ops import (
    fused_gaussian_sketch,
    gaussian_clusters,
    gaussian_engine,
    sketch_matmul,
    threefry_bits,
)
from .ref import (
    default_scale,
    fused_gaussian_ref,
    gaussian_cols_ref,
    gaussian_matrix_ref,
    sketch_matmul_ref,
)

__all__ = [
    "default_scale",
    "fused_gaussian_ref",
    "fused_gaussian_sketch",
    "gaussian_clusters",
    "gaussian_cols_ref",
    "gaussian_engine",
    "gaussian_matrix_ref",
    "sketch_matmul",
    "sketch_matmul_ref",
    "threefry_bits",
]
