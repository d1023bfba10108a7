"""The port of ``repro.core``: sketch-and-solve least squares in PyTorch.

This port holds paper Algorithm 1 on dense inputs with the CountSketch,
Gaussian and uniform-dense sketches:

- ``backend``  — kernel/reference backend, precision and device policy
- ``result``   — the unified ``SolveResult``
- ``linop``    — ``LinearOperator`` protocol, ``DenseOperator``
- ``direct``   — QR/SVD/normal-equations ground truth
- ``problems`` — §5.1 ill-conditioned problem generator
- ``sketch``   — ``CountSketch`` (kernel B1), ``GaussianSketch`` (B4),
  ``UniformDenseSketch`` (B6)
- ``lsqr``     — LSQR with a windowed stop check
- ``precond``  — the shared sketched-QR factor
- ``saa``      — SAA-SAS, Algorithm 1, with its perturbation fallback
- ``lstsq``    — the one-call driver (``direct``/``lsqr``/``saa``)

The remaining modules of ``repro.core`` are listed in ROADMAP queue A.
"""
from . import backend, direct, linop, lsqr, precond, problems, result, saa, sketch
from .backend import BACKENDS, PRECISIONS
from .direct import normal_equations, qr_solve, svd_solve
from .linop import DenseOperator, LinearOperator, as_operator, ensure_dense, estimate_2norm
from .lsqr import lsqr as lsqr_solve, lsqr_dense, lsqr_operator
from .lstsq import ACCURACIES, CERTIFIED_LADDER, METHODS, TOL_SUPPORT, lstsq, select_method
from .precond import SketchedFactor, default_sketch_size, distortion
from .problems import Problem, generate as generate_problem
from .result import SolveResult
from .saa import saa_sas
from .sketch import (
    SKETCH_KINDS,
    CountSketch,
    GaussianSketch,
    UniformDenseSketch,
    sample as sample_sketch,
)

__all__ = [
    "backend", "direct", "linop", "lsqr", "precond", "problems", "result",
    "saa", "sketch",
    "BACKENDS", "PRECISIONS",
    "normal_equations", "qr_solve", "svd_solve",
    "LinearOperator", "DenseOperator", "as_operator", "ensure_dense",
    "estimate_2norm",
    "lsqr_solve", "lsqr_dense", "lsqr_operator",
    "ACCURACIES", "CERTIFIED_LADDER", "METHODS", "TOL_SUPPORT", "lstsq",
    "select_method",
    "SketchedFactor", "default_sketch_size", "distortion",
    "Problem", "generate_problem",
    "SolveResult",
    "saa_sas",
    "SKETCH_KINDS", "CountSketch", "GaussianSketch", "UniformDenseSketch",
    "sample_sketch",
]
