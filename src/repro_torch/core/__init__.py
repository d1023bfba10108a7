"""The port of ``repro.core``: sketch-and-solve least squares in PyTorch.

This port holds, on dense, sparse, Tikhonov-augmented (``reg=``) and
matrix-free inputs with all seven sketch kinds of the reference, paper
Algorithm 1, the forward-stable solvers and the certified tier:

- ``backend``  — kernel/reference backend, precision and device policy
- ``result``   — the unified ``SolveResult``
- ``linop``    — ``LinearOperator`` protocol, ``DenseOperator``,
  ``SparseOperator``, ``TikhonovAugmented``, ``CustomOperator``
- ``direct``   — QR/SVD/normal-equations ground truth
- ``problems`` — §5.1 ill-conditioned problem generator
- ``sketch``   — ``CountSketch`` (kernel B1), ``GaussianSketch`` (B4),
  ``UniformDenseSketch`` (B6), ``SRHTSketch`` (B8), ``SparseSignSketch``
  and ``UniformSparseSketch`` (B1; a sparse A through the coordinate
  scatter), the escalated ``StackedSketch`` and the ridge
  ``AugmentedSketch``
- ``lsqr``     — LSQR, one vector or a block of right-hand sides
- ``precond``  — the shared sketched-QR factor and its row escalation
- ``saa``      — SAA-SAS, Algorithm 1, with its perturbation fallback, and
  the batched ``saa_sas_batch``
- ``sap``      — the sketch-and-precondition baseline
- ``iterative`` — iterative sketching and FOSSILS (forward stable)
- ``certify``  — posterior certificates of a sketched solution
- ``lstsq``    — the one-call driver over every method and the certified
  escalation ladder
- ``session``  — ``SketchedSolver``: one sketch + QR served to many
  right-hand sides and row updates

The remaining modules of ``repro.core`` are listed in ROADMAP queue A.
"""
from . import (
    backend,
    certify,
    direct,
    iterative,
    linop,
    lsqr,
    precond,
    problems,
    result,
    saa,
    sap,
    session,
    sketch,
)
from .backend import BACKENDS, PRECISIONS
from .certify import Certificate, certify as certify_solution, error_bound, probe_distortion
from .direct import normal_equations, qr_solve, svd_solve
from .iterative import (
    damping_momentum,
    fossils,
    fossils_refine,
    heavy_ball_refine,
    iterative_sketching,
)
from .linop import (
    CustomOperator,
    DenseOperator,
    LinearOperator,
    SparseOperator,
    TikhonovAugmented,
    as_operator,
    ensure_dense,
    estimate_2norm,
)
from .lsqr import lsqr as lsqr_solve, lsqr_dense, lsqr_operator
from .lstsq import ACCURACIES, CERTIFIED_LADDER, METHODS, TOL_SUPPORT, lstsq, select_method
from .precond import SketchedFactor, default_sketch_size, distortion
from .problems import Problem, generate as generate_problem
from .result import SolveResult
from .saa import saa_sas, saa_sas_batch
from .sap import sap_sas
from .session import SketchedSolver
from .sketch import (
    SKETCH_KINDS,
    AugmentedSketch,
    CountSketch,
    GaussianSketch,
    SparseSignSketch,
    SRHTSketch,
    StackedSketch,
    UniformDenseSketch,
    UniformSparseSketch,
    sample as sample_sketch,
)

__all__ = [
    "backend", "certify", "direct", "iterative", "linop", "lsqr", "precond",
    "problems", "result", "saa", "sap", "session", "sketch",
    "BACKENDS", "PRECISIONS",
    "Certificate", "certify_solution", "error_bound", "probe_distortion",
    "normal_equations", "qr_solve", "svd_solve",
    "damping_momentum", "fossils", "fossils_refine", "heavy_ball_refine",
    "iterative_sketching",
    "LinearOperator", "DenseOperator", "SparseOperator", "TikhonovAugmented",
    "CustomOperator", "as_operator", "ensure_dense", "estimate_2norm",
    "lsqr_solve", "lsqr_dense", "lsqr_operator",
    "ACCURACIES", "CERTIFIED_LADDER", "METHODS", "TOL_SUPPORT", "lstsq",
    "select_method",
    "SketchedFactor", "default_sketch_size", "distortion",
    "Problem", "generate_problem",
    "SolveResult",
    "saa_sas", "saa_sas_batch",
    "sap_sas",
    "SketchedSolver",
    "SKETCH_KINDS", "CountSketch", "GaussianSketch", "UniformDenseSketch",
    "SRHTSketch", "SparseSignSketch", "UniformSparseSketch", "StackedSketch",
    "AugmentedSketch", "sample_sketch",
]
