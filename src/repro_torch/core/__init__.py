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
- ``distributed`` — SAA-SAS over a row-sharded A across the ranks of a
  ``torch.distributed`` group (``sketched_lstsq``, ``shard_rows``)

Row-streamed inputs live in the sibling ``repro_torch.streaming`` package;
``stream_lstsq`` and ``StreamingSolver`` are re-exported here lazily (the
streaming package imports this one), and ``lstsq`` on a row source
delegates to ``stream_lstsq``.

The port now holds every module of ``repro.core``.
"""
from . import (
    backend,
    certify,
    direct,
    distributed,
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
from .distributed import DistributedLSQResult, sketched_lstsq
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
from .lsqr import LSQRResult, lsqr as lsqr_solve, lsqr_dense, lsqr_operator
from .lstsq import ACCURACIES, CERTIFIED_LADDER, METHODS, TOL_SUPPORT, lstsq, select_method
from .precond import SketchedFactor, default_sketch_size, distortion
from .problems import Problem, generate as generate_problem
from .result import SolveResult
from .saa import SAAResult, saa_sas, saa_sas_batch
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
    fwht,
    sample as sample_sketch,
)

__all__ = [
    "backend", "certify", "direct", "distributed", "iterative", "linop", "lsqr", "precond",
    "problems", "result", "saa", "sap", "session", "sketch",
    "BACKENDS", "PRECISIONS",
    "Certificate", "certify_solution", "error_bound", "probe_distortion",
    "normal_equations", "qr_solve", "svd_solve",
    "DistributedLSQResult", "sketched_lstsq",
    "damping_momentum", "fossils", "fossils_refine", "heavy_ball_refine",
    "iterative_sketching",
    "LinearOperator", "DenseOperator", "SparseOperator", "TikhonovAugmented",
    "CustomOperator", "as_operator", "ensure_dense", "estimate_2norm",
    "LSQRResult", "lsqr_solve", "lsqr_dense", "lsqr_operator",
    "ACCURACIES", "CERTIFIED_LADDER", "METHODS", "TOL_SUPPORT", "lstsq",
    "select_method",
    "SketchedFactor", "default_sketch_size", "distortion",
    "Problem", "generate_problem",
    "SolveResult",
    "SAAResult", "saa_sas", "saa_sas_batch",
    "sap_sas",
    "SketchedSolver",
    "SKETCH_KINDS", "CountSketch", "GaussianSketch", "UniformDenseSketch",
    "SRHTSketch", "SparseSignSketch", "UniformSparseSketch", "StackedSketch",
    "AugmentedSketch", "fwht", "sample_sketch",
    "stream_lstsq", "StreamingSolver",
]


def __getattr__(name):
    # repro_torch.streaming imports this package at module scope, so these
    # re-exports resolve lazily (PEP 562)
    if name in ("stream_lstsq", "StreamingSolver"):
        from ..streaming import solve as _streaming_solve

        return getattr(_streaming_solve, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
