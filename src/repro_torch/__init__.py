"""repro_torch — the PyTorch/CUDA port of ``repro`` (Sketch 'n Solve).

A package of its own beside the JAX reference ``repro``: it imports
``torch``, numpy and the standard library only.  ``repro_torch.core``
mirrors ``repro.core``; ``repro_torch.kernels`` holds the hand-written
Hopper kernels (CUDA C++ in ``csrc/``) that replace the reference's Pallas
kernels, each beside its plain PyTorch version; ``repro_torch.obs`` the
span tracer, the metrics registry and their exporters; ``repro_torch.streaming``
the row sources, the mergeable sketch accumulators and the out-of-core
solvers (``stream_lstsq``, ``StreamingSolver``); ``repro_torch.serve`` the
multi-tenant ``SolveService`` (content fingerprints, the factor cache,
micro-batching and shape buckets); ``repro_torch.cluster`` the
fault-tolerant worker pool (``ClusterSpec``, ``ClusterEngine``) that the
streaming drivers and ``lstsq`` take as ``cluster=``, and
``repro_torch.train`` its atomic checkpoint store; ``repro_torch.sharding``
the collective plumbing (groups, all-reduce, row offsets) of the
distributed solve (``core.sketched_lstsq``, ``streaming.sharded_sketch``)
and of ``repro_torch.optim``'s CountSketch-compressed gradient
all-reduce.  The LM substrate: ``repro_torch.configs`` (the reference's
architecture configs, copied), ``repro_torch.models`` (the attention-only
decoder stack with a dense FFN), ``repro_torch.data`` (the synthetic
stream), ``repro_torch.optim``'s AdamW and ``repro_torch.train``'s steps
(one process and data-parallel), training loop and greedy generation;
``repro_torch.launch`` holds their command lines.  Entry points run on the
card unless the caller passes ``device="cpu"``.
"""
from . import cluster, configs, convert, core, data, kernels, models, obs, optim, serve, sharding, streaming, train
from .cluster import ClusterEngine, ClusterSpec
from .core import (
    Certificate,
    SketchedSolver,
    certify_solution,
    fossils,
    generate_problem,
    iterative_sketching,
    lsqr_dense,
    lstsq,
    qr_solve,
    saa_sas,
    saa_sas_batch,
    sap_sas,
)
from .serve import SolveService
from .streaming import StreamingSolver, stream_lstsq

__all__ = [
    "cluster", "configs", "convert", "core", "data", "kernels", "models", "obs", "optim", "serve",
    "sharding", "streaming", "train",
    "ClusterEngine", "ClusterSpec", "Certificate", "SketchedSolver",
    "SolveService",
    "StreamingSolver", "stream_lstsq",
    "certify_solution", "fossils", "generate_problem", "iterative_sketching",
    "lsqr_dense", "lstsq", "qr_solve", "saa_sas", "saa_sas_batch", "sap_sas",
]
