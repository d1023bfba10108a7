"""Multi-tenant least-squares serving on top of the port's solver stack.

Port of ``repro.serve``.  The serving thesis, straight from the paper's
economics: one sketch + QR is expensive, every subsequent right-hand side
against it is cheap.  This package caches the expensive artifact (live
``SketchedSolver`` sessions keyed by content fingerprint) and
micro-batches the cheap one (coalesced ``solve_many`` calls; padded shape
buckets for small-problem traffic), with per-request certified-accuracy
SLOs and deadlines on top.

- :mod:`~repro_torch.serve.fingerprint` — content fingerprints (the cache key)
- :mod:`~repro_torch.serve.cache` — byte-budgeted LRU cache of live sessions
- :mod:`~repro_torch.serve.batching` — micro-batch queue + padded shape buckets
- :mod:`~repro_torch.serve.service` — the ``SolveService`` front-end
"""
from .batching import MicroBatcher, bucket_shape, pad_problem, solve_bucket
from .cache import CacheEntry, FactorCache, session_nbytes
from .fingerprint import Fingerprint, digest_array, fingerprint
from .service import SolveResponse, SolveService

__all__ = [
    "CacheEntry",
    "FactorCache",
    "Fingerprint",
    "MicroBatcher",
    "SolveResponse",
    "SolveService",
    "bucket_shape",
    "digest_array",
    "fingerprint",
    "pad_problem",
    "session_nbytes",
    "solve_bucket",
]
