"""Content fingerprints — the cache key of the multi-tenant solve service.

Port of ``repro/serve/fingerprint.py``.  The expensive artifact the
service amortizes is a ``SketchedSolver`` session (one sketch + QR of A).
Two requests may share that artifact iff they would build the *same*
session: same data matrix, same dtype, same ridge parameter and same
sketch configuration.  A :class:`Fingerprint` names that equivalence
class as a small frozen value object, hashable and usable as a dict key.

What goes into the key:

- ``kind``   — the structural input family (``dense`` / ``sparse`` /
  ``operator``; ``sparse`` is the reference's ``bcoo``): a dense A and a
  sparse A with identical entries build different sessions (different
  apply paths), so they must not collide.
- ``shape``/``dtype`` — numpy's spelling (``"float64"``, ``"bfloat16"``),
  whatever container A came in.
- ``reg``    — the ridge λ (a different λ is a different factor).
- ``sketch``/``sketch_size`` — the embedding the session would be built
  with.
- ``digest`` — the content hash.  For a dense A it is BLAKE2b-128 over
  ``str(shape)``, ``str(dtype)`` and the raw bytes, byte for byte the
  reference's digest of the same content.  The bytes are the CALLER's:
  A is never converted or moved to the card to be fingerprinted (a CUDA
  tensor is copied to the host in row chunks, once per digest).  A sparse
  A digests its shape, dtype and entries (values, then row and column
  indices as int64, in storage order) in one BLAKE2b-128.
  Matrix-free operators have no inspectable payload, so they REQUIRE an
  explicit ``token``: the caller asserts "this token names this
  operator's content".  A token for array inputs overrides the digest —
  the escape hatch for callers who already version their data.

The digest memo (:func:`_memo_key` holds the whole policy, on
:func:`version_tracked`).  A torch tensor is always writable, so a memo
keyed on identity alone would serve the factor of old bytes after an
in-place write.  A CUDA tensor is memoized on ``(id(t), t._version)``:
every in-place write through torch bumps the version counter (a sparse
tensor shares one counter with its indices and values), and a
``weakref.finalize`` evicts the entry when the object dies, so a recycled
``id`` never serves a stale digest.  A ``SparseOperator`` is memoized on
the versions of its stored rows, cols and vals.  A write that bypasses
torch's version counter is NOT seen: one through DLPack or
``__cuda_array_interface__``, or through ``A.data`` (a tensor of its own
version counter, so ``A.data[...] = v`` leaves ``A._version`` where it
was) — pass ``token=`` for data written that way.  Re-digested on every
call: writable numpy arrays (as in the reference), CPU tensors (they may
share memory with a numpy array, whose writes do not bump the version)
and inference tensors (which have no version counter).  Read-only numpy
arrays are memoized by identity, as in the reference.  The factor cache
holds the same line (``serve/cache.py``): a session aliases only data
whose writes :func:`version_tracked` says the version counter sees.

Tokens live in ONE namespace per service by default; ``tenant=`` scopes
them per caller (the tenant id is mixed into the token with a ``"\\x1f"``
separator).  Content digests are deliberately NOT tenant-scoped:
identical bytes SHOULD share a factor.
"""
from __future__ import annotations

import dataclasses
import hashlib
import weakref

import numpy as np
import torch

from ..core import linop

__all__ = ["Fingerprint", "fingerprint", "digest_array"]

# id(object) → (version, digest).  See the module docstring.
_DIGEST_MEMO: dict[int, tuple] = {}

# Device types whose tensors' version counters are trusted
# (``version_tracked``): their digests are memoized on them.
_MEMO_DEVICE_TYPES = frozenset({"cuda"})

# Bytes per device→host copy while hashing a tensor: bounds the host
# memory a digest of a large A takes.
_CHUNK_BYTES = 64 << 20


def _memo_evict(obj_id: int) -> None:
    _DIGEST_MEMO.pop(obj_id, None)


def version_tracked(t: torch.Tensor) -> bool:
    """Whether every write to ``t``'s memory moves ``t._version``, as far
    as this package relies on it (module docstring): a tensor on a device
    of ``_MEMO_DEVICE_TYPES`` that is not an inference tensor."""
    return t.device.type in _MEMO_DEVICE_TYPES and not t.is_inference()


def _memo_key(x):
    """``(id, version)`` under which ``x``'s digest may be memoized, or
    ``None`` where ``x`` must be re-digested on every call."""
    if isinstance(x, torch.Tensor):
        return (id(x), x._version) if version_tracked(x) else None
    if isinstance(x, linop.SparseOperator):
        parts = (x.rows, x.cols, x.vals)
        if not all(version_tracked(t) for t in parts):
            return None
        return id(x), tuple((id(t), t._version) for t in parts)
    if isinstance(x, np.ndarray) and not x.flags.writeable:
        return id(x), None
    return None


def _memoized(x, compute) -> str:
    """``compute()``, the digest of ``x``, through the memo."""
    key = _memo_key(x)
    if key is not None:
        hit = _DIGEST_MEMO.get(key[0])
        if hit is not None and hit[0] == key[1]:
            return hit[1]
    digest = compute()
    if key is not None:
        if key[0] not in _DIGEST_MEMO:
            try:
                weakref.finalize(x, _memo_evict, key[0])
            except TypeError:
                return digest  # not weakref-able: never risk staleness
        _DIGEST_MEMO[key[0]] = (key[1], digest)
    return digest


def _dtype_name(dtype) -> str:
    """numpy's name of a torch or numpy dtype (``"float64"``, ``"bfloat16"``)."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return str(np.dtype(dtype))


def _hash_tensor(h, t: torch.Tensor) -> None:
    """Feed ``t``'s C-order bytes to ``h``, through the host in chunks."""
    flat = t.detach().contiguous().reshape(-1)
    if flat.dtype == torch.bfloat16:  # no numpy dtype: its raw bits
        flat = flat.view(torch.uint16)
    step = max(1, _CHUNK_BYTES // max(1, flat.element_size()))
    for start in range(0, flat.numel(), step):
        h.update(flat[start:start + step].cpu().numpy())


def digest_array(x) -> str:
    """BLAKE2b-128 hex digest of an array's raw bytes (+ shape/dtype).

    ``x`` is a strided torch tensor (on any device), a numpy array or
    anything ``np.asarray`` takes; the digest of given content is the
    reference's ``repro.serve.digest_array`` of it.  Memoized where
    :func:`_memo_key` allows (module docstring).
    """
    return _memoized(x, lambda: _dense_digest(x))


def _dense_digest(x) -> str:
    h = hashlib.blake2b(digest_size=16)
    if isinstance(x, torch.Tensor):
        h.update(str(tuple(x.shape)).encode())
        h.update(_dtype_name(x.dtype).encode())
        _hash_tensor(h, x)
    else:
        host = np.ascontiguousarray(np.asarray(x))
        h.update(str(host.shape).encode())
        h.update(str(host.dtype).encode())
        h.update(host.reshape(-1).view(np.uint8))
    return h.hexdigest()


def _sparse_digest(A) -> str:
    """Digest of a sparse A's entries, memoized on the object that owns
    them (a torch sparse tensor or a ``SparseOperator``)."""

    def compute():
        rows, cols, vals = _sparse_entries(A)
        h = hashlib.blake2b(digest_size=16)
        h.update(str(tuple(int(s) for s in A.shape)).encode())
        h.update(_dtype_name(vals.dtype).encode())
        for t in (vals, rows.long(), cols.long()):
            _hash_tensor(h, t)
        return h.hexdigest()

    return _memoized(A, compute)


@dataclasses.dataclass(frozen=True)
class Fingerprint:
    """Hashable identity of a solve problem's expensive artifact."""

    kind: str  # "dense" | "sparse" | "operator"
    shape: tuple[int, int]
    dtype: str
    reg: float | None
    sketch: str
    sketch_size: int | None
    digest: str

    def short(self) -> str:
        """Human-readable cache-log form."""
        r = "" if self.reg is None else f"|reg={self.reg:g}"
        return (
            f"{self.kind}{self.shape[0]}x{self.shape[1]}:{self.dtype}"
            f"{r}|{self.sketch}|{self.digest[:10]}"
        )


def _sparse_entries(A):
    """(rows, cols, vals) of a sparse A in storage order, where A lies."""
    if isinstance(A, linop.SparseOperator):
        return A.rows, A.cols, A.vals
    if A.layout == torch.sparse_coo:
        rows, cols = A._indices()
        return rows, cols, A._values()
    if A.layout == torch.sparse_csr:
        major, minor, n_major = A.crow_indices(), A.col_indices(), A.shape[0]
    else:
        major, minor, n_major = A.ccol_indices(), A.row_indices(), A.shape[1]
    expanded = torch.repeat_interleave(
        torch.arange(n_major, device=major.device), major.diff()
    )
    if A.layout == torch.sparse_csr:
        return expanded, minor, A.values()
    return minor, expanded, A.values()


def fingerprint(
    A,
    *,
    reg: float | None = None,
    sketch: str = "clarkson_woodruff",
    sketch_size: int | None = None,
    token: str | None = None,
    tenant: str | None = None,
) -> Fingerprint:
    """Fingerprint a problem: a dense tensor or numpy array, a torch sparse
    tensor or ``SparseOperator``, or a matrix-free operator.

    ``token`` is REQUIRED for matrix-free operators (nothing to digest)
    and optional for array inputs (it overrides the digest with a
    caller-asserted content name).  ``tenant`` scopes the token, so two
    callers both naming their data ``"v1"`` do not share one cache entry;
    ``tenant`` without a token is a no-op.  ``reg``/``sketch``/
    ``sketch_size`` must match the session configuration the cache would
    build — the service threads its own knobs through here.  Shape and
    dtype are read from the caller's object; A is never converted.
    """
    kind = linop.input_kind(A)
    if isinstance(A, linop.DenseOperator):
        A = A.A
    if kind == "dense" and not isinstance(A, torch.Tensor):
        A = np.asarray(A)
    shape = tuple(int(s) for s in A.shape)
    if len(shape) != 2:
        raise ValueError(f"need a 2-D matrix, got shape {shape}")
    dtype = _dtype_name(A.dtype)
    reg_f = None if reg is None else float(reg)
    if token is not None and tenant is not None:
        token = f"{tenant}\x1f{token}"  # \x1f: no crafted-string collisions
    if kind == "dense":
        digest = token if token is not None else digest_array(A)
    elif kind == "sparse":
        digest = token if token is not None else _sparse_digest(A)
    else:
        if token is None:
            raise ValueError(
                "matrix-free operators have no inspectable payload to "
                "digest — pass an explicit token= naming this operator's "
                "content (the caller owns its versioning)"
            )
        name = type(A).__name__ if isinstance(A, linop.LinearOperator) else "CustomOperator"
        digest = f"{name}:{token}"
    return Fingerprint(
        kind=kind, shape=shape, dtype=dtype, reg=reg_f,
        sketch=sketch, sketch_size=sketch_size, digest=digest,
    )
