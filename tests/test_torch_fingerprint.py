"""Port parity: content fingerprints (``repro_torch/serve/fingerprint.py``)
against the reference's ``repro.serve.fingerprint``.

Every contract of ``tests/test_fingerprint.py`` on the port's inputs (torch
tensors and numpy arrays made from a numpy seed), plus:

- the dense digest is bitwise the reference's ``digest_array`` of the same
  bytes for f64, f32 and bf16 (a jax bf16 array against the torch bf16
  tensor of the same bits), through the chunked device→host walk too;
  ``Fingerprint.short()`` and the token/tenant digests are equal strings;
- the memo policy (``_memo_key``): CUDA tensors on ``(id, _version)``,
  never CPU tensors, inference tensors or writable numpy arrays; driven on
  the CPU by adding ``"cpu"`` to ``_MEMO_DEVICE_TYPES``, an in-place write
  bumps the version and re-digests, restoring the saved value exactly
  gives the first digest back, and a dead tensor's entry is evicted;
- a sparse A's digest is memoized on the object that owns its entries
  (a torch sparse tensor, a ``SparseOperator``): a second fingerprint
  hashes nothing, and a write to its values re-digests;
- A is never converted to be fingerprinted (``linop.as_operator`` is not
  reached for dense or sparse input).

The in-place test restores the entry by assigning the saved value (the
reference test's ``+= 1.0; -= 1.0`` does not give the same bits back in
f64).
"""
import gc
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import serve as jserve  # noqa: E402
from repro.core import linop as jlinop  # noqa: E402
from repro_torch.core import linop  # noqa: E402
from repro_torch.serve import Fingerprint, digest_array, fingerprint  # noqa: E402

# the package exports the function under the module's name
fp_mod = importlib.import_module("repro_torch.serve.fingerprint")


def _np(seed=0, shape=(50, 7)):
    return np.random.default_rng(seed).standard_normal(shape)


def _A(seed=0, shape=(50, 7)):
    return torch.as_tensor(_np(seed, shape))


def _op(A, lib=linop):
    if lib is linop:
        return linop.CustomOperator(
            matvec_fn=lambda x: A @ x, rmatvec_fn=lambda y: A.T @ y,
            op_shape=tuple(A.shape), op_dtype=A.dtype, op_device="cpu",
        )
    return jlinop.CustomOperator(
        matvec_fn=lambda x: A @ x, rmatvec_fn=lambda y: A.T @ y,
        op_shape=A.shape, op_dtype=A.dtype,
    )


@pytest.fixture
def memo_on_cpu(monkeypatch):
    """The CUDA memo policy, applied to CPU tensors."""
    monkeypatch.setattr(fp_mod, "_MEMO_DEVICE_TYPES", frozenset({"cpu", "cuda"}))


# ------------------------------------------------ the reference's contracts


def test_same_content_same_fingerprint():
    A = _A()
    B = A.clone()  # distinct object, identical bytes
    assert fingerprint(A) == fingerprint(B)
    assert hash(fingerprint(A)) == hash(fingerprint(B))
    assert fingerprint(A) == fingerprint(A.numpy())  # tensor or numpy: one digest


def test_content_sensitivity():
    A = _A()
    B = A.clone()
    B[3, 4] += 1e-12
    assert fingerprint(A) != fingerprint(B)


def test_config_sensitivity():
    A = _A()
    base = fingerprint(A)
    assert fingerprint(A, reg=0.1) != base
    assert fingerprint(A, sketch="gaussian") != base
    assert fingerprint(A, sketch_size=32) != base
    assert fingerprint(A.to(torch.float32)) != base


def test_digest_memo_hits_by_identity(memo_on_cpu, monkeypatch):
    A = _A()
    calls = []
    real = fp_mod._hash_tensor
    monkeypatch.setattr(fp_mod, "_hash_tensor", lambda h, t: (calls.append(1), real(h, t)))
    d1 = digest_array(A)
    d2 = digest_array(A)
    assert d1 == d2 and len(calls) == 1  # the second call is a memo hit
    assert digest_array(A.clone()) == d1  # same bytes, fresh object
    assert len(calls) == 2


def test_inplace_mutation_changes_fingerprint():
    """A writable numpy A mutated in place must NOT hit a stale memo, and
    restoring the saved value gives the first fingerprint back."""
    A = _np()
    fp1 = fingerprint(A)
    saved = A[0, 0]
    A[0, 0] += 1.0
    fp2 = fingerprint(A)
    assert fp1 != fp2
    A[0, 0] = saved
    assert fingerprint(A) == fp1


def test_inplace_mutation_of_a_cpu_tensor_changes_fingerprint():
    """CPU tensors are re-digested on every call, including a write
    through a numpy view that torch's version counter cannot see."""
    A = _A()
    fp1 = fingerprint(A)
    view = A.numpy()
    saved = float(view[0, 0])
    view[0, 0] += 1.0
    assert A._version == 0  # torch did not see the write
    assert fingerprint(A) != fp1
    view[0, 0] = saved
    assert fingerprint(A) == fp1


def test_readonly_numpy_is_memoized():
    A = _np()
    A.setflags(write=False)
    assert fp_mod._memo_key(A) == (id(A), None)
    assert digest_array(A) == digest_array(A)
    assert fingerprint(A) == fingerprint(A)


def test_tenant_namespaces_tokens():
    A, A2 = _A(), _A(seed=1)
    fa = fingerprint(A, token="v1", tenant="alice")
    fb = fingerprint(A2, token="v1", tenant="bob")
    assert fa != fb
    assert fingerprint(A, token="v1", tenant="alice") == fa
    # tenant= without a token is a no-op: content digests stay shared
    assert fingerprint(A, tenant="alice") == fingerprint(A)
    op = _op(A)
    assert (fingerprint(op, token="v1", tenant="alice")
            != fingerprint(op, token="v1", tenant="bob"))


@pytest.mark.parametrize("layout", ["coo", "csr", "csc", "operator"])
def test_sparse_fingerprint(layout):
    A = _A()
    dense = torch.where(A.abs() > 1.0, A, 0.0)

    def make(M):
        if layout == "coo":
            return M.to_sparse()
        if layout == "csr":
            return M.to_sparse_csr()
        if layout == "csc":
            return M.to_sparse_csc()
        return linop.SparseOperator.from_tensor(M.to_sparse(), device="cpu")

    fp = fingerprint(make(dense))
    assert fp.kind == "sparse" and fp.shape == (50, 7) and fp.dtype == "float64"
    assert fingerprint(make(dense.clone())) == fp  # equal content, equal key
    shifted = torch.where(A.abs() > 1.0, A + 2.0, 0.0)
    assert fingerprint(make(shifted)) != fp  # values change it
    vals = dense[dense != 0]
    vals[0] = 7.0
    one = dense.clone()
    one[dense != 0] = vals
    assert fingerprint(make(one)) != fp  # one changed value changes it
    assert fingerprint(dense) != fp  # dense and sparse never collide
    assert fingerprint(dense).kind == "dense"


def test_operator_requires_token():
    op = _op(_A())
    with pytest.raises(ValueError, match="token"):
        fingerprint(op)
    fp = fingerprint(op, token="model-v3")
    assert fp.kind == "operator"
    assert fingerprint(op, token="model-v3") == fp
    assert fingerprint(op, token="model-v4") != fp


def test_duck_typed_operator_needs_a_token():
    class Duck:
        shape = (50, 7)
        dtype = np.float64

        def matvec(self, v):
            return v

        def rmatvec(self, u):
            return u

    with pytest.raises(ValueError, match="token"):
        fingerprint(Duck())
    fp = fingerprint(Duck(), token="t")
    assert fp.kind == "operator" and fp.digest == "CustomOperator:t"
    assert fp.dtype == "float64"


def test_token_overrides_digest_for_arrays():
    assert fingerprint(_A(), token="t1") == fingerprint(_A(seed=1), token="t1")


def test_short_is_human_readable():
    s = fingerprint(_A(), reg=0.5).short()
    assert "50x7" in s and "reg=0.5" in s


def test_fingerprint_is_frozen():
    fp = fingerprint(_A())
    assert isinstance(fp, Fingerprint)
    with pytest.raises(Exception):
        fp.kind = "other"


# ------------------------------------------------- parity with the reference


@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
def test_dense_digest_is_the_references(dtype, monkeypatch):
    a = _np(3, (37, 5))
    ref_arr = jnp.asarray(a, dtype=dtype)
    want = jserve.digest_array(ref_arr)
    bits = np.asarray(ref_arr)
    if dtype == "bfloat16":
        t = torch.from_numpy(bits.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(bits.copy())
    assert digest_array(t) == want
    assert digest_array(bits.copy()) == want  # the numpy path
    # the chunked walk (several device→host copies) gives the same bytes
    monkeypatch.setattr(fp_mod, "_CHUNK_BYTES", 24)
    assert digest_array(t) == want
    assert digest_array(t.T.contiguous().T) == want  # strides do not matter


def test_fingerprint_strings_equal_the_references():
    a = _np(4)
    A, J = torch.as_tensor(a), jnp.asarray(a)
    for kw in ({}, {"reg": 0.5}, {"sketch": "gaussian", "sketch_size": 32},
               {"token": "v1"}, {"token": "v1", "tenant": "alice"}):
        ours, ref = fingerprint(A, **kw), jserve.fingerprint(J, **kw)
        assert (ours.kind, ours.shape, ours.dtype, ours.reg, ours.sketch,
                ours.sketch_size, ours.digest) == (
            ref.kind, ref.shape, ref.dtype, ref.reg, ref.sketch,
            ref.sketch_size, ref.digest)
        assert ours.short() == ref.short()
    ours = fingerprint(_op(A), token="v1", tenant="bob")
    ref = jserve.fingerprint(_op(J, jlinop), token="v1", tenant="bob")
    assert ours.digest == ref.digest and ours.short() == ref.short()


# ----------------------------------------------------------- the memo policy


def test_memo_policy():
    assert fp_mod._MEMO_DEVICE_TYPES == frozenset({"cuda"})
    assert fp_mod._memo_key(_A()) is None  # CPU tensor: re-digested
    assert fp_mod._memo_key(_np()) is None  # writable numpy: re-digested
    with torch.inference_mode():
        inf = torch.ones(3, 2)
    assert fp_mod._memo_key(inf) is None
    assert fp_mod._memo_key([[1.0]]) is None


def test_version_counter_memo(memo_on_cpu):
    A = _A()
    key = fp_mod._memo_key(A)
    assert key == (id(A), A._version)
    d1 = digest_array(A)
    assert fp_mod._DIGEST_MEMO[id(A)] == (A._version, d1)
    saved = A[0, 0].item()
    A[0, 0] += 1.0  # an in-place write through torch bumps the version
    assert fp_mod._memo_key(A)[1] > key[1]
    d2 = digest_array(A)
    assert d2 != d1
    A[0, 0] = saved
    assert digest_array(A) == d1  # the saved value restored: the first digest
    with torch.inference_mode():
        inf = A.clone()
    assert fp_mod._memo_key(inf) is None  # no version counter
    obj_id = id(A)
    del A
    gc.collect()
    assert obj_id not in fp_mod._DIGEST_MEMO  # the finalizer evicted it


@pytest.mark.parametrize("layout", ["coo", "csr", "operator"])
def test_sparse_digest_is_memoized_on_its_owner(memo_on_cpu, monkeypatch, layout):
    A = _A()
    dense = torch.where(A.abs() > 1.0, A, 0.0)
    if layout == "coo":
        S, vals = dense.to_sparse(), lambda S: S._values()
    elif layout == "csr":
        S, vals = dense.to_sparse_csr(), lambda S: S.values()
    else:
        S = linop.SparseOperator.from_tensor(dense.to_sparse(), device="cpu")
        vals = lambda S: S.vals  # noqa: E731
    calls = []
    real = fp_mod._hash_tensor
    monkeypatch.setattr(fp_mod, "_hash_tensor", lambda h, t: (calls.append(1), real(h, t)))
    fp1 = fingerprint(S)
    hashed = len(calls)
    assert hashed == 3  # values, rows, cols: no stacked copy
    assert fingerprint(S) == fp1 and len(calls) == hashed  # a memo hit
    saved = vals(S)[0].item()
    vals(S)[0] += 1.0  # through torch: the owner's version moves
    fp2 = fingerprint(S)
    assert fp2 != fp1 and len(calls) == 2 * hashed
    vals(S)[0] = saved
    assert fingerprint(S) == fp1


def test_sparse_digest_is_not_memoized_off_the_card():
    S = torch.where(_A().abs() > 1.0, _A(), 0.0).to_sparse()
    assert fp_mod._memo_key(S) is None
    assert fp_mod._memo_key(linop.SparseOperator.from_tensor(S, device="cpu")) is None


def test_fingerprint_never_converts_a(monkeypatch):
    def boom(*a, **kw):
        raise AssertionError("fingerprint converted A")

    monkeypatch.setattr(linop, "as_operator", boom)
    A = _A()
    fingerprint(A)
    fingerprint(A.numpy())
    fingerprint(linop.DenseOperator(A))
    fingerprint(torch.where(A > 1, A, 0.0).to_sparse())
