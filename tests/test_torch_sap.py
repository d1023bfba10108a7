"""Port parity: SAP-SAS (sketch-and-precondition, paper §4) against the JAX
reference, on the same problem and the same CountSketch.

Tolerances:
- same-sketch parity at κ = 1e4, warm and cold: x within 1e-10 relative
  of the reference's, ``istop`` equal, ``itn`` within 2 (LSQR's step-floor
  stop can move a step under other rounding, ``test_torch_saa.py``);
- at κ = 1e10, the reference's own bounds (``tests/test_sap.py``): the
  warm start converges in under 40 iterations with an error under 100x
  ``qr_solve``'s, and beats the zero start by 100x;
- the product count: one matvec and one rmatvec with A per LSQR
  iteration, plus one matvec for the warm start's residual.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import generate_problem as j_generate  # noqa: E402
from repro.core import sap_sas as j_sap  # noqa: E402
from repro.core import sketch as jsketch  # noqa: E402
from repro.core.precond import default_sketch_size  # noqa: E402
from repro_torch.convert import countsketch_from_reference, problem_from_reference  # noqa: E402
from repro_torch.core import qr_solve, sap_sas  # noqa: E402

from test_torch_iterative import _Counting  # noqa: E402

CPU = "cpu"
M, N = 4000, 64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small tensors, the module's fixtures
    included: the suite runs several test workers at once, and more threads
    only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(x, y):
    x, y = np.asarray(x), np.asarray(y)
    return float(np.linalg.norm(x - y) / np.linalg.norm(y))


def _both(cond):
    p = j_generate(jax.random.key(0), M, N, cond=cond, beta=1e-10)
    arrays = [np.asarray(a) for a in (p.A, p.b, p.x_true, p.r_true)]
    return p, problem_from_reference(*arrays, p.cond, p.beta, device=CPU)


def _same_sketch(key):
    op = jsketch.sample("clarkson_woodruff", key, default_sketch_size(N, M), M, dtype=jnp.float64)
    return countsketch_from_reference(op.buckets, op.signs, op.d, device=CPU)


@pytest.fixture(scope="module")
def mild():
    return _both(1e4)


@pytest.fixture(scope="module")
def hard():
    return _both(1e10)


@pytest.mark.parametrize("warm_start", [True, False])
def test_same_sketch_parity(mild, warm_start):
    pj, pt = mild
    key = jax.random.key(1)
    ref = j_sap(pj.A, pj.b, key, warm_start=warm_start)
    res = sap_sas(pt.A, pt.b, 0, sketch=_same_sketch(key), warm_start=warm_start, device=CPU)
    assert _rel(res.x, ref.x) < 1e-10
    assert int(res.istop) == int(ref.istop)
    assert abs(int(res.itn) - int(ref.itn)) <= 2


def test_reference_bounds_at_cond_1e10(hard):
    _, pt = hard
    res = sap_sas(pt.A, pt.b, 0, sketch=_same_sketch(jax.random.key(1)), device=CPU)
    assert bool(res.converged) and int(res.itn) < 40
    e_qr = _rel(qr_solve(pt.A, pt.b, device=CPU), pt.x_true)
    assert _rel(res.x, pt.x_true) < 100 * max(e_qr, 1e-12)
    op = _same_sketch(jax.random.key(2))
    warm = sap_sas(pt.A, pt.b, 0, sketch=op, device=CPU)
    cold = sap_sas(pt.A, pt.b, 0, sketch=op, warm_start=False, device=CPU)
    assert _rel(warm.x, pt.x_true) < _rel(cold.x, pt.x_true) / 100


def test_products_per_iteration(mild):
    _, pt = mild
    A = _Counting(pt.A)
    res = sap_sas(A, pt.b, 3, device=CPU, history=True)
    itn = int(res.itn)
    assert A.counts == {"matvec": itn + 1, "rmatvec": itn + 1}
    assert res.history.shape == (200,) and bool(torch.isfinite(res.history[:itn]).all())
