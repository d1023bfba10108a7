"""The tuner's role (``repro_torch.kernels.autotune``,
``core.backend.kernel_blocks``) against ``PERF.md``'s kernel table and the
kernels' own plans.

``predict_cost`` is the H100 bound the table prints beside each kernel's
time, from the same formula ``chip_smoke.py`` uses (``_bound`` imports it):
B1 2.517 ms at A (2^20, 1000) sketched to 4000 rows, B2 0.060 ms on the
(4000, 1000) sketch, B6 7.825 ms at A (2^16, 1000), held within 0.5%.
A bf16/f16 launch is bounded at the dense tensor-core rate (989 TFLOP/s)
and writes its f32 output at 4 bytes a cell: B6 at A (2^16, 1000) in bf16
is 0.530 ms, against 7.825 ms at the FP32 rate.
``best_blocks`` returns the plans the kernels take (``kernels/common.py``),
and ``kernel_blocks`` is ``best_blocks``.  The reference's kind names are
kept.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.backend import kernel_blocks  # noqa: E402
from repro_torch.kernels import autotune, common  # noqa: E402

M, N, D = 2**20, 1000, 4000


@pytest.mark.parametrize("kind, m, ms", [("countsketch", M, 2.517), ("tsqr", M, 0.060),
                                         ("sketch_matmul", 2**16, 7.825)])
def test_predict_cost_is_the_tables_bound(kind, m, ms):
    assert autotune.predict_cost(kind, m, N, D, torch.float64) * 1e3 == pytest.approx(ms, rel=5e-3)


def test_bound_names_what_binds():
    assert autotune.bound(*autotune.work("countsketch", M, N, D))[1] == "bytes"
    assert autotune.bound(*autotune.work("sketch_matmul", 2**16, N, D))[1] == "operations"
    assert autotune.predict_cost("uniform_dense", 2**16, N, D) == autotune.predict_cost("sketch_matmul", 2**16, N, D)


@pytest.mark.parametrize("m, n, d", [(2**20, 1000, 4000), (2**16, 1000, 4000), (4096, 33, 130), (2**13, 2, 8)])
def test_best_blocks_are_the_kernels_plans(m, n, d):
    sms = autotune.H100_SMS
    f64 = torch.float64
    assert autotune.best_blocks("sketch_matmul", m, n, d, f64) == {"split": common.sketch_split(f64, d, m, n, sms)}
    assert autotune.best_blocks("gaussian", m, n, d, f64) == {"split": common.gaussian_split(f64, d, m, n, sms),
                                                              "cluster": common.gen_cluster(n)}
    assert autotune.best_blocks("tsqr", m, n, d, f64) == {"split": common.gram_split(f64, d, n, sms)}
    m_pad = 1 << (m - 1).bit_length()
    assert autotune.best_blocks("srht", m, n, d, torch.float32) == {"passes": common.hadamard_passes(m_pad),
                                                                   "panel": min(16, n)}
    assert autotune.best_blocks("countsketch", m, n, d, f64) == {}
    assert kernel_blocks("sketch_matmul", m, n, d, f64, "cpu") == autotune.best_blocks("sketch_matmul", m, n, d, f64)


def test_kinds_are_the_references():
    pytest.importorskip("jax")
    from repro.kernels import autotune as reference

    assert set(autotune.KINDS) == set(reference.KINDS)
    with pytest.raises(ValueError, match="unknown kind"):
        autotune.best_blocks("pallas", M, N, D)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_half_launches_are_bounded_at_the_tensor_core_rate(dtype):
    ops, nbytes = autotune.work("sketch_matmul", 2**16, N, D, dtype)
    assert ops == 2 * D * 2**16 * N
    assert nbytes == (D * 2**16 + 2**16 * N) * 2 + D * N * 4
    assert autotune.bound(ops, nbytes, str(dtype).removeprefix("torch."))[1] == "operations"
    assert autotune.predict_cost("sketch_matmul", 2**16, N, D, dtype) * 1e3 == pytest.approx(0.530, rel=5e-3)
    # f32: three TF32 products (csrc/tf32_mma.cuh) at 495 TFLOP/s
    assert autotune.predict_cost("sketch_matmul", 2**16, N, D, torch.float32) * 1e3 == pytest.approx(3.18, rel=5e-3)


@pytest.mark.parametrize("kind", ["countsketch", "sketch_matmul", "gaussian", "srht", "tsqr"])
def test_half_outputs_count_four_bytes_a_cell(kind):
    """A bf16 launch reads its input elements at 2 bytes and writes its f32
    output at 4, as an f32 launch does: the two differ by 2 bytes an input
    element (B1's int32 buckets count alike in both)."""
    m, n, d = 2**12, 33, 130
    inputs = {"countsketch": m * n + m, "sketch_matmul": d * m + m * n, "gaussian": m * n,
              "srht": m * n + m + d, "tsqr": d * n}[kind]
    _, b16 = autotune.work(kind, m, n, d, torch.bfloat16)
    _, b32 = autotune.work(kind, m, n, d, torch.float32)
    assert b32 - b16 == 2 * inputs
