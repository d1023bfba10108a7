"""Port parity: checkpointable sketch state (``repro_torch.cluster.checkpoint``)
against the JAX reference's ``repro.cluster.checkpoint``.

Every test of ``tests/test_cluster_checkpoint.py`` has a counterpart here,
at its sizes (M = 600, N = 12, tiles of 50, 128 sketch rows), on the
reference's draw converted to the port (``repro_torch.convert``):

- save → restore → continue is BITWISE the uninterrupted fold for every
  name of the reference's ``SKETCH_KINDS``, and the uninterrupted fold is
  bitwise the reference's for the kinds whose streamed B is
  (``tests/test_torch_streaming.py``);
- a one-range checkpoint finished by two workers (``split_range`` +
  merge) within merge-grouping rounding, exact for the SRHT;
- the refusal paths (another draw, another range, no checkpoint), the
  digest (same draw → same digest, another draw → another), and the
  SRHT's placement buffer restored as a tensor on the operator's device
  that ``update`` writes in place;
- a checkpoint file crosses between the packages' stores bitwise.

The lock-order watchdog is armed for every test of the file.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.cluster as jcl  # noqa: E402
import repro.streaming as jst  # noqa: E402
from repro.core import SKETCH_KINDS  # noqa: E402
from repro.core import sample_sketch as jsample  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.cluster import (  # noqa: E402
    CheckpointMismatch,
    RowRange,
    RowRangeSource,
    latest_watermark,
    op_digest,
    pass_namespace,
    restore_accumulator,
    save_accumulator,
    split_range,
)
from repro_torch.obs import lockcheck  # noqa: E402
from repro_torch.streaming import ArraySource, make_accumulator, merge_all  # noqa: E402
from repro_torch.train import checkpoint as ckpt_lib  # noqa: E402

CPU = "cpu"
M, N, TILE, S_ROWS = 600, 12, 50, 128
ALL_KINDS = list(SKETCH_KINDS)
EXACT = ("countsketch", "clarkson_woodruff", "uniform_sparse", "sparse_sign", "srht")


@pytest.fixture(autouse=True)
def _lock_watchdog():
    forced = lockcheck._forced
    lockcheck.enable()
    yield
    lockcheck._forced = forced


@pytest.fixture(scope="module")
def data():
    return np.random.default_rng(42).standard_normal((M, N))


def _convert(op):
    name = type(op).__name__
    if name == "CountSketch":
        return convert.countsketch_from_reference(op.buckets, op.signs, op.d, device=CPU)
    if name == "SparseSignSketch":
        return convert.sparse_sign_from_reference(op.buckets, op.signs, op.d, op.k, device=CPU)
    if name == "UniformSparseSketch":
        return convert.uniform_sparse_from_reference(op.buckets, op.values, op.d, device=CPU)
    if name == "SRHTSketch":
        return convert.srht_from_reference(op.signs, op.rows, op.d, op.m, device=CPU)
    if name == "GaussianSketch":
        S = None if op.S is None else np.asarray(op.S)
        return convert.gaussian_from_reference(np.asarray(jax.random.key_data(op.key)), op.d, op.m, S,
                                               device=CPU)
    if name == "UniformDenseSketch":
        return convert.uniform_dense_from_reference(np.asarray(op.S), device=CPU)
    raise TypeError(name)


def _ops(kind, seed=9):
    kw = {"materialize": False} if kind == "gaussian" else {}
    jop = jsample(kind, jax.random.key(seed), S_ROWS, M, **kw)
    return jop, _convert(jop)


def _feed(acc, A, lo, hi):
    """Stream grid tiles of A[lo:hi) into acc at global offsets."""
    for o in range(lo, hi, TILE):
        acc.update(A[o : min(o + TILE, hi)], o)
    return acc


@pytest.mark.parametrize("kind", ALL_KINDS)
def test_save_restore_continue_bit_equal(data, tmp_path, kind):
    A = torch.as_tensor(data)
    jop, op = _ops(kind)
    ref = _feed(make_accumulator(op, N, dtype=A.dtype), A, 0, M).finalize()
    if kind in EXACT:
        jref = _feed(jst.make_accumulator(jop, N, dtype=data.dtype), data, 0, M).finalize()
        assert torch.equal(ref, torch.as_tensor(np.array(jref)))

    cut = 4 * TILE
    acc = _feed(make_accumulator(op, N, dtype=A.dtype), A, 0, cut)
    save_accumulator(str(tmp_path), acc, cut, range_start=0, range_stop=M)
    assert latest_watermark(str(tmp_path), 0, M) == cut
    restored, wm = restore_accumulator(str(tmp_path), op, N, range_start=0, range_stop=M, dtype=A.dtype)
    assert wm == cut
    assert restored.rows_seen == acc.rows_seen and restored.tiles_seen == acc.tiles_seen
    assert restored.state.device == op.device and restored.state.dtype == acc.state.dtype
    assert torch.equal(restored.state, acc.state)  # the partial round-trips bitwise
    out = _feed(restored, A, wm, M).finalize()
    assert torch.equal(out, ref), f"{kind}: resume after a checkpoint must be bitwise the uninterrupted stream"


@pytest.mark.parametrize("kind", ["countsketch", "srht"])
def test_restore_into_different_worker_count(data, tmp_path, kind):
    """A checkpoint written by ONE worker is finished by TWO: the restored
    partial plus two fresh sub-range partials merge to the same sketch
    (exact for the SRHT's placement; merge-grouping rounding otherwise)."""
    A = torch.as_tensor(data)
    jop, op = _ops(kind)
    ref = _feed(make_accumulator(op, N, dtype=A.dtype), A, 0, M).finalize()
    cut = 4 * TILE
    acc = _feed(make_accumulator(op, N, dtype=A.dtype), A, 0, cut)
    save_accumulator(str(tmp_path), acc, cut, range_start=0, range_stop=M)
    restored, wm = restore_accumulator(str(tmp_path), op, N, range_start=0, range_stop=M, dtype=A.dtype)
    halves = split_range(RowRange(wm, M), 2, TILE)
    assert len(halves) == 2 and halves[0].start == wm and halves[1].stop == M
    parts = [restored]
    for h in halves:
        sub = RowRangeSource(ArraySource(A, tile_rows=TILE), h.start, h.stop, tile_rows=TILE)
        p = make_accumulator(op, N, dtype=A.dtype)
        for local_o, tile in sub.tiles():
            p.update(tile, h.start + local_o)
        parts.append(p)
    out = merge_all(parts).finalize()
    # the reference does the same on its draw
    jrestored = _feed(jst.make_accumulator(jop, N, dtype=data.dtype), data, 0, cut)
    jparts = [jrestored] + [_feed(jst.make_accumulator(jop, N, dtype=data.dtype), data, h.start, h.stop)
                            for h in halves]
    jout = np.asarray(jst.merge_all(jparts).finalize())
    if kind == "srht":
        assert torch.equal(out, ref) and torch.equal(out, torch.as_tensor(np.array(jout)))
    else:
        assert torch.allclose(out, ref, rtol=0, atol=1e-12)
        assert torch.equal(out, torch.as_tensor(np.array(jout)))  # the same grouping, the same sums


def test_restore_refuses_wrong_operator_draw(data, tmp_path):
    A = torch.as_tensor(data)
    _, op = _ops("countsketch")
    acc = _feed(make_accumulator(op, N, dtype=A.dtype), A, 0, 2 * TILE)
    save_accumulator(str(tmp_path), acc, 2 * TILE, range_start=0, range_stop=M)
    _, other = _ops("countsketch", seed=10)
    assert op_digest(other) != op_digest(op)
    with pytest.raises(CheckpointMismatch, match="different operator draw"):
        restore_accumulator(str(tmp_path), other, N, range_start=0, range_stop=M, dtype=A.dtype)
    assert restore_accumulator(str(tmp_path), op, N, range_start=0, range_stop=M, dtype=A.dtype) is not None
    # a state of another shape (another column count) is refused too
    with pytest.raises(CheckpointMismatch, match="does not match"):
        restore_accumulator(str(tmp_path), op, N + 1, range_start=0, range_stop=M, dtype=A.dtype)


def test_restore_missing_range_returns_none(tmp_path):
    _, op = _ops("countsketch")
    assert restore_accumulator(str(tmp_path), op, N, range_start=0, range_stop=M) is None
    assert latest_watermark(str(tmp_path), 0, M) is None


def test_restore_refuses_another_ranges_metadata(data, tmp_path):
    """A checkpoint moved under another range's directory is refused."""
    import shutil

    A = torch.as_tensor(data)
    _, op = _ops("countsketch")
    acc = _feed(make_accumulator(op, N, dtype=A.dtype), A, 0, 2 * TILE)
    path = save_accumulator(str(tmp_path), acc, 2 * TILE, range_start=0, range_stop=M)
    moved = tmp_path / "pass1" / "range_0_300" / "step_100"
    moved.parent.mkdir(parents=True)
    shutil.copytree(path, moved)
    with pytest.raises(CheckpointMismatch, match="range metadata"):
        restore_accumulator(str(tmp_path), op, N, range_start=0, range_stop=300, dtype=A.dtype)


def test_op_digest_distinguishes_draws_not_objects():
    _, op1 = _ops("sparse_sign")
    _, op2 = _ops("sparse_sign")  # the same key: the same draw, distinct objects
    assert op1 is not op2 and op_digest(op1) == op_digest(op2)
    _, op3 = _ops("sparse_sign", seed=10)
    assert op_digest(op1) != op_digest(op3)
    # the per-operator caches are not the draw
    op1.csr(torch.float64)
    assert op1._csr and op_digest(op1) == op_digest(op2)
    # the Gaussian's key words are its draw; another d is another draw
    _, g1 = _ops("gaussian")
    _, g2 = _ops("gaussian")
    _, g3 = _ops("gaussian", seed=10)
    assert op_digest(g1) == op_digest(g2) != op_digest(g3)
    # the namespace tells right-hand sides apart, not their objects
    b = torch.linspace(0, 1, M, dtype=torch.float64)
    assert pass_namespace(op1, b) == pass_namespace(op2, b.clone()) != pass_namespace(op1, 2 * b)
    assert pass_namespace(op1) != pass_namespace(op1, b) and pass_namespace(op1).startswith("pass1-")
    # bf16 tensors digest by their bits
    from repro_torch.core.sketch import UniformDenseSketch

    S = torch.randn(4, M, generator=torch.Generator().manual_seed(0))
    assert op_digest(UniformDenseSketch(S=S.bfloat16(), d=4, m=M)) != op_digest(UniformDenseSketch(S=S, d=4, m=M))


def test_srht_restore_keeps_writable_device_buffer(data, tmp_path):
    """The SRHT's accumulator writes its placement buffer in place: the
    restored state is a tensor on the operator's device, written in place by
    the next ``update`` (the reference's is host numpy)."""
    A = torch.as_tensor(data)
    _, op = _ops("srht")
    acc = _feed(make_accumulator(op, N, dtype=A.dtype), A, 0, 2 * TILE)
    save_accumulator(str(tmp_path), acc, 2 * TILE, range_start=0, range_stop=M)
    restored, wm = restore_accumulator(str(tmp_path), op, N, range_start=0, range_stop=M, dtype=A.dtype)
    assert isinstance(restored.state, torch.Tensor) and restored.state.device == op.device
    assert tuple(restored.state.shape) == (op.m_pad, N)
    ptr = restored.state.data_ptr()
    _feed(restored, A, wm, M)
    assert restored.state.data_ptr() == ptr  # placed in place


@pytest.mark.parametrize("direction", ["reference_to_port", "port_to_reference"])
def test_accumulator_checkpoint_crosses_packages(data, tmp_path, direction):
    """The range checkpoint's file holds the same keys in both packages, and
    a file written by one store restores bitwise in the other (the op
    digests differ by design: the reference hashes JAX treedefs)."""
    A = torch.as_tensor(data)
    jop, op = _ops("countsketch")
    rdir = tmp_path / "pass1" / f"range_0_{M}"
    if direction == "port_to_reference":
        acc = _feed(make_accumulator(op, N, dtype=A.dtype), A, 0, 3 * TILE)
        save_accumulator(str(tmp_path), acc, 3 * TILE, range_start=0, range_stop=M)
        target = {"state": jax.ShapeDtypeStruct((S_ROWS, N), np.float64),
                  "rows_seen": jax.ShapeDtypeStruct((), np.int64),
                  "range": jax.ShapeDtypeStruct((2,), np.int64)}
        tree, step = jckpt.restore(str(rdir), target)
        assert step == 3 * TILE and int(tree["rows_seen"]) == 3 * TILE
        assert np.array_equal(np.asarray(tree["state"]), acc.state.numpy())
        assert np.asarray(tree["range"]).tolist() == [0, M]
    else:
        jacc = _feed(jst.make_accumulator(jop, N, dtype=data.dtype), data, 0, 3 * TILE)
        jcl.save_accumulator(str(tmp_path), jacc, 3 * TILE, range_start=0, range_stop=M)
        target = {"state": ((S_ROWS, N), torch.float64), "rows_seen": ((), torch.int64),
                  "watermark": ((), torch.int64)}
        tree, step = ckpt_lib.restore(str(rdir), target, device=CPU)
        assert step == 3 * TILE and int(tree["watermark"]) == 3 * TILE
        assert torch.equal(tree["state"], torch.as_tensor(np.array(jacc.state)))
        # the same draw's fold continues from the reference's partial, bitwise
        acc = make_accumulator(op, N, dtype=A.dtype)
        acc.state, acc.rows_seen = tree["state"], int(tree["rows_seen"])
        assert torch.equal(_feed(acc, A, 3 * TILE, M).finalize(),
                           _feed(make_accumulator(op, N, dtype=A.dtype), A, 0, M).finalize())
