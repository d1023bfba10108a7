"""The split plan of the f64 tensor-core engine and the C interface of the
kernel library, checked without a card.

- ``split_plan`` cuts a reduction of ``length`` rows into slabs that cover
  [0, length) exactly, in order, none empty, every one but the last a whole
  number of ring stages; the number of slabs is bounded and depends on the
  arguments alone;
- ``sketch_split`` / ``gram_split`` give the f64 engine a plan and its
  scratch size; ``sketch_split`` gives B6's bf16/f16 engine its own plan
  (64-row stages, 256 x 128 tiles, f32 partials in half an f64 word each),
  whose slabs cover m exactly once, in order; the f32 engines' plans are
  held in ``tests/test_torch_tf32.py``;
- the engine's shapes in ``kernels/common.py`` are the ones the CUDA sources
  set;
- every ``extern "C" int repro_*(`` entry of ``csrc/*.cu`` takes as many
  arguments, of the same types, as its ``_build._SIGNATURES`` entry: with
  ctypes a wrong count or type corrupts arguments without an error.
"""
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import common  # noqa: E402
from repro_torch.kernels.common import (  # noqa: E402
    GRAM_MMA_TILE,
    HALF_MMA_COLS,
    HALF_MMA_ROWS,
    HALF_MMA_STEP,
    MAX_PARTS,
    MMA_STEP,
    SKETCH_MMA_TILE,
    Split,
    cdiv,
    gram_split,
    sketch_split,
    split_plan,
)

CSRC = Path(_build.CSRC)


def _slabs(length, slab, parts):
    return [(p * slab, min((p + 1) * slab, length)) for p in range(parts)]


@settings(max_examples=300, deadline=None)
@given(
    length=st.integers(0, 2**22),
    tiles=st.integers(1, 5000),
    sms=st.integers(1, 264),
    step=st.sampled_from([1, 4, 16, 32]),
)
def test_slabs_cover_the_reduction_in_order(length, tiles, sms, step):
    slab, parts = split_plan(length, tiles, sms, step)
    assert 1 <= parts <= MAX_PARTS
    assert slab >= step and slab % step == 0
    slabs = _slabs(length, slab, parts)
    if length == 0:
        assert parts == 1
        return
    assert slabs[0][0] == 0 and slabs[-1][1] == length
    for (a0, a1), (b0, _) in zip(slabs, slabs[1:]):
        assert a1 == b0  # contiguous, in order
    assert all(b > a for a, b in slabs)  # none empty
    assert all((b - a) % step == 0 for a, b in slabs[:-1])
    assert parts == cdiv(length, slab)  # what the C entries check


@settings(max_examples=100, deadline=None)
@given(length=st.integers(0, 2**20), tiles=st.integers(1, 3000), sms=st.integers(1, 264))
def test_plan_is_a_function_of_its_arguments(length, tiles, sms):
    first = split_plan(length, tiles, sms)
    split_plan(length + 1, tiles + 1, sms)  # no state carried between calls
    assert split_plan(length, tiles, sms) == first
    assert split_plan(length, tiles, sms, MMA_STEP) == first


@pytest.mark.parametrize("sms", [1, 66, 132])
def test_full_waves_keep_one_slab(sms):
    # tiles that fill every SM the same number of times gain nothing from a split
    for waves in (1, 2, 3):
        assert split_plan(2**16, waves * sms, sms) == (2**16, 1)


def test_few_tiles_split_the_reduction():
    # one tile on a card of 132 SMs walks a long reduction alone without a split
    slab, parts = split_plan(2**16, 1, 132)
    assert parts > 1 and slab * (parts - 1) < 2**16 <= slab * parts


@pytest.mark.parametrize("length,tiles,sms,step", [
    (-1, 1, 1, 16), (10, 0, 1, 16), (10, 1, 0, 16), (10, 1, 1, 0),
])
def test_plan_rejects_bad_arguments(length, tiles, sms, step):
    with pytest.raises(ValueError):
        split_plan(length, tiles, sms, step)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_only_f64_is_split(dtype):
    """B6's half engine at d = 4000, n = 1000 has 128 tiles for 132 SMs and
    its f32 engine 256 (two waves), so they keep one slab (the f32 engine's
    scratch holds A^T's two TF32 parts, (n, m) f32 each); the Gram splits in
    f64 and f32 (B2's split-TF32 engine: 136 upper tiles, 16-row stages),
    not on a half B."""
    if dtype == torch.float32:
        assert sketch_split(dtype, 4000, 2**16, 1000, 132) == Split(2**16, 1, 1000 * 2**16)
        slab, parts = split_plan(4000, 136, 132, 16)
        assert parts > 1
        assert gram_split(dtype, 4000, 1000, 132) == Split(slab, parts, cdiv(parts * 136 * GRAM_MMA_TILE**2, 2))
    else:
        assert sketch_split(dtype, 4000, 2**16, 1000, 132) == Split(2**16, 1, 0)
        assert gram_split(dtype, 4000, 1000, 132) == Split(MMA_STEP, 1, 0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d,m,n", [(4000, 2**16, 1000), (4000, 2**16, 2), (300, 1007, 130), (37, 5, 3),
                                   (100, 17, 2), (129, 4096, 257), (7, 0, 9)])
def test_half_sketch_split_covers_m_once_in_order(dtype, d, m, n):
    split = sketch_split(dtype, d, m, n, 132)
    tiles = cdiv(d, HALF_MMA_ROWS) * cdiv(n, HALF_MMA_COLS)
    assert (split.slab, split.parts) == split_plan(m, tiles, 132, HALF_MMA_STEP)
    assert split.slab % HALF_MMA_STEP == 0 and split.slab >= HALF_MMA_STEP
    slabs = _slabs(m, split.slab, split.parts)
    covered = [k for lo, hi in slabs for k in range(lo, hi)]
    assert covered == list(range(m))  # every row of the reduction once, in slab order
    assert all(hi > lo for lo, hi in slabs) or m == 0
    # f32 partial tiles, two to an f64 word of scratch
    want = cdiv(split.parts * tiles * HALF_MMA_ROWS * HALF_MMA_COLS, 2) if split.parts > 1 else 0
    assert split.scratch == want
    assert sketch_split(dtype, d, m, n, 132) == split  # a function of its arguments


def test_half_sketch_split_fills_the_card_on_narrow_outputs():
    # n = 2: 16 tiles on 132 SMs, so the sum over m is cut into slabs
    split = sketch_split(torch.bfloat16, 4000, 2**16, 2, 132)
    assert split.parts > 1 and cdiv(2**16, split.slab) == split.parts
    assert sketch_split(torch.bfloat16, 4000, 2**16, 1, 132) == Split(MMA_STEP, 1, 0)  # b: the vector kernel


@pytest.mark.parametrize("d,m,n", [(4000, 2**16, 1000), (300, 1007, 130), (37, 5, 3), (100, 17, 2)])
def test_sketch_split_scratch_holds_every_partial(d, m, n):
    split = sketch_split(torch.float64, d, m, n, 132)
    tiles = cdiv(d, SKETCH_MMA_TILE) * cdiv(n, SKETCH_MMA_TILE)
    assert (split.slab, split.parts) == split_plan(m, tiles, 132)
    want = split.parts * tiles * SKETCH_MMA_TILE**2 if split.parts > 1 else 0
    assert split.scratch == want


def test_sketch_split_leaves_vectors_and_empty_outputs_alone():
    # n = 1 runs the vector kernel, d = 0 launches nothing
    assert sketch_split(torch.float64, 4000, 2**16, 1, 132) == Split(MMA_STEP, 1, 0)
    assert sketch_split(torch.float64, 0, 2**16, 8, 132) == Split(MMA_STEP, 1, 0)


@pytest.mark.parametrize("s,n", [(4000, 1000), (700, 33), (3, 5), (333, 1), (8192, 2048)])
def test_gram_split_counts_upper_tiles(s, n):
    split = gram_split(torch.float64, s, n, 132)
    t = cdiv(n, GRAM_MMA_TILE)
    tiles = t * (t + 1) // 2
    assert (split.slab, split.parts) == split_plan(s, tiles, 132)
    assert split.scratch == (split.parts * tiles * GRAM_MMA_TILE**2 if split.parts > 1 else 0)


def test_scratch_for_shares_one_buffer():
    a, b = Split(16, 2, 10), Split(16, 3, 25)
    buf = common.scratch_for([a, b], "cpu")
    assert buf.dtype == torch.float64 and buf.numel() == 25
    assert common.scratch_for([Split(16, 1, 0)], "cpu") is None


def _constexpr(name, text):
    found = re.search(rf"constexpr int {name} = (\w+);", text)
    assert found, name
    return found.group(1)


def test_engine_shapes_match_the_cuda_sources():
    mma = (CSRC / "dense_mma.cuh").read_text()
    assert int(_constexpr("kMmaStep", mma)) == MMA_STEP
    sketch = (CSRC / "dense_sketch.cuh").read_text()
    assert int(_constexpr("kSketchMmaTile", sketch)) == SKETCH_MMA_TILE
    assert "MmaShape<kSketchMmaTile, kSketchMmaTile," in sketch
    gram = (CSRC / "gram.cuh").read_text()
    assert int(_constexpr(_constexpr("kGramMmaTile", gram), gram)) == GRAM_MMA_TILE
    assert "MmaShape<kGramMmaTile, kGramMmaTile," in gram
    half = (CSRC / "half_mma.cuh").read_text()
    assert int(_constexpr("kHalfBD", half)) == HALF_MMA_ROWS
    assert int(_constexpr("kHalfBN", half)) == HALF_MMA_COLS
    assert int(_constexpr("kHalfBK", half)) == HALF_MMA_STEP


_CTYPES = {
    "int": _build.ctypes.c_int,
    "int64_t": _build.ctypes.c_int64,
    "uint32_t": _build.ctypes.c_uint32,
    "float": _build.ctypes.c_float,
    "double": _build.ctypes.c_double,
}


def _c_entries():
    entries = {}
    for path in sorted(CSRC.glob("*.cu")):
        for name, args in re.findall(r'extern "C" int (repro_\w+)\(([^)]*)\)', path.read_text()):
            types = []
            for arg in args.split(","):
                decl = " ".join(arg.split())
                if "*" in decl:
                    types.append(_build.ctypes.c_void_p)
                else:
                    types.append(_CTYPES[decl.rsplit(" ", 1)[0].replace("const ", "")])
            entries[name] = types
    return entries


def test_every_c_entry_is_declared():
    assert set(_c_entries()) == set(_build._SIGNATURES)


@pytest.mark.parametrize("name", sorted(_build._SIGNATURES))
def test_c_entry_matches_its_ctypes_signature(name):
    c_types = _c_entries()[name]
    assert len(c_types) == len(_build._SIGNATURES[name]), name
    assert c_types == _build._SIGNATURES[name], name
