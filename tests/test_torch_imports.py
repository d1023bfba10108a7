"""The port stands alone: no JAX, no reference package, no silent CPU.

- every module of ``repro_torch`` imports in a fresh interpreter where
  ``jax`` and ``repro`` cannot be imported;
- an AST scan finds no ``jax``/``repro`` import in ``src/repro_torch`` or
  ``chip_smoke.py``;
- entry points called without ``device=`` on a machine without CUDA raise
  instead of running on the CPU, and a CUDA kernel without ``nvcc`` raises
  instead of falling back.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_every_module_imports_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import importlib\n"
        f"for name in {_port_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'jaxlib', 'repro.'))\n"
        "               for k in sys.modules if sys.modules[k] is not None)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize(
    "path",
    sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_no_jax_or_reference_imports(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path.name} imports {name}"


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


class _Duck:
    """A duck-typed operator with no device of its own."""

    shape = (200, 5)
    dtype = np.float64

    def matvec(self, v):
        return v

    def rmatvec(self, u):
        return u


def _entry_points():
    from repro_torch import convert
    from repro_torch.core import (
        CountSketch,
        GaussianSketch,
        CustomOperator,
        SketchedFactor,
        SketchedSolver,
        SparseOperator,
        SparseSignSketch,
        TikhonovAugmented,
        SRHTSketch,
        UniformDenseSketch,
        UniformSparseSketch,
        as_operator,
        estimate_2norm,
        generate_problem,
        lsqr_dense,
        lstsq,
        qr_solve,
        saa_sas,
    )
    from repro_torch.kernels import sketch_qr, tsqr

    A = np.random.default_rng(0).standard_normal((200, 5))
    b = A[:, 0].copy()
    A_cpu = torch.as_tensor(A)  # a CPU tensor is moved to CUDA all the same
    op = CountSketch.sample(0, 20, 200, device="cpu")
    return {
        "generate_problem": lambda: generate_problem(0, 200, 5),
        "lstsq": lambda: lstsq(A, b, 0, method="saa"),
        "lstsq_cpu_tensor": lambda: lstsq(A_cpu, b, 0),
        "saa_sas": lambda: saa_sas(A_cpu, b, 0),
        "lsqr_dense": lambda: lsqr_dense(A, b),
        "qr_solve": lambda: qr_solve(A, b),
        "SketchedFactor.build": lambda: SketchedFactor.build(A, 0),
        "CountSketch.sample": lambda: CountSketch.sample(0, 20, 200),
        "GaussianSketch.sample": lambda: GaussianSketch.sample(0, 20, 200),
        "UniformDenseSketch.sample": lambda: UniformDenseSketch.sample(0, 20, 200),
        "lstsq_gaussian": lambda: lstsq(A, b, 0, method="saa", sketch="gaussian"),
        "SRHTSketch.sample": lambda: SRHTSketch.sample(0, 20, 200),
        "SparseSignSketch.sample": lambda: SparseSignSketch.sample(0, 20, 200),
        "UniformSparseSketch.sample": lambda: UniformSparseSketch.sample(0, 20, 200),
        "lstsq_srht": lambda: lstsq(A, b, 0, method="saa", sketch="srht"),
        "lstsq_sparse_sign": lambda: lstsq(A, b, 0, method="saa", sketch="sparse_sign"),
        "srht_from_reference": lambda: convert.srht_from_reference(
            np.ones(4), np.zeros(2, np.int32), 2, 3
        ),
        "sparse_sign_from_reference": lambda: convert.sparse_sign_from_reference(
            np.zeros((2, 3), np.int32), np.ones((2, 3)), 2, 2
        ),
        "uniform_sparse_from_reference": lambda: convert.uniform_sparse_from_reference(
            np.zeros(3, np.int32), np.ones(3), 2
        ),
        "as_operator": lambda: as_operator(A),
        "estimate_2norm": lambda: estimate_2norm(A, 0),
        "tsqr": lambda: tsqr(A),
        "sketch_qr": lambda: sketch_qr(op, A),
        "countsketch_from_reference": lambda: convert.countsketch_from_reference(
            np.zeros(3, np.int32), np.ones(3), 2
        ),
        "gaussian_from_reference": lambda: convert.gaussian_from_reference(
            np.zeros(2, np.uint32), 2, 3
        ),
        "uniform_dense_from_reference": lambda: convert.uniform_dense_from_reference(
            np.zeros((2, 3))
        ),
        "problem_from_reference": lambda: convert.problem_from_reference(
            A, b, b[:5], b, 1.0, 0.0
        ),
        "sparse_from_reference": lambda: convert.sparse_from_reference(
            np.array([[0, 1]]), np.ones(1), (2, 2)
        ),
        "SparseOperator.from_entries": lambda: SparseOperator.from_entries([0], [1], [1.0], (2, 2)),
        "as_operator_sparse": lambda: as_operator(A_cpu.to_sparse()),
        "as_operator_duck": lambda: as_operator(_Duck()),
        "CustomOperator.device": lambda: CustomOperator(abs, abs, (2, 2), torch.float64).device,
        "TikhonovAugmented.wrap": lambda: TikhonovAugmented.wrap(A, 0.1),
        "lstsq_reg": lambda: lstsq(A, b, 0, reg=0.1),
        "lstsq_sparse": lambda: lstsq(A_cpu.to_sparse(), b, 0),
        "SketchedSolver_reg": lambda: SketchedSolver(A, 0, reg=0.1),
    }


@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda, name):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _entry_points()[name]()


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    from repro_torch.kernels import _build

    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "DEFAULT_NVCC", tmp_path / "no-nvcc")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    _build.load.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.load()
    finally:
        _build.load.cache_clear()


def test_wrappers_refuse_other_devices():
    from repro_torch.kernels import (
        countsketch_apply,
        countsketch_coo_apply,
        countsketch_gram,
        fused_gaussian_sketch,
        gaussian_gram,
        hadamard_transform,
        matmul_gram,
        panel_gram,
        sketch_matmul,
        srht_apply,
        threefry_bits,
    )

    A = torch.zeros(8, 3, device="meta")
    h = torch.zeros(8, dtype=torch.int32, device="meta")
    s = torch.ones(8, device="meta")
    S = torch.zeros(4, 8, device="meta")
    with pytest.raises(ValueError):
        countsketch_apply(A, h, s, 4)
    r = torch.zeros(8, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        countsketch_coo_apply(r, r, s, (8, 3), h, s, 4)
    with pytest.raises(ValueError):
        countsketch_gram(A, h, s, 4)
    with pytest.raises(ValueError):
        panel_gram(A)
    with pytest.raises(ValueError):
        sketch_matmul(S, A)
    with pytest.raises(ValueError):
        matmul_gram(S, A)
    with pytest.raises(ValueError):
        fused_gaussian_sketch(A, (0, 0), 4)
    with pytest.raises(ValueError):
        gaussian_gram(A, (0, 0), 4)
    with pytest.raises(ValueError):
        threefry_bits((0, 0), 0, 0, 2, 2, "cpu")
    with pytest.raises(ValueError):
        hadamard_transform(A)
    with pytest.raises(ValueError):
        srht_apply(A, torch.ones(8, device="meta"), torch.zeros(2, dtype=torch.int64, device="meta"), 2)
