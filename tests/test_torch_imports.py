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


def test_the_scan_covers_every_package():
    mods = _port_modules()
    for pkg in ("core", "kernels", "obs", "streaming", "serve", "analysis", "cluster", "train",
                "sharding", "optim", "configs", "models", "data", "launch"):
        assert f"repro_torch.{pkg}" in mods, pkg
    assert {"repro_torch.streaming.sources", "repro_torch.streaming.accumulate",
            "repro_torch.streaming.solve"} <= set(mods)
    assert {"repro_torch.serve.fingerprint", "repro_torch.serve.cache",
            "repro_torch.serve.batching", "repro_torch.serve.service",
            "repro_torch.analysis.annotations"} <= set(mods)
    assert {"repro_torch.cluster.shard", "repro_torch.cluster.faults", "repro_torch.cluster.checkpoint",
            "repro_torch.cluster.coordinator", "repro_torch.train.checkpoint"} <= set(mods)
    assert {"repro_torch.core.distributed", "repro_torch.optim.compression"} <= set(mods)
    assert {"repro_torch.models.common", "repro_torch.models.attention", "repro_torch.models.mlp",
            "repro_torch.models.transformer", "repro_torch.optim.adamw", "repro_torch.data.synthetic",
            "repro_torch.train.step", "repro_torch.train.loop", "repro_torch.train.serve",
            "repro_torch.train.elastic", "repro_torch.launch.train", "repro_torch.launch.serve",
            "repro_torch.configs.registry", "repro_torch.configs.llama3_2_1b"} <= set(mods)


def test_the_lm_stack_imports_neither_jax_nor_the_reference():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch.models, repro_torch.train, repro_torch.data, repro_torch.configs\n"
        "import repro_torch.launch.train, repro_torch.launch.serve\n"
        "from repro_torch.train import generate, make_dp_train_step, make_train_step, train_loop\n"
        "from repro_torch.configs import get_config\n"
        "get_config('llama3.2-1b')\n"
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


def test_the_distributed_slice_imports_neither_jax_nor_the_reference():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch.sharding, repro_torch.optim, repro_torch.core.distributed\n"
        "from repro_torch.core import sketched_lstsq\n"
        "from repro_torch.streaming import sharded_sketch\n"
        "from repro_torch.optim import sketched_psum_grads\n"
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


def test_serve_imports_neither_jax_nor_the_reference():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch.serve, repro_torch.analysis.annotations\n"
        "from repro_torch import SolveService\n"
        "assert SolveService is repro_torch.serve.SolveService\n"
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


def test_core_exports_the_references_names():
    import repro_torch.core as core
    from repro_torch.kernels.srht import fwht

    for name in ("fwht", "LSQRResult", "SAAResult"):
        assert name in core.__all__, name
    assert core.fwht is fwht
    assert core.LSQRResult is core.SAAResult is core.SolveResult
    assert core.lsqr.LSQRResult is core.SolveResult and core.saa.SAAResult is core.SolveResult


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
        sketched_lstsq,
    )
    from repro_torch.configs import smoke_config
    from repro_torch.data import SyntheticConfig, batch_at
    from repro_torch.kernels import sketch_qr, tsqr
    from repro_torch.models import Transformer, init_cache, init_params
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import init_train_state, train_loop
    from repro_torch.serve import SolveService
    from repro_torch.streaming import ArraySource, StreamingSolver, stream_lstsq, stream_sketch

    A = np.random.default_rng(0).standard_normal((200, 5))
    b = A[:, 0].copy()
    A_cpu = torch.as_tensor(A)  # a CPU tensor is moved to CUDA all the same
    op = CountSketch.sample(0, 20, 200, device="cpu")
    lm = smoke_config("llama3.2-1b")
    data = SyntheticConfig(vocab=lm.vocab, seq_len=8, global_batch=2)
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
        "stream_lstsq": lambda: stream_lstsq(A, b, 0),
        "stream_lstsq_cpu_tensor": lambda: stream_lstsq(ArraySource(A_cpu), b, 0, method="saa"),
        "stream_sketch": lambda: stream_sketch(A, 0),
        "StreamingSolver": lambda: StreamingSolver(A, 0),
        "SketchedFactor.build_streaming": lambda: SketchedFactor.build_streaming(A, 0),
        "lstsq_row_source": lambda: lstsq(ArraySource(A), b, 0),
        "source_from_reference": lambda: convert.source_from_reference(ArraySource(A)),
        "SolveService": lambda: SolveService(0),
        "sketched_lstsq": lambda: sketched_lstsq(A_cpu, b, 0),
        "init_params": lambda: init_params(lm, 0),
        "Transformer": lambda: Transformer(lm),
        "init_cache": lambda: init_cache(lm, 1, 8),
        "init_train_state": lambda: init_train_state(lm, 0),
        "train_loop": lambda: train_loop(lm, data, AdamWConfig(), steps=1),
        "batch_at": lambda: batch_at(data, 0),
        "params_from_reference": lambda: convert.params_from_reference(lm, {}),
        "batch_from_reference": lambda: convert.batch_from_reference({"tokens": np.zeros((1, 2), np.int32)}),
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
