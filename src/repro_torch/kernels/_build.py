"""Build and load the hand-written CUDA kernels of ``repro_torch/csrc``.

Every ``csrc/*.cu`` has a plain C interface.  At first use each source is
compiled by its own ``nvcc`` process (all started together) for
``sm_90a``, the objects are linked into one shared library under
``build/repro_torch/`` at the root of the checkout (listed in
``.gitignore``), and the library is loaded with ``ctypes``.  The library's
name carries a hash of the sources and flags, so an edit to any source
rebuilds it and an unchanged tree reuses it.  If ``nvcc`` is missing or a
build fails, the call raises: a CUDA tensor never falls back to the plain
versions.

Each C entry returns ``cudaGetLastError()`` after its launches;
:func:`check` turns a non-zero code into an exception.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

__all__ = ["load", "check", "dtype_code", "stream_ptr", "ptr", "count_launch", "BUILD_DIR", "CSRC"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)

# Order matches the DtypeCode enum of csrc/common.cuh.
_DTYPE_CODES = {
    torch.float64: 0,
    torch.float32: 1,
    torch.bfloat16: 2,
    torch.float16: 3,
}

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_U32 = ctypes.c_uint32
_F32 = ctypes.c_float
_F64 = ctypes.c_double
_SIGNATURES = {
    "repro_countsketch_apply": [_I, _P, _P, _P, _P, _P, _I64, _I64, _P],
    "repro_countsketch_fold": [_I, _P, _P, _P, _P, _P, _I64, _I64, _P],
    "repro_coo_scatter": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _P],
    "repro_panel_gram": [_I, _P, _P, _P, _I64, _I64, _I64, _I64, _P],
    "repro_countsketch_gram": [_I, _P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _P],
    "repro_sketch_matmul": [_I, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _I64, _I64, _P],
    "repro_fused_gaussian": [
        _I, _U32, _U32, _F32, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _P,
    ],
    "repro_fused_gaussian_cols": [
        _I, _U32, _U32, _U32, _F32, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _P,
    ],
    "repro_gaussian_engine": [_U32, _U32, _F32, _P, _P, _I64, _I64, _I64, _I, _P],
    "repro_gaussian_clusters": [_I, _P],
    "repro_matmul_gram": [
        _I, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _I64, _I64, _I64, _I64, _P,
    ],
    "repro_gaussian_gram": [
        _I, _U32, _U32, _F32, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _I64, _I64, _P,
    ],
    "repro_threefry_bits": [_U32, _U32, _I64, _I64, _I64, _I64, _P, _P, _P],
    "repro_hadamard": [_I, _P, _P, _I64, _I64, _P],
    "repro_srht_apply": [
        _I, _P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _F64, _P,
    ],
}

def dtype_code(dtype: torch.dtype) -> int:
    try:
        return _DTYPE_CODES[dtype]
    except KeyError:
        raise TypeError(
            f"the CUDA kernels take {sorted(map(str, _DTYPE_CODES))}, got {dtype}"
        ) from None


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


_LAUNCHES_MU = threading.Lock()


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches``: under a lock, since the cluster's
    worker threads launch the same kernel at once."""
    with _LAUNCHES_MU:
        wrapper.launches += 1


def ptr(t: torch.Tensor | None) -> int | None:
    """A tensor's device pointer, or NULL for None."""
    return None if t is None else t.data_ptr()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if DEFAULT_NVCC.exists():
        return str(DEFAULT_NVCC)
    raise RuntimeError(
        "nvcc not found: the repro_torch CUDA kernels are built from "
        f"{CSRC} at first use and need the CUDA toolkit"
    )


def _sources() -> tuple[list[Path], str]:
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return sources, digest.hexdigest()[:16]


def _compile(target: Path) -> None:
    nvcc = _nvcc()
    sources, _ = _sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objects = [Path(tmp) / (src.stem + ".o") for src in sources]
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for src, obj in zip(sources, objects)
        ]
        failures = []
        for src, proc in zip(sources, procs):
            out, _ = proc.communicate()
            if proc.returncode:
                failures.append(f"{src.name}:\n{out}")
        if failures:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
        lib = Path(tmp) / target.name
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", *map(str, objects), "-o", str(lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(lib, target)  # atomic: concurrent builds race safely


@functools.cache
def load() -> ctypes.CDLL:
    """Build (if the sources changed) and load the kernel library."""
    _, digest = _sources()
    target = BUILD_DIR / f"librepro_torch_{digest}.so"
    if not target.exists():
        _compile(target)
    lib = ctypes.CDLL(str(target))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, name: str) -> None:
    """Raise if a C entry reported a CUDA error."""
    if err:
        text = load().repro_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {text}")
