"""Architecture registry: ``--arch <id>`` resolution + per-arch shape cells."""
from __future__ import annotations

from importlib import import_module

from .base import SHAPES, ModelConfig, ShapeConfig

ARCHS: dict[str, str] = {
    "musicgen-medium": "musicgen_medium",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "llama3.2-1b": "llama3_2_1b",
    "mistral-nemo-12b": "mistral_nemo_12b",
    "nemotron-4-15b": "nemotron_4_15b",
    "qwen3-0.6b": "qwen3_0_6b",
    "mixtral-8x7b": "mixtral_8x7b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "mamba2-2.7b": "mamba2_2_7b",
    "llama-3.2-vision-11b": "llama3_2_vision_11b",
}

# long_500k needs bounded-state attention: SSM state (mamba2), RG-LRU +
# 2048-window local attn (recurrentgemma), 4096-window SWA (mixtral).
# Pure full-attention archs are skipped per the assignment (see DESIGN.md).
LONG_OK = {"mamba2-2.7b", "recurrentgemma-9b", "mixtral-8x7b"}


def _module(name: str):
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return import_module(f".{ARCHS[name]}", __package__)


def get_config(name: str) -> ModelConfig:
    return _module(name).get_config()


def smoke_config(name: str) -> ModelConfig:
    return _module(name).smoke_config()


def list_archs() -> list[str]:
    return list(ARCHS)


def cells(name: str) -> list[str]:
    """The assigned (arch x shape) cells that actually lower."""
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if name in LONG_OK:
        out.append("long_500k")
    return out


def all_cells() -> list[tuple[str, str]]:
    return [(a, s) for a in ARCHS for s in cells(a)]


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]
