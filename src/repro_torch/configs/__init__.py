"""Architecture registry: --arch <id> -> ModelConfig."""
from __future__ import annotations

from importlib import import_module

from ..models.config import ModelConfig

_MODULES = {
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "phi3.5-moe-42b-a6.6b": "phi35_moe_42b",
    "xlstm-125m": "xlstm_125m",
    "qwen2-72b": "qwen2_72b",
    "qwen2-0.5b": "qwen2_0_5b",
    "granite-20b": "granite_20b",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "musicgen-medium": "musicgen_medium",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "llava-next-34b": "llava_next_34b",
}

ARCH_IDS = tuple(_MODULES)


def get(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    return import_module(f"repro_torch.configs.{_MODULES[name]}").CONFIG


def all_configs():
    return {name: get(name) for name in _MODULES}
