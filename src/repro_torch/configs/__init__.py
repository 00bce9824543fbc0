"""Architecture registry: ``get_config("<arch-id>")`` / ``--arch <id>``.

The port's own copy of the reference's configurations (plain dataclasses),
so that it imports nothing of the reference package. Only the dense family
without a frontend runs in the port's models; ``models.init_params`` says
which configurations wait.
"""
from __future__ import annotations

import dataclasses
import importlib

from .base import MLAConfig, ModelConfig, MoEConfig, RGLRUConfig, SSMConfig
from .shapes import SHAPES, ShapeSpec, applicable, skip_reason

_MODULES = {
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "yi-34b": "yi_34b",
    "qwen2.5-32b": "qwen2_5_32b",
    "qwen3-4b": "qwen3_4b",
    "starcoder2-7b": "starcoder2_7b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "musicgen-medium": "musicgen_medium",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "recurrentgemma-2b": "recurrentgemma_2b",
}

ARCH_IDS = list(_MODULES)


def _normalize(arch_id: str) -> str:
    a = arch_id.replace("_", "-").lower()
    if a in _MODULES:
        return a
    # allow module-style names (qwen2_5_32b) and dots
    for k, v in _MODULES.items():
        if a == v.replace("_", "-") or a.replace(".", "-") == k.replace(".", "-"):
            return k
    raise KeyError(f"unknown arch '{arch_id}'; known: {ARCH_IDS}")


def get_config(arch_id: str, smoke: bool = False, **overrides) -> ModelConfig:
    mod = importlib.import_module(
        f".{_MODULES[_normalize(arch_id)]}", __package__)
    cfg = mod.SMOKE if smoke else mod.CONFIG
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


__all__ = [
    "ARCH_IDS", "MLAConfig", "ModelConfig", "MoEConfig", "RGLRUConfig",
    "SHAPES", "SSMConfig", "ShapeSpec", "applicable", "get_config",
    "skip_reason",
]
