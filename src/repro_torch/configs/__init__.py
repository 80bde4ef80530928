"""Architecture config registry of the PyTorch port.

All ten of the JAX package's architectures, in its order, each in its own
module exposing ``CONFIG`` (the port's copy: it imports nothing of
``repro``). ``get_config(arch)`` returns the full config;
``get_smoke_config(arch)`` the reduced same-family variant used by CPU
smoke tests; ``SHAPES`` the input-shape cells of the dry-run.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List

from .base import ModelConfig, ShapeConfig, SHAPES, cell_is_runnable  # noqa: F401

_ARCH_MODULES = {
    "mamba2-130m": "mamba2_130m",
    "phi3.5-moe-42b-a6.6b": "phi35_moe_42b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "musicgen-medium": "musicgen_medium",
    "zamba2-7b": "zamba2_7b",
    "chatglm3-6b": "chatglm3_6b",
    "stablelm-3b": "stablelm_3b",
    "gemma-7b": "gemma_7b",
    "stablelm-12b": "stablelm_12b",
    "qwen2-vl-7b": "qwen2_vl_7b",
}

ARCH_IDS: List[str] = list(_ARCH_MODULES)


def get_config(arch: str, **overrides) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    cfg: ModelConfig = mod.CONFIG
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def get_smoke_config(arch: str, **overrides) -> ModelConfig:
    return get_config(arch).reduced(**overrides)


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
