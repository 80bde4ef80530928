"""Architecture config registry of the PyTorch port.

Only the architectures whose layer stack the port runs are registered: the
dense code path (dense, audio and vlm families), the SSM family (mamba2) and
the hybrid family (zamba2). The MoE configs join with the slice that ports
their layers; until then ``get_config`` raises ``KeyError`` for them.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import List

from .base import ModelConfig  # noqa: F401

_ARCH_MODULES = {
    "musicgen-medium": "musicgen_medium",
    "chatglm3-6b": "chatglm3_6b",
    "stablelm-3b": "stablelm_3b",
    "gemma-7b": "gemma_7b",
    "stablelm-12b": "stablelm_12b",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "mamba2-130m": "mamba2_130m",
    "zamba2-7b": "zamba2_7b",
}

ARCH_IDS: List[str] = list(_ARCH_MODULES)


def get_config(arch: str, **overrides) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown or not yet ported arch {arch!r}; "
                       f"known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    cfg: ModelConfig = mod.CONFIG
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def get_smoke_config(arch: str, **overrides) -> ModelConfig:
    return get_config(arch).reduced(**overrides)
