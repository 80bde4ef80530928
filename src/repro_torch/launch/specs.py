"""Shape-only stand-ins for every model input of every (arch x shape) cell,
as the JAX package's ``repro/launch/specs.py`` gives them with
``jax.ShapeDtypeStruct`` and ``jax.eval_shape``: tensors on the ``meta``
device, which carry shape and dtype and allocate nothing, so the full
configs' trees (phi3.5-moe's 41.9 B parameters, a 32k-token decode cache)
cost nothing to build. The sharding rules and the dry-run read them."""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.model import init_cache, init_params
from repro_torch.optim import adamw


def _meta(shape, dtype=torch.int32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _pos_struct(cfg: ModelConfig, B: int, S: int) -> torch.Tensor:
    if cfg.rope_kind == "mrope":
        return _meta((3, B, S))
    return _meta((B, S))


def _input_struct(cfg: ModelConfig, B: int, S: int) -> Dict[str, Any]:
    """Token ids, or (``input_mode == "embeddings"``, the modality frontend
    stub) precomputed frame/patch embeddings in bf16."""
    if cfg.input_mode == "embeddings":
        return {"embeds": _meta((B, S, cfg.d_model), torch.bfloat16)}
    return {"tokens": _meta((B, S))}


def train_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    B, S = shape.global_batch, shape.seq_len
    return {"labels": _meta((B, S)), "positions": _pos_struct(cfg, B, S),
            **_input_struct(cfg, B, S)}


def prefill_input_specs(cfg: ModelConfig, shape: ShapeConfig
                        ) -> Dict[str, Any]:
    B, S = shape.global_batch, shape.seq_len
    return {"positions": _pos_struct(cfg, B, S), **_input_struct(cfg, B, S)}


def decode_input_specs(cfg: ModelConfig, shape: ShapeConfig
                       ) -> Tuple[Dict[str, Any], Any]:
    """(batch struct, cache struct). Cache capacity = shape.seq_len; the step
    appends token #seq_len (index = seq_len - 1 entries already present)."""
    B, S = shape.global_batch, shape.seq_len
    batch = {"positions": _pos_struct(cfg, B, 1), **_input_struct(cfg, B, 1)}
    return batch, init_cache(cfg, B, S, device="meta")


def params_struct(cfg: ModelConfig):
    return init_params(cfg, device="meta")


def opt_state_struct(params, layout=None):
    """AdamW's state of ``params`` (of their device and kind), the ZeRO-1
    share of each block under a train ``layout``."""
    return adamw.init(params, layout)


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """The full input tree for the cell's step function."""
    if shape.kind == "train":
        params = params_struct(cfg)
        return {"params": params, "opt_state": opt_state_struct(params),
                "batch": train_input_specs(cfg, shape)}
    if shape.kind == "prefill":
        return {"params": params_struct(cfg),
                "batch": prefill_input_specs(cfg, shape)}
    batch, cache = decode_input_specs(cfg, shape)
    return {"params": params_struct(cfg), "batch": batch, "cache": cache}
