"""Shape-only stand-ins for the parameter and optimizer-state trees of a
config, as the JAX package's ``repro/launch/specs.py`` gives them with
``jax.eval_shape``: tensors on the ``meta`` device, which carry shape and
dtype and allocate nothing, so the full configs' trees (phi3.5-moe's 41.9 B
parameters) cost nothing to build. The sharding rules read them."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import init_params
from repro_torch.optim import adamw


def params_struct(cfg: ModelConfig):
    return init_params(cfg, device="meta")


def opt_state_struct(params):
    return adamw.init(params)
