"""AdamW with decoupled weight decay, global-norm clipping and a
warmup+cosine schedule, as the JAX package's ``repro/optim/adamw.py``.

Plain functions over the port's trees (``repro_torch.tree``). The moments are
f32 whatever the parameters' dtype. The arithmetic is JAX's: the schedule
reads the step before the increment, the gradients are clipped by their
global norm before the moments, the bias correction uses the step after it,
and decay skips norms, biases and the SSM's 1-D leaves.

One difference, for memory: ``update`` works leaf by leaf and **in place**
under ``torch.no_grad()``. It writes the new parameters into the caller's
parameter tensors and the new moments into ``state.mu`` / ``state.nu``, and
returns those same trees with a new step. The global norm is taken first;
each leaf's gradient is then scaled as it is consumed, so no f32 copy of the
whole gradient tree is made (the reference's ``clip_by_global_norm`` makes
one; it is kept here for its callers).

On a mesh (``layout``, ``distributed/tensor_parallel.TrainLayout``) the trees
are one rank's blocks: the norm sums over the ranks, and the moments hold
only the ZeRO-1 share of each block (``distributed/sharding.zero1_spec``),
the parameter gathered over ``data`` after its update.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch import tree as T
from repro_torch.distributed import tensor_parallel as TP


@dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    betas: Tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


class OptState(NamedTuple):
    step: torch.Tensor         # 0-dim int32, on the parameters' device
    mu: Any                    # first moment (f32 tree)
    nu: Any                    # second moment (f32 tree)


def init(params, layout=None) -> OptState:
    """Zero moments of the parameters' shapes; with a ``layout``
    (``tensor_parallel.TrainLayout``, ``params`` this rank's blocks) of
    each block's ZeRO-1 share (``layout.moment_block``)."""
    def shape(path, p):
        blk = layout.moment_block(path) if layout is not None else None
        return p.shape if blk is None else p[blk[1]].shape

    def zeros():
        return T.unflatten(params, [
            torch.zeros(shape(path, p), dtype=torch.float32, device=p.device)
            for path, p in T.flatten(params)])
    device = T.leaves(params)[0].device
    return OptState(step=torch.zeros((), dtype=torch.int32, device=device),
                    mu=zeros(), nu=zeros())


def schedule(cfg: OptimizerConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor or an int) as an f32 tensor."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp((step + 1.0) / max(1, cfg.warmup_steps), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree, layout=None) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in f32 (no f32 copy of a
    leaf is made). With a ``layout`` the leaves are this rank's blocks: the
    squares of the leaves split over the model group are summed over its
    ranks, those of a leaf whole on every rank counted once."""
    sq = {path: torch.linalg.vector_norm(x, dtype=torch.float32).square()
          for path, x in T.flatten(tree)}
    if layout is None or layout.tp is None:
        return torch.sqrt(torch.sum(torch.stack(list(sq.values()))))
    zero = torch.zeros((), dtype=torch.float32,
                       device=T.leaves(tree)[0].device)
    split = sum((v for p, v in sq.items() if layout.split_over_model(p)), zero)
    whole = sum((v for p, v in sq.items() if not layout.split_over_model(p)),
                zero)
    return torch.sqrt(TP.all_reduce(split, layout.tp.group) + whole)


def clip_by_global_norm(grads, max_norm: float):
    """(the gradients in f32 scaled to a global norm of at most
    ``max_norm``, their global norm before)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return T.tree_map(lambda g: g.float() * scale, grads), norm


def _decay_mask(path: str) -> bool:
    """No weight decay for norms, biases, and 1-D params (by the leaf's last
    key)."""
    return path.rsplit("/", 1)[-1] not in ("scale", "b", "A_log", "D",
                                           "dt_bias")


@torch.no_grad()
def update(cfg: OptimizerConfig, state: OptState, grads, params, layout=None
           ) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step, in place (see the module docstring). Returns
    (params, OptState(step + 1, mu, nu), {"grad_norm", "lr"}).

    With a ``layout`` (``tensor_parallel.TrainLayout``; ``params``,
    ``grads`` and the moments this rank's blocks, as ``init(params,
    layout)`` makes them): the global norm over every rank's blocks, and
    ZeRO-1, each rank updating the block of a parameter its moments cover
    and all-gathering the parameter over ``data``."""
    gnorm = global_norm(grads, layout)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    b1, b2 = cfg.betas
    step = state.step + 1
    lr = schedule(cfg, state.step)
    bc1 = 1.0 - b1 ** step.to(torch.float32)
    bc2 = 1.0 - b2 ** step.to(torch.float32)
    for (path, whole), g, m, v in zip(T.flatten(params), T.leaves(grads),
                                      T.leaves(state.mu), T.leaves(state.nu)):
        blk = layout.moment_block(path) if layout is not None else None
        p = whole if blk is None else whole[blk[1]]
        g32 = (g if blk is None else g[blk[1]]).float() * scale
        m.mul_(b1).add_(g32, alpha=1 - b1)
        v.mul_(b2).addcmul_(g32, g32, value=1 - b2)
        del g32
        den = torch.div(v, bc2).sqrt_().add_(cfg.eps)
        upd = torch.div(m, bc1).div_(den)
        del den
        if _decay_mask(path):
            upd.add_(p, alpha=cfg.weight_decay)      # in f32
        p.sub_(upd.mul_(lr))           # in f32, rounded once to p's dtype
        if blk is not None:            # the other ranks' blocks
            TP.all_gather_dim(p.clone(), blk[0], layout.data_group,
                              layout.data_size, out=whole)
    return params, OptState(step=step, mu=state.mu, nu=state.nu), \
        {"grad_norm": gnorm, "lr": lr}
