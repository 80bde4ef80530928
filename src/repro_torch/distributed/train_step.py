"""Train-step factory: CE loss (+ MoE aux), gradient accumulation, the
data-parallel gradient mean (fp32 or int8, ``distributed/compression.py``)
and the AdamW update, as the JAX package's
``repro/distributed/train_step.py``.

Gradients come from ``torch.autograd.grad`` over aliases of the parameter
leaves (``detach().requires_grad_()``: the same storage, made to require
grad for this step only), so no ``.grad`` field is written and nothing
carries over from one step to the next. With ``cfg.use_pallas`` (the port's
default) the forward on the card runs the CUDA kernels and the backward the
vector-Jacobian products of their plain versions (the kernels' wrappers).
``cfg.remat`` selects the activation checkpointing (``models.model``).
On a mesh of several ranks the step is ZeRO-1 over ``data`` and splits the
model over ``model`` (``distributed/tensor_parallel.py``): under tp16 the
layers and the vocabulary, under dp_all the vocabulary alone.

The step, its forward and backward (a microbatch's each) and its update
are spans of ``core/spans.py`` (``step``, ``step.forward``,
``step.backward``, ``step.update``), recorded only while a span trace is
on. The update is ``optim.adamw.update``, which writes the new parameters
and moments into the trees it is given: ``train_step`` returns the
caller's parameter tree, updated in place, and a new ``OptState`` over the
same moment tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch import tree as T
from repro_torch.configs.base import ModelConfig
from repro_torch.core import spans
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.distributed.compression import make_local_grad_fn
from repro_torch.models import model as M
from repro_torch.optim import adamw

_METRICS = ("loss", "ce", "aux_loss")


def make_loss_fn(cfg: ModelConfig, tp=None):
    """loss_fn(params, batch) -> (loss, metrics). With ``tp`` the forward
    runs tensor-parallel and, where the vocabulary is split, the cross
    entropy is the vocab-parallel one (``tensor_parallel.vocab_parallel_ce``,
    the same arithmetic); where the group's ranks hold other rows
    (``tp.split_rows``) it is the mean over the group's rows, gathered."""
    vtp = M.vocab_group(cfg, tp)

    def loss_fn(params, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        logits, aux, _ = M.forward(params, cfg, batch, mode="train", tp=tp)
        labels = batch["labels"].long()
        if vtp is not None and vtp.split_rows:
            labels = TP.all_gather_dim(labels, 0, vtp.group, vtp.size)
        if vtp is not None:
            ce = torch.mean(TP.vocab_parallel_ce(logits, labels, vtp))
            loss = ce + aux
            return loss, {"loss": loss, "ce": ce, "aux_loss": aux}
        # the gold logit gathered first in the logits' dtype, then the f32
        # logsumexp (as the JAX package)
        gold = torch.gather(logits, -1, labels[..., None])[..., 0].float()
        logz = torch.logsumexp(logits.float(), dim=-1)
        ce = torch.mean(logz - gold)
        loss = ce + aux
        return loss, {"loss": loss, "ce": ce, "aux_loss": aux}
    return loss_fn


def _batch_size(batch) -> int:
    return (batch["tokens"] if "tokens" in batch else batch["embeds"]).shape[0]


def _microbatch(batch, i: int, mb: int, B: int):
    """Rows [i*mb, (i+1)*mb) of every batch leaf; mrope positions (3, B, S)
    are sliced along dim 1."""
    def cut(t):
        if t.ndim and t.shape[0] == B:
            return t[i * mb:(i + 1) * mb]
        if t.ndim >= 2 and t.shape[0] == 3 and t.shape[1] == B:
            return t[:, i * mb:(i + 1) * mb]
        return t
    return {k: cut(v) for k, v in batch.items()}


def make_grad_fn(cfg: ModelConfig, *, accum_steps: int = 1,
                 tp=None) -> Callable:
    """grad_fn(params, batch) -> (grads, metrics): the gradients of the loss
    as a tree of params' structure (in the parameters' dtype, or f32 when
    accumulated over ``accum_steps`` microbatches along dim 0) and the
    loss metrics, averaged over the microbatches, detached. With ``tp``
    (``tensor_parallel.TP``) ``params`` are this rank's blocks and so are
    the gradients; a leaf whole on every rank has its whole gradient on
    every rank."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    loss_fn = make_loss_fn(cfg, tp)

    def one(params, batch):
        alias = [p.detach().requires_grad_() for p in T.leaves(params)]
        with torch.enable_grad():
            with spans.span("step.forward", device=True):
                loss, metrics = loss_fn(T.unflatten(params, alias), batch)
            # a leaf the loss does not reach (the token table when the batch
            # brings embeddings) gets zeros, as under jax.grad
            with spans.span("step.backward", device=True):
                grads = torch.autograd.grad(loss, alias, allow_unused=True,
                                            materialize_grads=True)
        return list(grads), {k: v.detach() for k, v in metrics.items()}

    def grad_fn(params, batch):
        if accum_steps == 1:
            grads, metrics = one(params, batch)
            return T.unflatten(params, grads), metrics
        B = _batch_size(batch)
        if B % accum_steps:
            raise ValueError(f"batch {B} is not a multiple of accum_steps "
                             f"{accum_steps}")
        mb = B // accum_steps
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in T.leaves(params)]
        total = {k: 0.0 for k in _METRICS}
        for i in range(accum_steps):
            grads, metrics = one(params, _microbatch(batch, i, mb, B))
            for a, g in zip(acc, grads):
                a.add_(g.float())
            del grads
            total = {k: total[k] + metrics[k] for k in _METRICS}
        return (T.unflatten(params, [a.div_(accum_steps) for a in acc]),
                {k: v / accum_steps for k, v in total.items()})

    return grad_fn


def kernel_launches(cfg: ModelConfig, model_ranks: int = 1,
                    rank: int = 0) -> Dict[str, int]:
    """The CUDA kernel launches of one ``make_grad_fn(cfg)`` pass (one step
    at ``accum_steps=1``) with ``cfg.use_pallas``, by kernel. Each layer's
    forward launches its kernels once, and once more in its recompute under
    remat 'full' or 'dots' (which keeps only matrix products); the final
    norm launches once; the backward relaunches no forward (flash
    attention's backward kernel is counted apart: ``flash_backwards``). An
    attention block (dense, MoE, the MoE family's leading dense
    layers) runs flash attention and 2 RMSNorms, 3 with MLA (its
    ``kv_norm``); a Mamba2 block the SSD scan, its input norm and its gated
    norm; the hybrid's shared block runs once per group, never under remat
    (as in the reference). A rank of a tensor-parallel step launches as
    many: each kernel runs once a layer whatever the rank's share of the
    heads, and every norm runs whole on every rank, but for the gated norm
    of a Mamba2 layer split over ``model_ranks`` > 1 ranks, which runs in
    two launches (``tensor_parallel.split_rmsnorm``). Where the query heads
    are padded to slots (``tensor_parallel.head_slots``), model rank
    ``rank`` holding only padding launches no flash attention."""
    L, runs = cfg.num_layers, 1 if cfg.remat == "none" else 2
    shared = 0                          # the hybrid's shared-block calls
    if cfg.family in ("ssm", "hybrid"):
        split = cfg.family == "hybrid" and model_ranks > 1
        flash, norms, scans = 0, (3 if split else 2) * L, L
        if cfg.family == "hybrid":
            shared = L // cfg.attn_every
    else:
        flash, norms, scans = L, (3 if cfg.use_mla else 2) * L, 0
    slots = TP.head_slots(cfg, model_ranks)
    attends = slots is None or slots.real(rank)[1] > 0
    return {"flash_attention": (runs * flash + shared) * attends,
            "decode_attention": 0,
            "fused_rmsnorm": runs * norms + 2 * shared + 1,
            "ssd": runs * scans}


def flash_backwards(cfg: ModelConfig, model_ranks: int = 1,
                    rank: int = 0) -> Dict[str, int]:
    """The flash-attention backwards of one ``make_grad_fn(cfg)`` pass (one
    step at ``accum_steps=1``) with ``cfg.use_pallas``, by route, as the
    wrapper counts them: ``backward_launches`` where its backward kernel
    takes the config's dtype and head widths
    (``flash_attention.ops.kernel_backward``), else ``plain_backward_calls``
    (the plain vjp). One per attention call of the forward without remat
    (``kernel_launches``), which a recompute does not add to."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    calls = kernel_launches(dataclasses.replace(cfg, remat="none"),
                            model_ranks, rank)["flash_attention"]
    hd, hd_v = ((cfg.qk_nope_head_dim + cfg.qk_rope_head_dim,
                 cfg.v_head_dim) if cfg.use_mla
                else (cfg.head_dim, cfg.head_dim))
    kernel = fa_ops.kernel_backward(getattr(torch, cfg.dtype), hd, hd_v)
    return {"backward_launches": calls if kernel else 0,
            "plain_backward_calls": 0 if kernel else calls}


def split_norm_launches(cfg: ModelConfig, model_ranks: int) -> int:
    """The split-row RMSNorm launches among ``kernel_launches(cfg,
    model_ranks)["fused_rmsnorm"]``: the two passes of each Mamba2 layer's
    gated norm and forward run, where the hybrid family is split over more
    than one model rank; else none."""
    if cfg.family != "hybrid" or model_ranks == 1:
        return 0
    return 2 * cfg.num_layers * (1 if cfg.remat == "none" else 2)


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.OptimizerConfig, *,
                    accum_steps: int = 1,
                    grad_compression: Optional[str] = None,
                    mesh=None, dp_axes: Tuple[str, ...] = ()):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), metrics holding ``loss``, ``ce``, ``aux_loss``, ``grad_norm``
    and ``lr`` as 0-dim tensors on the parameters' device.

    accum_steps > 1: the batch is split into microbatches along dim 0 and
    gradients accumulate in f32. With a ``mesh`` whose ``dp_axes`` span more
    than one rank, each rank takes the gradients of its rows of the (global)
    batch and the ranks' mean is explicit (``compression.make_local_grad_fn``,
    in f32); grad_compression='int8' makes that mean the two-phase int8 one,
    on any number of ranks (one rank: the gradients quantized once).

    On a mesh of several ranks (``tensor_parallel.train_layout``) the step
    takes this rank's blocks, ``layout.shard_params(params)`` and
    ``adamw.init(params, layout)``, and updates them, ZeRO-1 over ``data``:
    a tp16 model runs tensor-parallel over ``model``, a dp_all one splits
    its vocabulary there (over ranks holding other rows where ``dp_axes``
    name ``model``: ``tensor_parallel.step_group``). The gradient mean acts
    on the rank's blocks of the gradients. The step carries its gradient
    function (``grad_fn``, the mean included) and its ``layout`` (None on
    one rank) as attributes.

    A one-device local mesh (a Flux partition of one card,
    ``make_local_mesh``) is one rank: no collective runs, and the batch
    must lie on its device. A local mesh of several devices raises
    NotImplementedError: a step over it runs on a group of ranks spawned
    over its devices (``launch/ranks.run_on_mesh``, the flux executor's
    route for such a partition), each rank's step made over the group's
    mesh."""
    if grad_compression not in (None, "int8"):
        raise ValueError(f"unknown grad_compression {grad_compression!r}")
    layout = TP.train_layout(cfg, mesh)
    tp = TP.step_group(cfg, layout, dp_axes)
    grad_fn = make_grad_fn(cfg, accum_steps=accum_steps, tp=tp)
    compress = grad_compression == "int8"
    if compress or (mesh is not None and mesh.axes_size(dp_axes) > 1):
        if mesh is None or not dp_axes:
            raise ValueError("int8 compression needs mesh and dp_axes")
        batch_dim_map = {"positions": 1} if cfg.rope_kind == "mrope" else {}
        group_loss = (layout.split_over_model
                      if tp is not None and tp.split_rows
                      and M.vocab_group(cfg, tp) is not None else None)
        grad_fn = make_local_grad_fn(grad_fn, mesh, dp_axes, batch_dim_map,
                                     compress=compress,
                                     group_loss=group_loss)

    def train_step(params, opt_state, batch):
        with spans.span("step"):
            TP.check_local(mesh, batch["labels"], "the batch")
            grads, metrics = grad_fn(params, batch)
            with spans.span("step.update", device=True):
                params, opt_state, om = adamw.update(opt_cfg, opt_state,
                                                     grads, params, layout)
            metrics.update(om)
            return params, opt_state, metrics

    # its parts, for callers that read the gradients or gather the blocks
    train_step.grad_fn, train_step.layout = grad_fn, layout
    return train_step


def make_eval_step(cfg: ModelConfig):
    loss_fn = make_loss_fn(cfg)

    def eval_step(params, batch):
        with torch.no_grad():
            _, metrics = loss_fn(params, batch)
        return metrics
    return eval_step
