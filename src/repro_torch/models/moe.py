"""Mixture-of-Experts layer: top-k routing, capacity-based scatter/gather
dispatch, optional shared experts (DeepSeek), load-balance aux loss.

The same function as the JAX package's ``repro/models/moe.py``, in plain
PyTorch ops (the reference computes routing, dispatch and the expert GEMMs
in jnp, outside any Pallas kernel):

  * the router in f32: softmax, top-k (ties to the lower expert index, as
    ``jax.lax.top_k``: a stable descending sort), renormalized;
  * slots assigned k-priority first, then in token order within an expert,
    at most C per expert and group; a token past capacity goes to the dump
    slot and its gate is 0;
  * token groups: one per batch row when S > 1 (train / prefill), one
    global group at decode (S == 1), so C differs between the two;
  * experts stacked (E, ...) and applied as batched matrix products over E,
    dense over every capacity slot (decode reads every expert's weights).

The expert buffers are laid out (E, G, C) rather than JAX's (G, E, C), so
the products take them with no copy; the dump slot is one extra row after
them. Kept slots hold exactly one token each, so the scatter
(``index_add_``, atomic on CUDA) adds a token to zeros only there; the
tokens it piles into the dump row are never read.
``cfg.moe_dispatch_constraint`` pins a sharding in the reference; here it
is read and ignored (expert parallelism is ``moe_apply``'s ``tp``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.models.layers import (_act, init_mlp, mlp, mlp_hidden,
                                       truncated_normal_init)


def init_moe(gen, cfg: ModelConfig, dtype, device, lead=()):
    E, d, ff = cfg.num_experts, cfg.d_model, cfg.d_ff_expert
    std_in = 1.0 / math.sqrt(d)
    std_out = 1.0 / math.sqrt(ff * 2 * cfg.num_layers)
    p = {
        "router": {"w": truncated_normal_init(gen, (*lead, d, E), std_in,
                                              torch.float32, device)},
        "w_in": truncated_normal_init(gen, (*lead, E, d, ff), std_in, dtype,
                                      device),
        "w_gate": truncated_normal_init(gen, (*lead, E, d, ff), std_in, dtype,
                                        device),
        "w_out": truncated_normal_init(gen, (*lead, E, ff, d), std_out, dtype,
                                       device),
    }
    if cfg.num_shared_experts:
        shared_cfg = dataclasses.replace(cfg, gated_mlp=True)
        p["shared"] = init_mlp(gen, shared_cfg, cfg.num_shared_experts * ff,
                               dtype, device, lead)
    return p


def moe_capacity(cfg: ModelConfig, tokens_per_group: int) -> int:
    c = int(math.ceil(tokens_per_group / cfg.num_experts
                      * cfg.capacity_factor * cfg.top_k))
    return max(cfg.top_k, min(c, tokens_per_group))


def _route(logits: torch.Tensor, cfg: ModelConfig):
    """logits (G, Tg, E) f32 -> (probs, top_p (G,Tg,K), top_i (G,Tg,K))."""
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[..., :cfg.top_k], top_i[..., :cfg.top_k]
    top_p = top_p / torch.sum(top_p, dim=-1, keepdim=True)   # renormalize
    return probs, top_p, top_i


def _assign(top_i: torch.Tensor, E: int, C: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Slots of the top-k choices (G, Tg, K): k-priority, then token order
    within an expert. Returns (position within the expert, kept), each
    (G, Tg, K); a choice is kept while its position is below C."""
    G = top_i.shape[0]
    counts = torch.zeros((G, 1, E), dtype=torch.int64, device=top_i.device)
    pos, keep = [], []
    for j in range(top_i.shape[-1]):
        e_j = top_i[..., j:j + 1]                                  # (G,Tg,1)
        mask_j = F.one_hot(e_j[..., 0], E)                         # (G,Tg,E)
        pos_j = torch.cumsum(mask_j, dim=1) - 1 + counts
        pos.append(torch.gather(pos_j, -1, e_j)[..., 0])
        keep.append(pos[-1] < C)
        counts = counts + mask_j.sum(dim=1, keepdim=True)
    return torch.stack(pos, -1), torch.stack(keep, -1)


def _scatter(x_flat: torch.Tensor, slot: torch.Tensor, n_rows: int
             ) -> torch.Tensor:
    """Rows (n_rows, d): token t added at row ``slot[t, j]`` for every
    choice j. A kept slot takes exactly one token; the dump row (the last)
    sums the dropped ones."""
    buf = torch.zeros((n_rows, x_flat.shape[-1]), dtype=x_flat.dtype,
                      device=x_flat.device)
    for j in range(slot.shape[-1]):
        buf.index_add_(0, slot[..., j].reshape(-1), x_flat)
    return buf


def moe_apply(p, x: torch.Tensor, cfg: ModelConfig, tp=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (y (B, S, d), aux_loss scalar f32).

    Token groups: one group per batch row when S > 1 (train/prefill), a single
    global group for decode (S == 1).

    With ``tp`` (``tensor_parallel.TP``, expert parallelism): the expert
    weights are this rank's ``E / tp`` experts. The router, the aux loss and
    the slots stay whole and the same on every rank; the rank scatters only
    its experts' slots (the others go to its dump row), runs its experts,
    gathers their outputs back weighted by the gates (taken through
    ``copy_to_tp``, so the router's gradient is whole on every rank), adds
    the shared experts' partial sum (the dense MLP's split) and reduces the
    sum once over the ranks.
    """
    B, S, d = x.shape
    E, K = cfg.num_experts, cfg.top_k
    G, Tg = (B, S) if S > 1 else (1, B)
    xg = x.reshape(G, Tg, d)

    C = moe_capacity(cfg, Tg)
    logits = xg.float() @ p["router"]["w"]                     # (G,Tg,E)
    probs, top_p, top_i = _route(logits, cfg)
    pos, keep = _assign(top_i, E, C)

    # --- scatter tokens into expert buffers (E, G, C, d) + the dump row ------
    group = torch.arange(G, device=x.device)[:, None, None]
    dump = E * G * C
    slot = torch.where(keep, (top_i * G + group) * C + pos, dump)  # (G,Tg,K)
    xs = xg
    if tp is not None:
        # this rank's experts' rows; every other slot goes to its dump row
        dump = p["w_in"].shape[0] * G * C
        slot = slot - tp.rank * dump
        slot = torch.where((slot >= 0) & (slot < dump), slot, dump)
        xs = TP.copy_to_tp(xg, tp)
        top_p = TP.copy_to_tp(top_p, tp)
    x_e = _scatter(xs.reshape(G * Tg, d), slot, dump + 1)[:dump].view(
        -1, G * C, d)

    # --- expert GEMMs ---------------------------------------------------------
    h = torch.bmm(x_e, p["w_in"])
    g = torch.bmm(x_e, p["w_gate"])
    h = _act(cfg.act, g) * h
    y_e = torch.bmm(h, p["w_out"])                             # (E, G*C, d)

    # --- gather back ----------------------------------------------------------
    y_flat = torch.cat([y_e.reshape(dump, d), y_e.new_zeros((1, d))])
    out = torch.zeros_like(xg)
    for j in range(K):
        picked = y_flat[slot[..., j]]                          # (G, Tg, d)
        gate = (top_p[..., j] * keep[..., j])[..., None].to(picked.dtype)
        out = out + picked * gate

    # --- load-balance aux loss (Switch-style) -----------------------------------
    frac = torch.mean(F.one_hot(top_i[..., 0], E).float(), dim=(0, 1))
    mean_prob = torch.mean(probs, dim=(0, 1))
    aux = cfg.router_aux_coef * E * torch.sum(frac * mean_prob)

    # --- shared experts --------------------------------------------------------
    # last: under remat the recompute replays a layer's forward up to the last
    # tensor its backward saves, so after them the aux loss would rerun their
    # down projection, which the reference's remat does not
    if "shared" in p:
        if tp is None:
            out = out + mlp(p["shared"], xg, cfg)
        else:
            out = out + mlp_hidden(p["shared"], xs, cfg) @ p["shared"][
                "w_out"]["w"]
    if tp is not None:
        out = TP.reduce_from_tp(out, tp)

    return out.reshape(B, S, d), aux

