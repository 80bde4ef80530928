"""Serving-step factories: prefill (prompt -> last-token logits + caches) and
decode (one token against caches), plus greedy/temperature sampling. Both
steps take ``tp`` (``tensor_parallel.TP``, the model group of a
``ServeLayout``): they then run a rank's tensor-parallel program on its
blocks of the parameters and caches, and their logits are its vocab
columns (``tensor_parallel.gather_vocab`` makes them whole for
``sample``)."""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M

_SEQ_CACHE_LEAVES = ("k", "v", "c_kv", "k_rope")


def kernel_launches(cfg: ModelConfig, new_tokens: int, tp=None,
                    rank: int = 0) -> Dict[str, int]:
    """The CUDA kernel launches of one ``launch.serve.generate`` (a prefill
    and ``new_tokens - 1`` decode steps) with ``cfg.use_pallas``, by kernel.
    Every step runs RMSNorm twice per attention block (three times with
    MLA, whose ``kv_norm`` is one more) and per Mamba2 layer (its input and
    gated norms), and once at the end; the prefill runs flash attention per
    attention block and the SSD scan per Mamba2 layer; every decode step
    runs decode attention per GQA block (MLA decodes through einsums, as
    the reference does). The hybrid's shared block runs once per group.

    ``tp`` (the size of the model group, or None for one rank): each
    rank's launches, which are as many, each kernel once a layer whatever
    the rank's share of the heads, but for the gated norm of a Mamba2 layer
    of the hybrid family split over more than one rank: two launches, the
    row sums and the scaling (``tensor_parallel.split_rmsnorm``). With
    ``tp`` the split-row launches among the RMSNorm's are an entry of their
    own, ``fused_rmsnorm_split``. Where the query heads are padded to
    slots (``tensor_parallel.head_slots``), model rank ``rank`` holding
    only padding launches no attention kernel. A sequence-parallel decode
    launches as many: each rank's decode kernel runs over its block."""
    from repro_torch.distributed.tensor_parallel import head_slots
    L = cfg.num_layers
    split = cfg.family == "hybrid" and (tp or 1) > 1
    if cfg.family == "ssm":
        attn, norms = 0, 2 * L
    elif cfg.family == "hybrid":
        attn = L // cfg.attn_every                  # shared-block calls
        norms = (3 if split else 2) * L + 2 * attn
    else:
        attn, norms = L, (3 if cfg.use_mla else 2) * L
    slots = head_slots(cfg, tp)
    attends = attn if slots is None or slots.real(rank)[1] else 0
    out = {"flash_attention": attends,
           "decode_attention": (0 if cfg.use_mla
                                else attends * (new_tokens - 1)),
           "fused_rmsnorm": (norms + 1) * new_tokens,
           "ssd": L if cfg.family in ("ssm", "hybrid") else 0}
    if tp is not None:
        out["fused_rmsnorm_split"] = 2 * L * new_tokens if split else 0
    return out


def make_prefill_step(cfg: ModelConfig, tp=None, sp=None):
    """``sp`` (``tensor_parallel.SeqPar``): the prefill of a
    sequence-parallel decode, its K/V this rank's block of the cache."""
    def prefill_step(params, batch) -> Tuple[torch.Tensor, Any]:
        logits, _, cache = M.forward(params, cfg, batch, mode="prefill",
                                     tp=tp, sp=sp)
        return logits, cache
    return prefill_step


def make_decode_step(cfg: ModelConfig, tp=None, sp=None):
    def decode_step(params, batch, cache) -> Tuple[torch.Tensor, Any]:
        return M.decode(params, cfg, batch, cache, tp, sp)
    return decode_step


def sample(logits: torch.Tensor, generator: Optional[torch.Generator] = None,
           temperature: float = 0.0, vocab_size: int = 0) -> torch.Tensor:
    """logits (B,1,V) -> tokens (B,1). temperature 0 = greedy.
    Padded-vocab tail is masked out. Temperature sampling draws from
    ``generator`` (on logits' device)."""
    if vocab_size:
        mask = torch.arange(logits.shape[-1], device=logits.device) < vocab_size
        logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    return torch.multinomial(flat, 1, generator=generator).reshape(
        logits.shape[:-1])


def pad_cache(cache: Dict[str, Any], cfg: ModelConfig, max_len: int
              ) -> Dict[str, Any]:
    """Grow prefill-sized caches (seq dim == prompt len) to ``max_len`` so
    decode can append. Seq dim is axis 2 of k/v/c_kv/k_rope leaves (stacked
    over layers: (L, B, S, ...)), in every subtree (``layers``,
    ``dense_layers``, the hybrid's ``attn``); a rank's block of them too."""
    def grow(name, leaf):
        if isinstance(leaf, dict):
            return {k: grow(k, v) for k, v in leaf.items()}
        if name in _SEQ_CACHE_LEAVES and leaf.shape[2] < max_len:
            pad = [0, 0] * (leaf.ndim - 3) + [0, max_len - leaf.shape[2]]
            return F.pad(leaf, pad)
        return leaf
    return {k: grow(k, v) for k, v in cache.items()}
