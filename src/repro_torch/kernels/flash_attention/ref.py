"""Plain PyTorch version of flash attention (GQA, causal): the CPU path of
``ops.flash_attention`` and the oracle the CUDA kernel is held against."""
from __future__ import annotations

import torch


def attention_ref(q, k, v, *, scale: float):
    """q (B, H, S, hd), k (B, KV, S, hd), v (B, KV, S, hd_v) -> (B, H, S, hd_v)."""
    B, H, S, hd = q.shape
    KV = k.shape[1]
    G = H // KV
    qg = q.reshape(B, KV, G, S, hd).float()
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k.float()) * scale
    mask = torch.tril(torch.ones((S, S), dtype=torch.bool, device=q.device))
    s = torch.where(mask[None, None, None], s, -1e30)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bksd->bkgqd", w, v.float())
    return o.reshape(B, H, S, v.shape[-1]).to(q.dtype)
