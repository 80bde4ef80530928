"""Plain PyTorch version of single-token decode attention with a
valid-length masked KV cache: the CPU path of ``ops.decode_attention`` and
the oracle the CUDA kernel is held against."""
from __future__ import annotations

import torch


def decode_attention_ref(q, k, v, valid_len, *, scale: float):
    """q (B, H, 1, hd), k/v (B, KV, S, hd) -> (B, H, 1, hd).

    ``valid_len`` is an int or an integer tensor on q's device (read on the
    device, never on the host)."""
    B, H, _, hd = q.shape
    KV, S = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, KV, G, 1, hd).float()
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k.float()) * scale
    mask = torch.arange(S, device=q.device)[None, None, None, None, :] < valid_len
    s = torch.where(mask, s, -1e30)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bksd->bkgqd", w, v.float())
    return o.reshape(B, H, 1, v.shape[-1]).to(q.dtype)
