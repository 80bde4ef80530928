"""Plain PyTorch versions of flash attention (GQA, causal) and of its
gradient: the CPU path of ``ops.flash_attention`` and the oracles the CUDA
kernels are held against."""
from __future__ import annotations

import torch


def attention_ref(q, k, v, *, scale: float, return_lse: bool = False):
    """q (B, H, S, hd), k (B, KV, S, hd), v (B, KV, S, hd_v) -> (B, H, S, hd_v);
    with ``return_lse`` also each query row's log-sum-exp of its scaled,
    masked scores, (B, H, S) f32."""
    B, H, S, hd = q.shape
    KV = k.shape[1]
    G = H // KV
    qg = q.reshape(B, KV, G, S, hd).float()
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k.float()) * scale
    mask = torch.tril(torch.ones((S, S), dtype=torch.bool, device=q.device))
    s = torch.where(mask[None, None, None], s, -1e30)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bksd->bkgqd", w, v.float())
    o = o.reshape(B, H, S, v.shape[-1]).to(q.dtype)
    if return_lse:
        return o, torch.logsumexp(s, dim=-1).reshape(B, H, S)
    return o


def attention_bwd_ref(q, k, v, o, lse, do, *, scale: float):
    """The gradient of ``attention_ref`` from its output o, its log-sum-exp
    and the output's gradient do, as FA2 computes it, over the whole masked
    score matrix: P = exp(S scale - lse), D = rowsum(do o), dS = P (dP - D),
    dV = P^T do, dK = dS^T q scale and dQ = dS K scale, every sum in f32
    (the kernels round P and dS to bf16 as tensor-core operands; this
    version does not).

    q, o, do (B, H, S, hd), k, v (B, KV, S, hd), lse (B, H, S) -> (dq, dk,
    dv) in the dtypes of q, k and v."""
    B, H, S, hd = q.shape
    KV = k.shape[1]
    G = H // KV
    qg = q.float().reshape(B, KV, G, S, hd)
    dog = do.float().reshape(B, KV, G, S, -1)
    kf, vf = k.float(), v.float()
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, kf) * scale
    mask = torch.tril(torch.ones((S, S), dtype=torch.bool, device=q.device))
    s = torch.where(mask, s, -torch.inf)
    p = torch.exp(s - lse.float().reshape(B, KV, G, S, 1))
    dsum = (do.float() * o.float()).sum(-1).reshape(B, KV, G, S, 1)
    ds = p * (torch.einsum("bkgqd,bksd->bkgqs", dog, vf) - dsum)
    dv = torch.einsum("bkgqs,bkgqd->bksd", p, dog)
    dk = torch.einsum("bkgqs,bkgqd->bksd", ds, qg) * scale
    dq = torch.einsum("bkgqs,bksd->bkgqd", ds, kf) * scale
    return (dq.reshape(B, H, S, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
