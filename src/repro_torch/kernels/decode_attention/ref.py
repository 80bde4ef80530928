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


def decode_attention_split_ref(q, k, v, valid_len, n_split: int, *,
                               scale: float, rows: int | None = None):
    """The split-KV arithmetic of the CUDA kernels in plain PyTorch, with the
    same layouts as ``decode_attention_ref``: the cache is cut into
    ``n_split`` runs of ``rows`` rows (by default ceil(S / n_split); the
    kernels take theirs from ``ops.split_plan``); each run gives f32 partials
    (m, l, acc) per head over its rows below ``valid_len`` (m = -1e30, l = 0,
    acc = 0 for a run with none), and the combine returns
    sum e^(m_i - M) acc_i / max(sum e^(m_i - M) l_i, 1e-30), M = max m_i.
    At ``valid_len == 0`` that is zero, as the kernels and the JAX package's
    Pallas kernel return (``decode_attention_ref`` returns the mean of V)."""
    B, H, _, hd = q.shape
    KV, S = k.shape[1], k.shape[2]
    G = H // KV
    rows = rows or -(-S // n_split)
    qg = q.reshape(B, KV, G, hd).float()
    pos = torch.arange(S, device=q.device)
    ms, ls, accs = [], [], []
    for i in range(n_split):
        lo, hi = min(i * rows, S), min((i + 1) * rows, S)
        s = torch.einsum("bkgd,bksd->bkgs", qg, k[:, :, lo:hi].float()) * scale
        s = torch.where(pos[lo:hi] < valid_len, s, -torch.inf)
        m = torch.full((B, KV, G), -1e30, device=q.device)
        if hi > lo:
            m = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m[..., None])                  # masked rows: 0
        ms.append(m)
        ls.append(p.sum(dim=-1))
        accs.append(torch.einsum("bkgs,bksd->bkgd", p, v[:, :, lo:hi].float()))
    m = torch.stack(ms)
    w = torch.exp(m - m.amax(dim=0))
    l = (w * torch.stack(ls)).sum(dim=0)
    acc = (w[..., None] * torch.stack(accs)).sum(dim=0)
    o = acc / torch.clamp(l, min=1e-30)[..., None]
    return o.reshape(B, H, 1, v.shape[-1]).to(q.dtype)
