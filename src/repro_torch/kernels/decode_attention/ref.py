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


def _split_partials(q, k, v, valid_len, n_split: int, scale: float,
                    rows: int | None):
    """The split-KV arithmetic of ``decode_attention_split_ref``: (the
    merged f32 accumulator over max(l, 1e-30), the merged l, the merged
    max M), each per (B, KV, G) head."""
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
    top = m.amax(dim=0)
    w = torch.exp(m - top)
    l = (w * torch.stack(ls)).sum(dim=0)
    acc = (w[..., None] * torch.stack(accs)).sum(dim=0)
    return acc / torch.clamp(l, min=1e-30)[..., None], l, top


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
    o = _split_partials(q, k, v, valid_len, n_split, scale, rows)[0]
    return o.reshape(B, H, 1, v.shape[-1]).to(q.dtype)


def decode_attention_partial_ref(q, k, v, valid_len, *, scale: float,
                                 n_split: int = 1, rows: int | None = None):
    """The softmax partial of a block of the cache (``ops.decode_attention(
    ..., return_lse=True)``): ``decode_attention_split_ref``'s output in f32,
    (B, H, 1, hd), and the f32 log-sum-exp of the scaled scores over the
    rows below ``valid_len``, (B, H): M + log(sum e^(m_i - M) l_i), or -inf
    where no row is valid (the output is 0 there, and weighs nothing in
    ``combine_partials_ref``)."""
    B, H, _, hd = q.shape
    o, l, top = _split_partials(q, k, v, valid_len, n_split, scale, rows)
    lse = torch.where(l > 0, top + torch.log(torch.clamp(l, min=1e-30)),
                      -torch.inf)
    return o.reshape(B, H, 1, v.shape[-1]), lse.reshape(B, H)


def combine_partials_ref(o, lse):
    """The attention over the whole cache from the partials of its n blocks,
    stacked along dim 0: o (n, B, H, hd) f32, lse (n, B, H) -> (B, H, hd)
    f32, sum_i w_i o_i / sum_i w_i with w_i = e^(lse_i - L), L = max_i
    lse_i; a block with lse -inf weighs nothing. Some block must hold a
    valid row."""
    w = torch.exp(lse - lse.amax(dim=0))[..., None]
    return (w * o).sum(dim=0) / w.sum(dim=0)
