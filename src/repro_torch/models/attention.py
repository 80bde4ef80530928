"""Attention variants: GQA/MQA/MHA with RoPE flavors, and DeepSeek MLA.

Entry modes, as in the JAX package:
  * full-sequence causal (train / prefill): ``gqa_full``, ``mla_full``
    (K/V decompressed from the latent; the flash kernel takes MLA's
    query/key width 192 with its value width 128 as they are);
  * single-token decode against a KV cache: ``gqa_decode``, which writes the
    new K/V row into the cache in place (JAX returns an updated copy);
  * MLA decode in the absorbed-weight form (``mla_decode``): scores in the
    512-dim latent space, only (c_kv, k_rope) cached, written in place. Its
    f32 einsums are the reference's: attention through no kernel there
    either.

Every entry takes ``tp`` (``tensor_parallel.TP``): the weights are then
this rank's heads, and the head counts are read off their widths, never
off the config; the out-projection is row-parallel. The caches are this
rank's blocks by ``sharding.cache_pspec``: K/V of its kv heads, or whole
under the replicated-KV rule (``tensor_parallel.local_kv`` then views the
kv heads its query heads read), MLA's latents whole. Where the query heads
do not divide over the ranks (``tensor_parallel.head_slots``) a rank's
weights hold its slots: it attends with its real heads and its padded
slots' outputs are zero. ``gqa_decode`` also takes ``sp``
(``tensor_parallel.SeqPar``): the caches are then this rank's block of the
sequence, and the block's softmax partials are combined over the data
group.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.models.layers import (apply_rope, init_linear, init_rmsnorm,
                                       linear, rmsnorm, rope_cos_sin,
                                       rot_dim_for)

NEG_INF = -2.0e38


# ============================================================ core (plain path)
def attn_weights_core(q, k, *, scale: float, q_offset, kv_valid_len) -> torch.Tensor:
    """Grouped-query causal attention scores+softmax.

    q: (B, Sq, KV, G, hd); k: (B, Sk, KV, hd). Returns weights (B,KV,G,Sq,Sk) f32.
    ``q_offset``: position of q[0] in the global sequence (int or device scalar).
    ``kv_valid_len``: number of valid cache entries (None -> all Sk valid).
    """
    B, Sq, KV, G, hd = q.shape
    Sk = k.shape[1]
    scores = torch.einsum("bqkgd,bskd->bkgqs", q.float(), k.float()) * scale
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    k_pos = torch.arange(Sk, device=q.device)
    mask = k_pos[None, :] <= q_pos[:, None]                      # causal
    if kv_valid_len is not None:
        mask = mask & (k_pos[None, :] < kv_valid_len)
    scores = torch.where(mask[None, None, None], scores, NEG_INF)
    return torch.softmax(scores, dim=-1)


def attn_core(q, k, v, *, scale: float, q_offset=0, kv_valid_len=None,
              use_pallas: bool = False) -> torch.Tensor:
    """q (B,Sq,H,hd), k/v (B,Sk,KV,hd) -> (B,Sq,H,hd_v)."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    if use_pallas and Sq > 1 and kv_valid_len is None:
        from repro_torch.kernels.flash_attention import ops as fa_ops
        return fa_ops.flash_attention(q, k, v, scale=scale)
    if use_pallas and Sq == 1 and kv_valid_len is not None:
        from repro_torch.kernels.decode_attention import ops as da_ops
        return da_ops.decode_attention(q, k, v, kv_valid_len, scale=scale)
    qg = q.reshape(B, Sq, KV, G, hd)
    w = attn_weights_core(qg, k, scale=scale, q_offset=q_offset,
                          kv_valid_len=kv_valid_len)
    o = torch.einsum("bkgqs,bskd->bqkgd", w, v.float())
    return o.reshape(B, Sq, H, v.shape[-1]).to(q.dtype)


# ================================================================== GQA layer
def init_gqa(gen, cfg: ModelConfig, dtype, device, lead=()):
    H, KV, hd, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_model
    return {
        "wq": init_linear(gen, d, H * hd, dtype, device, bias=cfg.qkv_bias,
                          lead=lead),
        "wk": init_linear(gen, d, KV * hd, dtype, device, bias=cfg.qkv_bias,
                          lead=lead),
        "wv": init_linear(gen, d, KV * hd, dtype, device, bias=cfg.qkv_bias,
                          lead=lead),
        "wo": init_linear(gen, H * hd, d, dtype, device, lead=lead,
                          stddev=1.0 / math.sqrt(H * hd * 2 * cfg.num_layers)),
    }


def gqa_rope(cfg: ModelConfig, q, k, positions):
    rd = rot_dim_for(cfg, cfg.head_dim)
    if rd == 0 or positions is None:
        return q, k
    cos, sin = rope_cos_sin(cfg, positions, rd)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin)


def gqa_full(p, x, cfg: ModelConfig, positions, *, return_kv: bool = False,
             tp=None):
    """Full-sequence causal attention (train / prefill).

    Returns (out, (k, v) or None). positions: (B,S) or (3,B,S) for mrope.
    With ``tp`` (``tensor_parallel.TP``) the weights are this rank's: q
    heads and ``wo``'s rows split over the ranks, the head counts read off
    the weights' widths; K/V split the same way, or whole on every rank
    under the replicated-KV rule (``tensor_parallel.local_kv``).
    """
    B, S, _ = x.shape
    hd = cfg.head_dim
    xq = x if tp is None else TP.copy_to_tp(x, tp)
    kv_split = _kv_split(p, cfg, tp)
    xkv = xq if kv_split else x
    q = linear(p["wq"], xq).reshape(B, S, -1, hd)
    k = linear(p["wk"], xkv).reshape(B, S, -1, hd)
    v = linear(p["wv"], xkv).reshape(B, S, -1, hd)
    q, k = gqa_rope(cfg, q, k, positions)
    o = _attend(q, k, v, kv_split, cfg, tp, lambda qr, ka, va: attn_core(
        qr, ka, va, scale=1.0 / math.sqrt(hd), use_pallas=cfg.use_pallas))
    return _out(p, o.reshape(B, S, -1), tp), ((k, v) if return_kv else None)


def _kv_split(p, cfg: ModelConfig, tp) -> bool:
    """Whether this rank's K/V are its own kv heads (else, under ``tp``,
    the replicated-KV rule: whole on every rank)."""
    return tp is not None and (p["wk"]["w"].shape[-1]
                               < cfg.num_kv_heads * cfg.head_dim)


def _attend(q, k, v, kv_split: bool, cfg: ModelConfig, tp, core):
    """``core(q, k, v)`` over the K/V (B, S, KV, hd) this rank's query
    heads read: ``k``/``v`` themselves, or under the replicated-KV rule a
    view of the kv heads they read (no copy: the kernels read through
    strides). Where the heads are padded to slots (``TP.head_slots``) only
    the rank's real heads attend, and its padded slots' outputs are zeros
    (a rank of padding alone runs no attention, ``TP.unread``)."""
    if tp is None or kv_split:
        return core(q, k, v)
    G = cfg.num_heads // cfg.num_kv_heads
    slots = TP.head_slots(cfg, tp)
    if slots is None:
        return core(q, *TP.local_kv(k, v, q.shape[2], G, tp))
    first, n = slots.real(tp.rank)
    ka, va = TP.local_kv(k, v, n, G, tp, first=first)
    if n == 0:
        return TP.unread(q.new_zeros(q.shape[:3] + v.shape[-1:]), q, ka, va)
    o = core(q[:, :, :n], ka, va)
    return F.pad(o, (0, 0, 0, q.shape[2] - n))


def _out(p, o, tp):
    """The out-projection: row-parallel under ``tp``."""
    return linear(p["wo"], o) if tp is None else TP.row_parallel(p["wo"], o,
                                                                  tp)


def attn_partial(q, k, v, valid_len, *, scale: float, use_pallas: bool):
    """The softmax partial of single-token attention over a block of a
    cache: q (B, 1, H, hd), k/v (B, S, KV, hd), ``valid_len`` an int32
    device tensor -> (o (B, 1, H, hd) f32, lse (B, H) f32), by the decode
    kernel (``return_lse``) or its plain version."""
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.decode_attention import ref as da_ref
    if use_pallas:
        return da_ops.decode_attention(q, k, v, valid_len, scale=scale,
                                       return_lse=True)
    o, lse = da_ref.decode_attention_partial_ref(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), valid_len,
        scale=scale)
    return o.transpose(1, 2), lse


def gqa_decode(p, x, cfg: ModelConfig, positions, k_cache, v_cache, index,
               tp=None, sp=None):
    """Single-token decode. x (B,1,d); caches (B,Smax,KV,hd); index = #tokens
    already cached, a 0-dim int32 tensor on the device.

    The new row is written into ``k_cache``/``v_cache`` in place at ``index``
    (an ``index_copy_`` driven by the device tensor: no host sync). Returns
    (out, k_cache, v_cache). With ``tp`` the caches are this rank's blocks
    (see the module docstring). With ``sp`` (``tensor_parallel.SeqPar``)
    they are this rank's block of the sequence, positions [r * Sb, (r + 1)
    * Sb): the new row lands on the rank whose block holds ``index`` (every
    other rank writes its old row back, all on the device), the rank
    attends over its clamp(index + 1 - r * Sb, 0, Sb) valid rows and
    ``TP.combine_partials`` joins the data group's partials."""
    B = x.shape[0]
    hd = cfg.head_dim
    q = linear(p["wq"], x).reshape(B, 1, -1, hd)
    k = linear(p["wk"], x).reshape(B, 1, -1, hd)
    v = linear(p["wv"], x).reshape(B, 1, -1, hd)
    q, k = gqa_rope(cfg, q, k, positions)
    k, v = k.to(k_cache.dtype), v.to(v_cache.dtype)
    scale = 1.0 / math.sqrt(hd)
    if sp is None:
        row = index.reshape(1).long()

        def core(qr, ka, va):
            return attn_core(qr, ka, va, scale=scale, q_offset=index,
                             kv_valid_len=index + 1,
                             use_pallas=cfg.use_pallas)
    else:
        Sb = k_cache.shape[1]
        local = index - sp.rank * Sb
        row = local.clamp(0, Sb - 1).reshape(1).long()
        mine = (local >= 0) & (local < Sb)
        k = torch.where(mine, k, k_cache.index_select(1, row))
        v = torch.where(mine, v, v_cache.index_select(1, row))
        valid = (local + 1).clamp(0, Sb).to(torch.int32)

        def core(qr, ka, va):
            o, lse = attn_partial(qr, ka, va, valid, scale=scale,
                                  use_pallas=cfg.use_pallas)
            return TP.combine_partials(o, lse, sp).to(qr.dtype)
    k_cache.index_copy_(1, row, k)
    v_cache.index_copy_(1, row, v)
    o = _attend(q, k_cache, v_cache, _kv_split(p, cfg, tp), cfg, tp, core)
    return _out(p, o.reshape(B, 1, -1), tp), k_cache, v_cache


# ================================================================== MLA layer
def init_mla(gen, cfg: ModelConfig, dtype, device, lead=()):
    d, H = cfg.d_model, cfg.num_heads
    nope, rope_d, vdim, r = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                             cfg.v_head_dim, cfg.kv_lora_rank)
    return {
        "wq": init_linear(gen, d, H * (nope + rope_d), dtype, device,
                          lead=lead),
        "w_dkv": init_linear(gen, d, r, dtype, device, lead=lead),
        "w_krope": init_linear(gen, d, rope_d, dtype, device, lead=lead),
        "kv_norm": init_rmsnorm(r, dtype, device, lead),
        "w_uk": init_linear(gen, r, H * nope, dtype, device, lead=lead),
        "w_uv": init_linear(gen, r, H * vdim, dtype, device, lead=lead),
        "wo": init_linear(gen, H * vdim, d, dtype, device, lead=lead,
                          stddev=1.0 / math.sqrt(H * vdim * 2 * cfg.num_layers)),
    }


def _mla_dims(cfg):
    return (cfg.num_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
            cfg.v_head_dim, cfg.kv_lora_rank)


def mla_latents(p, x, cfg: ModelConfig, positions):
    """Compute (c_kv, k_rope) — the quantities MLA caches."""
    B, S, _ = x.shape
    H, nope, rope_d, vdim, r = _mla_dims(cfg)
    c_kv = rmsnorm(p["kv_norm"], linear(p["w_dkv"], x), cfg.norm_eps,
                   cfg.use_pallas)                                  # (B,S,r)
    k_rope = linear(p["w_krope"], x).reshape(B, S, 1, rope_d)
    cos, sin = rope_cos_sin(cfg, positions, rope_d)
    k_rope = apply_rope(k_rope, cos, sin)
    return c_kv, k_rope, (cos, sin)


def mla_full(p, x, cfg: ModelConfig, positions, *, return_kv: bool = False,
             tp=None):
    """Full-sequence MLA (train / prefill). Decompresses K/V explicitly; q
    and k are (B, S, H, nope + rope_d), v (B, S, H, vdim), all contiguous
    (k_rope broadcast to every head by the concatenation). With ``tp`` the
    per-head weights (``wq``, ``w_uk``, ``w_uv``, ``wo``'s rows) are this
    rank's heads; the latents come whole from the replicated ``w_dkv`` and
    ``w_krope`` and enter the per-head products through ``copy_to_tp``."""
    B, S, _ = x.shape
    _, nope, rope_d, vdim, r = _mla_dims(cfg)
    c_kv, k_rope, (cos, sin) = mla_latents(p, x, cfg, positions)
    c_h, k_rope_h, xq = c_kv, k_rope, x
    if tp is not None:
        c_h, k_rope_h, xq = (TP.copy_to_tp(t, tp) for t in (c_kv, k_rope, x))
    q = linear(p["wq"], xq).reshape(B, S, -1, nope + rope_d)
    H = q.shape[2]
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope, cos, sin)
    k_nope = linear(p["w_uk"], c_h).reshape(B, S, H, nope)
    v = linear(p["w_uv"], c_h).reshape(B, S, H, vdim)
    k = torch.cat([k_nope, k_rope_h.expand(B, S, H, rope_d)], -1)
    qf = torch.cat([q_nope, q_rope], -1)
    o = attn_core(qf, k, v, scale=1.0 / math.sqrt(nope + rope_d),
                  use_pallas=cfg.use_pallas).reshape(B, S, H * vdim)
    return _out(p, o, tp), ((c_kv, k_rope[:, :, 0, :]) if return_kv
                            else None)


def mla_decode(p, x, cfg: ModelConfig, positions, ckv_cache, krope_cache,
               index, tp=None):
    """Absorbed-weight MLA decode.

    scores[h, s] = q_nope[h] @ W_uk[h]^T @ c_kv[s]  +  q_rope[h] @ k_rope[s]
    out[h]       = (sum_s w[h,s] c_kv[s]) @ W_uv[h]
    Caches: ckv_cache (B,Smax,r), krope_cache (B,Smax,rope_d); the new rows
    are written in place at ``index`` (a 0-dim int32 tensor on the device).
    Returns (out, ckv_cache, krope_cache). With ``tp`` the per-head weights
    (``wq``, ``w_uk``, ``w_uv``, ``wo``'s rows) are this rank's heads, H
    read off ``wq``'s width; the latents and their caches are whole.
    """
    B = x.shape[0]
    _, nope, rope_d, vdim, r = _mla_dims(cfg)
    c_kv, k_rope, (cos, sin) = mla_latents(p, x, cfg, positions)
    row = index.reshape(1).long()
    ckv_cache.index_copy_(1, row, c_kv.to(ckv_cache.dtype))
    krope_cache.index_copy_(1, row, k_rope[:, :, 0, :].to(krope_cache.dtype))

    q = linear(p["wq"], x).reshape(B, 1, -1, nope + rope_d)
    H = q.shape[2]                        # this rank's heads under tp
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope, cos, sin)
    w_uk = p["w_uk"]["w"].reshape(r, H, nope)
    ckv = ckv_cache.float()
    # absorb: q_lat (B,1,H,r)
    q_lat = torch.einsum("bqhn,rhn->bqhr", q_nope.float(), w_uk.float())
    scale = 1.0 / math.sqrt(nope + rope_d)
    s_lat = torch.einsum("bqhr,bsr->bhqs", q_lat, ckv)
    s_rope = torch.einsum("bqhd,bsd->bhqs", q_rope.float(),
                          krope_cache.float())
    scores = (s_lat + s_rope) * scale
    Sk = ckv_cache.shape[1]
    mask = torch.arange(Sk, device=x.device)[None, None, None, :] < index + 1
    scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    ctx_lat = torch.einsum("bhqs,bsr->bqhr", w, ckv)
    w_uv = p["w_uv"]["w"].reshape(r, H, vdim)
    o = torch.einsum("bqhr,rhv->bqhv", ctx_lat, w_uv.float())
    return _out(p, o.reshape(B, 1, H * vdim).to(x.dtype), tp), ckv_cache, \
        krope_cache
