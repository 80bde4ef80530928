"""Shared layer primitives: norms, linears, embeddings, positional encodings.

Plain functions on tensors, as in the JAX package: params are nested dicts of
tensors, every ``init_*`` returns such a dict, every apply is a function of
(params, inputs). Linear weights are ``(d_in, d_out)`` so ``x @ w`` means the
same as in JAX. ``embed``, ``unembed`` and ``mlp`` take ``tp``, the model
group of a tensor-parallel step (``distributed/tensor_parallel.py``); with
``tp=None`` they are the one-rank code. Every ``init_*`` draws from an
explicit ``torch.Generator`` and creates its tensors on ``device``; ``lead``
prepends dims, which is how ``model.init_params`` builds the stacked
per-layer leaves in one draw.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.kernels.fused_rmsnorm import ops as rn_ops


# A leaf of more than _DRAW_WHOLE elements is drawn in f32 a slice of dim 0
# of at most _DRAW_SLICE elements at a time: the f32 draw of phi3.5-moe's
# stacked experts at 32 layers (54 GB) would not fit beside the leaf on one
# card. Every leaf of a model one card holds is smaller, and is drawn whole:
# a slice draws other values from the generator than the whole draw.
_DRAW_WHOLE, _DRAW_SLICE = 1 << 33, 1 << 28
_drawn = threading.local()     # .fn: ``drawn_leaves``'s, on this thread


@contextlib.contextmanager
def drawn_leaves(fn):
    """Within, on this thread: every leaf ``truncated_normal_init`` draws
    is replaced by ``fn(leaf)`` (``tensor_parallel.ParamLayout.init_params``
    keeps this rank's block of each one as it is drawn)."""
    before = getattr(_drawn, "fn", None)
    _drawn.fn = fn
    try:
        yield
    finally:
        _drawn.fn = before


def truncated_normal_init(gen: torch.Generator, shape, stddev: float, dtype,
                          device) -> torch.Tensor:
    """N(0, stddev^2) truncated at +-2 stddev, drawn in f32, cast to dtype
    (above ``_DRAW_WHOLE`` elements, a slice of dim 0 at a time)."""
    shape = tuple(shape)
    row = math.prod(shape[1:])
    if not shape or math.prod(shape) <= _DRAW_WHOLE:
        t = torch.empty(shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(t, 0.0, stddev, -2.0 * stddev,
                                    2.0 * stddev, generator=gen)
        t = t.to(dtype)
    else:
        t = torch.empty(shape, dtype=dtype, device=device)
        step = max(1, _DRAW_SLICE // max(row, 1))
        for i in range(0, shape[0], step):
            part = torch.empty((min(step, shape[0] - i), *shape[1:]),
                               dtype=torch.float32, device=device)
            torch.nn.init.trunc_normal_(part, 0.0, stddev, -2.0 * stddev,
                                        2.0 * stddev, generator=gen)
            t[i:i + part.shape[0]] = part
            del part
    fn = getattr(_drawn, "fn", None)
    return t if fn is None else fn(t)


def init_linear(gen, d_in: int, d_out: int, dtype, device, *, bias: bool = False,
                stddev: Optional[float] = None, lead: Tuple[int, ...] = ()):
    stddev = stddev if stddev is not None else 1.0 / math.sqrt(d_in)
    p = {"w": truncated_normal_init(gen, (*lead, d_in, d_out), stddev, dtype,
                                    device)}
    if bias:
        p["b"] = torch.zeros((*lead, d_out), dtype=dtype, device=device)
    return p


def linear(p, x):
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


# --------------------------------------------------------------------------- norm
def init_rmsnorm(d: int, dtype, device, lead: Tuple[int, ...] = ()):
    # stored as (w - 1): apply uses 1 + w
    return {"scale": torch.zeros((*lead, d), dtype=dtype, device=device)}


def rmsnorm(p, x, eps: float, use_pallas: bool = False, *, gate=None):
    """RMSNorm with (1 + w) parametrization (covers both llama & gemma styles:
    llama-style init w=1 is stored as scale=0). With ``gate`` it normalizes
    ``x * silu(gate)`` (the Mamba2 block's gated norm). ``use_pallas`` routes
    it through the fused kernel, which computes the same function."""
    if use_pallas:
        return rn_ops.rmsnorm(x, p["scale"], eps=eps, gate=gate)
    if gate is not None:
        x = x * F.silu(gate)
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + p["scale"].float())).to(dt)


# ---------------------------------------------------------------------- embedding
def init_embedding(gen, vocab: int, d: int, dtype, device):
    # 1/sqrt(d): keeps tied-unembedding logits O(1); gemma's sqrt(d) input
    # scaling (below) restores unit-variance embeddings where the arch wants it
    return {"table": truncated_normal_init(gen, (vocab, d), 1.0 / math.sqrt(d),
                                           dtype, device)}


def embed(p, tokens, cfg: ModelConfig, tp=None):
    """Token embeddings; with ``tp`` (``tensor_parallel.TP``) the table is
    this rank's rows of the vocabulary (the vocab-parallel lookup)."""
    x = (F.embedding(tokens, p["table"]) if tp is None
         else TP.vocab_embed(p["table"], tokens, tp))
    if cfg.gemma_norm:
        # the scale is rounded to x's dtype first, as in the JAX package
        x = x * torch.full((), math.sqrt(cfg.d_model), dtype=x.dtype,
                           device=x.device)
    return x


def unembed(p, x, cfg: ModelConfig, tp=None):
    """Project to (padded) vocab logits. ``p`` is the embedding table when
    tied. With ``tp`` the weights are this rank's vocab columns (rows of a
    tied table), and so are the logits; where the group's ranks hold other
    rows of the batch (``tp.split_rows``) they are the logits of the
    group's rows, gathered in rank order."""
    if tp is not None:
        x = TP.gather_rows(x, tp) if tp.split_rows else TP.copy_to_tp(x, tp)
    return x @ p["table"].T if "table" in p else x @ p["w"]


# --------------------------------------------------------------------------- RoPE
def _rope_angles(positions, inv_freq):
    """positions (..., S) int -> angles (..., S, dim/2) f32."""
    return positions.float()[..., None] * inv_freq


def rope_cos_sin(cfg: ModelConfig, positions: torch.Tensor, rot_dim: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables.

    positions: (B, S) for full/partial RoPE; (3, B, S) for M-RoPE (t, h, w
    streams, qwen2-vl style).
    Returns cos, sin of shape (B, S, rot_dim // 2), float32.
    """
    half = rot_dim // 2
    inv_freq = 1.0 / (cfg.rope_theta ** (
        torch.arange(0, half, dtype=torch.float32, device=positions.device)
        / half))
    if cfg.rope_kind == "mrope":
        if positions.ndim != 3:
            raise ValueError("mrope needs (3, B, S) position streams")
        sections = cfg.mrope_sections
        if sum(sections) != half:
            raise ValueError(f"mrope sections {sections} do not sum to {half}")
        parts = []
        start = 0
        for stream, sec in enumerate(sections):
            parts.append(_rope_angles(positions[stream],
                                      inv_freq[start:start + sec]))
            start += sec
        ang = torch.cat(parts, dim=-1)                   # (B, S, half)
    else:
        ang = _rope_angles(positions, inv_freq)          # (B, S, half)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """NeoX-style rotate-half on the leading ``2 * cos.shape[-1]`` channels of x.

    x: (B, S, H, hd); cos/sin: (B, S, half). Channels beyond rot_dim pass through
    (partial RoPE, chatglm/stablelm style).
    """
    half = cos.shape[-1]
    rot_dim = 2 * half
    x_rot, x_pass = x[..., :rot_dim], x[..., rot_dim:]
    x1, x2 = x_rot[..., :half], x_rot[..., half:]
    c = cos[:, :, None, :].float()
    s = sin[:, :, None, :].float()
    x1f, x2f = x1.float(), x2.float()
    out = torch.cat([x1f * c - x2f * s, x2f * c + x1f * s], dim=-1).to(x.dtype)
    if x_pass.shape[-1]:
        out = torch.cat([out, x_pass], dim=-1)
    return out


def rot_dim_for(cfg: ModelConfig, head_dim: int) -> int:
    if cfg.rope_kind == "none":
        return 0
    if cfg.rope_kind == "partial":
        rd = int(cfg.rotary_pct * head_dim)
        return rd - (rd % 2)
    return head_dim


# --------------------------------------------------------------- sinusoidal (musicgen)
def sinusoidal_pos_embed(positions: torch.Tensor, d_model: int, dtype
                         ) -> torch.Tensor:
    """positions (B, S) -> (B, S, d_model), classic transformer sin/cos."""
    half = d_model // 2
    freq = torch.exp(-math.log(10000.0)
                     * torch.arange(half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions.float()[..., None] * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


# --------------------------------------------------------------------------- MLP
def init_mlp(gen, cfg: ModelConfig, d_ff: int, dtype, device,
             lead: Tuple[int, ...] = ()):
    p = {"w_in": init_linear(gen, cfg.d_model, d_ff, dtype, device, lead=lead),
         "w_out": init_linear(gen, d_ff, cfg.d_model, dtype, device, lead=lead)}
    if cfg.gated_mlp:
        p["w_gate"] = init_linear(gen, cfg.d_model, d_ff, dtype, device,
                                  lead=lead)
    return p


def _act(name: str, x):
    if name == "silu":
        return F.silu(x)
    if name == "gelu":
        return F.gelu(x, approximate="tanh")
    raise ValueError(name)


def mlp_hidden(p, x, cfg: ModelConfig):
    """The MLP's activation, before its out-projection."""
    h = linear(p["w_in"], x)
    if cfg.gated_mlp:
        h = _act(cfg.act, linear(p["w_gate"], x)) * h
    else:
        h = _act(cfg.act, h)
    return h


def mlp(p, x, cfg: ModelConfig, tp=None):
    """With ``tp``: ``w_in``/``w_gate`` column-parallel (this rank's ffn
    columns), ``w_out`` row-parallel, its partial sums reduced."""
    if tp is None:
        return linear(p["w_out"], mlp_hidden(p, x, cfg))
    return TP.row_parallel(p["w_out"], mlp_hidden(p, TP.copy_to_tp(x, tp),
                                                  cfg), tp)
