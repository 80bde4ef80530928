"""Mamba2 (SSD) block: projections, causal depthwise convs, SSD scan, gated
RMSNorm, output projection. Full-sequence (train/prefill) and single-step
(decode) paths share parameters.

As in the JAX package, z/x/B/C/dt use separate projection matrices and
x/B/C separate depthwise convs: mathematically the fused in_proj/conv of the
reference implementation, since depthwise convs are per channel.

Under ``cfg.use_pallas`` the prefill scan runs the CUDA SSD kernel and the
gated norm ``rmsnorm(y * silu(z))`` the RMSNorm kernel with its gate fused in
(one pass at width d_inner, in prefill and decode); decode runs the plain
``ssd_step``, as the JAX package does. ``mamba2_decode`` writes the conv
windows and the state into the caller's cache tensors in place, as the
attention decode writes its K/V rows.

Tensor parallelism (``tp`` of ``mamba2_full`` and ``mamba2_decode``)
splits a layer's heads over the model group, as the JAX package's tp16
specs split ``d_inner``: ``wz``, ``wx``, ``conv_x``, the gated norm's scale
and ``w_out``'s rows are this rank's blocks. B, C and dt are computed whole
on every rank (their projections and convs are whole) and enter the split
scan through ``copy_to_tp``, and so do the per-head leaves ``A_log``, ``D``
and ``dt_bias``: each rank's gradient of them is the whole one. The gated
norm's row sum crosses the ranks (``tensor_parallel.split_rmsnorm``, at a
decode step on (B, d_inner / n) rows) and the out-projection is
row-parallel. The widths are read off the weights. The cache is this
rank's block by ``sharding.cache_pspec``: ``conv_x``'s window and the
state of its heads, ``conv_B``/``conv_C`` whole.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd.ref import ssd_step
from repro_torch.models import layers as L


def init_mamba2(gen, cfg: ModelConfig, dtype, device, lead=()):
    """The JAX package's distributions (``init_mamba2``): dt_bias is the
    inverse softplus of dt ~ logUniform[1e-3, 0.1], A_log = log U[1, 16],
    conv weights N(0, 1/K) untruncated, w_out's std 1/sqrt(2 d_inner L)."""
    d, di = cfg.d_model, cfg.ssm_d_inner
    H, G, N, K = cfg.ssm_heads, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_conv

    def uniform(lo, hi):
        t = torch.empty((*lead, H), dtype=torch.float32, device=device)
        return t.uniform_(lo, hi, generator=gen)

    def conv(channels):
        t = torch.empty((*lead, K, channels), dtype=torch.float32,
                        device=device)
        return (t.normal_(generator=gen) / math.sqrt(K)).to(dtype)

    dt_init = torch.exp(uniform(math.log(1e-3), math.log(0.1)))
    dt_bias = dt_init + torch.log(-torch.expm1(-dt_init))
    A_log = torch.log(uniform(1.0, 16.0))
    return {
        "wz": L.init_linear(gen, d, di, dtype, device, lead=lead),
        "wx": L.init_linear(gen, d, di, dtype, device, lead=lead),
        "wB": L.init_linear(gen, d, G * N, dtype, device, lead=lead),
        "wC": L.init_linear(gen, d, G * N, dtype, device, lead=lead),
        "wdt": L.init_linear(gen, d, H, dtype, device, lead=lead),
        "conv_x": conv(di),
        "conv_B": conv(G * N),
        "conv_C": conv(G * N),
        "A_log": A_log,
        "D": torch.ones((*lead, H), dtype=torch.float32, device=device),
        "dt_bias": dt_bias,
        "norm": L.init_rmsnorm(di, dtype, device, lead),
        "w_out": L.init_linear(gen, di, d, dtype, device, lead=lead,
                               stddev=1.0 / math.sqrt(di * 2 * cfg.num_layers)),
    }


def causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x (B, S, C), w (K, C) -> (B, S, C)."""
    K = w.shape[0]
    S = x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    y = torch.zeros_like(x)
    for k in range(K):
        y = y + w[k] * xp[:, k:k + S]
    return y


def causal_conv_step(x_t: torch.Tensor, w: torch.Tensor, cache: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x_t (B, C), cache (B, K-1, C) of previous inputs -> (y_t, new window
    (B, K-1, C)). The new window is a new tensor; ``cache`` is not written."""
    window = torch.cat([cache, x_t[:, None, :]], dim=1)           # (B,K,C)
    y = torch.einsum("bkc,kc->bc", window, w)
    return y, window[:, 1:, :]


def _ssd_dispatch(cfg: ModelConfig, x4, dt, A, B4, C4):
    return ssd_ops.ssd(x4, dt, A, B4, C4, chunk=cfg.ssm_chunk,
                       use_pallas=cfg.use_pallas, precision=cfg.ssd_precision)


def mamba2_full(p, x, cfg: ModelConfig, *, return_cache: bool = False,
                tp=None):
    """Full-sequence SSD block. x (B, S, d) -> (y, cache or None). With
    ``tp`` (``tensor_parallel.TP``) the weights are this rank's and so is
    the cache (see the module docstring)."""
    B, S, _ = x.shape
    P, G, N, K = (cfg.ssm_head_dim, cfg.ssm_groups, cfg.ssm_state,
                  cfg.ssm_conv)
    # the split products read x through copy_to_tp; B, C and dt read it
    # whole (their gradient of x is whole on every rank already)
    xs = x if tp is None else TP.copy_to_tp(x, tp)
    z = L.linear(p["wz"], xs)
    xin_raw = L.linear(p["wx"], xs)
    B_raw = L.linear(p["wB"], x)
    C_raw = L.linear(p["wC"], x)
    dt_raw = L.linear(p["wdt"], x)

    xin = F.silu(causal_conv(xin_raw, p["conv_x"]))
    Bc = F.silu(causal_conv(B_raw, p["conv_B"]))
    Cc = F.silu(causal_conv(C_raw, p["conv_C"]))
    dt = F.softplus(dt_raw.float() + p["dt_bias"])

    di = xin.shape[-1]                    # this rank's columns of d_inner
    H = di // P
    x4 = xin.reshape(B, S, H, P)
    B4 = Bc.reshape(B, S, G, N)
    C4 = Cc.reshape(B, S, G, N)
    A_log, D = p["A_log"], p["D"]
    if tp is not None:                    # this rank's heads of the whole
        dt, A_log, D, B4, C4 = _local_heads(dt, A_log, D, B4, C4, H, cfg, tp)
    A = -torch.exp(A_log)

    y4, h_final = _ssd_dispatch(cfg, x4, dt, A, B4, C4)
    y4 = y4 + (D[None, None, :, None] * x4.float()).to(y4.dtype)

    y = y4.reshape(B, S, di)
    if tp is None:
        y = L.rmsnorm(p["norm"], y, cfg.norm_eps, cfg.use_pallas, gate=z)
        out = L.linear(p["w_out"], y)
    else:
        y = TP.split_rmsnorm(p["norm"], y, z, cfg.norm_eps, cfg.use_pallas,
                             tp)
        out = TP.row_parallel(p["w_out"], y, tp)

    cache = None
    if return_cache:
        cache = {"conv_x": _tail(xin_raw, K - 1),
                 "conv_B": _tail(B_raw, K - 1),
                 "conv_C": _tail(C_raw, K - 1),
                 "state": h_final}
    return out, cache


def _local_heads(dt, A_log, D, B4, C4, H: int, cfg: ModelConfig, tp):
    """This rank's ``H`` heads of the per-head values whole on every rank
    (dt, A_log, D along their last dim) and the B/C groups they read
    (``tensor_parallel.local_kv`` on (B, S, G, N))."""
    dt, A_log, D = (TP.local_heads(t, -1, H, tp) for t in (dt, A_log, D))
    B4, C4 = TP.local_kv(B4, C4, H, cfg.ssm_heads // cfg.ssm_groups, tp)
    return dt, A_log, D, B4, C4


def _tail(t: torch.Tensor, n: int) -> torch.Tensor:
    """Last n positions along axis 1, left-padded with zeros if S < n; a copy,
    so the cache does not keep the whole projection alive."""
    S = t.shape[1]
    if S >= n:
        return t[:, S - n:, :].clone()
    return F.pad(t, (0, 0, n - S, 0))


def mamba2_decode(p, x, cfg: ModelConfig, cache, tp=None):
    """Single-token decode. x (B, 1, d), cache dict -> (y (B,1,d), cache),
    with the cache's conv windows and state written in place. With ``tp``
    the weights and the cache are this rank's (see the module docstring)."""
    B = x.shape[0]
    P, G, N = cfg.ssm_head_dim, cfg.ssm_groups, cfg.ssm_state
    xt = x[:, 0, :]
    z = L.linear(p["wz"], xt)
    xin_raw = L.linear(p["wx"], xt)
    B_raw = L.linear(p["wB"], xt)
    C_raw = L.linear(p["wC"], xt)
    dt_raw = L.linear(p["wdt"], xt)

    xin, conv_x = causal_conv_step(xin_raw, p["conv_x"], cache["conv_x"])
    Bc, conv_B = causal_conv_step(B_raw, p["conv_B"], cache["conv_B"])
    Cc, conv_C = causal_conv_step(C_raw, p["conv_C"], cache["conv_C"])
    xin, Bc, Cc = F.silu(xin), F.silu(Bc), F.silu(Cc)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])

    di = xin.shape[-1]                    # this rank's columns of d_inner
    H = di // P
    A_log, D = p["A_log"], p["D"]
    B3, C3 = Bc.reshape(B, 1, G, N), Cc.reshape(B, 1, G, N)
    if tp is not None:                    # this rank's heads of the whole
        dt, A_log, D, B3, C3 = _local_heads(dt, A_log, D, B3, C3, H, cfg, tp)
    A = -torch.exp(A_log)
    y3, h = ssd_step(xin.reshape(B, H, P), dt, A, B3[:, 0], C3[:, 0],
                     cache["state"])
    y3 = y3 + (D[None, :, None] * xin.reshape(B, H, P).float()).to(y3.dtype)
    y = y3.reshape(B, di)
    if tp is None:
        y = L.rmsnorm(p["norm"], y, cfg.norm_eps, cfg.use_pallas, gate=z)
        out = L.linear(p["w_out"], y)
    else:
        y = TP.split_rmsnorm(p["norm"], y, z, cfg.norm_eps, cfg.use_pallas,
                             tp)
        out = TP.row_parallel(p["w_out"], y, tp)
    out = out[:, None, :]
    for name, new in (("conv_x", conv_x), ("conv_B", conv_B),
                      ("conv_C", conv_C), ("state", h)):
        cache[name].copy_(new)
    return out, cache
