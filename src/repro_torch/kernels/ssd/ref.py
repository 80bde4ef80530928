"""Plain PyTorch versions of the Mamba2 SSD (state-space duality) scan: the
CPU path of ``ops.ssd``, the plain model path, and the oracles the CUDA
kernel is held against.

``ssd_naive``   the per-timestep linear recurrence (the ground truth).
``ssd_chunked`` the SSD blocked algorithm (arXiv:2405.21060 section 6).
``ssd_chunked_tc`` the same algorithm at the bf16 tensor-core kernel's
                rounding points (the plain version of that kernel).
``ssd_step``    one decode step of the recurrence.

Shapes (G = #B/C groups, heads map to groups by h // (H // G)):
  x  (B, S, H, P)   dt (B, S, H)  [post-softplus, > 0]
  A  (H,)           [negative]
  Bm (B, S, G, N)   Cm (B, S, G, N)
  h0 (B, H, P, N)   [optional initial state]
returns y (B, S, H, P) in x's dtype, h_final (B, H, P, N) in f32.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def _expand_groups(t: torch.Tensor, H: int) -> torch.Tensor:
    """(B, S, G, N) -> (B, S, H, N) by repeating each group H//G times."""
    return torch.repeat_interleave(t, H // t.shape[2], dim=2)


def ssd_naive(x, dt, A, Bm, Cm, h0: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    Bh = _expand_groups(Bm, H).float()
    Ch = _expand_groups(Cm, H).float()
    xf, dtf, Af = x.float(), dt.float(), A.float()
    h = (torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    ys = []
    for t in range(S):
        dA = torch.exp(dtf[:, t] * Af)                         # (B,H)
        h = h * dA[..., None, None] + (dtf[:, t, :, None, None]
                                       * xf[:, t, :, :, None]
                                       * Bh[:, t, :, None, :])
        ys.append(torch.einsum("bhpn,bhn->bhp", h, Ch[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype), h


def ssd_chunked(x, dt, A, Bm, Cm, *, chunk: int = 256,
                h0: Optional[torch.Tensor] = None,
                precision: str = "highest"
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """precision='highest': all math in f32. 'mixed': decay / cumsum / state
    stay f32, but the operands of the large products (C B^T, att @ x) are
    rounded to the input dtype, as in the JAX package; the products still
    accumulate in f32 (JAX's ``preferred_element_type``)."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    L = min(chunk, S)
    pad = (-S) % L
    if pad:          # dt = 0 rows: exp(0 * A) = 1 and B = 0, so no-ops
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
    Sp = S + pad
    nc = Sp // L
    mm_dtype = torch.float32 if precision == "highest" else x.dtype

    def mm(t):                                      # a product operand
        return t.to(mm_dtype).float()

    xf = mm(x).reshape(B, nc, L, H, P)
    dtf = dt.float().reshape(B, nc, L, H)
    Bh = mm(_expand_groups(Bm, H)).reshape(B, nc, L, H, N)
    Ch = mm(_expand_groups(Cm, H)).reshape(B, nc, L, H, N)
    Af = A.float()

    dA = dtf * Af                                   # (B,nc,L,H), negative
    cum = torch.cumsum(dA, dim=2)                   # inclusive, within chunk

    # ---- intra-chunk: att[i, j] = C_i . B_j * exp(cum_i - cum_j) * dt_j, j <= i
    cb = torch.einsum("bclhn,bcshn->bchls", Ch, Bh)           # (B,nc,H,L,L)
    cum_t = cum.permute(0, 1, 3, 2)                           # (B,nc,H,L)
    causal = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
    # the exponent is clamped to 0 above the diagonal, where it is positive
    # and would overflow; those entries are dropped by the select anyway
    diff = (cum_t[..., :, None] - cum_t[..., None, :]).masked_fill(~causal, 0.0)
    att = torch.where(causal, cb * torch.exp(diff), 0.0)
    att = att * dtf.permute(0, 1, 3, 2)[:, :, :, None, :]     # * dt_j
    y_intra = torch.einsum("bchls,bcshp->bclhp", mm(att), xf)

    # ---- chunk summaries -> inter-chunk recurrence
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)         # (B,nc,L,H)
    Sc = torch.einsum("bclh,bclhn,bclhp->bchpn",
                      mm(decay_to_end * dtf), Bh, xf)
    Gam = torch.exp(cum[:, :, -1, :])                         # (B,nc,H)

    h = (torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    h_prev = []
    for c in range(nc):                             # emit the state *before* chunk c
        h_prev.append(h)
        h = h * Gam[:, c, :, None, None] + Sc[:, c]
    h_prev = torch.stack(h_prev, dim=1)                       # (B,nc,H,P,N)

    # ---- inter-chunk output: y_i += C_i . (exp(cum_i) * h_prev)
    y_inter = torch.einsum("bclhn,bchpn,bclh->bclhp", Ch, h_prev,
                           torch.exp(cum))

    y = (y_intra + y_inter).reshape(B, Sp, H, P)[:, :S].to(x.dtype)
    return y, h


def ssd_chunked_tc(x, dt, A, Bm, Cm, *, chunk: int = 256
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The bf16 CUDA kernel's arithmetic (``csrc/ssd.cu``, ``ssd_fwd_mma``).

    Products take bf16 operands and sum in f32, as ``precision="mixed"``:
    C B^T of the bf16 inputs; att = select(j <= i, C B^T exp(cum_i - cum_j)
    dt_j) rounded to bf16 before att . x. Below the 16-row diagonal tiles
    the kernel takes exp(cum_i - cum_j) dt_j as exp(cum_i - cum_q) times
    exp(cum_q - cum_j) dt_j, q = j | 15 the last row of j's tile (both
    factors at most 1). It differs from "mixed" in the state terms, which
    run on the tensor cores too:
      y_i   += exp(cum_i) C_i . bf16(state)^T, the f32 state rounded
               once per chunk for the product (it carries on in f32);
      state  = exp(cum_last) state + sum_j x_j (x) bf16(w_j B_j),
               w_j = exp(cum_last - cum_j) dt_j, rounded once with B_j
    (mixed rounds w_j alone). The prefix sum cum is f64 within the chunk, and
    the exponents are (hi_i - hi_j) + (lo_i - lo_j) of cum split into two
    f32 parts. x, B and C are taken as they are (bf16 in the kernel).
    """
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    L = min(chunk, S)
    pad = (-S) % L
    if pad:          # dt = 0 rows: exp(0 * A) = 1 and B = 0, so no-ops
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
    nc = (S + pad) // L

    def bf16(t):
        return t.to(torch.bfloat16).float()

    xf = x.float().reshape(B, nc, L, H, P)
    dtf = dt.float().reshape(B, nc, L, H)
    Bh = _expand_groups(Bm, H).float().reshape(B, nc, L, H, N)
    Ch = _expand_groups(Cm, H).float().reshape(B, nc, L, H, N)
    cum = torch.cumsum((dtf * A.float()).double(), dim=2)      # f64
    hi = cum.float()
    lo = (cum - hi.double()).float()
    causal = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
    row = torch.arange(L, device=x.device)
    below = (row[:, None] // 16) > (row[None, :] // 16)       # [i, j]
    q = torch.clamp(row | 15, max=L - 1)        # last row of j's 16-row tile

    def t(u):                                   # (B, L, H) -> (B, H, L)
        return u.permute(0, 2, 1)

    h = torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for c in range(nc):
        xc, Bc, Cc = xf[:, c], Bh[:, c], Ch[:, c]               # (B,L,H,.)
        hi_c, lo_c, dt_c = t(hi[:, c]), t(lo[:, c]), t(dtf[:, c])
        cum_c = t(cum[:, c])
        ex = ((hi_c[..., :, None] - hi_c[..., None, :])
              + (lo_c[..., :, None] - lo_c[..., None, :]))
        ex_q = ((hi_c[..., :, None] - hi_c[..., None, q])
                + (lo_c[..., :, None] - lo_c[..., None, q]))
        v = torch.exp((cum_c[..., q] - cum_c).float()) * dt_c
        cb = torch.einsum("blhn,bshn->bhls", Cc, Bc)
        att = torch.where(
            below, cb * (torch.exp(ex_q.masked_fill(~below, 0.0))
                         * v[..., None, :]),
            torch.where(causal, cb * torch.exp(ex.masked_fill(~causal, 0.0))
                        * dt_c[..., None, :], 0.0))
        y = torch.einsum("bhls,bshp->blhp", bf16(att), xc)
        y = y + (torch.einsum("blhn,bhpn->blhp", Cc, bf16(h))
                 * torch.exp(hi[:, c])[..., None])
        ys.append(y)
        clast = cum[:, c, -1]                                   # (B, H)
        w = torch.exp((clast[:, None] - cum[:, c]).float()) * dtf[:, c]
        h = (h * torch.exp(clast.float())[..., None, None]
             + torch.einsum("blhp,blhn->bhpn", xc, bf16(w[..., None] * Bc)))
    y = torch.stack(ys, dim=1).reshape(B, nc * L, H, P)[:, :S]
    return y.to(x.dtype), h


def ssd_step(x_t, dt_t, A, B_t, C_t, h):
    """Single decode step.

    x_t (B,H,P), dt_t (B,H), B_t/C_t (B,G,N), h (B,H,P,N) -> (y (B,H,P), h')
    """
    H, G = x_t.shape[1], B_t.shape[1]
    Bh = torch.repeat_interleave(B_t, H // G, dim=1).float()
    Ch = torch.repeat_interleave(C_t, H // G, dim=1).float()
    dtf = dt_t.float()
    dA = torch.exp(dtf * A.float())
    h = (h.float() * dA[..., None, None]
         + dtf[..., None, None] * x_t.float()[..., None] * Bh[:, :, None, :])
    y = torch.einsum("bhpn,bhn->bhp", h, Ch)
    return y.to(x_t.dtype), h
