"""Plain PyTorch versions of the Mamba2 SSD (state-space duality) scan: the
CPU path of ``ops.ssd``, the plain model path, and the oracles the CUDA
kernel is held against.

``ssd_naive``   the per-timestep linear recurrence (the ground truth).
``ssd_chunked`` the SSD blocked algorithm (arXiv:2405.21060 section 6).
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
