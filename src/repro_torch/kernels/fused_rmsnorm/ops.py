"""RMSNorm with the (1 + w) parametrization, fused into one pass per row.

Replaces the TPU kernel ``repro/kernels/fused_rmsnorm/fused_rmsnorm.py``
(``_rmsnorm_kernel`` / ``fused_rmsnorm``) and its shim ``ops.py``. On the H100
it is bound by bytes: each element is read once and written once by the
Triton kernel in ``fused_rmsnorm.py``, with the row sum in f32.

A CPU tensor takes the plain version (``ref.rmsnorm_ref``); a CUDA tensor
launches the kernel or raises. ``launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from . import ref
from .fused_rmsnorm import fused_rmsnorm

launches = 0

_DTYPES = (torch.float32, torch.bfloat16)


def rmsnorm(x, w, *, eps: float = 1e-6):
    """x (..., d), w (d,) -> x's shape and dtype."""
    global launches
    if x.device.type == "cpu":
        return ref.rmsnorm_ref(x, w, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm runs on cpu or cuda, not {x.device}")
    if w.device != x.device:
        raise ValueError("x and w must be on one device")
    if x.dtype not in _DTYPES or w.dtype not in _DTYPES:
        raise TypeError(f"rmsnorm takes float32 or bfloat16, got {x.dtype}, "
                        f"{w.dtype}")
    d = x.shape[-1]
    if w.shape != (d,) or not w.is_contiguous():
        raise ValueError(f"w must be a contiguous ({d},) vector, got "
                         f"{tuple(w.shape)}")
    if not x.is_contiguous():
        raise ValueError("rmsnorm takes a contiguous x")
    x2 = x.view(-1, d)
    out = torch.empty_like(x2)
    fused_rmsnorm(x2, w, out, float(eps))
    launches += 1
    return out.view(x.shape)
