"""Fused RMSNorm as a Triton kernel for Hopper.

Replaces the TPU kernel ``repro/kernels/fused_rmsnorm/fused_rmsnorm.py``
(``_rmsnorm_kernel`` / ``fused_rmsnorm``): row-wise
``x * rsqrt(mean(x^2) + eps) * (1 + w)`` in f32, output in x's dtype. It is a
one-pass row reduction plus an elementwise scale, bound by bytes with no
tensor-core work, so one program handles one row held whole in registers
(``BLOCK`` = next power of two of d, masked): one read and one write per
element. ``triton`` is imported, and the kernel defined, at the first launch,
so the module imports where Triton is absent.
"""
from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=None)
def _kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def rmsnorm_kernel(x_ptr, w_ptr, o_ptr, x_row_stride, o_row_stride, d,
                       eps, BLOCK: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        cols = tl.arange(0, BLOCK)
        mask = cols < d
        x = tl.load(x_ptr + row * x_row_stride + cols, mask=mask,
                    other=0.0).to(tl.float32)
        var = tl.sum(x * x, axis=0) / d
        y = x * tl.rsqrt(var + eps)
        w = tl.load(w_ptr + cols, mask=mask, other=0.0).to(tl.float32)
        y = y * (1.0 + w)
        tl.store(o_ptr + row * o_row_stride + cols,
                 y.to(o_ptr.dtype.element_ty), mask=mask)

    return rmsnorm_kernel, triton.next_power_of_2


def fused_rmsnorm(x2: torch.Tensor, w: torch.Tensor, out: torch.Tensor,
                  eps: float) -> None:
    """x2, out (rows, d) with a contiguous last dim; w (d,) contiguous."""
    kernel, next_pow2 = _kernel()
    rows, d = x2.shape
    block = next_pow2(d)
    num_warps = min(max(block // 512, 1), 16)
    kernel[(rows,)](x2, w, out, x2.stride(0), out.stride(0), d, eps,
                    BLOCK=block, num_warps=num_warps)
