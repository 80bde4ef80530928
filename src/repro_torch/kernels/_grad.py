"""The routing that the training path's kernel wrappers share (flash
attention, RMSNorm, the SSD scan), and the gradient their kernels get.

A CPU tensor takes the kernel's plain PyTorch version; a tensor on
``KERNEL_DEVICE`` launches the kernel or raises. The reference's Pallas
kernels have no backward; of these CUDA kernels flash attention has one, at
the dtype and widths it is built for (``flash_attention.ops.FlashAttention``,
handed to ``call`` as ``vjp``). Elsewhere, where a gradient is asked (grad
mode on and an input requiring grad), the launch runs inside ``PlainVJP``,
an ``autograd.Function`` whose forward launches the kernel and whose
backward is the vector-Jacobian product of the plain version, recomputed
from the saved inputs. Without grad the launch is called directly, with no
``Function`` around it.
"""
from __future__ import annotations

import torch

# the device type whose tensors launch the kernels (the CPU tests set "cpu",
# with each launch played by its plain version)
KERNEL_DEVICE = "cuda"


def call(launch, plain, *inputs, vjp=None, **static):
    """``plain(*inputs, **static)`` on CPU tensors, else ``launch`` with the
    same arguments, under ``PlainVJP`` where a gradient is asked, or
    ``vjp(*inputs, **static)`` there where given (a route with a backward of
    its own). ``inputs`` are tensors (or None, for an absent optional one),
    the first deciding the device; ``static`` holds the rest, passed as
    keywords."""
    dev = inputs[0].device.type
    if dev != KERNEL_DEVICE:
        if dev == "cpu":
            return plain(*inputs, **static)
        raise ValueError(f"the kernels run on cpu or cuda tensors, not "
                         f"{inputs[0].device}")
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in inputs):
        if vjp is not None:
            return vjp(*inputs, **static)
        return PlainVJP.apply(launch, plain, static, *inputs)
    return launch(*inputs, **static)


class PlainVJP(torch.autograd.Function):
    """The kernel forward; the backward is the vjp of the plain version.
    Where the kernel returns a tuple, only its first output is
    differentiated: a gradient asked of another (the SSD scan's final
    state) raises."""

    @staticmethod
    def forward(ctx, launch, plain, static, *inputs):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*inputs)
        ctx.plain, ctx.static = plain, static
        return launch(*inputs, **static)

    @staticmethod
    def backward(ctx, grad, *rest):
        if any(g is not None for g in rest):
            raise NotImplementedError(
                "only a kernel's first output has a gradient; the SSD "
                "kernel's final state has none (use_pallas=False "
                "differentiates it)")
        need = ctx.needs_input_grad[3:]
        if grad is None:
            return (None,) * (3 + len(need))
        inputs = [None if t is None else t.detach().requires_grad_(r)
                  for t, r in zip(ctx.saved_tensors, need)]
        with torch.enable_grad():
            out = ctx.plain(*inputs, **ctx.static)
        if isinstance(out, tuple):
            out = out[0]
        grads = iter(torch.autograd.grad(
            out, [t for t, r in zip(inputs, need) if r], grad))
        return (None, None, None, *(next(grads) if r else None for r in need))
