"""Plain PyTorch version of fused_rmsnorm: the CPU path of ``ops.rmsnorm``
and the oracle the CUDA kernel is held against."""
import torch
import torch.nn.functional as F


def rmsnorm_ref(x, w, *, eps: float = 1e-6, gate=None):
    """x * rsqrt(mean(x^2) + eps) * (1 + w) in f32, out in x's dtype. With
    ``gate`` it normalizes ``x * F.silu(gate)``, computed in x's dtype."""
    if gate is not None:
        x = x * F.silu(gate)
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * (1.0 + w.float())).to(x.dtype)
