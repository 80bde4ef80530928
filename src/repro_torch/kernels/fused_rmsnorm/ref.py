"""Plain PyTorch version of fused_rmsnorm: the CPU path of ``ops.rmsnorm``
and the oracle the Triton kernel is held against."""
import torch


def rmsnorm_ref(x, w, *, eps: float = 1e-6):
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * (1.0 + w.float())).to(x.dtype)
