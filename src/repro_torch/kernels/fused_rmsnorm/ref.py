"""Plain PyTorch version of fused_rmsnorm: the CPU path of ``ops.rmsnorm``
and ``ops.row_sumsq``, and the oracle the CUDA kernels are held against."""
import torch
import torch.nn.functional as F


def _gated(x, gate):
    """``x * F.silu(gate)`` in x's dtype, or x without a gate."""
    return x if gate is None else x * F.silu(gate)


def rmsnorm_ref(x, w, *, eps: float = 1e-6, gate=None, row_ss=None,
                width=None):
    """x * rsqrt(mean(x^2) + eps) * (1 + w) in f32, out in x's dtype. With
    ``gate`` it normalizes ``x * F.silu(gate)``, computed in x's dtype.
    With ``row_ss`` (x.shape[:-1], f32: each row's sum of squares over its
    full ``width``, of which x holds some columns) the mean is
    ``row_ss / width`` in place of the row's own."""
    x = _gated(x, gate)
    x32 = x.float()
    if row_ss is None:
        var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    else:
        var = row_ss[..., None] / width
    return (x32 * torch.rsqrt(var + eps) * (1.0 + w.float())).to(x.dtype)


def row_sumsq_ref(x, gate=None):
    """Each row's sum of squares in f32 (x.shape[:-1]), of x or of the
    gated ``x * F.silu(gate)`` rounded to x's dtype."""
    return torch.sum(torch.square(_gated(x, gate).float()), dim=-1)
