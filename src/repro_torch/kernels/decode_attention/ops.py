"""Single-token GQA decode attention against a KV cache in its stored layout.

Replaces the TPU kernel ``repro/kernels/decode_attention/decode_attention.py``
(``_decode_kernel`` / ``decode_attention_bhd``) and its shim ``ops.py``, which
copied the whole cache with ``swapaxes`` every step. On the H100 a decode step
is bound by the bytes of K/V it must read. The CUDA kernels
(``csrc/decode_attention.cu``) read the cache (B, S, KV, hd) through strides
with no copy and split it across the SMs (split-KV): one block per (batch, kv
head, split) serves the G query heads of its kv head, so each cached row is
read once, and stops at ``valid_len``, which it reads from a device pointer:
the decode step never waits on the host. A second kernel, launched by the same
call, merges the splits' f32 partials (``ref.decode_attention_split_ref`` is
the same arithmetic in plain PyTorch). bf16 products run on the tensor cores
(``mma.sync``), f32 ones as scalar FMAs.

A CPU tensor takes the plain version (``ref.decode_attention_ref``); a CUDA
tensor launches the kernels or raises, on the card q lies on whatever the
calling thread's current device. ``launches`` counts calls that launched
them, ``card_launches`` the same by card.

There is no gradient: the reference kernel has no backward (its Pallas call
raises under ``jax.grad``) and no training path decodes. Where grad mode is
on and an input requires grad, the call raises on any device rather than
return an output that autograd cannot see through.
"""
from __future__ import annotations

import ctypes

import torch

from ...device import sm_count, stream_ptr
from .. import _build, count_launch
from . import ref

launches = 0
card_launches = {}      # CUDA device index -> launches

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {"decode_attention_fwd":
               [_P] * 7 + [_I] * 8 + [_L] * 10 + [ctypes.c_float, _P, _I]}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the head widths the bf16 kernel is instantiated for (as flash attention's)
HEAD_DIMS = (16, 32, 64, 80, 112, 128, 160, 256)
SPLIT_ROWS = 64         # a split is a whole number of the kernel's 64-row steps


def split_plan(B: int, KV: int, S: int, n_sm: int):
    """(n_split, rows per split) for a cache of capacity S: enough splits for
    two blocks per SM over the B * KV (batch, kv head) pairs, each split at
    least one 64-row step. Depends on the capacity, never on valid_len,
    which stays on the device."""
    steps = -(-S // SPLIT_ROWS)
    want = max(1, min(steps, -(-2 * n_sm // (B * KV))))
    rows = -(-steps // want) * SPLIT_ROWS
    return -(-S // rows), rows


def _check(q, k, v, valid_len):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4 or q.shape[1] != 1:
        raise ValueError("decode_attention takes q (B,1,H,hd), caches "
                         "(B,S,KV,hd)")
    if not (q.device == k.device == v.device == valid_len.device):
        raise ValueError("q, caches and valid_len must be on one device")
    if q.dtype not in _DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"decode_attention takes float32 or bfloat16 of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if valid_len.dtype != torch.int32 or valid_len.numel() != 1:
        raise TypeError("valid_len must be one int32 value")
    B, _, H, hd = q.shape
    if k.shape[0] != B or k.shape[-1] != hd or v.shape != k.shape:
        raise ValueError(f"cache shapes {tuple(k.shape)}, {tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if H % k.shape[2]:
        raise ValueError(f"num heads {H} is not a multiple of kv heads "
                         f"{k.shape[2]}")
    if (q.dtype == torch.bfloat16 and hd not in HEAD_DIMS) or hd % 16 \
            or hd > 1024:
        raise ValueError(f"head_dim {hd} is not one of {HEAD_DIMS} (bf16) "
                         f"or a multiple of 16 up to 1024 (f32)")
    vec = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have a contiguous head dim")
        if t.data_ptr() % 16 or any(s % vec for s in t.stride()[:3]):
            raise ValueError(f"{name} rows must be 16-byte aligned")


def decode_attention(q, k_cache, v_cache, valid_len, *, scale: float,
                     return_lse: bool = False):
    """q (B, 1, H, hd), caches (B, S, KV, hd) -> (B, 1, H, hd).

    ``valid_len``: number of valid cache rows, the same for the whole batch,
    as an int32 tensor of one element on q's device (the kernel reads it
    there, so the host never waits on the device).

    ``return_lse``: the softmax partial of this block of a cache, (o, lse):
    o in f32 whatever q's dtype, and lse (B, H) f32, the log-sum-exp of the
    scaled scores over the valid rows, -inf where there is none (o is 0
    there). The same kernels, whose merge writes lse too
    (``ref.decode_attention_partial_ref`` is its plain version);
    ``tensor_parallel.combine_partials`` joins the blocks of several
    ranks."""
    if not isinstance(valid_len, torch.Tensor):
        raise TypeError("valid_len must be an int32 tensor on q's device")
    if torch.is_grad_enabled() and (q.requires_grad or k_cache.requires_grad
                                    or v_cache.requires_grad):
        raise RuntimeError("decode_attention has no gradient (nor has the "
                           "reference kernel): call it under torch.no_grad() "
                           "or on tensors that do not require grad")
    if q.device.type == "cpu":
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k_cache, v_cache))
        if return_lse:
            ot, lse = ref.decode_attention_partial_ref(qt, kt, vt, valid_len,
                                                       scale=scale)
            return ot.transpose(1, 2), lse
        ot = ref.decode_attention_ref(qt, kt, vt, valid_len, scale=scale)
        return ot.transpose(1, 2)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on cpu or cuda, not {q.device}")
    _check(q, k_cache, v_cache, valid_len)
    B, _, H, hd = q.shape
    _, S, KV, _ = k_cache.shape
    dev = q.get_device()
    n_split, rows = split_plan(B, KV, S, sm_count(dev))
    o = torch.empty(q.shape, device=q.device,
                    dtype=torch.float32 if return_lse else q.dtype)
    lse = (torch.empty((B, H), dtype=torch.float32, device=q.device)
           if return_lse else None)
    # f32 partials of every (batch, head, split): acc[hd], then (m, l)
    scratch = torch.empty(B * H * n_split * (hd + 2), dtype=torch.float32,
                          device=q.device)
    lib = _build.load("decode_attention", _SIGNATURES)
    err = lib.decode_attention_fwd(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), o.data_ptr(),
        valid_len.data_ptr(), scratch.data_ptr(),
        lse.data_ptr() if return_lse else None, _DTYPES[q.dtype], B, S, H,
        KV, hd, n_split, rows, q.stride(0), q.stride(2),
        *k_cache.stride()[:3], *v_cache.stride()[:3], o.stride(0), o.stride(2),
        float(scale), stream_ptr(dev), dev)
    _build.check(lib, "decode_attention", err)
    count_launch(__name__, card=dev)
    return (o, lse) if return_lse else o
