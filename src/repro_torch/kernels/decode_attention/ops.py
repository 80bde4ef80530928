"""Single-token GQA decode attention against a KV cache in its stored layout.

Replaces the TPU kernel ``repro/kernels/decode_attention/decode_attention.py``
(``_decode_kernel`` / ``decode_attention_bhd``) and its shim ``ops.py``, which
copied the whole cache with ``swapaxes`` every step. On the H100 a decode step
is bound by the bytes of K/V it must read. The CUDA kernel
(``csrc/decode_attention.cu``) reads the cache (B, S, KV, hd) through strides
with no copy, serves the G query heads of a kv head from one block so each
cached row is read once, and stops at ``valid_len``, which it reads from a
device pointer: the decode step never waits on the host.

A CPU tensor takes the plain version (``ref.decode_attention_ref``); a CUDA
tensor launches the kernel or raises. ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from . import ref

launches = 0

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {"decode_attention_fwd":
               [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I] + [_L] * 10
               + [ctypes.c_float, _P]}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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
    if hd % 16:
        raise ValueError(f"head_dim {hd} must be a multiple of 16")
    vec = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have a contiguous head dim")
    for name, t in (("k", k), ("v", v)):
        if t.data_ptr() % 16 or any(s % vec for s in t.stride()[:3]):
            raise ValueError(f"{name} rows must be 16-byte aligned")


def decode_attention(q, k_cache, v_cache, valid_len, *, scale: float):
    """q (B, 1, H, hd), caches (B, S, KV, hd) -> (B, 1, H, hd).

    ``valid_len``: number of valid cache rows, the same for the whole batch,
    as an int32 tensor of one element on q's device (the kernel reads it
    there, so the host never waits on the device)."""
    global launches
    if not isinstance(valid_len, torch.Tensor):
        raise TypeError("valid_len must be an int32 tensor on q's device")
    if q.device.type == "cpu":
        ot = ref.decode_attention_ref(q.transpose(1, 2), k_cache.transpose(1, 2),
                                      v_cache.transpose(1, 2), valid_len,
                                      scale=scale)
        return ot.transpose(1, 2)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on cpu or cuda, not {q.device}")
    _check(q, k_cache, v_cache, valid_len)
    B, _, H, hd = q.shape
    _, S, KV, _ = k_cache.shape
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    lib = _build.load("decode_attention", _SIGNATURES)
    err = lib.decode_attention_fwd(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), o.data_ptr(),
        valid_len.data_ptr(), _DTYPES[q.dtype], B, S, H, KV, hd,
        q.stride(0), q.stride(2), *k_cache.stride()[:3], *v_cache.stride()[:3],
        o.stride(0), o.stride(2), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, "decode_attention", err)
    launches += 1
    return o
