"""Causal GQA flash attention in the model layout (B, S, H, hd), with a value
width of its own (MLA: q/k 192, v 128).

Replaces the TPU kernel ``repro/kernels/flash_attention/flash_attention.py``
(``_flash_kernel`` / ``flash_attention_bhsd``) and its shim ``ops.py``. On the
H100 the GQA prefill call is bound by operations (the two products of
attention, causal half), not bytes; MLA's, whose every head has its own K
and V, narrowly by bytes. The CUDA kernels (``csrc/flash_attention.cu``) read
q/k/v in place (kv head ``h // G``, no repeat-KV, no transposed or padded
copies), keep the online-softmax state in f32 registers and mask the ragged
edge themselves. bf16 runs on the tensor cores (``wgmma``, operands brought
by TMA, P rounded to bf16 before P.V); f32 keeps scalar FMAs, so it holds
the algorithm at 2e-5.

A CPU tensor takes the plain version (``ref.attention_ref``); a CUDA tensor
launches the kernel or raises. ``launches`` counts kernel launches. Under
grad the gradient is the vector-Jacobian product of ``ref.attention_ref``
(``kernels._grad``). The kernel runs on the card q lies on, on that card's
current stream, whatever the calling thread's current device;
``card_launches`` counts its launches by card.
"""
from __future__ import annotations

import ctypes

import torch

from ...device import stream_ptr
from .. import _build, _grad, count_launch
from . import ref

launches = 0
card_launches = {}      # CUDA device index -> launches

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {"flash_attention_fwd":
               [_P, _P, _P, _P] + [_I] * 7 + [_L] * 12
               + [ctypes.c_float, _P, _I]}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the head widths the kernels are instantiated for where q/k and v have one
# width: the ported configs' (64, 80, 112, 128, 160, 256) and the smoke
# configs' and tests' (16, 32)
HEAD_DIMS = (16, 32, 64, 80, 112, 128, 160, 256)
# every (q/k width, v width) pair instantiated: the above, and DeepSeek
# MLA's prefill (nope 128 + rope 64 against v 128)
HEAD_DIM_PAIRS = tuple((hd, hd) for hd in HEAD_DIMS) + ((192, 128),)


def _check(q, k, v):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention takes q (B,S,H,hd), k (B,S,KV,hd), "
                         "v (B,S,KV,hd_v)")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    if q.dtype not in _DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_attention takes float32 or bfloat16 q/k/v of "
                        f"one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    B, S, H, hd = q.shape
    KV = k.shape[2]
    if k.shape != (B, S, KV, hd):
        raise ValueError(f"k shape {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if v.shape[:3] != k.shape[:3]:
        raise ValueError(f"v shape {tuple(v.shape)} does not match k "
                         f"{tuple(k.shape)}")
    if H % KV:
        raise ValueError(f"num heads {H} is not a multiple of kv heads {KV}")
    if (hd, v.shape[-1]) not in HEAD_DIM_PAIRS:
        raise ValueError(f"head widths (q/k {hd}, v {v.shape[-1]}) are not "
                         f"one of the pairs built, {HEAD_DIM_PAIRS}")
    vec = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have a contiguous head dim")
        # k/v rows are 16-byte loads; in bf16 all three are TMA tensor maps
        if (name != "q" or q.dtype == torch.bfloat16) and (
                t.data_ptr() % 16 or any(s % vec for s in t.stride()[:3])):
            raise ValueError(f"{name} rows must be 16-byte aligned")


def plain(q, k, v, *, scale: float):
    """``ref.attention_ref`` in the model layout (B, S, H, hd)."""
    ot = ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2), scale=scale)
    return ot.transpose(1, 2)


def flash_attention(q, k, v, *, scale: float):
    """Causal attention: q (B, S, H, hd), k (B, S, KV, hd), v (B, S, KV, hd_v)
    -> (B, S, H, hd_v)."""
    return _grad.call(_launch, plain, q, k, v, scale=scale)


def _launch(q, k, v, *, scale):
    """Launch the CUDA kernel on q, k, v; a new output, outside autograd."""
    _check(q, k, v)
    B, S, H, hd = q.shape
    hd_v = v.shape[-1]
    o = q.new_empty((B, S, H, hd_v))
    dev = q.get_device()
    lib = _build.load("flash_attention", _SIGNATURES)
    err = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        _DTYPES[q.dtype], B, S, H, k.shape[2], hd, hd_v,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        float(scale), stream_ptr(dev), dev)
    _build.check(lib, "flash_attention", err)
    count_launch(__name__, card=dev)
    return o
