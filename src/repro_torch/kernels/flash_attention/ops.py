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
launches the kernel or raises. ``launches`` counts forward launches. Under
grad the route is chosen from the input (``kernel_backward``): bf16 at equal
widths up to 128 runs ``FlashAttention``, whose forward launch also writes
each query row's log-sum-exp and whose backward is the CUDA backward
(``flash_bwd_dq`` and ``flash_bwd_wgmma``: dQ, dK and dV from q, k, v, o,
that log-sum-exp and dO, the (S, S) matrix never in device memory, the same
bits on every run; ``ref.attention_bwd_ref`` is its plain version), counted
in ``backward_launches``; f32, the widths 160 and 256 and MLA's (192, 128)
take the vector-Jacobian product of ``ref.attention_ref`` recomputed from
the saved inputs (``kernels._grad``), counted in ``plain_backward_calls``.
The kernels run on the card q lies on, on that card's current stream,
whatever the calling thread's current device; ``card_launches`` counts the
forward launches by card.
"""
from __future__ import annotations

import ctypes

import torch

from ...device import stream_ptr
from .. import _build, _grad, count_launch
from . import ref

launches = 0
card_launches = {}      # CUDA device index -> launches
backward_launches = 0   # backward kernel calls (its dQ and dK/dV passes)
plain_backward_calls = 0    # backwards taken by the plain vjp on the card

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {"flash_attention_fwd":
               [_P, _P, _P, _P] + [_I] * 7 + [_L] * 12
               + [_P, _L, ctypes.c_float, _P, _I],
               "flash_attention_bwd":
               [_P] * 10 + [_I] * 5 + [_L] * 15 + [ctypes.c_float, _P, _I]}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the head widths the kernels are instantiated for where q/k and v have one
# width: the ported configs' (64, 80, 112, 128, 160, 256) and the smoke
# configs' and tests' (16, 32)
HEAD_DIMS = (16, 32, 64, 80, 112, 128, 160, 256)
# every (q/k width, v width) pair instantiated: the above, and DeepSeek
# MLA's prefill (nope 128 + rope 64 against v 128)
HEAD_DIM_PAIRS = tuple((hd, hd) for hd in HEAD_DIMS) + ((192, 128),)
# the equal widths the backward kernel (and the forward's log-sum-exp) is
# built for
BACKWARD_DIMS = (16, 32, 64, 80, 112, 128)
# the backward kernels' query tiles: the rows of the log-sum-exp and of D
# are padded to a whole tile, which the kernels read and write whole
LSE_ROWS = 64


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
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have a contiguous head dim")
        # k/v rows are 16-byte loads; in bf16 all three are TMA tensor maps
        if (name != "q" or q.dtype == torch.bfloat16) and not _aligned(t):
            raise ValueError(f"{name} rows must be 16-byte aligned")


def _aligned(t):
    """Whether t's rows start on 16 bytes: its address and its (batch, seq,
    head) strides, as a TMA tensor map and the 16-byte loads need."""
    vec = 16 // t.element_size()
    return t.data_ptr() % 16 == 0 and not any(s % vec for s in t.stride()[:3])


def kernel_backward(dtype, hd: int, hd_v: int) -> bool:
    """Whether a gradient through flash attention on the card, for q/k/v of
    ``dtype`` and widths (``hd``, ``hd_v``), is the backward kernel's: bf16
    at equal widths it is built for. Else (f32, whose scalar forward holds
    the algorithm at 2e-5; the widths 160 and 256; MLA's (192, 128)) the
    plain version's vjp."""
    return dtype == torch.bfloat16 and hd == hd_v and hd in BACKWARD_DIMS


def plain(q, k, v, *, scale: float):
    """``ref.attention_ref`` in the model layout (B, S, H, hd)."""
    ot = ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2), scale=scale)
    return ot.transpose(1, 2)


def plain_lse(q, k, v, *, scale: float):
    """``ref.attention_ref`` with its log-sum-exp, in the model layout:
    (o (B, S, H, hd_v), lse (B, H, S) f32)."""
    ot, lse = ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), scale=scale,
                                return_lse=True)
    return ot.transpose(1, 2), lse


def plain_bwd(q, k, v, o, lse, do, *, scale: float):
    """``ref.attention_bwd_ref`` in the model layout: (dq, dk, dv)."""
    grads = ref.attention_bwd_ref(
        *(t.transpose(1, 2) for t in (q, k, v, o)), lse, do.transpose(1, 2),
        scale=scale)
    return tuple(g.transpose(1, 2) for g in grads)


def flash_attention(q, k, v, *, scale: float):
    """Causal attention: q (B, S, H, hd), k (B, S, KV, hd), v (B, S, KV, hd_v)
    -> (B, S, H, hd_v)."""
    route = kernel_backward(q.dtype, q.shape[-1], v.shape[-1])
    vjp = _kernel_vjp if route else _plain_vjp
    return _grad.call(_launch, plain, q, k, v, vjp=vjp, scale=scale)


class FlashAttention(torch.autograd.Function):
    """The forward launch, with each query row's log-sum-exp; the backward
    launch from q, k, v, o, that log-sum-exp and dO."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        o, lse = _launch_lse(q, k, v, scale=scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        dq, dk, dv = _launch_bwd(*ctx.saved_tensors, do, scale=ctx.scale)
        return dq, dk, dv, None


def _kernel_vjp(q, k, v, *, scale):
    return FlashAttention.apply(q, k, v, scale)


def _plain_vjp(q, k, v, *, scale):
    return _grad.PlainVJP.apply(_launch, _counted_plain, {"scale": scale},
                                q, k, v)


def _counted_plain(q, k, v, *, scale):
    """``plain``, recomputed for the plain vjp: one backward on that route."""
    count_launch(__name__, "plain_backward_calls")
    return plain(q, k, v, scale=scale)


def _padded(S):
    """S rounded up to the backward's query tiles (``LSE_ROWS``)."""
    return -(-S // LSE_ROWS) * LSE_ROWS


def _launch(q, k, v, *, scale):
    """Launch the CUDA kernel on q, k, v; a new output, outside autograd."""
    return _forward(q, k, v, scale, None)


def _launch_lse(q, k, v, *, scale):
    """The launch writing each query row's log-sum-exp too: (o, lse), lse
    (B, H, S) f32, a view of rows padded to ``LSE_ROWS`` (``_padded``),
    which the backward kernel reads whole."""
    B, S, H, _ = q.shape
    lse = torch.empty((B, H, _padded(S)), dtype=torch.float32,
                      device=q.device)
    return _forward(q, k, v, scale, lse), lse[..., :S]


def _forward(q, k, v, scale, lse):
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
        None if lse is None else lse.data_ptr(),
        0 if lse is None else lse.stride(1), float(scale), stream_ptr(dev),
        dev)
    _build.check(lib, "flash_attention", err)
    count_launch(__name__, card=dev)
    return o


def _launch_bwd(q, k, v, o, lse, do, *, scale):
    """Launch the backward kernels: (dq, dk, dv), new and contiguous, from the
    forward's inputs, its output and ``_launch_lse``'s log-sum-exp, and dO
    (copied first where its rows are not 16-byte aligned)."""
    _check(q, k, v)
    if not kernel_backward(q.dtype, q.shape[-1], v.shape[-1]):
        raise ValueError(f"the flash backward takes bfloat16 at equal widths "
                         f"{BACKWARD_DIMS}, not {q.dtype} at "
                         f"({q.shape[-1]}, {v.shape[-1]})")
    B, S, H, hd = q.shape
    KV = k.shape[2]
    S_pad = _padded(S)
    if do.shape != o.shape or do.dtype != o.dtype:
        raise ValueError(f"dO {tuple(do.shape)} {do.dtype} is not shaped as "
                         f"the output {tuple(o.shape)} {o.dtype}")
    if lse.shape != (B, H, S) or lse.stride() != (H * S_pad, S_pad, 1):
        raise ValueError("lse must be _launch_lse's (B, H, S) rows")
    if do.stride(-1) != 1 or not _aligned(do):
        do = do.contiguous()
    dsum = torch.empty((B, H, S_pad), dtype=torch.float32, device=q.device)
    dq = q.new_empty((B, S, H, hd))
    dk, dv = k.new_empty((B, S, KV, hd)), v.new_empty((B, S, KV, hd))
    dev = q.get_device()
    lib = _build.load("flash_attention", _SIGNATURES)
    err = lib.flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), dsum.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), B, S, H, KV, hd, *q.stride()[:3],
        *k.stride()[:3], *v.stride()[:3], *o.stride()[:3], *do.stride()[:3],
        float(scale), stream_ptr(dev), dev)
    _build.check(lib, "flash_attention backward", err)
    count_launch(__name__, "backward_launches")
    return dq, dk, dv
