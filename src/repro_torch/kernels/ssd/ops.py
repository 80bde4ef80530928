"""The Mamba2 SSD chunked scan: the entry point the model calls.

Replaces the TPU kernel ``repro/kernels/ssd/ssd.py`` (``_ssd_kernel`` /
``ssd_pallas``) and its dispatcher ``ops.py``. On the H100 the scan is bound
by bytes: x read and y written once, plus dt, B/C and the final state. The
CUDA kernels (``csrc/ssd.cu``) give each (batch, head) a block that walks its
chunks in order, reading x, dt and B/C in place through strides (the TPU
wrapper's transposes and padding are not repeated). In bf16 the products run
on the tensor cores with the P x N state in registers; in f32 they are scalar
FMAs.

``use_pallas=False`` runs the plain ``ref.ssd_chunked`` on any device, as it
selects XLA in the JAX package. With ``use_pallas=True`` a CPU tensor takes
the plain version of the kernel (``ref.ssd_chunked_tc`` in bf16, the
tensor-core kernel's rounding points; ``ssd_chunked`` in f32, whatever
``precision`` says, as ``ssd_pallas`` ignores it; the f32 kernel differs only
in keeping its within-chunk prefix sums in f64) and a CUDA tensor launches
the kernel or raises. Like ``ssd_pallas``, the kernel path starts from a zero
state: ``h0`` raises there. The kernel runs on the card x lies on whatever
the calling thread's current device. ``launches`` counts kernel launches,
``card_launches`` the same by card.

Under grad the kernel path's gradient is the vector-Jacobian product of the
plain version that dtype takes on the CPU (``kernels._grad``). Only y is
differentiated: the training path discards the final state, and a gradient
asked of it raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ...device import stream_ptr
from .. import _build, _grad, count_launch
from . import ref

launches = 0
card_launches = {}      # CUDA device index -> launches

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {"ssd_fwd_launch": [_P] * 7 + [_I] * 8 + [_L] * 15 + [_P, _I]}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_CHUNK, MAX_P, MAX_N = 256, 64, 128


def _check(x, dt, A, Bm, Cm, L):
    if x.ndim != 4 or dt.ndim != 3 or A.ndim != 1 or Bm.ndim != 4:
        raise ValueError("ssd takes x (B,S,H,P), dt (B,S,H), A (H,), "
                         "B/C (B,S,G,N)")
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if (tuple(dt.shape) != (B, S, H) or tuple(A.shape) != (H,)
            or tuple(Bm.shape[:2]) != (B, S) or Cm.shape != Bm.shape):
        raise ValueError(f"shapes do not match: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(Bm.shape)}, C {tuple(Cm.shape)}")
    if len({t.device for t in (x, dt, A, Bm, Cm)}) != 1:
        raise ValueError("x, dt, A, B and C must be on one device")
    if x.dtype not in _DTYPES or not (x.dtype == Bm.dtype == Cm.dtype):
        raise TypeError(f"ssd takes x, B and C as float32 or bfloat16 of one "
                        f"dtype, got {x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError("dt and A must be float32")
    if H % G:
        raise ValueError(f"heads {H} are not a multiple of groups {G}")
    vec = 16 // x.element_size()
    if not (0 < P <= MAX_P and P % vec == 0 and 0 < N <= MAX_N
            and N % vec == 0):
        raise ValueError(f"head dim {P} and state {N} must be multiples of "
                         f"{vec} up to {MAX_P} and {MAX_N}")
    if not 0 < L <= MAX_CHUNK:
        raise ValueError(f"chunk {L} must be in 1..{MAX_CHUNK}")
    for name, t in (("x", x), ("dt", dt), ("A", A), ("B", Bm), ("C", Cm)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have a contiguous last dim")
    for name, t in (("x", x), ("B", Bm), ("C", Cm)):
        if t.data_ptr() % 16 or any(s % vec for s in t.stride()[:3]):
            raise ValueError(f"{name} rows must be 16-byte aligned")


def ssd(x, dt, A, Bm, Cm, *, chunk: int = 256, use_pallas: bool = False,
        h0: Optional[torch.Tensor] = None, precision: str = "highest"
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD scan. See ``ref.py`` for shapes. Returns y (B,S,H,P) in x's dtype
    and the final state (B,H,P,N) in f32."""
    if not use_pallas:
        return ref.ssd_chunked(x, dt, A, Bm, Cm, chunk=chunk, h0=h0,
                               precision=precision)
    if h0 is not None:
        raise ValueError("the SSD kernel starts from a zero state: h0 is not "
                         "supported (use use_pallas=False)")
    return _grad.call(_launch, plain, x, dt, A, Bm, Cm, chunk=chunk)


def plain(x, dt, A, Bm, Cm, *, chunk: int):
    """The kernel's plain version: ``ref.ssd_chunked_tc`` (the bf16
    tensor-core kernel's roundings) in bf16, ``ref.ssd_chunked`` in f32."""
    if x.dtype == torch.bfloat16:
        return ref.ssd_chunked_tc(x, dt, A, Bm, Cm, chunk=chunk)
    return ref.ssd_chunked(x, dt, A, Bm, Cm, chunk=chunk)


def _launch(x, dt, A, Bm, Cm, *, chunk):
    """Launch the CUDA kernel; new outputs (y, final state), outside
    autograd."""
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    L = min(chunk, S)
    _check(x, dt, A, Bm, Cm, L)
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    h_final = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    dev = x.get_device()
    lib = _build.load("ssd", _SIGNATURES)
    err = lib.ssd_fwd_launch(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), y.data_ptr(), h_final.data_ptr(), _DTYPES[x.dtype],
        B, S, H, G, P, N, L, *x.stride()[:3], *dt.stride(), *Bm.stride()[:3],
        *Cm.stride()[:3], *y.stride()[:3], stream_ptr(dev), dev)
    _build.check(lib, "ssd", err)
    count_launch(__name__, card=dev)
    return y, h_final
