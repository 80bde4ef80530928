"""RMSNorm with the (1 + w) parametrization, fused into one pass per row,
optionally on ``x * silu(gate)`` (the Mamba2 block's gated norm).

Replaces the TPU kernel ``repro/kernels/fused_rmsnorm/fused_rmsnorm.py``
(``_rmsnorm_kernel`` / ``fused_rmsnorm``) and its shim ``ops.py``. On the H100
it is bound by bytes: the CUDA kernels (``csrc/fused_rmsnorm.cu``) read each
element once and write it once, with the row sum in f32. ``plan`` picks their
launch from the row count, the width, the gate and the SM count: a row per
group of warps, each thread holding up to 4 16-byte vectors, a persistent
grid for gated rows.

At a decode step the kernel takes ~2 us of device time and its launch more
of the host's, so the CUDA path of ``rmsnorm`` is kept short: the C entry
point, the SM count and the plans are cached, the checks are the kernel's
needs only, one output is allocated and one ``ctypes`` call launches.

A CPU tensor takes the plain version (``ref.rmsnorm_ref``); a CUDA tensor
launches the kernel or raises. ``launches`` counts kernel launches. Under
grad the gradient is the vector-Jacobian product of ``ref.rmsnorm_ref``,
gated or not (``kernels._grad``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ...device import sm_count, stream_ptr
from .. import _build, _grad, count_launch
from . import ref

launches = 0

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {"fused_rmsnorm_fwd":
               [_P] * 4 + [_I] * 3 + [_L] * 2 + [ctypes.c_float] + [_I] * 3
               + [_P]}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
LOADS = 4            # 16-byte vectors of a row a thread holds (NV) at most
MAX_THREADS = 512    # threads of a block
ROW_THREADS = 128    # threads a block is given where rows are narrow
SM_THREADS = 512     # threads an SM is given by a persistent grid

_fwd = None     # the C entry point, once its library is loaded


@functools.lru_cache(maxsize=None)
def plan(rows: int, d: int, vec: int, aligned: bool, n_sm: int,
         gated: bool):
    """(threads, rows per block, blocks) of the launch for ``rows`` rows of
    width ``d`` in ``vec``-element 16-byte vectors. ``aligned``: every row
    starts 16-byte aligned and d is a multiple of vec. threads 0 is the
    scalar kernel (rows not aligned, or too wide to hold in registers).

    Each thread holds up to LOADS vectors of a row, and narrow rows share a
    block of ROW_THREADS where rows outnumber SMs (else a block a row). A
    gated row holds three tensors' vectors, so few of its blocks fit on an
    SM: it takes a persistent grid of about SM_THREADS threads an SM, whose
    blocks load each next row while they finish the current one, and at no
    more rows than SMs (a decode step) a vector or two a thread. An ungated
    row takes a block per row block, and at a decode step's rows 4 vectors
    a thread: on the card a persistent grid gained nothing there, and more
    threads a row took longer (PERF.md, Findings)."""
    nvec = d // vec
    loads = 1 if gated and rows <= n_sm else LOADS
    threads = min(MAX_THREADS, -(-nvec // (32 * loads)) * 32)
    if not aligned or threads * LOADS < nvec:
        return 0, 1, rows
    rows_per_block = 1 if rows <= n_sm else max(1, ROW_THREADS // threads)
    row_blocks = -(-rows // rows_per_block)
    if not gated:
        return threads, rows_per_block, row_blocks
    per_sm = max(1, SM_THREADS // (threads * rows_per_block))
    return threads, rows_per_block, min(row_blocks, n_sm * per_sm)


def _row_stride(t, d: int, name: str) -> int:
    if t.stride(-1) != 1:
        raise ValueError(f"rmsnorm takes {name} with a contiguous last dim")
    return t.view(-1, d).stride(0)     # raises where rows are not evenly spaced


def _load():
    global _fwd
    _fwd = _build.load("fused_rmsnorm", _SIGNATURES).fused_rmsnorm_fwd
    return _fwd


def rmsnorm(x, w, *, eps: float = 1e-6, gate=None):
    """x (..., d), w (d,) -> x's shape and dtype. With ``gate`` (x's shape,
    dtype and device) it normalizes ``x * silu(gate)``."""
    if gate is not None:
        if gate.shape != x.shape:
            raise ValueError(f"gate {tuple(gate.shape)} is not x's shape "
                             f"{tuple(x.shape)}")
        if gate.dtype != x.dtype:
            raise TypeError(f"gate is {gate.dtype}, x {x.dtype}")
        if gate.device != x.device:
            raise ValueError("x and gate must be on one device")
    return _grad.call(_launch, plain, x, w, gate, eps=eps)


def plain(x, w, gate, *, eps: float):
    """``ref.rmsnorm_ref``, gated where ``gate`` is not None."""
    return ref.rmsnorm_ref(x, w, eps=eps, gate=gate)


def _launch(x, w, gate, *, eps):
    """Launch the CUDA kernel; a new output, outside autograd."""
    dtype = _DTYPES.get(x.dtype)
    if dtype is None or w.dtype != x.dtype:
        raise TypeError(f"rmsnorm takes float32 or bfloat16 x and w of one "
                        f"dtype, got {x.dtype}, {w.dtype}")
    dev = x.get_device()
    d = x.shape[-1]
    if w.shape != (d,) or w.get_device() != dev or not w.is_contiguous():
        raise ValueError(f"w must be a contiguous ({d},) vector on x's device,"
                         f" got {tuple(w.shape)} on {w.device}")
    if x.is_contiguous():
        xs = d
        out = torch.empty_like(x)
    else:
        xs = _row_stride(x, d, "x")
        out = torch.empty_like(x, memory_format=torch.contiguous_format)
    gp = gs = 0
    if gate is not None:
        gp = gate.data_ptr()
        gs = d if gate.is_contiguous() else _row_stride(gate, d, "gate")
    n = out.numel()
    if n == 0:
        return out
    xp, wp = x.data_ptr(), w.data_ptr()
    vec = 8 if dtype else 4            # elements in 16 bytes
    aligned = not (d % vec or xs % vec or gs % vec or (xp | wp | gp) & 15)
    threads, rows_per_block, blocks = plan(n // d, d, vec, aligned,
                                           sm_count(dev), gp != 0)
    err = (_fwd or _load())(xp, gp, wp, out.data_ptr(), dtype, n // d, d, xs,
                            gs, eps, threads, rows_per_block, blocks,
                            stream_ptr(dev))
    if err:
        _build.check(_build.load("fused_rmsnorm", _SIGNATURES),
                     "fused_rmsnorm", err)
    count_launch(__name__)
    return out
