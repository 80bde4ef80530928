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

Split rows (tensor parallelism: each rank holds some columns of a row,
``distributed/tensor_parallel.split_rmsnorm``) take two launches with the
caller's all-reduce between them: ``row_sumsq`` (each row's f32 sum of
squares, gated or not) and ``rmsnorm(..., row_ss=, width=)`` (the scaling
from the summed row, the mean over the full ``width``).

A CPU tensor takes the plain version (``ref.rmsnorm_ref``,
``ref.row_sumsq_ref``); a CUDA tensor launches the kernel or raises.
The kernel runs on the card x lies on whatever the calling thread's current
device. ``launches`` counts kernel launches, ``card_launches`` the same by
card, ``split_launches`` those of the two split-row passes among them. Under grad the gradient is the
vector-Jacobian product of the plain version (``kernels._grad``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ...device import sm_count, stream_ptr
from .. import _build, _grad, count_launch
from . import ref

launches = 0
card_launches = {}      # CUDA device index -> launches
split_launches = 0

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_SIGNATURES = {"fused_rmsnorm_fwd":
               [_P] * 4 + [_I] * 3 + [_L] * 2 + [_F] + [_I] * 3 + [_P, _I],
               "fused_rmsnorm_sumsq":
               [_P] * 3 + [_I] * 3 + [_L] * 2 + [_I] * 3 + [_P, _I],
               "fused_rmsnorm_scale":
               [_P] * 5 + [_I] * 3 + [_L] * 2 + [_I, _F] + [_I] * 3
               + [_P, _I]}
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


def _check_gate(x, gate):
    if gate is None:
        return
    if gate.shape != x.shape:
        raise ValueError(f"gate {tuple(gate.shape)} is not x's shape "
                         f"{tuple(x.shape)}")
    if gate.dtype != x.dtype:
        raise TypeError(f"gate is {gate.dtype}, x {x.dtype}")
    if gate.device != x.device:
        raise ValueError("x and gate must be on one device")


def rmsnorm(x, w, *, eps: float = 1e-6, gate=None, row_ss=None, width=None):
    """x (..., d), w (d,) -> x's shape and dtype. With ``gate`` (x's shape,
    dtype and device) it normalizes ``x * silu(gate)``. With ``row_ss``
    (x.shape[:-1], f32, on x's device: each row's sum of squares over the
    full row, of which x holds d columns) and ``width`` (the full row's
    width) it scales by ``rsqrt(row_ss / width + eps)``."""
    _check_gate(x, gate)
    if row_ss is None:
        return _grad.call(_launch, plain, x, w, gate, eps=eps)
    if (row_ss.shape != x.shape[:-1] or row_ss.dtype != torch.float32
            or row_ss.device != x.device):
        raise ValueError(f"row_ss must be an f32 {tuple(x.shape[:-1])} "
                         f"tensor on x's device, got {row_ss.dtype} "
                         f"{tuple(row_ss.shape)} on {row_ss.device}")
    if width is None or width < x.shape[-1]:
        raise ValueError(f"width {width} is not a full row of at least "
                         f"{x.shape[-1]} columns")
    return _grad.call(_launch, plain, x, w, gate, row_ss, eps=eps,
                      width=int(width))


def row_sumsq(x, gate=None):
    """Each row's sum of squares of x (..., d), or of ``x * silu(gate)``
    rounded to x's dtype, in f32: x.shape[:-1]."""
    _check_gate(x, gate)
    return _grad.call(_launch_sumsq, plain_sumsq, x, gate)


def plain(x, w, gate, row_ss=None, *, eps: float, width=None):
    """``ref.rmsnorm_ref``, gated where ``gate`` is not None, from
    ``row_ss`` where given."""
    return ref.rmsnorm_ref(x, w, eps=eps, gate=gate, row_ss=row_ss,
                           width=width)


def plain_sumsq(x, gate):
    """``ref.row_sumsq_ref``."""
    return ref.row_sumsq_ref(x, gate)


def _geometry(x, gate, dtype: int, wp: int = 0):
    """(x's row stride, the gate's pointer (0 without one) and row stride,
    the elements in a 16-byte vector, and whether every row starts 16-byte
    aligned at a width of whole vectors, w's pointer ``wp`` too)."""
    d = x.shape[-1]
    xs = d if x.is_contiguous() else _row_stride(x, d, "x")
    gp = gs = 0
    if gate is not None:
        gp = gate.data_ptr()
        gs = d if gate.is_contiguous() else _row_stride(gate, d, "gate")
    vec = 8 if dtype else 4            # elements in 16 bytes
    aligned = not (d % vec or xs % vec or gs % vec
                   or (x.data_ptr() | wp | gp) & 15)
    return xs, gp, gs, vec, aligned


def _launch(x, w, gate, row_ss=None, *, eps, width=None):
    """Launch the CUDA kernel (the scaling pass of a split row where
    ``row_ss`` is given); a new output, outside autograd."""
    dtype = _DTYPES.get(x.dtype)
    if dtype is None or w.dtype != x.dtype:
        raise TypeError(f"rmsnorm takes float32 or bfloat16 x and w of one "
                        f"dtype, got {x.dtype}, {w.dtype}")
    dev = x.get_device()
    d = x.shape[-1]
    if w.shape != (d,) or w.get_device() != dev or not w.is_contiguous():
        raise ValueError(f"w must be a contiguous ({d},) vector on x's device,"
                         f" got {tuple(w.shape)} on {w.device}")
    wp = w.data_ptr()
    xs, gp, gs, vec, aligned = _geometry(x, gate, dtype, wp)
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    n = out.numel()
    if n == 0:
        return out
    threads, rows_per_block, blocks = plan(n // d, d, vec, aligned,
                                           sm_count(dev), gp != 0)
    if row_ss is None:
        err = (_fwd or _load())(x.data_ptr(), gp, wp, out.data_ptr(), dtype,
                                n // d, d, xs, gs, eps, threads,
                                rows_per_block, blocks, stream_ptr(dev), dev)
    else:
        row_ss = row_ss.contiguous()
        err = _build.load("fused_rmsnorm", _SIGNATURES).fused_rmsnorm_scale(
            x.data_ptr(), gp, wp, row_ss.data_ptr(), out.data_ptr(), dtype,
            n // d, d, xs, gs, width, eps, threads, rows_per_block, blocks,
            stream_ptr(dev), dev)
    if err:
        _build.check(_build.load("fused_rmsnorm", _SIGNATURES),
                     "fused_rmsnorm", err)
    count_launch(__name__, card=dev)
    if row_ss is not None:
        count_launch(__name__, "split_launches")
    return out


def _launch_sumsq(x, gate):
    """Launch the CUDA kernel's row-sum pass; a new f32 (x.shape[:-1])
    tensor, outside autograd."""
    dtype = _DTYPES.get(x.dtype)
    if dtype is None:
        raise TypeError(f"rmsnorm takes float32 or bfloat16 x, got {x.dtype}")
    d = x.shape[-1]
    out = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
    if out.numel() == 0 or d == 0:
        return out.zero_()
    xs, gp, gs, vec, aligned = _geometry(x, gate, dtype)
    dev = x.get_device()
    threads, rows_per_block, blocks = plan(out.numel(), d, vec, aligned,
                                           sm_count(dev), gp != 0)
    lib = _build.load("fused_rmsnorm", _SIGNATURES)
    err = lib.fused_rmsnorm_sumsq(x.data_ptr(), gp, out.data_ptr(), dtype,
                                  out.numel(), d, xs, gs, threads,
                                  rows_per_block, blocks, stream_ptr(dev),
                                  dev)
    _build.check(lib, "fused_rmsnorm", err)
    count_launch(__name__, card=dev)
    count_launch(__name__, "split_launches")
    return out
