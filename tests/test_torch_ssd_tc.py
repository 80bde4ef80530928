"""The plain version of the bf16 tensor-core SSD kernel on the CPU
(``ref.ssd_chunked_tc``: bf16 operands of C B^T, att . x and both state
terms, f32 sums, the f32 state rounded to bf16 for C . state^T) against the
recurrence ``ssd_naive`` at the widths and chunks only the kernel's tiles
make special, on the same numpy inputs (the shapes of the JAX package's SSD
tests are in tests/test_torch_ssd.py); and the shapes the wrapper admits to
the kernel (``ops._check``).

Tolerance 3e-2 relative to max|want|, as the JAX package's bf16 SSD tests:
the att and state operands are rounded to bf16 where the oracles keep f32."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd import ref as j_ref
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd import ref

TOL = 3e-2
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(shape, dtype="bfloat16", seed=0, dt_scale=1.0):
    """x, dt, A, B, C as jnp arrays and CPU tensors from one numpy draw;
    x, B and C rounded to ``dtype`` once, dt and A in f32."""
    B, S, H, G, P, N = shape
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    arrays = {
        "x": rng.standard_normal((B, S, H, P)).astype(np.float32),
        "dt": (np.log1p(np.exp(rng.standard_normal((B, S, H))))
               * dt_scale).astype(np.float32),
        "A": -np.exp(rng.uniform(0.0, 2.0, H)).astype(np.float32),
        "Bm": rng.standard_normal((B, S, G, N)).astype(np.float32),
        "Cm": rng.standard_normal((B, S, G, N)).astype(np.float32),
    }
    low = ("x", "Bm", "Cm")
    j = [jnp.asarray(v, jdt if k in low else jnp.float32)
         for k, v in arrays.items()]
    t = [torch.from_numpy(v).to(tdt if k in low else torch.float32)
         for k, v in arrays.items()]
    return j, t


def _rel(port, want):
    p = port.float().numpy()
    w = (want.float().numpy() if isinstance(want, torch.Tensor)
         else np.asarray(jnp.asarray(want, jnp.float32)))
    return float(np.max(np.abs(p - w)) / (np.max(np.abs(w)) + 1e-9))


@pytest.mark.parametrize("shape,chunk", [
    ((1, 300, 4, 1, 24, 40), 256),     # P, N multiples of 8, not of 16
    ((2, 200, 3, 1, 56, 120), 64),
    ((1, 70, 2, 1, 8, 8), 7),          # chunk shorter than one 16-row tile
])
def test_tc_plain_odd_widths_and_short_chunks(shape, chunk):
    j, t = _inputs(shape, seed=1)
    y, h = ref.ssd_chunked_tc(*t, chunk=chunk)
    yn, hn = j_ref.ssd_naive(*j)
    assert max(_rel(y, yn), _rel(h, hn)) < TOL


def test_tc_plain_never_exponentiates_above_the_diagonal():
    """Large dt makes exp(cum_i - cum_j) overflow for j > i; the select
    keeps it out, as in the kernel."""
    j, t = _inputs((1, 64, 2, 1, 16, 16), seed=9, dt_scale=50.0)
    y, h = ref.ssd_chunked_tc(*t, chunk=64)
    assert bool(torch.isfinite(y.float()).all())
    assert bool(torch.isfinite(h).all())
    yn, hn = j_ref.ssd_naive(*j)
    assert max(_rel(y, yn), _rel(h, hn)) < TOL


def test_cpu_kernel_route_in_bf16_is_the_tc_plain_version():
    _, t = _inputs((1, 80, 4, 1, 16, 32), seed=3)
    n0 = ssd_ops.launches
    y, h = ssd_ops.ssd(*t, chunk=32, use_pallas=True)
    assert ssd_ops.launches == n0, "a CPU tensor must not launch the kernel"
    y0, h0 = ref.ssd_chunked_tc(*t, chunk=32)
    assert torch.equal(y, y0) and torch.equal(h, h0)


def _kernel_args(B=1, S=64, H=4, G=1, P=64, N=64, dtype=torch.bfloat16):
    x = torch.zeros(B, S, H, P, dtype=dtype)
    dt = torch.ones(B, S, H)
    A = -torch.ones(H)
    Bm = torch.zeros(B, S, G, N, dtype=dtype)
    return [x, dt, A, Bm, Bm.clone()]


@pytest.mark.parametrize("widths", [
    dict(P=64, N=64), dict(P=64, N=128), dict(P=24, N=40), dict(P=8, N=8),
    dict(P=4, N=4, dtype=torch.float32), dict(P=12, N=20, dtype=torch.float32),
])
def test_kernel_admits_its_widths(widths):
    """P up to 64 and N up to 128 in multiples of one 16-byte vector: 8 in
    bf16 (zero-filled up to the tensor-core tiles), 4 in f32."""
    ssd_ops._check(*_kernel_args(**widths), L=64)


def _edit(i, f):
    def go(args):
        args[i] = f(args[i])
        return args
    return go


@pytest.mark.parametrize("case,make,L,error", [
    ("P not a multiple of 8 in bf16", lambda: _kernel_args(P=20), 64,
     ValueError),
    ("P past 64", lambda: _kernel_args(P=72), 64, ValueError),
    ("N past 128", lambda: _kernel_args(N=136), 64, ValueError),
    ("chunk past 256", lambda: _kernel_args(S=300), 257, ValueError),
    ("no chunk", lambda: _kernel_args(), 0, ValueError),
    ("B in another dtype", lambda: _edit(3, lambda t: t.float())(
        _kernel_args()), 64, TypeError),
    ("dt in bf16", lambda: _edit(1, lambda t: t.bfloat16())(_kernel_args()),
     64, TypeError),
    ("heads not a multiple of groups", lambda: _kernel_args(H=3, G=2), 64,
     ValueError),
    ("dt of another length", lambda: _edit(1, lambda t: t[:, :32])(
        _kernel_args()), 64, ValueError),
    ("x's last dim strided", lambda: _edit(0, lambda t: t.transpose(1, 3))(
        _kernel_args(S=64, P=64)), 64, ValueError),
    ("x's rows not 16-byte aligned", lambda: _edit(
        0, lambda t: torch.zeros(1, 64, 4, 68, dtype=t.dtype)[..., 4:])(
        _kernel_args()), 64, ValueError),
])
def test_kernel_refuses_what_it_cannot_read(case, make, L, error):
    with pytest.raises(error):
        ssd_ops._check(*make(), L=L)
