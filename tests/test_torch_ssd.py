"""The port's SSD scan on the CPU (``kernels/ssd``): its plain versions and
its ``ops`` wrapper, on CPU tensors, against the JAX package's Pallas kernel
run in interpret mode (as tests/test_kernels.py runs it) and against the JAX
oracles, on the same numpy inputs. Twins of the JAX package's SSD tests.

Tolerances are relative (max|diff| / max|want|), as in the JAX package's
SSD tests: 1e-5 in f32 (sums in another order); 3e-2 in bf16 (one rounding
of y, and bf16 operands of the mixed-precision products)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd import ops as j_ops
from repro.kernels.ssd import ref as j_ref
from repro.kernels.ssd.ssd import ssd_pallas
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd import ref

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 1e-5, "bfloat16": 3e-2}


def _inputs(shape, dtype="float32", seed=0, h0=False):
    """x, dt, A, B, C (and h0) as jnp arrays and as CPU tensors from one
    numpy draw; x, B and C rounded to ``dtype`` once, dt and A in f32."""
    B, S, H, G, P, N = shape
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    arrays = {
        "x": rng.standard_normal((B, S, H, P)).astype(np.float32),
        "dt": np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(
            np.float32),                                 # softplus: > 0
        "A": -np.exp(rng.uniform(0.0, 2.0, H)).astype(np.float32),
        "Bm": rng.standard_normal((B, S, G, N)).astype(np.float32),
        "Cm": rng.standard_normal((B, S, G, N)).astype(np.float32),
    }
    if h0:
        arrays["h0"] = rng.standard_normal((B, H, P, N)).astype(np.float32)
    low = ("x", "Bm", "Cm")
    j = {k: jnp.asarray(v, jdt if k in low else jnp.float32)
         for k, v in arrays.items()}
    t = {k: torch.from_numpy(v).to(tdt if k in low else torch.float32)
         for k, v in arrays.items()}
    return j, t


def _rel(port, want):
    p = port.float().numpy()
    w = np.asarray(jnp.asarray(want, jnp.float32))
    return float(np.max(np.abs(p - w)) / (np.max(np.abs(w)) + 1e-9))


def _args(d):
    return d["x"], d["dt"], d["A"], d["Bm"], d["Cm"]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape,chunk", [
    ((2, 128, 4, 1, 32, 64), 32),
    ((1, 96, 4, 2, 16, 32), 32),       # grouped B/C, ragged chunks
    ((1, 256, 2, 1, 64, 128), 128),    # production-like tile
])
def test_ssd_vs_jax_pallas_and_naive(shape, chunk, dtype):
    """Twin of test_ssd_pallas_vs_naive: the wrapper on CPU tensors (the
    kernel's plain version: ``ssd_chunked_tc`` in bf16) against the Pallas
    kernel, ``ssd_naive`` and the JAX ``ssd_chunked(precision="mixed")``."""
    j, t = _inputs(shape, dtype)
    yp, hp = ssd_pallas(*_args(j), chunk=chunk, interpret=True)
    yn, hn = j_ref.ssd_naive(*_args(j))
    ym, hm = j_ref.ssd_chunked(*_args(j), chunk=chunk, precision="mixed")
    n0 = ssd_ops.launches
    y, h = ssd_ops.ssd(*_args(t), chunk=chunk, use_pallas=True)
    assert ssd_ops.launches == n0, "a CPU tensor must not launch the kernel"
    assert y.dtype == t["x"].dtype and y.shape == t["x"].shape
    assert h.dtype == torch.float32
    for name, (want_y, want_h) in (("ssd_pallas", (yp, hp)),
                                   ("ssd_naive", (yn, hn)),
                                   ("jax mixed", (ym, hm))):
        err = max(_rel(y, want_y), _rel(h, want_h))
        assert err < TOL[dtype], f"{shape} {dtype} vs {name}: {err:.2e}"
    # the port's own ground truth against JAX's
    y0, h0 = ref.ssd_naive(*_args(t))
    assert max(_rel(y0, yn), _rel(h0, hn)) < TOL[dtype]


@pytest.mark.parametrize("chunk,seq", [
    (16, 33), (32, 64), (64, 100), (96, 128), (16, 128), (32, 47), (64, 65),
    (96, 96)])
def test_ssd_chunk_size_invariance(chunk, seq):
    """Twin of the JAX package's property test (which needs hypothesis):
    the chunked algorithm is exact for any chunk size and sequence length,
    ragged final chunks included."""
    j, t = _inputs((1, seq, 2, 1, 8, 16), seed=seq)
    yn, hn = j_ref.ssd_naive(*_args(j))
    y, h = ref.ssd_chunked(*_args(t), chunk=chunk)
    assert _rel(y, yn) < 1e-5 and _rel(h, hn) < 1e-5
    y0, h0 = ref.ssd_naive(*_args(t))
    assert _rel(y, y0.numpy()) < 1e-5 and _rel(h, h0.numpy()) < 1e-5


def test_ssd_decode_step_consistency():
    """Running ssd_step over a sequence == ssd_naive (port and JAX)."""
    B, S, H, G, P, N = 1, 24, 2, 1, 8, 16
    j, t = _inputs((B, S, H, G, P, N))
    yn, hn = j_ref.ssd_naive(*_args(j))
    x, dt, A, Bm, Cm = _args(t)
    h = torch.zeros(B, H, P, N)
    ys = []
    for s in range(S):
        y, h = ref.ssd_step(x[:, s], dt[:, s], A, Bm[:, s], Cm[:, s], h)
        ys.append(y)
    y1 = torch.stack(ys, dim=1)
    assert float(np.max(np.abs(y1.numpy() - np.asarray(yn)))) < 1e-4
    assert float(np.max(np.abs(h.numpy() - np.asarray(hn)))) < 1e-4
    jy, jh = j_ref.ssd_step(j["x"][:, 0], j["dt"][:, 0], j["A"], j["Bm"][:, 0],
                            j["Cm"][:, 0], jnp.zeros((B, H, P, N)))
    y, h = ref.ssd_step(x[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0],
                        torch.zeros(B, H, P, N))
    assert _rel(y, jy) < 1e-6 and _rel(h, jh) < 1e-6


def test_ssd_ops_dispatcher():
    """Twin of test_ssd_ops_dispatcher: the plain route and the kernel route
    agree, and match the JAX dispatcher's routes."""
    j, t = _inputs((1, 64, 2, 1, 8, 16))
    y_x, _ = ssd_ops.ssd(*_args(t), chunk=32, use_pallas=False)
    y_p, _ = ssd_ops.ssd(*_args(t), chunk=32, use_pallas=True)
    assert float((y_x - y_p).abs().max()) < 1e-4
    jy_x, _ = j_ops.ssd(*_args(j), chunk=32, use_pallas=False)
    jy_p, _ = j_ops.ssd(*_args(j), chunk=32, use_pallas=True, interpret=True)
    assert _rel(y_x, jy_x) < 1e-5 and _rel(y_p, jy_p) < 1e-5


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ssd_mixed_precision_matches_jax(dtype):
    """precision='mixed' rounds the operands of the large products to the
    input dtype and accumulates in f32, as the JAX package does; in f32 it
    is the 'highest' path."""
    j, t = _inputs((2, 80, 4, 2, 16, 32), dtype, seed=3)
    jy, jh = j_ref.ssd_chunked(*_args(j), chunk=32, precision="mixed")
    y, h = ssd_ops.ssd(*_args(t), chunk=32, precision="mixed")
    assert max(_rel(y, jy), _rel(h, jh)) < TOL[dtype]
    yh, _ = ref.ssd_chunked(*_args(t), chunk=32, precision="highest")
    if dtype == "float32":
        torch.testing.assert_close(y, yh, rtol=0, atol=0)
    else:
        assert not torch.equal(y, yh)


def test_ssd_initial_state_matches_jax():
    """h0 on the plain routes (the kernel starts from a zero state)."""
    j, t = _inputs((1, 70, 2, 1, 8, 16), h0=True)
    jy, jh = j_ref.ssd_chunked(*_args(j), chunk=32, h0=j["h0"])
    y, h = ssd_ops.ssd(*_args(t), chunk=32, h0=t["h0"])
    assert max(_rel(y, jy), _rel(h, jh)) < 1e-5
    jy, jh = j_ref.ssd_naive(*_args(j), h0=j["h0"])
    y, h = ref.ssd_naive(*_args(t), h0=t["h0"])
    assert max(_rel(y, jy), _rel(h, jh)) < 1e-5


def test_ssd_kernel_route_refuses_h0():
    """As ``ssd_pallas`` asserts h0 is None, the kernel route raises on any
    device, so the CPU route holds the kernel's contract."""
    _, t = _inputs((1, 16, 2, 1, 8, 16), h0=True)
    with pytest.raises(ValueError, match="h0"):
        ssd_ops.ssd(*_args(t), chunk=8, use_pallas=True, h0=t["h0"])
    with pytest.raises(AssertionError):
        j, _ = _inputs((1, 16, 2, 1, 8, 16), h0=True)
        ssd_pallas(*_args(j), chunk=8, interpret=True, h0=j["h0"])


def test_ssd_chunked_never_exponentiates_above_the_diagonal():
    """Large dt makes exp(cum_i - cum_j) overflow for j > i; the select must
    keep those entries out (no inf or NaN in y)."""
    j, t = _inputs((1, 64, 2, 1, 8, 16), seed=9)
    t["dt"] = t["dt"] * 50.0
    j["dt"] = j["dt"] * 50.0
    y, h = ref.ssd_chunked(*_args(t), chunk=64)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
    yn, hn = j_ref.ssd_naive(*_args(j))
    assert max(_rel(y, yn), _rel(h, hn)) < 1e-5
