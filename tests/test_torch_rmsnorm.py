"""RMSNorm on the CPU: the gated norm of the Mamba2 block (``x * silu(gate)``
normalized) and the plain norm, through the plain version, ``layers.rmsnorm``
under both values of ``use_pallas`` and the ``ops`` wrapper, against the JAX
package on the same numpy inputs; the wrapper's refusals; and the launch
plan the CUDA kernel is given at the main paths' shapes.

Tolerances: 2e-5 in f32 (the row sum in another order); 0.05 in bf16 (one
bf16 rounding of the output on each side, as the JAX package's kernel tests
allow). The gated norm in bf16 is held at 0.05 against JAX given the gate
product as PyTorch's eager ops round it (silu in f32 rounded to bf16, then
the product rounded); against JAX's own bf16 ``y * jax.nn.silu(z)``, whose
silu rounds the sigmoid and then its product, g may differ by one bf16 step
(2^-8 of it), which the norm carries into the output in proportion: there
the bound is 0.05 of max(1, |want|) per element."""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels.fused_rmsnorm import ops as j_rn
from repro.models import layers as jL
from repro_torch import device as port_device
from repro_torch.kernels import _build
from repro_torch.kernels.fused_rmsnorm import ops as rn_ops
from repro_torch.kernels.fused_rmsnorm import ref as rn_ref
from repro_torch.models import layers as L

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 2e-5, "bfloat16": 0.05}
EPS = 1e-5


def _inputs(shapes, dtype, seed):
    """The same random values as a jnp array and a CPU tensor, each rounded
    to ``dtype`` once (w scaled by 0.1, as a trained (1 + w) stays near 1)."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    out = []
    for i, shape in enumerate(shapes):
        a = rng.standard_normal(shape).astype(np.float32)
        if i == len(shapes) - 1:
            a *= 0.1
        out.append((jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)))
    return out


def _err(port, jax_out):
    return float(np.max(np.abs(port.float().numpy()
                               - np.asarray(jax_out, np.float32))))


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("d", [32, 128, 256])
@pytest.mark.parametrize("rows", [1, 7, 33, 70])
def test_gated_norm_vs_jax(rows, d, dtype, use_pallas):
    (jy, y), (jz, z), (jw, w) = _inputs([(rows, d), (rows, d), (d,)], dtype,
                                        seed=rows * 1000 + d)
    jdt = DTYPES[dtype][0]
    s = jax.nn.silu(jz.astype(jnp.float32)).astype(jdt)
    g = (jy.astype(jnp.float32) * s.astype(jnp.float32)).astype(jdt)
    want = jL.rmsnorm({"scale": jw}, g, EPS)
    literal = np.asarray(jL.rmsnorm({"scale": jw}, jy * jax.nn.silu(jz), EPS),
                         np.float32)
    n0 = rn_ops.launches
    got = L.rmsnorm({"scale": w}, y, EPS, use_pallas, gate=z)
    plain = rn_ref.rmsnorm_ref(y, w, eps=EPS, gate=z)
    assert rn_ops.launches == n0, "a CPU tensor must not launch the kernel"
    assert got.shape == y.shape and got.dtype == y.dtype
    # the gate changes no arithmetic: the plain branch is today's eager
    # y * F.silu(z) then the norm, to the bit, and so is the CPU wrapper
    torch.testing.assert_close(got, L.rmsnorm({"scale": w}, y * F.silu(z), EPS),
                               rtol=0, atol=0)
    torch.testing.assert_close(got, plain, rtol=0, atol=0)
    assert _err(got, want) < TOL[dtype]
    diff = np.abs(got.float().numpy() - literal)
    assert np.all(diff < TOL[dtype] * np.maximum(1.0, np.abs(literal)))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("layout", ["3d", "row stride", "row stride 3d"])
def test_ungated_norm_vs_jax_pallas(layout, dtype):
    """The ungated path on x of more than 2 dims and on rows of a wider
    buffer (a row stride, taken without a copy on the card), against the
    JAX package's Pallas kernel in interpret mode and its jnp oracle."""
    d = 96
    (jb, buf), (jw, w) = _inputs([(2, 5, d + 32), (d,)], dtype, seed=11)
    if layout == "3d":
        jx, x = jb[..., :d], buf[..., :d].contiguous()
    elif layout == "row stride":
        jx, x = jb.reshape(10, d + 32)[:, :d], buf.view(10, d + 32)[:, :d]
    else:
        jx, x = jb[..., 16:16 + d], buf[..., 16:16 + d]
    want = j_rn.rmsnorm(jx, jw, eps=EPS, use_pallas=True, interpret=True)
    oracle = j_rn.rmsnorm(jx, jw, eps=EPS, use_pallas=False)
    n0 = rn_ops.launches
    got = rn_ops.rmsnorm(x, w, eps=EPS)
    assert rn_ops.launches == n0
    assert got.shape == x.shape and got.dtype == x.dtype
    for use_pallas in (False, True):
        torch.testing.assert_close(
            L.rmsnorm({"scale": w}, x, EPS, use_pallas), got, rtol=0, atol=0)
    assert _err(got, want) < TOL[dtype]
    assert _err(got, oracle) < TOL[dtype]


@pytest.mark.parametrize("bad,error", [
    ("shape", ValueError), ("broadcast shape", ValueError),
    ("dtype", TypeError), ("device", ValueError)])
def test_wrapper_refuses_a_gate_it_cannot_take(bad, error):
    """Checked on every device, before the CPU path: there a wrong gate
    would broadcast or promote silently."""
    x, w = torch.zeros(4, 32), torch.zeros(32)
    gate = {"shape": torch.zeros(4, 16), "broadcast shape": torch.zeros(1, 32),
            "dtype": torch.zeros(4, 32, dtype=torch.bfloat16),
            "device": torch.zeros(4, 32, device="meta")}[bad]
    n0 = rn_ops.launches
    with pytest.raises(error):
        rn_ops.rmsnorm(x, w, gate=gate)
    assert rn_ops.launches == n0


def test_wrapper_refuses_what_the_kernel_does_not_take_on_other_devices():
    x = torch.zeros(4, 32, device="meta")
    with pytest.raises(ValueError):
        rn_ops.rmsnorm(x, torch.zeros(32, device="meta"), gate=x)


@pytest.mark.parametrize("gated", [False, True])
def test_cpu_tensor_never_launches(gated):
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((8, 77)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal(77).astype(np.float32)) * 0.1
    gate = -x if gated else None
    n0 = rn_ops.launches
    got = rn_ops.rmsnorm(x, w, eps=EPS, gate=gate)
    assert rn_ops.launches == n0
    torch.testing.assert_close(got, rn_ref.rmsnorm_ref(x, w, eps=EPS,
                                                       gate=gate),
                               rtol=0, atol=0)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("parts", [2, 4])
def test_split_row_against_jax_gated_norm(parts, dtype):
    """The split mode's two plain passes through the wrapper (CPU tensors:
    ``row_sumsq``, the sums of the ``parts`` column blocks added, then
    ``rmsnorm(..., row_ss=, width=)`` of each block) concatenated, against
    JAX's ``rmsnorm(p, y * silu(z))`` on the whole row, at the tolerances
    of the unsplit norm; no launch on CPU tensors."""
    rows, d = 7, 32 * parts
    (jy, y), (jz, z), (jw, w) = _inputs([(rows, d), (rows, d), (d,)], dtype,
                                        seed=parts)
    want = jL.rmsnorm({"scale": jw}, jy * jax.nn.silu(jz), EPS)
    n0 = rn_ops.launches
    cols = [slice(k * 32, (k + 1) * 32) for k in range(parts)]
    total = sum(rn_ops.row_sumsq(y[:, c], z[:, c]) for c in cols)
    assert total.dtype == torch.float32 and total.shape == (rows,)
    got = torch.cat([rn_ops.rmsnorm(y[:, c], w[c], eps=EPS, gate=z[:, c],
                                    row_ss=total, width=d) for c in cols], -1)
    assert rn_ops.launches == n0
    assert got.dtype == y.dtype
    assert _err(got, want) < TOL[dtype]
    unsplit = rn_ref.rmsnorm_ref(y, w, eps=EPS, gate=z)
    assert _err(got, unsplit.float().numpy()) < TOL[dtype]


@pytest.mark.parametrize("bad", ["shape", "dtype", "device", "width"])
def test_wrapper_refuses_a_row_sum_it_cannot_take(bad):
    x, w = torch.zeros(4, 32), torch.zeros(32)
    ss = {"shape": torch.ones(3), "dtype": torch.ones(4, dtype=torch.float64),
          "device": torch.ones(4, device="meta"),
          "width": torch.ones(4)}[bad]
    with pytest.raises(ValueError):
        rn_ops.rmsnorm(x, w, row_ss=ss, width=16 if bad == "width" else 64)


# (rows, d, itemsize, gated) -> (threads, rows per block, blocks) on 132
# SMs: every norm of the three main paths (chatglm3-6b d_model 4,096;
# zamba2-7b 3,584 and the gated d_inner 7,168; mamba2-130m 768 and the gated
# 1,536) at prefill's 8,192 rows and a decode step's 8, in bf16 and f32.
# Each thread holds up to 4 16-byte vectors; ungated rows a block per row
# block, gated rows a persistent grid of about 512 threads an SM, and at a
# decode step a vector or two a thread.
MAIN_PATH_PLANS = {
    (8192, 4096, 2, False): (128, 1, 8192),
    (8192, 3584, 2, False): (128, 1, 8192),
    (8192, 7168, 2, True): (224, 1, 264),
    (8192, 768, 2, False): (32, 4, 2048),
    (8192, 1536, 2, True): (64, 2, 528),
    (8, 4096, 2, False): (128, 1, 8),
    (8, 3584, 2, False): (128, 1, 8),
    (8, 7168, 2, True): (512, 1, 8),
    (8, 768, 2, False): (32, 1, 8),
    (8, 1536, 2, True): (192, 1, 8),
    (8192, 4096, 4, False): (256, 1, 8192),
    (8192, 7168, 4, True): (448, 1, 132),
    (8192, 768, 4, False): (64, 2, 4096),
    (8192, 1536, 4, True): (96, 1, 660),
    (8, 4096, 4, False): (256, 1, 8),
    (8, 7168, 4, True): (512, 1, 8),
    (8, 768, 4, False): (64, 1, 8),
    (8, 1536, 4, True): (384, 1, 8),
}


@pytest.mark.parametrize("shape", list(MAIN_PATH_PLANS),
                         ids=lambda s: "x".join(map(str, s)))
def test_plan_at_the_main_path_shapes(shape):
    rows, d, itemsize, gated = shape
    assert rn_ops.plan(rows, d, 16 // itemsize, True, 132, gated) == \
        MAIN_PATH_PLANS[shape]


@pytest.mark.parametrize("vec", [4, 8])
def test_plan_takes_every_width(vec):
    """The plans the C entry point accepts (its own check, repeated): whole
    warps, at most 512 threads a block, every vector of a row held by a
    thread of its group, at least one block and no more than there are row
    blocks; the scalar kernel (threads 0) for rows that are not aligned or
    too wide for the registers."""
    for rows, d, gated in itertools.product(
            (1, 3, 8, 33, 132, 133, 1000, 8192),
            list(range(vec, 40 * vec, vec)) + [768, 4096, 7168, 8192, 16384,
                                                32768],
            (False, True)):
        threads, rpb, blocks = rn_ops.plan(rows, d, vec, True, 132, gated)
        assert rn_ops.plan(rows, d, vec, False, 132, gated)[0] == 0
        if threads == 0:
            assert d // vec > rn_ops.MAX_THREADS * rn_ops.LOADS
            continue
        assert threads % 32 == 0 and 32 <= threads <= rn_ops.MAX_THREADS
        assert 1 <= rpb and threads * rpb <= rn_ops.MAX_THREADS
        assert threads * rn_ops.LOADS >= d // vec
        assert 1 <= blocks <= -(-rows // rpb)
        if rows <= 132:                 # a block a row
            assert (rpb, blocks) == (1, rows)


def test_load_returns_a_loaded_library_without_the_lock(monkeypatch):
    """A launch finds its library with one dict lookup: no lock is taken
    once it is loaded."""
    class NoLock:
        def __enter__(self):
            raise AssertionError("the lock was taken")

        def __exit__(self, *exc):
            return False

    lib = object()
    monkeypatch.setitem(_build._libs, "a_kernel", lib)
    monkeypatch.setattr(_build, "_lock", NoLock())
    assert _build.load("a_kernel", {}) is lib


def test_sm_count_is_read_once_per_device(monkeypatch):
    calls = []

    class Props:
        multi_processor_count = 132

    def props(index):
        calls.append(index)
        return Props()

    monkeypatch.setattr(torch.cuda, "get_device_properties", props)
    monkeypatch.setattr(port_device, "_sm_counts", {})
    assert [port_device.sm_count(i) for i in (3, 3, 4, 3)] == [132] * 4
    assert calls == [3, 4]
