"""Each kernel module of the port on the CPU: its plain version (``ref.py``)
and its ``ops`` wrapper, on CPU tensors, against the JAX package's Pallas
kernel run in interpret mode (as tests/test_kernels.py runs it) and against
the JAX oracle, on the same numpy inputs.

Tolerances: 2e-5 in f32 (sums in another order); 2e-2 in bf16 for attention
and 0.05 for RMSNorm (one bf16 rounding of the output on each side, as in
the JAX package's own kernel tests)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import ops as j_da
from repro.kernels.flash_attention import ops as j_fa
from repro.kernels.fused_rmsnorm import ops as j_rn
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention import ref as da_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.fused_rmsnorm import ops as rn_ops
from repro_torch.kernels.fused_rmsnorm import ref as rn_ref
from repro_torch.kernels.ssd import ops as ssd_ops

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(shapes, dtype, seed=7):
    """The same random values as a jnp array and a CPU tensor, each rounded
    to ``dtype`` once."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    out = []
    for shape in shapes:
        a = rng.standard_normal(shape).astype(np.float32)
        out.append((jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)))
    return out


def _err(port, jax_out):
    return float(np.max(np.abs(port.float().numpy()
                               - np.asarray(jax_out, np.float32))))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", [
    (2, 256, 4, 2, 64),      # GQA
    (1, 200, 4, 4, 32),      # non-multiple seq
    (1, 384, 8, 1, 128),     # MQA, wide head
    (1, 200, 4, 2, 80),      # stablelm-3b head width, ragged seq
])
def test_flash_attention_vs_jax_pallas(shape, dtype):
    B, S, H, KV, hd = shape
    (jq, q), (jk, k), (jv, v) = _inputs([(B, S, H, hd), (B, S, KV, hd),
                                         (B, S, KV, hd)], dtype)
    scale = 1.0 / np.sqrt(hd)
    want = j_fa.flash_attention(jq, jk, jv, scale=scale, use_pallas=True,
                                interpret=True)
    oracle = j_fa.flash_attention(jq, jk, jv, scale=scale, use_pallas=False)
    n0 = fa_ops.launches
    got = fa_ops.flash_attention(q, k, v, scale=scale)
    plain = fa_ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), scale=scale).transpose(1, 2)
    assert fa_ops.launches == n0, "a CPU tensor must not launch the kernel"
    assert got.shape == (B, S, H, hd) and got.dtype == q.dtype
    torch.testing.assert_close(got, plain, rtol=0, atol=0)
    assert _err(got, want) < ATTN_TOL[dtype]
    assert _err(got, oracle) < ATTN_TOL[dtype]


@pytest.mark.parametrize("S", [1, 5, 64, 130])
@pytest.mark.parametrize("G", [1, 2, 4])
def test_flash_backward_plain_version_is_autograds(G, S):
    """``ref.attention_bwd_ref`` (FA2's gradient from o, the log-sum-exp and
    dO, over the whole masked score matrix) against autograd through
    ``ref.attention_ref``, f32: 1e-5 of each gradient's largest and 1e-6
    absolute (the same sums in another order; at S = 1 dq and dk are 0).
    The log-sum-exp against torch.logsumexp of the masked scaled scores."""
    B, KV, hd = 2, 2, 16
    rng = np.random.default_rng(G * 1000 + S)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                   for s in ((B, G * KV, S, hd), (B, KV, S, hd),
                             (B, KV, S, hd), (B, G * KV, S, hd)))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o, lse = fa_ref.attention_ref(*leaves, scale=0.3, return_lse=True)
    torch.testing.assert_close(o, fa_ref.attention_ref(q, k, v, scale=0.3),
                               rtol=0, atol=0)
    scores = torch.einsum("bhqd,bhsd->bhqs", q,
                          k.repeat_interleave(G, dim=1)) * 0.3
    causal = torch.ones(S, S, dtype=torch.bool).tril()
    want_lse = torch.logsumexp(scores.masked_fill(~causal, float("-inf")), -1)
    torch.testing.assert_close(lse, want_lse, rtol=1e-6, atol=1e-6)
    want = torch.autograd.grad(o, leaves, do)
    got = fa_ref.attention_bwd_ref(q, k, v, o.detach(), lse.detach(), do,
                                   scale=0.3)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        torch.testing.assert_close(g, w, rtol=0,
                                   atol=1e-5 * float(w.abs().max()) + 1e-6)


@pytest.mark.parametrize("shape", [(2, 200, 4, 2, 80), (1, 130, 4, 1, 64)])
def test_flash_backward_plain_version_vs_jax(shape):
    """The port's plain backward, in the model layout (``ops.plain_bwd`` of
    ``ops.plain_lse``'s o and log-sum-exp), against jax.vjp of the JAX
    package's flash attention oracle on the same inputs, f32: 2e-5 of each
    gradient's largest (sums in another order)."""
    import jax
    B, S, H, KV, hd = shape
    (jq, q), (jk, k), (jv, v), (jdo, do) = _inputs(
        [(B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd), (B, S, H, hd)],
        "float32")
    _, vjp = jax.vjp(lambda q, k, v: j_fa.flash_attention(
        q, k, v, scale=0.125, use_pallas=False), jq, jk, jv)
    want = vjp(jdo)
    o, lse = fa_ops.plain_lse(q, k, v, scale=0.125)
    got = fa_ops.plain_bwd(q, k, v, o, lse, do, scale=0.125)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert _err(g, w) < 2e-5 * float(np.abs(w).max())


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape,valid", [
    ((2, 512, 4, 2, 64), 301),
    ((1, 1024, 8, 8, 32), 1024),
    ((2, 640, 4, 1, 128), 17),
])
def test_decode_attention_vs_jax_pallas(shape, valid, dtype):
    B, S, H, KV, hd = shape
    (jq, q), (jk, k), (jv, v) = _inputs([(B, 1, H, hd), (B, S, KV, hd),
                                         (B, S, KV, hd)], dtype)
    want = j_da.decode_attention(jq, jk, jv, valid, scale=0.1, use_pallas=True,
                                 interpret=True, block_k=128)
    oracle = j_da.decode_attention(jq, jk, jv, valid, scale=0.1,
                                   use_pallas=False)
    n0 = da_ops.launches
    vl = torch.tensor(valid, dtype=torch.int32)      # as the model passes it
    got = da_ops.decode_attention(q, k, v, vl, scale=0.1)
    plain = da_ref.decode_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                        v.transpose(1, 2), valid, scale=0.1
                                        ).transpose(1, 2)
    assert da_ops.launches == n0, "a CPU tensor must not launch the kernel"
    assert got.shape == (B, 1, H, hd) and got.dtype == q.dtype
    torch.testing.assert_close(got, plain, rtol=0, atol=0)
    assert _err(got, want) < ATTN_TOL[dtype]
    assert _err(got, oracle) < ATTN_TOL[dtype]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("d", [32, 128, 256])
@pytest.mark.parametrize("rows", [1, 7, 33, 70])
def test_rmsnorm_vs_jax_pallas(rows, d, dtype):
    (jx, x), (jw, w) = _inputs([(rows, d), (d,)], dtype, seed=rows * 1000 + d)
    want = j_rn.rmsnorm(jx, jw, eps=1e-6, use_pallas=True, interpret=True)
    oracle = j_rn.rmsnorm(jx, jw, eps=1e-6, use_pallas=False)
    n0 = rn_ops.launches
    got = rn_ops.rmsnorm(x, w, eps=1e-6)
    plain = rn_ref.rmsnorm_ref(x, w, eps=1e-6)
    assert rn_ops.launches == n0, "a CPU tensor must not launch the kernel"
    assert got.shape == x.shape and got.dtype == x.dtype
    torch.testing.assert_close(got, plain, rtol=0, atol=0)
    tol = 2e-5 if dtype == "float32" else 0.05
    assert _err(got, want) < tol
    assert _err(got, oracle) < tol


def test_jax_decode_kernel_at_valid_len_zero_returns_zeros():
    """The JAX package's Pallas decode kernel runs no kv block at
    valid_len 0 and divides a zero accumulator by max(l, 1e-30): zeros, as
    the port's CUDA kernel returns (tests/test_torch_gpu.py). Only the plain
    versions, the JAX oracle and ``ref.decode_attention_ref``, return the
    mean of V there."""
    from repro.kernels.decode_attention.decode_attention import (
        decode_attention_bhd)
    (jq, q), (jk, k) = _inputs([(2, 4, 1, 32), (2, 2, 128, 32)], "float32")
    got = decode_attention_bhd(jq, jk, jk, jnp.int32(0), scale=0.1,
                               block_k=64, interpret=True)
    assert got.shape == (2, 4, 1, 32)
    assert float(jnp.max(jnp.abs(got))) == 0.0
    plain = da_ref.decode_attention_ref(q, k, k, 0, scale=0.1)
    mean_v = k.mean(dim=2, keepdim=True).repeat_interleave(2, dim=1)
    torch.testing.assert_close(plain, mean_v, rtol=1e-5, atol=1e-6)


def test_wrappers_refuse_other_devices():
    x = torch.zeros(2, 4, 2, 16, device="meta")
    with pytest.raises(ValueError):
        fa_ops.flash_attention(x, x, x, scale=1.0)
    with pytest.raises(ValueError):
        da_ops.decode_attention(x[:, :1], x, x,
                                torch.zeros((), dtype=torch.int32,
                                            device="meta"), scale=1.0)
    with pytest.raises(ValueError):
        rn_ops.rmsnorm(x, torch.zeros(16, device="meta"))
    dt = torch.zeros(2, 4, 2, device="meta")
    with pytest.raises(ValueError):
        ssd_ops.ssd(x, dt, torch.zeros(2, device="meta"), x, x, chunk=4,
                    use_pallas=True)


def test_decode_wrapper_takes_valid_len_only_as_a_tensor():
    """The kernel reads valid_len from the device: the wrapper takes no
    Python int, on any device, so no call site can make a host copy."""
    q, k = torch.zeros(1, 1, 2, 16), torch.zeros(1, 8, 1, 16)
    with pytest.raises(TypeError):
        da_ops.decode_attention(q, k, k, 3, scale=1.0)


def test_every_cuda_source_is_built():
    """``build_all`` builds every ``csrc/<name>.cu`` of the kernels, the SSD
    scan's and RMSNorm's included, and nothing else: every kernel of the
    port is CUDA C++."""
    from repro_torch.kernels import _build
    sources = {p.stem for p in _build.KERNELS_DIR.glob("*/csrc/*.cu")}
    assert sources == set(_build.CUDA_KERNELS) == {
        "flash_attention", "decode_attention", "fused_rmsnorm", "ssd"}
    for name in _build.CUDA_KERNELS:
        assert _build._source(name).is_file()


def test_an_edited_header_rebuilds(tmp_path, monkeypatch):
    """The library name hashes every ``*.cuh`` under kernels/, not only
    ``common.cuh``: editing or adding a header gives every kernel a new
    name, so a stale build is never loaded."""
    import shutil
    from repro_torch.kernels import _build
    root = tmp_path / "kernels"
    shutil.copytree(_build.KERNELS_DIR, root,
                    ignore=shutil.ignore_patterns("__pycache__"))
    monkeypatch.setattr(_build, "KERNELS_DIR", root)
    before = {n: _build._target(n) for n in _build.CUDA_KERNELS}
    assert {p.name for p in _build._headers()} >= {"common.cuh", "hopper.cuh"}
    (root / "hopper.cuh").write_text((root / "hopper.cuh").read_text() + "\n")
    edited = {n: _build._target(n) for n in _build.CUDA_KERNELS}
    (root / "ssd" / "csrc" / "extra.cuh").write_text("#pragma once\n")
    added = {n: _build._target(n) for n in _build.CUDA_KERNELS}
    for n in _build.CUDA_KERNELS:
        assert len({before[n], edited[n], added[n]}) == 3
