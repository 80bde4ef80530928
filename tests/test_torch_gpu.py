"""The port's kernels on the card: each CUDA kernel against its plain
PyTorch version on the same CUDA tensors, and the model and serving path on
the kernels against the plain path.

Every test here needs a CUDA device (and nvcc, which builds the kernels;
nothing needs Triton). Whether a device is present is decided inside the
``cuda`` fixture, never at import, so every pytest-xdist worker collects the
same tests; without a card they skip.
Run on the card (where JAX, which tests/conftest.py imports, is absent):
``PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_gpu.py``.
"""
import dataclasses
import threading

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention import ref as da_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.fused_rmsnorm import ops as rn_ops
from repro_torch.kernels.fused_rmsnorm import ref as rn_ref
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd import ref as ssd_ref
from repro_torch.launch.serve import _positions, serve_batch
from repro_torch.models import model as M

pytestmark = pytest.mark.gpu

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# deepseek's smoke config at its published MLA head widths (q/k 128 + 64,
# v 128): the flash kernel is built for that pair, not the smoke's (24, 16)
MLA_WIDTHS = {"qk_nope_head_dim": 128, "qk_rope_head_dim": 64,
              "v_head_dim": 128}
SMOKE_OVERRIDES = {"deepseek-v2-lite-16b": MLA_WIDTHS}
# f32: the kernel sums in another order than cuBLAS; bf16: one rounding of
# the output plus bf16 inputs, as in the JAX package's kernel tests
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(rng, shape, dtype, device):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
        device=device, dtype=dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", [
    (2, 256, 4, 2, 64), (1, 200, 4, 4, 32), (1, 384, 8, 1, 128),
    (1, 200, 4, 2, 80), (1, 130, 2, 1, 256), (2, 1024, 32, 2, 128)])
def test_flash_kernel_vs_plain(cuda, shape, dtype):
    B, S, H, KV, hd = shape
    rng = np.random.default_rng(0)
    dt = DTYPES[dtype]
    q = _randn(rng, (B, S, H, hd), dt, cuda)
    k = _randn(rng, (B, S, KV, hd), dt, cuda)
    v = _randn(rng, (B, S, KV, hd), dt, cuda)
    n0 = fa_ops.launches
    got = fa_ops.flash_attention(q, k, v, scale=hd ** -0.5)
    torch.cuda.synchronize()
    assert fa_ops.launches == n0 + 1
    want = fa_ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), scale=hd ** -0.5
                                ).transpose(1, 2)
    err = (got.float() - want.float()).abs().max().item()
    assert err < TOL[dtype], f"{shape} {dtype}: {err}"


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape,valid", [
    ((2, 512, 4, 2, 64), 301), ((1, 1024, 8, 8, 32), 1024),
    ((2, 640, 4, 1, 128), 17), ((8, 1056, 32, 2, 128), 1025),
    ((8, 1056, 32, 2, 128), 3), ((2, 300, 32, 32, 80), 200)])
def test_decode_kernel_vs_plain(cuda, shape, valid, dtype):
    B, S, H, KV, hd = shape
    rng = np.random.default_rng(1)
    dt = DTYPES[dtype]
    q = _randn(rng, (B, 1, H, hd), dt, cuda)
    k = _randn(rng, (B, S, KV, hd), dt, cuda)
    v = _randn(rng, (B, S, KV, hd), dt, cuda)
    vl = torch.full((), valid, dtype=torch.int32, device=cuda)
    n0 = da_ops.launches
    got = da_ops.decode_attention(q, k, v, vl, scale=0.1)
    torch.cuda.synchronize()
    assert da_ops.launches == n0 + 1
    want = da_ref.decode_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                       v.transpose(1, 2), vl, scale=0.1
                                       ).transpose(1, 2)
    err = (got.float() - want.float()).abs().max().item()
    assert err < TOL[dtype], f"{shape}@{valid} {dtype}: {err}"


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("G", [1, 4, 16])
@pytest.mark.parametrize("S", [200, 1000])
@pytest.mark.parametrize("hd", [64, 80, 112, 128, 160, 256])
def test_flash_kernel_head_widths(cuda, hd, S, G, dtype):
    """Every head width of the ported configs (bf16: 64-column TMA slabs,
    the last one partly past hd), ragged S, MHA to G = 16."""
    B, KV = 1, 2
    H = G * KV
    rng = np.random.default_rng(hd + S + G)
    dt = DTYPES[dtype]
    q = _randn(rng, (B, S, H, hd), dt, cuda)
    k = _randn(rng, (B, S, KV, hd), dt, cuda)
    v = _randn(rng, (B, S, KV, hd), dt, cuda)
    got = fa_ops.flash_attention(q, k, v, scale=hd ** -0.5)
    torch.cuda.synchronize()
    want = fa_ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), scale=hd ** -0.5
                                ).transpose(1, 2)
    err = (got.float() - want.float()).abs().max().item()
    assert err < TOL[dtype], f"hd {hd} S {S} G {G} {dtype}: {err}"


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("S", [200, 1000])
def test_flash_kernel_mla_widths(cuda, S, G, dtype):
    """MLA's prefill: q/k 192 wide (3 TMA slabs, 64-row kv tiles), v and the
    output 128 wide; ragged S."""
    B, KV = 2, 2
    H = G * KV
    rng = np.random.default_rng(S + G)
    dt = DTYPES[dtype]
    q = _randn(rng, (B, S, H, 192), dt, cuda)
    k = _randn(rng, (B, S, KV, 192), dt, cuda)
    v = _randn(rng, (B, S, KV, 128), dt, cuda)
    n0 = fa_ops.launches
    got = fa_ops.flash_attention(q, k, v, scale=192 ** -0.5)
    torch.cuda.synchronize()
    assert fa_ops.launches == n0 + 1 and got.shape == (B, S, H, 128)
    want = fa_ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), scale=192 ** -0.5
                                ).transpose(1, 2)
    err = (got.float() - want.float()).abs().max().item()
    assert err < TOL[dtype], f"MLA S {S} G {G} {dtype}: {err}"


@pytest.mark.parametrize("widths", [(192, 192), (128, 192), (24, 16),
                                    (128, 64)])
def test_flash_kernel_refuses_width_pairs_it_was_not_built_for(cuda, widths):
    hd, hd_v = widths
    q = torch.zeros(1, 8, 2, hd, device=cuda, dtype=torch.bfloat16)
    v = torch.zeros(1, 8, 2, hd_v, device=cuda, dtype=torch.bfloat16)
    n0 = fa_ops.launches
    with pytest.raises(ValueError, match="pairs built"):
        fa_ops.flash_attention(q, q, v, scale=1.0)
    assert fa_ops.launches == n0


def _split_edge(B, KV, S, device):
    n_split, rows = da_ops.split_plan(
        B, KV, S, torch.cuda.get_device_properties(device).multi_processor_count)
    return n_split, rows


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("hd", [112, 128])
@pytest.mark.parametrize("G", [1, 2, 16])
@pytest.mark.parametrize("where", ["1", "17", "edge-1", "edge", "edge+1", "S"])
def test_decode_kernel_split_edges(cuda, where, G, hd, dtype):
    """valid_len inside the first split, around the first split edge and at
    the capacity, which is not a multiple of the split (S 1,000)."""
    B, KV, S = 2, 2, 1000
    n_split, rows = _split_edge(B, KV, S, cuda)
    assert n_split > 1 and S % rows
    valid = {"1": 1, "17": 17, "edge-1": rows - 1, "edge": rows,
             "edge+1": rows + 1, "S": S}[where]
    H = G * KV
    rng = np.random.default_rng(G + hd)
    dt = DTYPES[dtype]
    q = _randn(rng, (B, 1, H, hd), dt, cuda)
    k = _randn(rng, (B, S, KV, hd), dt, cuda)
    v = _randn(rng, (B, S, KV, hd), dt, cuda)
    vl = torch.full((), valid, dtype=torch.int32, device=cuda)
    got = da_ops.decode_attention(q, k, v, vl, scale=hd ** -0.5)
    torch.cuda.synchronize()
    want = da_ref.decode_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                       v.transpose(1, 2), vl, scale=hd ** -0.5
                                       ).transpose(1, 2)
    err = (got.float() - want.float()).abs().max().item()
    assert err < TOL[dtype], f"valid {valid} G {G} hd {hd} {dtype}: {err}"


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("offset", [-1, 0, 1])
def test_decode_kernel_at_the_zamba2_split_edge(cuda, offset, dtype):
    """zamba2-7b's decode shape: 256 (batch, kv head) pairs, two long splits;
    valid_len just below, at and just past the edge between them."""
    B, S, H, KV, hd = 8, 1056, 32, 32, 112
    n_split, rows = _split_edge(B, KV, S, cuda)
    valid = rows + offset
    rng = np.random.default_rng(7)
    dt = DTYPES[dtype]
    q = _randn(rng, (B, 1, H, hd), dt, cuda)
    k = _randn(rng, (B, S, KV, hd), dt, cuda)
    v = _randn(rng, (B, S, KV, hd), dt, cuda)
    vl = torch.full((), valid, dtype=torch.int32, device=cuda)
    got = da_ops.decode_attention(q, k, v, vl, scale=hd ** -0.5)
    torch.cuda.synchronize()
    want = da_ref.decode_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                       v.transpose(1, 2), vl, scale=hd ** -0.5
                                       ).transpose(1, 2)
    err = (got.float() - want.float()).abs().max().item()
    assert err < TOL[dtype], f"valid {valid} {dtype}: {err}"


def test_decode_grid_fills_the_card_at_the_chatglm_shape(cuda):
    """chatglm3-6b decodes 8 requests over 2 kv heads: the split-KV grid has
    at least one block per SM (PR 12's kernel ran 16 blocks)."""
    n_split, _ = _split_edge(8, 2, 1056, cuda)
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert 8 * 2 * n_split >= n_sm


def test_decode_kernel_valid_len_zero_returns_zeros(cuda):
    """With no valid cache row the kernel reads nothing and returns zeros,
    as the JAX package's Pallas kernel does (no kv block runs, and its
    finaliser divides a zero accumulator by max(l, 1e-30)); only the plain
    versions (``ref.py``, here and in the JAX package) softmax over an
    all-masked row and return the mean of V. The model never asks for this
    (valid_len = index + 1 >= 1)."""
    rng = np.random.default_rng(3)
    q = _randn(rng, (2, 1, 4, 32), torch.float32, cuda)
    k = _randn(rng, (2, 64, 2, 32), torch.float32, cuda)
    vl = torch.zeros((), dtype=torch.int32, device=cuda)
    got = da_ops.decode_attention(q, k, k, vl, scale=0.1)
    assert not bool(got.any())


# f32: rsqrt and the row sum's order; bf16: one output rounding. The gated
# kernel rounds silu(gate) and the product to x's dtype as the plain path's
# eager ops do, so it differs from it only by the row sum's order too; but a
# gated row's outputs reach 8 and more (g = x * silu(gate) is heavy-tailed),
# where one bf16 step is 0.0625: there the bf16 bound is one step, 2^-7 of
# the value, where that exceeds 0.05.
NORM_TOL = {"float32": 2e-5, "bfloat16": 0.05}


def _norm_case(cuda, rows, d, dtype, gated, seed=2):
    rng = np.random.default_rng(seed)
    dt = DTYPES[dtype]
    x = _randn(rng, (rows, d), dt, cuda)
    w = _randn(rng, (d,), dt, cuda) * 0.1
    gate = _randn(rng, (rows, d), dt, cuda) if gated else None
    return x, w, gate


def _norm_err(got, x, w, gate):
    """max|got - want| over the bound of each element (see NORM_TOL): below
    1 passes."""
    want = rn_ref.rmsnorm_ref(x, w, eps=1e-5, gate=gate).float()
    assert got.shape == want.shape and got.dtype == x.dtype
    tol = NORM_TOL["float32" if x.dtype == torch.float32 else "bfloat16"]
    bound = torch.full_like(want, tol)
    if gate is not None and x.dtype == torch.bfloat16:
        bound = torch.maximum(bound, want.abs() * 2.0 ** -7)
    return ((got.float() - want).abs() / bound).max().item()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("rows,d,gated", [
    (1, 32, False), (37, 128, False), (70, 256, False), (8, 4096, False),
    (8192, 4096, False), (5, 3000, False), (5, 77, False), (8, 77, True),
    (8, 7168, True), (8192, 7168, True), (8, 1536, True), (37, 128, True)])
def test_rmsnorm_kernel_vs_plain(cuda, rows, d, gated, dtype):
    """d = 77: rows that are not 16-byte aligned take the scalar kernel."""
    x, w, gate = _norm_case(cuda, rows, d, dtype, gated)
    n0 = rn_ops.launches
    got = rn_ops.rmsnorm(x, w, eps=1e-5, gate=gate)
    torch.cuda.synchronize()
    assert rn_ops.launches == n0 + 1
    err = _norm_err(got, x, w, gate)
    assert err < 1, f"{rows}x{d} gated={gated}: {err} of the bound"


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("rows,d,width", [
    (8, 4096, 4096 + 64), (8192, 768, 1024), (9, 96, 104), (9, 96, 97)])
def test_rmsnorm_kernel_takes_rows_of_a_wider_buffer(cuda, rows, d, width,
                                                    gated, dtype):
    """x and the gate as the first d columns of (rows, width) buffers, read
    in place through their row stride (16-byte aligned rows take the vector
    kernel, width 97 the scalar one); the output is contiguous."""
    x, w, gate = _norm_case(cuda, rows, width, dtype, gated, seed=4)
    w = w[:d].contiguous()
    x = x[:, :d]
    gate = gate[:, :d] if gated else None
    got = rn_ops.rmsnorm(x, w, eps=1e-5, gate=gate)
    torch.cuda.synchronize()
    assert got.is_contiguous()
    assert _norm_err(got, x, w, gate) < 1


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("rows,d,gated", [
    (1000, 4096, False), (1000, 7168, True), (333, 768, True),
    (8, 1536, False)])
def test_rmsnorm_kernel_any_grid_takes_every_row(cuda, rows, d, gated, dtype):
    """The persistent grid: every block count from one block to one per row
    block (each block walking its rows, w loaded once) gives the plain
    version's result, and so does the plan the wrapper picks."""
    x, w, gate = _norm_case(cuda, rows, d, dtype, gated, seed=6)
    vec = 16 // x.element_size()
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    threads, rpb, blocks = rn_ops.plan(rows, d, vec, True, n_sm, gated)
    assert threads > 0
    fwd = rn_ops._load()
    for n in sorted({1, 7, blocks, -(-rows // rpb)}):
        out = torch.empty_like(x)
        err = fwd(
            x.data_ptr(), 0 if gate is None else gate.data_ptr(), w.data_ptr(),
            out.data_ptr(), 0 if dtype == "float32" else 1, rows, d, d, d,
            1e-5, threads, rpb, n, torch.cuda.current_stream().cuda_stream,
            x.get_device())
        assert err == 0
        torch.cuda.synchronize()
        assert _norm_err(out, x, w, gate) < 1, f"{n} blocks"


@pytest.mark.parametrize("gated", [False, True])
def test_rmsnorm_kernel_too_wide_for_the_registers(cuda, gated):
    """Rows wider than 512 threads x 4 16-byte loads take the scalar kernel."""
    for rows in (200, 4):
        x, w, gate = _norm_case(cuda, rows, 20000, "bfloat16", gated)
        got = rn_ops.rmsnorm(x, w, eps=1e-5, gate=gate)
        torch.cuda.synchronize()
        assert _norm_err(got, x, w, gate) < 1


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("rows,d,parts", [
    (8192, 3584, 2), (8, 1792, 4), (37, 768, 2), (5, 77, 1), (9, 100, 2),
    (4, 20000, 2)])
def test_rmsnorm_split_kernels_vs_plain(cuda, rows, d, parts, gated, dtype):
    """The split row's two passes (``row_sumsq``, then ``rmsnorm`` from the
    summed row): each pass against its plain version on the same inputs,
    and the row split into ``parts`` column blocks (the ranks of a model
    group), their sums added, each block scaled over the full width,
    against the whole row's ``rmsnorm_ref``. Widths that are a multiple of
    16 bytes take the vector kernel, d = 77 and 100 in bf16 and the
    20,000-wide row the scalar one."""
    x, w, gate = _norm_case(cuda, rows, d * parts, dtype, gated, seed=8)
    n0, s0 = rn_ops.launches, rn_ops.split_launches
    blocks, total = [], None
    for k in range(parts):
        cols = slice(k * d, (k + 1) * d)
        xk = x[:, cols].contiguous()
        gk = None if gate is None else gate[:, cols].contiguous()
        ss = rn_ops.row_sumsq(xk, gk)
        want = rn_ref.row_sumsq_ref(xk, gk)
        assert ss.dtype == torch.float32 and ss.shape == (rows,)
        assert ((ss - want).abs() / want.abs().clamp_min(1e-30)).max() < 1e-5
        total = ss if total is None else total + ss
        blocks.append((xk, gk, w[cols].contiguous()))
    outs = []
    for xk, gk, wk in blocks:
        got = rn_ops.rmsnorm(xk, wk, eps=1e-5, gate=gk, row_ss=total,
                             width=d * parts)
        want = rn_ref.rmsnorm_ref(xk, wk, eps=1e-5, gate=gk, row_ss=total,
                                  width=d * parts)
        tol = NORM_TOL["float32" if x.dtype == torch.float32 else "bfloat16"]
        bound = torch.full_like(want.float(), tol)
        if gk is not None and x.dtype == torch.bfloat16:
            bound = torch.maximum(bound, want.float().abs() * 2.0 ** -7)
        assert ((got.float() - want.float()).abs() / bound).max() < 1
        outs.append(got)
    torch.cuda.synchronize()
    assert rn_ops.launches - n0 == rn_ops.split_launches - s0 == 2 * parts
    assert _norm_err(torch.cat(outs, dim=-1), x, w, gate) < 1


def test_rmsnorm_split_kernels_refuse_what_they_do_not_take(cuda):
    x = torch.zeros(4, 64, device=cuda)
    w = torch.zeros(64, device=cuda)
    ss = torch.ones(4, device=cuda)
    with pytest.raises(ValueError):           # width below the block's
        rn_ops.rmsnorm(x, w, row_ss=ss, width=32)
    with pytest.raises(ValueError):           # row_ss not f32
        rn_ops.rmsnorm(x, w, row_ss=ss.double(), width=128)
    with pytest.raises(ValueError):           # row_ss of another shape
        rn_ops.rmsnorm(x, w, row_ss=ss[:3], width=128)
    with pytest.raises(TypeError):
        rn_ops.row_sumsq(x.half())


def test_rmsnorm_kernel_refuses_what_it_does_not_take(cuda):
    x = torch.zeros(4, 64, device=cuda)
    with pytest.raises(TypeError):            # w in another dtype than x
        rn_ops.rmsnorm(x, torch.zeros(64, device=cuda, dtype=torch.bfloat16))
    with pytest.raises(ValueError):           # w on the host
        rn_ops.rmsnorm(x, torch.zeros(64))
    with pytest.raises(ValueError):           # the gate on the host
        rn_ops.rmsnorm(x, torch.zeros(64, device=cuda), gate=torch.zeros(4, 64))
    with pytest.raises(TypeError):
        rn_ops.rmsnorm(x.half(), torch.zeros(64, device=cuda).half())


def _ssd_inputs(rng, shape, dtype, device):
    B, S, H, G, P, N = shape
    x = _randn(rng, (B, S, H, P), dtype, device)
    dt = torch.nn.functional.softplus(_randn(rng, (B, S, H), torch.float32,
                                             device))
    A = -torch.exp(torch.from_numpy(rng.uniform(0.0, 2.0, H).astype(
        np.float32)).to(device))
    Bm = _randn(rng, (B, S, G, N), dtype, device)
    Cm = _randn(rng, (B, S, G, N), dtype, device)
    return x, dt, A, Bm, Cm


def _rel(a, b):
    return ((a.float() - b.float()).abs().max()
            / (b.float().abs().max() + 1e-9)).item()


# relative, as the JAX package's test_ssd_pallas_vs_naive: f32 differs by the
# order of sums; bf16 adds one rounding of y
SSD_TOL = {"float32": 1e-5, "bfloat16": 3e-2}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape,chunk", [
    ((2, 128, 4, 1, 32, 64), 32), ((1, 96, 4, 2, 16, 32), 32),
    ((1, 256, 2, 1, 64, 128), 128), ((1, 1000, 8, 2, 64, 64), 256),
    ((2, 1024, 16, 1, 64, 64), 256), ((2, 300, 4, 1, 64, 128), 256),
    ((1, 12, 2, 1, 16, 16), 32)])
def test_ssd_kernel_vs_plain(cuda, shape, chunk, dtype):
    """Ragged tails (1,000 and 300 rows at chunk 256, 96 at 32), grouped
    B/C, N 16-128, chunk longer than the sequence; in f32 against the
    recurrence, in bf16 against the chunked plain version."""
    rng = np.random.default_rng(4)
    x, dt, A, Bm, Cm = _ssd_inputs(rng, shape, DTYPES[dtype], cuda)
    n0 = ssd_ops.launches
    y, h = ssd_ops.ssd(x, dt, A, Bm, Cm, chunk=chunk, use_pallas=True)
    torch.cuda.synchronize()
    assert ssd_ops.launches == n0 + 1
    assert y.dtype == x.dtype and y.shape == x.shape
    assert h.dtype == torch.float32 and h.shape == (
        shape[0], shape[2], shape[4], shape[5])
    # the f32 oracle is the recurrence: at chunk 256 the plain ssd_chunked is
    # itself ~1e-5 from it (exponents from differences of large f32 prefix
    # sums), which the kernel avoids by keeping its prefix sums in f64
    if dtype == "float32":
        y0, h0 = ssd_ref.ssd_naive(x, dt, A, Bm, Cm)
    else:
        y0, h0 = ssd_ref.ssd_chunked(x, dt, A, Bm, Cm, chunk=chunk)
    err = max(_rel(y, y0), _rel(h, h0))
    assert err < SSD_TOL[dtype], f"{shape} {dtype}: {err}"


# the bf16 tensor-core kernel against the plain version of its arithmetic
# (ref.ssd_chunked_tc; both round y to bf16 from f32 sums taken in another
# order, so an entry may land one bf16 step, 2^-8 of it, away: 1e-2) and
# against the recurrence in f32 on the same bf16 inputs (3e-2, as above)
SSD_TC_TOL = 1e-2


@pytest.mark.parametrize("shape,chunk", [
    ((2, 128, 4, 1, 32, 64), 32), ((1, 96, 4, 2, 16, 32), 32),
    ((1, 256, 2, 1, 64, 128), 128), ((1, 1000, 8, 2, 64, 64), 256),
    ((2, 1024, 16, 1, 64, 64), 256), ((2, 300, 4, 1, 64, 128), 256),
    ((1, 12, 2, 1, 16, 16), 32),
    ((1, 300, 4, 1, 24, 40), 256),     # P, N multiples of 8, not of 16
    ((2, 200, 3, 1, 56, 120), 64),
    ((1, 70, 2, 1, 8, 8), 7),          # chunk shorter than a 16-row tile
    ((1, 40, 2, 1, 8, 24), 5)])
def test_ssd_tc_kernel_vs_its_plain_version_and_naive(cuda, shape, chunk):
    rng = np.random.default_rng(7)
    x, dt, A, Bm, Cm = _ssd_inputs(rng, shape, torch.bfloat16, cuda)
    n0 = ssd_ops.launches
    y, h = ssd_ops.ssd(x, dt, A, Bm, Cm, chunk=chunk, use_pallas=True)
    torch.cuda.synchronize()
    assert ssd_ops.launches == n0 + 1, "one call is one launch"
    assert y.dtype == torch.bfloat16 and y.shape == x.shape
    assert bool(torch.isfinite(y.float()).all())
    y1, h1 = ssd_ref.ssd_chunked_tc(x, dt, A, Bm, Cm, chunk=chunk)
    assert max(_rel(y, y1), _rel(h, h1)) < SSD_TC_TOL
    y0, h0 = ssd_ref.ssd_naive(x.float(), dt, A, Bm.float(), Cm.float())
    assert max(_rel(y, y0), _rel(h, h0)) < SSD_TOL["bfloat16"]


@pytest.mark.parametrize("P", [8, 16, 24, 32, 40, 48, 56, 64])
def test_ssd_tc_kernel_zero_fills_p_to_its_tile(cuda, P):
    """Every width of P the kernel admits runs in its 64-column tile, the
    columns past P zero-filled and never written."""
    rng = np.random.default_rng(8)
    args = _ssd_inputs(rng, (2, 300, 3, 1, P, 64), torch.bfloat16, cuda)
    y, h = ssd_ops.ssd(*args, chunk=256, use_pallas=True)
    y1, h1 = ssd_ref.ssd_chunked_tc(*args, chunk=256)
    assert y.shape == args[0].shape and h.shape == (2, 3, P, 64)
    assert max(_rel(y, y1), _rel(h, h1)) < SSD_TC_TOL


def test_ssd_kernel_vs_naive(cuda):
    rng = np.random.default_rng(5)
    x, dt, A, Bm, Cm = _ssd_inputs(rng, (2, 70, 4, 2, 32, 32), torch.float32,
                                   cuda)
    y, h = ssd_ops.ssd(x, dt, A, Bm, Cm, chunk=32, use_pallas=True)
    y0, h0 = ssd_ref.ssd_naive(x, dt, A, Bm, Cm)
    assert max(_rel(y, y0), _rel(h, h0)) < 1e-5


def test_ssd_kernel_refuses_h0_and_odd_shapes(cuda):
    rng = np.random.default_rng(6)
    x, dt, A, Bm, Cm = _ssd_inputs(rng, (1, 64, 2, 1, 16, 16), torch.float32,
                                   cuda)
    with pytest.raises(ValueError, match="h0"):
        ssd_ops.ssd(x, dt, A, Bm, Cm, chunk=32, use_pallas=True,
                    h0=torch.zeros(1, 2, 16, 16, device=cuda))
    with pytest.raises(ValueError):                 # head dim 128 > 64
        ssd_ops.ssd(*_ssd_inputs(rng, (1, 64, 2, 1, 128, 16), torch.float32,
                                 cuda), chunk=32, use_pallas=True)
    with pytest.raises(ValueError):                 # chunk 512 > 256
        ssd_ops.ssd(*_ssd_inputs(rng, (1, 600, 2, 1, 16, 16), torch.float32,
                                 cuda), chunk=512, use_pallas=True)


def test_kernel_rejects_what_it_does_not_take(cuda):
    q = torch.zeros(1, 8, 2, 24, device=cuda)          # head_dim 24
    with pytest.raises(ValueError):
        fa_ops.flash_attention(q, q, q, scale=1.0)
    q = torch.zeros(1, 8, 2, 32, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        fa_ops.flash_attention(q, q, q, scale=1.0)


@pytest.mark.parametrize("arch,over", [
    ("chatglm3-6b", {}), ("stablelm-3b", {}), ("qwen2-vl-7b", {}),
    ("mamba2-130m", {}), ("zamba2-7b", {}),
    ("zamba2-7b", {"num_layers": 5, "attn_every": 2}),
    ("deepseek-v2-lite-16b", MLA_WIDTHS), ("phi3.5-moe-42b-a6.6b", {})])
def test_model_kernel_path_matches_plain_path(cuda, arch, over):
    cfg = get_smoke_config(arch, dtype="float32", **over)
    params = M.init_params(cfg, seed=0, device=cuda)
    B, S = 2, 40
    gen = torch.Generator(device=cuda).manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device=cuda, dtype=torch.int32)
    batch = {"tokens": tokens, "positions": _positions(cfg, B, S,
                                                       device=cuda)}
    plain = dataclasses.replace(cfg, use_pallas=False)
    lk, _, ck = M.forward(params, cfg, batch, mode="prefill")
    lp, _, cp = M.forward(params, plain, batch, mode="prefill")
    assert (lk - lp).abs().max().item() < 1e-4
    from repro_torch.distributed.serve_step import pad_cache
    ck, cp = pad_cache(ck, cfg, S + 4), pad_cache(cp, cfg, S + 4)
    db = {"tokens": tokens[:, :1],
          "positions": _positions(cfg, B, 1, start=S, device=cuda)}
    dk, _ = M.decode(params, cfg, db, ck)
    dp, _ = M.decode(params, plain, db, cp)
    assert (dk - dp).abs().max().item() < 1e-4


def test_serve_batch_runs_every_kernel(cuda):
    cfg = get_smoke_config("chatglm3-6b")
    for ops in (fa_ops, da_ops, rn_ops):
        ops.launches = 0
    n, new = 3, 5
    res = serve_batch(cfg, n_requests=n, prompt_len=24, max_new_tokens=new,
                      quiet=True, device=cuda)
    L = cfg.num_layers
    assert fa_ops.launches == L
    assert da_ops.launches == L * (new - 1)
    assert rn_ops.launches == (2 * L + 1) * new
    assert res["tokens"].shape == (n, 24 + new)


def test_serve_batch_runs_every_kernel_hybrid(cuda):
    """zamba2's smoke config with a tail: 2 groups of 2 SSM layers, each
    followed by the shared attention block, then 1 tail layer."""
    cfg = get_smoke_config("zamba2-7b", num_layers=5, attn_every=2)
    for ops in (fa_ops, da_ops, rn_ops, ssd_ops):
        ops.launches = 0
    n, new = 3, 5
    res = serve_batch(cfg, n_requests=n, prompt_len=40, max_new_tokens=new,
                      quiet=True, device=cuda)
    groups = 2
    assert ssd_ops.launches == cfg.num_layers
    assert fa_ops.launches == groups
    assert da_ops.launches == groups * (new - 1)
    assert rn_ops.launches == (2 * cfg.num_layers + 2 * groups + 1) * new
    assert res["tokens"].shape == (n, 40 + new)


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b",
                                  "phi3.5-moe-42b-a6.6b"])
def test_serve_batch_runs_every_kernel_moe(cuda, arch):
    """The MoE family: deepseek's MLA blocks (a leading dense layer, then
    MoE) run flash attention in prefill and three norms a step each, and no
    decode attention; phi's GQA blocks as the dense path's."""
    from repro_torch.distributed.serve_step import kernel_launches
    cfg = get_smoke_config(arch, **SMOKE_OVERRIDES.get(arch, {}))
    for ops in (fa_ops, da_ops, rn_ops, ssd_ops):
        ops.launches = 0
    n, new = 3, 5
    res = serve_batch(cfg, n_requests=n, prompt_len=24, max_new_tokens=new,
                      quiet=True, device=cuda)
    got = {"flash_attention": fa_ops.launches,
           "decode_attention": da_ops.launches,
           "fused_rmsnorm": rn_ops.launches, "ssd": ssd_ops.launches}
    assert got == kernel_launches(cfg, new)
    assert got["fused_rmsnorm"] == ((3 if cfg.use_mla else 2)
                                    * cfg.num_layers + 1) * new
    assert res["tokens"].shape == (n, 24 + new)


# ------------------------------------------------------------------ training
def _launches():
    return {"flash_attention": fa_ops.launches,
            "fused_rmsnorm": rn_ops.launches, "ssd": ssd_ops.launches,
            "decode_attention": da_ops.launches}


def _backwards():
    return {"backward_launches": fa_ops.backward_launches,
            "plain_backward_calls": fa_ops.plain_backward_calls}


def _flash_grads(q, k, v, do, scale):
    """(the wrapper's output, its gradients) under grad, on leaves made of
    q, k and v, and the gradients of the plain version computed in f32 on
    the same values."""
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = fa_ops.flash_attention(*leaves, scale=scale)
    got = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    f32 = [t.detach().float().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(fa_ops.plain(*f32, scale=scale), f32,
                               do.float())
    return out, got, want


def _worst_rel(got, want):
    """The largest over the gradients of max|diff| / max|want|, each max|want|
    taken at least a thousandth of the largest gradient's: at S = 1 dq and
    dk are 0, and the kernel's differ from 0 by the rounding of D."""
    tops = [b.float().abs().max().item() for b in want]
    return max((a.float() - b.float()).abs().max().item()
               / max(top, 1e-3 * max(tops), 1e-30)
               for a, b, top in zip(got, want, tops))


# bf16 backward kernel against the plain vjp computed in f32, per gradient
# max|diff| / max|want| (``_worst_rel``): the kernel rounds P and dS to bf16
# as tensor-core operands (2^-9 each) and each gradient once to bf16
# (2^-9), its sums in f32 in another order; read up to 5.5e-3 at the shapes
# below
BWD_TOL = 1e-2


@pytest.mark.parametrize("shape", [
    (8, 1024, 32, 32, 80),          # stablelm-3b's training shape
    (2, 1024, 32, 2, 128),          # GQA, G 16
    (2, 512, 28, 4, 112),           # zamba2-7b's width, G 7
    (1, 1, 4, 2, 64), (1, 63, 4, 4, 80), (2, 130, 8, 2, 32),
    (1, 1000, 4, 1, 16)])           # ragged S, MQA
def test_flash_backward_kernel_vs_plain(cuda, shape):
    """The backward kernel's dq, dk and dv (bf16) against the plain vjp in
    f32 and against it in bf16, one backward launch and no plain vjp."""
    B, S, H, KV, hd = shape
    rng = np.random.default_rng(S + hd)
    q = _randn(rng, (B, S, H, hd), torch.bfloat16, cuda)
    k, v = (_randn(rng, (B, S, KV, hd), torch.bfloat16, cuda)
            for _ in range(2))
    do = _randn(rng, (B, S, H, hd), torch.bfloat16, cuda)
    b0 = _backwards()
    out, got, want = _flash_grads(q, k, v, do, hd ** -0.5)
    assert out.grad_fn.name() == "FlashAttentionBackward"
    assert _backwards() == {"backward_launches": b0["backward_launches"] + 1,
                            "plain_backward_calls":
                                b0["plain_backward_calls"]}
    assert all(g.dtype == torch.bfloat16 and g.shape == t.shape
               and g.is_contiguous() for g, t in zip(got, (q, k, v)))
    assert _worst_rel(got, want) < BWD_TOL, shape
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    bf16 = torch.autograd.grad(fa_ops.plain(*leaves, scale=hd ** -0.5),
                               leaves, do)
    assert _worst_rel(got, bf16) < BWD_TOL, shape


@pytest.mark.parametrize("do_layout", ["contiguous", "wider rows",
                                       "heads outer"])
def test_flash_backward_kernel_takes_strided_views(cuda, do_layout):
    """q, k and v as views of one fused projection (B, S, H + 2 KV, hd), and
    dO contiguous, as a view of wider rows (TMA reads it in place) or with
    its heads outermost: the same gradients as on contiguous copies, bit
    for bit, and within BWD_TOL of the plain vjp."""
    B, S, H, KV, hd = 2, 300, 8, 2, 80
    rng = np.random.default_rng(11)
    qkv = _randn(rng, (B, S, H + 2 * KV, hd), torch.bfloat16, cuda)
    q, k, v = qkv[:, :, :H], qkv[:, :, H:H + KV], qkv[:, :, H + KV:]
    do = _randn(rng, (B, S, H, hd), torch.bfloat16, cuda)
    if do_layout == "wider rows":
        wide = torch.zeros(B, S, H, hd + 16, dtype=do.dtype, device=cuda)
        wide[..., :hd] = do
        do = wide[..., :hd]
    elif do_layout == "heads outer":
        do = do.transpose(1, 2).contiguous().transpose(1, 2)
    assert not q.is_contiguous() and (do_layout == "contiguous"
                                      or not do.is_contiguous())
    _, got, want = _flash_grads(q, k, v, do, 0.1)
    _, same, _ = _flash_grads(q.contiguous(), k.contiguous(), v.contiguous(),
                              do.contiguous(), 0.1)
    for a, b in zip(got, same):
        assert torch.equal(a, b)
    assert _worst_rel(got, want) < BWD_TOL


@pytest.mark.parametrize("dtype,hd,hd_v", [
    ("float32", 80, 80), ("float32", 128, 128), ("bfloat16", 160, 160),
    ("bfloat16", 256, 256), ("bfloat16", 192, 128)])
def test_flash_backward_other_routes_take_the_plain_vjp(cuda, dtype, hd, hd_v):
    """f32 and the widths the backward kernel is not built for keep the
    plain version's vjp on the card: one plain backward, no backward
    launch, the gradients the plain vjp's bit for bit."""
    rng = np.random.default_rng(hd + hd_v)
    dt = DTYPES[dtype]
    q, k = (_randn(rng, (1, 200, 4, hd), dt, cuda),
            _randn(rng, (1, 200, 2, hd), dt, cuda))
    v = _randn(rng, (1, 200, 2, hd_v), dt, cuda)
    do = _randn(rng, (1, 200, 4, hd_v), dt, cuda)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    b0 = _backwards()
    out = fa_ops.flash_attention(*leaves, scale=0.1)
    assert out.grad_fn.name() == "PlainVJPBackward"
    got = torch.autograd.grad(out, leaves, do)
    assert _backwards() == {"backward_launches": b0["backward_launches"],
                            "plain_backward_calls":
                                b0["plain_backward_calls"] + 1}
    want = torch.autograd.grad(fa_ops.plain(*leaves, scale=0.1), leaves, do)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_flash_forward_log_sum_exp_vs_plain(cuda):
    """The forward's log-sum-exp rows (the backward's input) against the
    plain version's, in f32: 1e-5 of its size (exp2 and log2 in place of
    exp and log, sums in another order); the output the same as without
    them, bit for bit."""
    rng = np.random.default_rng(5)
    q = _randn(rng, (2, 333, 8, 80), torch.bfloat16, cuda)
    k, v = (_randn(rng, (2, 333, 2, 80), torch.bfloat16, cuda)
            for _ in range(2))
    o, lse = fa_ops._launch_lse(q, k, v, scale=0.1)
    assert lse.shape == (2, 8, 333) and lse.dtype == torch.float32
    _, want = fa_ops.plain_lse(q, k, v, scale=0.1)
    assert (lse - want).abs().max().item() < 1e-5 * want.abs().max().item()
    assert torch.equal(o, fa_ops._launch(q, k, v, scale=0.1))


@pytest.mark.parametrize("arch,dtype", [
    ("stablelm-3b", "float32"), ("mamba2-130m", "float32"),
    ("zamba2-7b", "float32"), ("chatglm3-6b", "float32"),
    ("deepseek-v2-lite-16b", "float32"), ("phi3.5-moe-42b-a6.6b", "float32"),
    ("stablelm-3b", "bfloat16")])
def test_kernel_path_gradients_match_plain_path(cuda, arch, dtype):
    """A train step's gradients with use_pallas=True (the kernels in the
    forward and its recompute; in the backward the flash backward kernel
    where it takes the dtype and widths, else the plain versions' vjps)
    against use_pallas=False; every kernel of the path launches, as counted,
    and each attention call's backward takes its route once. f32: per leaf
    max|diff| / max|grad| under 1e-4 and the loss within 1e-6 relative
    (chip_smoke.py's limits at full width). bf16 (the backward kernel at
    head width 16): per leaf under 2e-2 and the loss within 1e-2 relative,
    both paths running bf16 activations that round at other points."""
    from repro_torch import tree as T
    from repro_torch.distributed.train_step import (flash_backwards,
                                                    kernel_launches,
                                                    make_grad_fn)
    cfg = get_smoke_config(arch, dtype=dtype,
                           **SMOKE_OVERRIDES.get(arch, {}))
    params = M.init_params(cfg, seed=0, device=cuda)
    B, S = 2, 40
    gen = torch.Generator(device=cuda).manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen,
                           device=cuda, dtype=torch.int32)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:],
             "positions": _positions(cfg, B, S, device=cuda)}
    before, b0 = _launches(), _backwards()
    gk, mk = make_grad_fn(cfg)(params, batch)
    torch.cuda.synchronize()
    after, b1 = _launches(), _backwards()
    assert {k: after[k] - before[k] for k in after} == kernel_launches(cfg)
    assert {k: b1[k] - b0[k] for k in b1} == flash_backwards(cfg)
    gp, mp = make_grad_fn(dataclasses.replace(cfg, use_pallas=False))(
        params, batch)
    assert _launches() == after and _backwards() == b1
    loss_tol, tol = (1e-6, 1e-4) if dtype == "float32" else (1e-2, 2e-2)
    assert abs(mk["loss"].item() - mp["loss"].item()) < loss_tol * abs(
        mp["loss"].item())
    for (path, g), w in zip(T.flatten(gk), T.leaves(gp)):
        assert bool(torch.isfinite(g).all()) and bool((g != 0).any()), path
        rel = (g.float() - w.float()).abs().max().item() / \
            w.float().abs().max().item()
        assert rel < tol, f"{path}: {rel}"


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_kernel_functions_backward_is_the_plain_vjp(cuda, dtype):
    """Each training-path wrapper under grad on CUDA tensors: the output
    comes from the kernel (one launch) through its autograd.Function, and
    the gradients are the plain version's vjp, bit for bit (the same
    operations on the same inputs); but flash attention's in bf16, which
    its backward kernel computes (one backward launch), within BWD_TOL of
    the plain vjp."""
    rng = np.random.default_rng(4)
    dt = DTYPES[dtype]

    def leaves(*shapes, dtype=dt):
        return [_randn(rng, s, dtype, cuda).requires_grad_() for s in shapes]

    q, k, v = leaves((2, 200, 4, 80), (2, 200, 4, 80), (2, 200, 4, 80))
    x, w, z = leaves((300, 2560), (2560,), (300, 2560))
    xs, Bm, Cm = leaves((2, 300, 4, 16), (2, 300, 1, 16), (2, 300, 1, 16))
    dts = torch.nn.functional.softplus(
        _randn(rng, (2, 300, 4), torch.float32, cuda) - 2).requires_grad_()
    A = (-torch.rand(4, device=cuda) - 0.5).requires_grad_()
    cases = [
        (fa_ops, lambda q, k, v: fa_ops.flash_attention(q, k, v, scale=0.1),
         lambda q, k, v: fa_ops.plain(q, k, v, scale=0.1), (q, k, v)),
        (rn_ops, lambda x, w: rn_ops.rmsnorm(x, w, eps=1e-5),
         lambda x, w: rn_ref.rmsnorm_ref(x, w, eps=1e-5), (x, w)),
        (rn_ops, lambda x, w, z: rn_ops.rmsnorm(x, w, eps=1e-5, gate=z),
         lambda x, w, z: rn_ref.rmsnorm_ref(x, w, eps=1e-5, gate=z),
         (x, w, z)),
        (ssd_ops, lambda *a: ssd_ops.ssd(*a, chunk=128, use_pallas=True)[0],
         lambda *a: ssd_ops.plain(*a, chunk=128)[0], (xs, dts, A, Bm, Cm))]
    for mod, kernel, plain, inputs in cases:
        n0, b0 = mod.launches, _backwards()
        out = kernel(*inputs)
        assert mod.launches == n0 + 1
        assert out.grad_fn is not None and "Backward" in out.grad_fn.name()
        dy = _randn(rng, tuple(out.shape), out.dtype, cuda)
        got = torch.autograd.grad(out, inputs, dy)
        want = torch.autograd.grad(plain(*inputs), inputs, dy)
        assert mod.launches == n0 + 1     # the backward relaunches no forward
        if mod is fa_ops and dtype == "bfloat16":
            assert _backwards()["backward_launches"] == \
                b0["backward_launches"] + 1
            assert _worst_rel(got, want) < BWD_TOL
            continue
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def test_decode_attention_raises_under_grad(cuda):
    q = torch.randn(2, 1, 4, 64, device=cuda, requires_grad=True)
    k = torch.randn(2, 64, 2, 64, device=cuda)
    vl = torch.full((), 10, dtype=torch.int32, device=cuda)
    n0 = da_ops.launches
    with pytest.raises(RuntimeError, match="no gradient"):
        da_ops.decode_attention(q, k, k, vl, scale=0.125)
    assert da_ops.launches == n0
    with torch.no_grad():
        da_ops.decode_attention(q, k, k, vl, scale=0.125)
    assert da_ops.launches == n0 + 1


@pytest.mark.parametrize("arch", ["stablelm-3b", "mamba2-130m"])
def test_driver_on_the_card(cuda, arch, tmp_path):
    """``launch.train.train`` on the card at smoke size: every step launches
    ``kernel_launches(cfg)``; 4 steps with a checkpoint every 2, then a
    resume to 6, equal bit for bit to 6 uninterrupted steps; with int8
    gradients the first loss equal (taken before any update) and every loss
    finite."""
    from repro_torch.distributed.train_step import kernel_launches
    from repro_torch.launch import train as train_mod
    from repro_torch.optim import adamw
    cfg = get_smoke_config(arch)
    kw = dict(global_batch=4, seq_len=64, quiet=True, device="cuda",
              opt_cfg=adamw.OptimizerConfig(total_steps=6, warmup_steps=2))
    before = _launches()
    full = train_mod.train(cfg, steps=6, **kw)
    after = _launches()
    want = kernel_launches(cfg)
    assert {k: after[k] - before[k] for k in after} == \
        {k: 6 * n for k, n in want.items()}
    first = train_mod.train(cfg, steps=4, ckpt_dir=str(tmp_path),
                            ckpt_every=2, **kw)
    rest = train_mod.train(cfg, steps=6, ckpt_dir=str(tmp_path), resume=True,
                           **kw)
    assert first["losses"] + rest["losses"] == full["losses"]
    int8 = train_mod.train(cfg, steps=6, compress_grads=True, **kw)
    assert int8["losses"][0] == full["losses"][0]
    assert all(np.isfinite(int8["losses"]))


@pytest.mark.parametrize("arch,kind", [
    ("stablelm-3b", "train"), ("zamba2-7b", "train"),
    ("deepseek-v2-lite-16b", "prefill"), ("chatglm3-6b", "decode")])
def test_dryrun_counts_equal_the_card(cuda, arch, kind):
    """The dry-run's step on fake tensors and the same plain step on CUDA
    tensors under the same OpProfile: the same ops, FLOPs, argument bytes
    and storage peak (what chip_smoke.py phase 9 holds at full width)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import abstract_mesh
    full, sm = get_config(arch), get_smoke_config(arch)
    over = {f.name: getattr(sm, f.name) for f in dataclasses.fields(sm)
            if f.name != "name" and getattr(sm, f.name) != getattr(full,
                                                                   f.name)}
    cell, _ = dryrun.lower_cell(arch, None, False, over,
                                shape=ShapeConfig("smoke", 32, 2, kind),
                                mesh=abstract_mesh(data=1, model=1))
    fake, real = cell.run(), cell.run(device=cuda, fake=False)
    for attr in ("matmul_flops", "flops", "argument_bytes", "peak_bytes",
                 "output_bytes"):
        assert getattr(fake, attr) == getattr(real, attr), attr


@pytest.mark.parametrize("arch,world", [("stablelm-3b", 2),
                                        ("chatglm3-6b", 4),
                                        ("zamba2-7b", 2)])
def test_tensor_parallel_step_on_ranks_sharing_the_card(cuda, arch, world):
    """A tensor-parallel step on gloo ranks that share the card (chatglm3-6b
    on 4: its 2 kv heads under the replicated-KV rule, a strided K/V view
    into the flash kernel): the loss within 1e-6 of the one-rank kernel
    path's, the gathered gradients and the updated leaves within 1e-4 of
    each leaf's largest value (the latter against the one-rank AdamW on the
    same gradients), every rank's launches those of one rank's step."""
    from repro_torch.distributed.train_step import kernel_launches
    from torch_ranks import run_ranks, tp_step_on_card
    cfg = get_smoke_config(arch, dtype="float32")
    want = kernel_launches(cfg, model_ranks=world)
    out = run_ranks(tp_step_on_card, world, arch, timeout=300)
    ref_loss, g_gap, p_gap = out[0][2]
    for launches, loss, _ in out:
        assert launches == {k: want[k] for k in launches}
        assert loss == out[0][1]
    assert abs(out[0][1] - ref_loss) <= 1e-6 * abs(ref_loss)
    assert g_gap < 1e-4 and p_gap < 1e-4


# ------------------------------------------- the softmax partial (lse mode)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("hd", [64, 112, 128])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("valid", [0, 1, 300, 512])
def test_decode_kernel_lse_mode_vs_plain(cuda, valid, G, hd, dtype):
    """``decode_attention(..., return_lse=True)`` on a 512-row block: o (f32
    whatever the inputs' dtype) within TOL of the plain partial, the
    log-sum-exp within 2e-5 (f32) or 1e-3 (bf16; an f32 sum in both, of
    bf16 products summed in another order), -inf and o zero where no row
    is valid."""
    rng = np.random.default_rng(valid + G + hd)
    dt = DTYPES[dtype]
    B, S, KV = 2, 512, 2
    q = _randn(rng, (B, 1, KV * G, hd), dt, cuda)
    k, v = (_randn(rng, (B, S, KV, hd), dt, cuda) for _ in range(2))
    vl = torch.tensor([valid], dtype=torch.int32, device=cuda)
    o, lse = da_ops.decode_attention(q, k, v, vl, scale=hd ** -0.5,
                                     return_lse=True)
    po, pl = da_ref.decode_attention_partial_ref(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), vl,
        scale=hd ** -0.5)
    assert o.dtype == torch.float32 and lse.shape == (B, KV * G)
    assert (o.transpose(1, 2) - po).abs().max().item() < TOL[dtype]
    if valid == 0:
        assert torch.isneginf(lse).all() and (o == 0).all()
    else:
        lse_tol = 2e-5 if dtype == "float32" else 1e-3
        assert (lse - pl).abs().max().item() < lse_tol


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n,valid", [(2, 700), (4, 1), (4, 1024)])
def test_decode_kernel_blocks_combine_to_the_whole_cache(cuda, n, valid,
                                                         dtype):
    """The lse mode on n blocks of a cache (zamba2-7b's 112-wide heads),
    combined (``ref.combine_partials_ref``), equals the kernel over the
    whole cache within TOL; blocks past ``valid`` weigh nothing."""
    rng = np.random.default_rng(n + valid)
    dt = DTYPES[dtype]
    B, S, H, hd = 1, 1024, 8, 112
    q = _randn(rng, (B, 1, H, hd), dt, cuda)
    k, v = (_randn(rng, (B, S, H, hd), dt, cuda) for _ in range(2))
    whole = da_ops.decode_attention(
        q, k, v, torch.tensor([valid], dtype=torch.int32, device=cuda),
        scale=hd ** -0.5)
    Sb, os_, lses = S // n, [], []
    for r in range(n):
        vl = torch.tensor([min(max(valid - r * Sb, 0), Sb)],
                          dtype=torch.int32, device=cuda)
        o, lse = da_ops.decode_attention(
            q, k[:, r * Sb:(r + 1) * Sb], v[:, r * Sb:(r + 1) * Sb], vl,
            scale=hd ** -0.5, return_lse=True)
        os_.append(o[:, 0])
        lses.append(lse)
    got = da_ref.combine_partials_ref(torch.stack(os_), torch.stack(lses))
    assert (got - whole[:, 0].float()).abs().max().item() < TOL[dtype]


def test_decode_kernel_lse_mode_refusals(cuda):
    """The lse mode takes what the kernel takes: it refuses a head width
    the bf16 kernel was not built for, and gradients."""
    q = torch.randn((1, 1, 4, 48), device=cuda, dtype=torch.bfloat16)
    k = torch.randn((1, 64, 4, 48), device=cuda, dtype=torch.bfloat16)
    vl = torch.tensor([8], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        da_ops.decode_attention(q, k, k, vl, scale=0.1, return_lse=True)
    qf = torch.randn((1, 1, 4, 64), device=cuda, requires_grad=True)
    kf = torch.randn((1, 64, 4, 64), device=cuda)
    with pytest.raises(RuntimeError, match="no gradient"):
        da_ops.decode_attention(qf, kf, kf, vl, scale=0.1, return_lse=True)
    with pytest.raises(TypeError, match="valid_len"):
        da_ops.decode_attention(qf.detach(), kf, kf, 8, scale=0.1,
                                return_lse=True)


def test_sequence_parallel_decode_on_ranks_sharing_the_card(cuda):
    """zamba2-7b's smoke config (f32), one request on a (2, 1) mesh of
    gloo ranks sharing the card, the cache's 16 positions over ``data``
    (blocks of 8; a prompt of 7, 8 new tokens across the boundary): every
    rank's tokens equal the one-rank kernel path's, the teacher-forced
    logits within 1e-5 of each step's largest, every rank's decode
    launches those of one rank's ``generate``."""
    from repro_torch.distributed.serve_step import kernel_launches
    from torch_ranks import run_ranks, seq_decode_on_card
    cfg = get_smoke_config("zamba2-7b", dtype="float32")
    out = run_ranks(seq_decode_on_card, 2, 7, 8, 16, timeout=300)
    want_tokens, want_logits = out[0][2]
    for tokens, launches, _, logits in out:
        np.testing.assert_array_equal(tokens, want_tokens)
        assert launches == kernel_launches(cfg, 8, tp=1)
        err = np.abs(logits - want_logits).max(axis=(1, 2))
        assert (err <= 1e-5 * np.abs(want_logits).max(axis=(1, 2))).all()


# ------------------------------------------------ a second card, one process
@pytest.fixture
def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0), torch.device(
        "cuda", torch.cuda.device_count() - 1)


def _kernel_call(name, dtype, device):
    """(the wrapper's call, the error of its output against the plain
    version, the limit of that error) on inputs of ``name`` at a small
    shape on ``device``; each kernel that opts in to more than 48 KB of
    shared memory takes more at its shape. The errors and limits are those
    of this file's tests of each kernel."""
    rng = np.random.default_rng(7)
    dt = DTYPES[dtype]

    def abs_err(want):
        return lambda got: (got.float() - want().float()).abs().max().item()

    if name == "flash_attention":
        q = _randn(rng, (2, 256, 4, 64), dt, device)
        k, v = (_randn(rng, (2, 256, 2, 64), dt, device) for _ in range(2))
        return (lambda: fa_ops.flash_attention(q, k, v, scale=0.125),
                abs_err(lambda: fa_ops.plain(q, k, v, scale=0.125)),
                TOL[dtype])
    if name == "decode_attention":
        q = _randn(rng, (2, 1, 8, 128), dt, device)
        k, v = (_randn(rng, (2, 300, 2, 128), dt, device) for _ in range(2))
        vl = torch.tensor(257, dtype=torch.int32, device=device)
        return (lambda: da_ops.decode_attention(q, k, v, vl,
                                                scale=128 ** -0.5),
                abs_err(lambda: da_ref.decode_attention_ref(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    vl, scale=128 ** -0.5).transpose(1, 2)),
                TOL[dtype])
    if name == "fused_rmsnorm":
        x, w, gate = _norm_case(device, 64, 1024, dtype, True)
        return (lambda: rn_ops.rmsnorm(x, w, eps=1e-5, gate=gate),
                lambda got: _norm_err(got, x, w, gate), 1.0)
    x, dtv, A, Bm, Cm = _ssd_inputs(rng, (1, 256, 4, 1, 64, 128), dt, device)
    if dtype == "float32":
        want = lambda: ssd_ref.ssd_naive(x, dtv, A, Bm, Cm)[0]     # noqa: E731
    else:
        want = lambda: ssd_ref.ssd_chunked(x, dtv, A, Bm, Cm,      # noqa: E731
                                           chunk=128)[0]
    return (lambda: ssd_ops.ssd(x, dtv, A, Bm, Cm, chunk=128,
                                use_pallas=True)[0],
            lambda got: _rel(got, want()), SSD_TOL[dtype])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", ["flash_attention", "decode_attention",
                                  "fused_rmsnorm", "ssd"])
def test_kernel_on_the_last_card_from_a_thread_on_card_0(two_cards, name,
                                                         dtype):
    """The kernel runs first on card 0 (its shared-memory opt-in made
    there), then on tensors of the last card from a thread whose current
    device is card 0: the launch lands on the tensors' card (its output
    there, equal to the plain version), the thread's current device is
    still card 0 after it, and the per-card count reads the last card."""
    first, last = two_cards
    mod = {"flash_attention": fa_ops, "decode_attention": da_ops,
           "fused_rmsnorm": rn_ops, "ssd": ssd_ops}[name]
    call0, _, _ = _kernel_call(name, dtype, first)
    call0()
    torch.cuda.synchronize(first)
    call, err_of, tol = _kernel_call(name, dtype, last)
    before = dict(mod.card_launches)
    out = {}

    def on_card_0():
        try:
            torch.cuda.set_device(first)
            out["got"] = call()
            out["current"] = torch.cuda.current_device()
            torch.cuda.synchronize(last)
        except BaseException as e:          # noqa: BLE001 - re-raised below
            out["error"] = e

    t = threading.Thread(target=on_card_0)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive() and "error" not in out, out.get("error")
    got = out["got"]
    assert got.device == last and out["current"] == first.index
    err = err_of(got)
    assert err < tol, f"{name} {dtype} on {last}: {err}"
    assert mod.card_launches.get(last.index, 0) \
        == before.get(last.index, 0) + 1
    assert mod.card_launches.get(first.index, 0) \
        == before.get(first.index, 0)
