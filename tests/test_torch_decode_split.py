"""The split-KV decode attention of the port on the CPU: the plain version of
the CUDA kernels' arithmetic (``ref.decode_attention_split_ref``: per-split
f32 partials and their combine) against the single-pass plain version and
against the JAX package's Pallas kernel run in interpret mode, on the same
numpy inputs; and the wrapper's choice of splits (``ops.split_plan``) at the
main path's shapes.

Tolerance 1e-5 in f32: the splits only change the order of the sums."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.decode_attention import decode_attention_bhd
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention import ref

TOL = 1e-5
H100_SMS = 132


def _inputs(B, S, H, KV, hd, seed=11):
    """q (B,H,1,hd), k/v (B,KV,S,hd) as jnp arrays and CPU tensors, f32."""
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((B, H, 1, hd), (B, KV, S, hd), (B, KV, S, hd))]
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(a) for a in arrays])


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32))))


@pytest.mark.parametrize("n_split", [1, 3, 16])
@pytest.mark.parametrize("valid", [1, 17, 63, 64, 65, 200])
def test_split_matches_single_pass(n_split, valid):
    """Every valid length, including ones that end inside, at and just past
    a split's edge, and ones that leave the later splits empty."""
    _, (q, k, v) = _inputs(2, 200, 8, 2, 32)
    got = ref.decode_attention_split_ref(q, k, v, valid, n_split, scale=0.2)
    want = ref.decode_attention_ref(q, k, v, valid, scale=0.2)
    assert got.shape == want.shape == (2, 8, 1, 32)
    assert _err(got, want) < TOL


@pytest.mark.parametrize("n_split", [1, 3, 16])
@pytest.mark.parametrize("shape,valid", [
    ((2, 512, 4, 2, 64), 301),       # GQA, splits past 301 empty
    ((1, 130, 8, 8, 32), 130),       # MHA, S not a multiple of the split
    ((2, 640, 4, 1, 128), 17),       # MQA, only the first split has rows
])
def test_split_matches_jax_pallas(shape, valid, n_split):
    B, S, H, KV, hd = shape
    (jq, jk, jv), (q, k, v) = _inputs(B, S, H, KV, hd)
    want = decode_attention_bhd(jq, jk, jv, jnp.int32(valid), scale=0.1,
                                block_k=128, interpret=True)
    got = ref.decode_attention_split_ref(q, k, v, valid, n_split, scale=0.1)
    assert _err(got, want) < TOL


@pytest.mark.parametrize("n_split", [1, 3, 16])
def test_split_at_valid_len_zero_returns_zeros(n_split):
    """No valid row: every split is empty and the combine gives zeros, as the
    Pallas kernel does (the single-pass plain version returns mean(V))."""
    (jq, jk, _), (q, k, _) = _inputs(2, 128, 4, 2, 32)
    got = ref.decode_attention_split_ref(q, k, k, torch.tensor(0), n_split,
                                         scale=0.1)
    assert not bool(got.any())
    pallas = decode_attention_bhd(jq, jk, jk, jnp.int32(0), scale=0.1,
                                  block_k=64, interpret=True)
    assert float(jnp.max(jnp.abs(pallas))) == 0.0


@pytest.mark.parametrize("arch,shape,blocks", [
    ("chatglm3-6b", (8, 1056, 32, 2, 128), 272),   # 16 pairs x 17 splits
    ("zamba2-7b", (8, 1056, 32, 32, 112), 512),    # 256 pairs x 2 splits
])
def test_split_plan_at_the_main_path_shapes(arch, shape, blocks):
    """The serving path's decode shapes (8 requests, a 1,056-row cache) give
    at least two blocks per SM of an H100 (B * KV * n_split), each split a
    whole number of the kernel's 64-row steps covering the cache."""
    B, S, H, KV, hd = shape
    n_split, rows = da_ops.split_plan(B, KV, S, H100_SMS)
    assert B * KV * n_split == blocks >= 2 * H100_SMS
    assert rows % da_ops.SPLIT_ROWS == 0
    assert (n_split - 1) * rows < S <= n_split * rows


@pytest.mark.parametrize("B,KV,S", [(1, 1, 16), (1, 8, 1024), (3, 2, 29),
                                    (64, 8, 4096), (2, 1, 640)])
def test_split_plan_covers_the_cache(B, KV, S):
    n_split, rows = da_ops.split_plan(B, KV, S, H100_SMS)
    assert n_split >= 1 and rows % da_ops.SPLIT_ROWS == 0
    assert (n_split - 1) * rows < S <= n_split * rows
    # no more splits than 64-row steps, none beyond two blocks per SM's need
    assert n_split <= -(-S // da_ops.SPLIT_ROWS)
    assert n_split <= max(1, -(-2 * H100_SMS // (B * KV)))


@pytest.mark.parametrize("valid", [1, 63, 64, 65, 1025, 1056])
def test_split_with_the_kernels_partition(valid):
    """The plain version on the kernels' own partition of the chatglm3-6b
    cache (17 splits of 64 rows), G = 16, held against the single pass."""
    n_split, rows = da_ops.split_plan(8, 2, 1056, H100_SMS)
    _, (q, k, v) = _inputs(2, 1056, 32, 2, 16)
    got = ref.decode_attention_split_ref(q, k, v, valid, n_split, scale=0.25,
                                         rows=rows)
    want = ref.decode_attention_ref(q, k, v, valid, scale=0.25)
    assert _err(got, want) < TOL
