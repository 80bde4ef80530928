"""Sequence-parallel decode of the port (``tensor_parallel.SeqPar``,
``combine_partials``, ``ServeLayout.seq_par``, the ``sp`` of the prefill
and decode steps): a serving batch that no batch axis divides (the
long_500k cells' batch 1) on a mesh with several ``data`` ranks, each
rank holding its block of the cache's sequence, and the decode kernel's
softmax partial (``decode_attention(..., return_lse=True)``) that the
ranks combine.

  * the partial's plain version (``ref.decode_attention_partial_ref``) of
    n blocks of a cache, one of them with no valid row, combined
    (``ref.combine_partials_ref``) equals the JAX package's Pallas kernel
    over the whole cache (``decode_attention_bhd(interpret=True)``) within
    1e-5 (f32; the same online-softmax arithmetic, merged once more); the
    wrapper on CPU tensors returns it; ``combine_partials`` over 2 gloo
    ranks equals the plain combine to 1e-6;
  * serving on gloo ranks of the CPU against the JAX package's unsharded
    ``generate`` on the same numpy weights (one spawn a mesh shape,
    ``tests/torch_ranks.tp_serve_on_ranks``, each launch played by its
    plain version): zamba2-7b's smoke config, one request, on (2, 1) and
    (2, 2) (heads over ``model`` too) with a cache of 16 positions, blocks
    of 8, a prompt of 7 and 8 new tokens, so that decoding crosses the
    block boundary; mamba2-130m under dp_all, one request on (2, 2)
    (states whole on every rank, its vocabulary split over ``model``).
    Greedy tokens equal; teacher-forced logits within 1e-5 of each step's
    largest; each rank's cache after the prefill and after the last step
    within 1e-5 of its ``cache_pspec`` block of the one-rank port cache of
    the same capacity; launches as ``kernel_launches`` says.
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.distributed import serve_step as jss
from repro.kernels.decode_attention.decode_attention import \
    decode_attention_bhd
from repro.launch import serve as jserve
from repro.models import model as jM
from repro_torch import bridge
from repro_torch import tree as T
from repro_torch.configs import get_smoke_config
from repro_torch.distributed import serve_step as ss
from repro_torch.distributed import sharding as SH
from repro_torch.distributed import tensor_parallel as TPm
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention import ref as da_ref
from repro_torch.launch import serve
from repro_torch.launch.mesh import abstract_mesh
from torch_ranks import combine_on_ranks, run_ranks, tp_serve_on_ranks

TOL = 1e-5
PROMPT, NEW, CAPACITY = 7, 8, 16
CASES = {(2, 1): ["zamba2-7b"], (2, 2): ["zamba2-7b", "mamba2-130m"]}
PARAMS = [(shape, i) for shape, archs in CASES.items()
          for i in range(len(archs))]
IDS = [f"{CASES[s][i]}-{s[0]}x{s[1]}" for s, i in PARAMS]


def _cache(seed, B=2, H=4, KV=2, S=64, hd=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, 1, hd)).astype(np.float32)
    k = rng.standard_normal((B, KV, S, hd)).astype(np.float32)
    v = rng.standard_normal((B, KV, S, hd)).astype(np.float32)
    return q, k, v


# ------------------------------------------------------ the softmax partial
@pytest.mark.parametrize("n_blocks,valid", [(4, 30), (2, 64), (4, 1),
                                            (8, 37)])
def test_blocks_partials_combined_equal_the_pallas_kernel(n_blocks, valid):
    """n blocks of a 64-row cache, each's partial over its rows below
    ``valid`` (blocks past it hold none: lse -inf, o 0), combined, equal
    JAX's Pallas kernel over the whole cache."""
    q, k, v = _cache(n_blocks + valid)
    scale = 1 / math.sqrt(q.shape[-1])
    want = np.asarray(decode_attention_bhd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), valid, scale=scale,
        block_k=16, interpret=True))
    Sb = k.shape[2] // n_blocks
    os_, lses = [], []
    for r in range(n_blocks):
        blk = slice(r * Sb, (r + 1) * Sb)
        local = torch.tensor(min(max(valid - r * Sb, 0), Sb),
                             dtype=torch.int32)
        o, lse = da_ref.decode_attention_partial_ref(
            torch.from_numpy(q), torch.from_numpy(k[:, :, blk].copy()),
            torch.from_numpy(v[:, :, blk].copy()), local, scale=scale)
        if int(local) == 0:
            assert torch.isneginf(lse).all() and (o == 0).all()
        os_.append(o[:, :, 0])
        lses.append(lse)
    assert (valid < k.shape[2] - Sb) == any(torch.isneginf(t).all()
                                           for t in lses)
    got = da_ref.combine_partials_ref(torch.stack(os_), torch.stack(lses))
    err = np.abs(got.numpy() - want[:, :, 0]).max()
    assert err <= TOL * np.abs(want).max(), err


@pytest.mark.parametrize("valid", [0, 5, 64])
def test_wrapper_returns_the_partial_on_cpu(valid):
    """``decode_attention(..., return_lse=True)`` on CPU tensors is the
    plain partial, in the wrapper's (B, 1, H, hd) layout, o in f32; its
    lse is the log-sum-exp of the scaled scores over the valid rows."""
    q, k, v = _cache(valid)
    qt, kt, vt = (torch.from_numpy(t).transpose(1, 2) for t in (q, k, v))
    scale = 0.25
    vl = torch.tensor(valid, dtype=torch.int32)
    o, lse = da_ops.decode_attention(qt, kt, vt, vl, scale=scale,
                                     return_lse=True)
    want_o, want_lse = da_ref.decode_attention_partial_ref(
        *(torch.from_numpy(t) for t in (q, k, v)), vl, scale=scale)
    assert o.dtype == torch.float32 and o.shape == qt.shape
    torch.testing.assert_close(o.transpose(1, 2), want_o)
    torch.testing.assert_close(lse, want_lse)
    if valid:
        G = q.shape[1] // k.shape[1]
        s = torch.einsum("bhd,bhsd->bhs", torch.from_numpy(q[:, :, 0]),
                         torch.from_numpy(k).repeat_interleave(G, 1)
                         [:, :, :valid]) * scale
        torch.testing.assert_close(lse, torch.logsumexp(s, -1))
    else:
        assert torch.isneginf(lse).all() and (o == 0).all()


def test_combine_partials_over_two_ranks():
    """The data group's combine (an all-reduce MAX of lse, an all-reduce
    SUM of (w * o, w)) equals the plain combine, a rank with no valid row
    among them."""
    q, k, v = _cache(3, S=32)
    scale = 0.25
    o, lse = [], []
    for r, valid in enumerate((16, 0)):
        blk = slice(r * 16, (r + 1) * 16)
        a, b = da_ref.decode_attention_partial_ref(
            torch.from_numpy(q), torch.from_numpy(k[:, :, blk].copy()),
            torch.from_numpy(v[:, :, blk].copy()),
            torch.tensor(valid, dtype=torch.int32), scale=scale)
        o.append(a.transpose(1, 2).numpy())
        lse.append(b.numpy())
    o, lse = np.stack(o), np.stack(lse)
    got = run_ranks(combine_on_ranks, 2, o, lse, timeout=120)
    want = da_ref.combine_partials_ref(
        torch.from_numpy(o[:, :, 0]), torch.from_numpy(lse)).numpy()
    for g in got:
        np.testing.assert_allclose(g[:, 0], want, rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------- the layout
def test_serve_layout_refusals():
    """MLA is refused under sequence parallelism (no MLA architecture runs
    long_500k), and so is a cache that does not divide over ``data``."""
    mesh = abstract_mesh(data=2, model=1)
    with pytest.raises(NotImplementedError, match="MLA"):
        TPm.serve_layout(get_smoke_config("deepseek-v2-lite-16b"), mesh, 1)
    layout = TPm.serve_layout(get_smoke_config("zamba2-7b"), mesh, 1)
    assert layout.seq_parallel and layout.rows == 1
    with pytest.raises(ValueError, match="does not divide"):
        layout.seq_par(15)
    assert not TPm.serve_layout(get_smoke_config("zamba2-7b"), mesh,
                                2).seq_parallel


# ---------------------------------------------------------------- serving
@functools.lru_cache(maxsize=None)
def _jax(arch):
    jcfg = jget_smoke(arch, dtype="float32", use_pallas=False)
    jparams = jM.init_params(jax.random.PRNGKey(2), jcfg)
    prompts = np.random.default_rng(7).integers(0, jcfg.vocab_size,
                                                (1, PROMPT), dtype=np.int32)
    tokens = np.asarray(jserve.generate(jparams, jcfg, jnp.asarray(prompts),
                                        max_new_tokens=NEW))
    prefill = jax.jit(jss.make_prefill_step(jcfg))
    decode = jax.jit(jss.make_decode_step(jcfg))
    lg, cache = prefill(jparams, {"tokens": jnp.asarray(tokens[:, :PROMPT]),
                                  "positions": jserve._positions(jcfg, 1,
                                                                 PROMPT)})
    cache = jss.pad_cache(cache, jcfg, CAPACITY)
    steps = [np.asarray(lg[:, 0])]
    for t in range(NEW - 1):
        s = PROMPT + t
        lg, cache = decode(jparams, {
            "tokens": jnp.asarray(tokens[:, s:s + 1]),
            "positions": jserve._positions(jcfg, 1, 1, start=s)}, cache)
        steps.append(np.asarray(lg[:, 0]))
    return (jax.tree.map(np.asarray, jparams), prompts, tokens,
            np.stack(steps))


@functools.lru_cache(maxsize=None)
def _one_rank_caches(arch):
    params, _, tokens, _ = _jax(arch)
    cfg = get_smoke_config(arch, dtype="float32")
    tp = bridge.to_torch(params, device="cpu")
    forced = torch.from_numpy(tokens.copy())
    _, cache = ss.make_prefill_step(cfg)(tp, {
        "tokens": forced[:, :PROMPT].contiguous(),
        "positions": serve._positions(cfg, 1, PROMPT, device="cpu")})
    cache = ss.pad_cache(cache, cfg, CAPACITY)
    first = {p: t.numpy().copy() for p, t in T.flatten(cache)}
    for t in range(NEW - 1):
        s = PROMPT + t
        _, cache = ss.make_decode_step(cfg)(tp, {
            "tokens": forced[:, s:s + 1].contiguous(),
            "positions": serve._positions(cfg, 1, 1, start=s,
                                          device="cpu")}, cache)
    return first, {p: t.numpy().copy() for p, t in T.flatten(cache)}


@functools.lru_cache(maxsize=None)
def _ranks(shape):
    cases = []
    for arch in CASES[shape]:
        params, prompts, tokens, _ = _jax(arch)
        cases.append((arch, params, prompts, tokens, NEW,
                      {"max_len": CAPACITY}))
    return run_ranks(tp_serve_on_ranks, shape[0] * shape[1], shape, cases,
                     timeout=300)


def _case(shape, i):
    return CASES[shape][i], [(r["coord"], r["cases"][i])
                             for r in _ranks(shape)]


def _block(full, spec, coord, mesh_shape):
    sl = []
    for d, n in enumerate(full.shape):
        axes = SH._axes_of(spec[d] if d < len(spec) else None)
        k = math.prod(mesh_shape[a] for a in axes)
        i = 0
        for a in axes:
            i = i * mesh_shape[a] + coord[a]
        sl.append(slice(i * (n // k), (i + 1) * (n // k)))
    return full[tuple(sl)]


@pytest.mark.parametrize("shape,i", PARAMS, ids=IDS)
def test_tokens_and_logits_match_jax_across_the_block_boundary(shape, i):
    arch, ranks = _case(shape, i)
    _, _, tokens, logits = _jax(arch)
    for _, r in ranks:
        np.testing.assert_array_equal(r["tokens"], tokens)
        assert r["logits"].shape == logits.shape
        for step in range(NEW):
            err = np.abs(r["logits"][step] - logits[step]).max()
            assert err <= TOL * np.abs(logits[step]).max(), (step, err)
        err = np.abs(r["helper_logits"] - logits).max()
        assert err <= TOL * np.abs(logits).max(), err
    # the prompt fills block 0 but a row; the decode crosses into block 1
    assert PROMPT < CAPACITY // 2 < PROMPT + NEW - 1


@pytest.mark.parametrize("shape,i", PARAMS, ids=IDS)
def test_each_rank_cache_is_its_sequence_block(shape, i):
    arch, ranks = _case(shape, i)
    cfg = get_smoke_config(arch, dtype="float32")
    mesh_shape = {"data": shape[0], "model": shape[1]}
    specs = SH.cache_pspec(cfg, abstract_mesh(**mesh_shape), 1)
    if arch == "zamba2-7b":
        assert specs["attn/k"][2] == "data"
        assert all(r["seq_rows"] == CAPACITY // shape[0] for _, r in ranks)
    for which, whole in zip(("prefill_cache", "final_cache"),
                            _one_rank_caches(arch)):
        for coord, r in ranks:
            for path, full in whole.items():
                want = _block(full, specs[path], coord, mesh_shape)
                got = r[which][path]
                assert got.shape == want.shape, (which, path)
                err = np.abs(got - want).max(initial=0.0)
                assert err <= TOL * np.abs(want).max(initial=0.0), (
                    which, path, err)


@pytest.mark.parametrize("shape,i", PARAMS, ids=IDS)
def test_launches_per_rank(shape, i):
    arch, ranks = _case(shape, i)
    cfg = get_smoke_config(arch, dtype="float32")
    for coord, r in ranks:
        assert r["launches"] == ss.kernel_launches(
            cfg, NEW, tp=shape[1], rank=coord["model"])


@pytest.mark.parametrize("shape,i", PARAMS, ids=IDS)
def test_temperature_tokens_equal_one_rank_generate(shape, i):
    arch, ranks = _case(shape, i)
    params, prompts, _, _ = _jax(arch)
    cfg = get_smoke_config(arch, dtype="float32")
    want = serve.generate(bridge.to_torch(params, device="cpu"), cfg,
                          torch.from_numpy(prompts), max_new_tokens=NEW,
                          temperature=0.7, max_len=CAPACITY,
                          generator=torch.Generator().manual_seed(5)).numpy()
    for _, r in ranks:
        np.testing.assert_array_equal(r["sampled"], want)
