"""Tensor-parallel and ZeRO-1 training of the port
(``repro_torch.distributed.tensor_parallel``, the ``tp`` paths of
``models`` and ``optim.adamw``) on gloo ranks of the CPU, held against the
JAX package's unsharded ``make_train_step`` on the same numpy weights and
batch (JAX's own sharded step fails on this tree: ROADMAP.md, reference
caveat 1).

Every case runs one spawn of its ranks (``tests/torch_ranks.tp_step_on_
ranks``), cached for the tests that read it: the step against JAX, the
gradients of the leaves whole on every rank, the ZeRO-1 moments' shapes and
the kernel launches per rank (each ``_launch`` played by its plain version,
as tests/test_torch_train.py does).

Tolerances, each with its reason:
  * the two collectives against one process: exact (sums of at most 4
    values of small integers);
  * the vocab-parallel embedding exact (one rank adds the row, the others
    zeros), and the vocab-parallel loss and its gradient within 1e-6
    relative to ``make_loss_fn``'s arithmetic on the whole vocabulary (the
    same f32 sums split over the ranks);
  * one step against JAX's: the loss 1e-5 relative; every gathered
    gradient per leaf 1e-4 relative to the leaf's largest value; every
    updated leaf 1e-4 absolute and relative, and both moments per leaf
    1e-4 relative to the leaf's largest (tests/test_torch_train.py's
    tolerances for the one-rank step: the same f32 math with sums split
    over the ranks);
  * a leaf whole on every rank: its gradient equal bit for bit on the
    ranks of a model group (each rank computes the same sums);
  * int8 gradients over ``data``: within 2/127 of the leaf's largest f32
    gradient (half a step of each of the scheme's two int8 phases).
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.distributed.train_step import make_loss_fn as jmake_loss_fn
from repro.distributed.train_step import make_train_step as jmake_train_step
from repro.models import model as jM
from repro.optim import adamw as jadamw
from repro_torch.configs import get_smoke_config
from repro_torch.distributed import train_step as TS
from repro_torch.kernels.fused_rmsnorm import ref as rn_ref
from torch_ranks import (collectives_on_ranks, row_collectives_on_ranks,
                         run_ranks, split_norm_on_ranks, tp_step_on_ranks,
                         vocab_ops_on_ranks)

OPT = dict(total_steps=10, warmup_steps=1)
TOL = 1e-4
CASES = [("stablelm-3b", (1, 2)), ("stablelm-3b", (2, 2)),
         ("stablelm-3b", (1, 4)), ("chatglm3-6b", (1, 2)),
         ("chatglm3-6b", (1, 4)), ("gemma-7b", (1, 2)),
         ("deepseek-v2-lite-16b", (1, 2)), ("deepseek-v2-lite-16b", (1, 4)),
         ("phi3.5-moe-42b-a6.6b", (1, 2)), ("phi3.5-moe-42b-a6.6b", (1, 4)),
         ("zamba2-7b", (1, 2)), ("zamba2-7b", (2, 2)), ("zamba2-7b", (1, 4)),
         ("mamba2-130m", (2, 2)), ("mamba2-130m", (1, 4))]
IDS = [f"{arch}-{d}x{m}" for arch, (d, m) in CASES]


def _batch(cfg, B=2, S=16, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    return {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1),
            "positions": pos}


def _paths(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(p.key) for p in path): np.asarray(leaf)
            for path, leaf in flat}


@functools.lru_cache(maxsize=None)
def _jax(arch):
    """JAX's unsharded step and ``jax.grad`` on its f32 weights: (weights
    before, after, mu, nu, grads as {path: numpy}, metrics)."""
    jcfg = jget_smoke(arch, dtype="float32")
    jparams = jM.init_params(jax.random.PRNGKey(0), jcfg)
    nb = _batch(jcfg)
    new, opt, metrics = jax.jit(jmake_train_step(
        jcfg, jadamw.OptimizerConfig(**OPT)))(jparams, jadamw.init(jparams),
                                              nb)
    grads, _ = jax.jit(jax.grad(jmake_loss_fn(jcfg), has_aux=True))(jparams,
                                                                     nb)
    return (jax.tree.map(np.asarray, jparams), _paths(new), _paths(opt.mu),
            _paths(opt.nu), _paths(grads),
            {k: float(v) for k, v in metrics.items()})


@functools.lru_cache(maxsize=None)
def _ranks(arch, mesh_shape, compress=False):
    params = _jax(arch)[0]
    cfg = get_smoke_config(arch, dtype="float32")
    return run_ranks(tp_step_on_ranks, mesh_shape[0] * mesh_shape[1], arch,
                     mesh_shape, params, _batch(cfg), OPT, compress,
                     timeout=240)


def _rel(got, want):
    return float(np.abs(got - want).max()) / (float(np.abs(want).max())
                                              + 1e-30)


# ------------------------------------------------------------ collectives
@pytest.mark.parametrize("world", [2, 4])
def test_collectives_forward_and_backward_against_one_process(world):
    rng = np.random.default_rng(world)
    xs = rng.integers(-5, 6, (world, 3, 4)).astype(np.float32)
    a = rng.integers(-3, 4, (world, 3, 4)).astype(np.float32)
    out = run_ranks(collectives_on_ranks, world, xs, a, timeout=120)
    for rank, got in enumerate(out):
        y, g = got["copy"]                 # identity; gradient summed
        np.testing.assert_array_equal(y, xs[0])
        np.testing.assert_array_equal(g, a.sum(0))
        y, g = got["reduce"]               # summed; gradient identity
        np.testing.assert_array_equal(y, xs.sum(0))
        np.testing.assert_array_equal(g, a[rank])


@pytest.mark.parametrize("world", [2, 4])
def test_row_collectives_forward_and_backward_against_one_process(world):
    """``sum_over_tp`` sums both ways: every rank reads the sum for its own
    part, so the gradient of a rank's term is the sum of every rank's
    gradient of the sum. ``gather_rows`` concatenates the ranks' rows and
    sums each rank's block of the gradients back to it; ``scatter_rows``
    is its mirror. Exact (sums of at most 4 small integers)."""
    rng = np.random.default_rng(world + 10)
    xs = rng.integers(-5, 6, (world, 2 * world, 3)).astype(np.float32)
    a = {"sum": rng.integers(-3, 4, (world, 2 * world, 3)),
         "gather": rng.integers(-3, 4, (world, 2 * world * world, 3)),
         "scatter": rng.integers(-3, 4, (world, 2, 3))}
    a = {k: v.astype(np.float32) for k, v in a.items()}
    out = run_ranks(row_collectives_on_ranks, world, xs, a, timeout=120)
    rows = lambda t, r: t[2 * r:2 * (r + 1)]            # noqa: E731
    for rank, got in enumerate(out):
        y, g = got["sum"]
        np.testing.assert_array_equal(y, xs.sum(0))
        np.testing.assert_array_equal(g, a["sum"].sum(0))
        y, g = got["gather"]
        np.testing.assert_array_equal(y, np.concatenate(list(xs)))
        np.testing.assert_array_equal(
            g, a["gather"].sum(0)[rank * 2 * world:(rank + 1) * 2 * world])
        y, g = got["scatter"]
        np.testing.assert_array_equal(y, rows(xs.sum(0), rank))
        np.testing.assert_array_equal(
            g, np.concatenate([a["scatter"][r] for r in range(world)]))


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("gated", [False, True])
def test_split_rmsnorm_equals_the_whole_row(world, gated):
    """The gated norm's row split over the model ranks
    (``tensor_parallel.split_rmsnorm``: each rank's sum of squares, summed
    over the ranks, then its columns scaled), through the kernel's wrapper
    (its plain versions on the CPU) and the plain path: each rank's columns
    of ``rmsnorm_ref`` on the whole row, and of its gradients with respect
    to x, the gate and w, f32 within 1e-6 relative (the same sums split
    over the ranks). w's gradient is this rank's columns of the whole one:
    a (1 + w) column is read by this rank only."""
    rng = np.random.default_rng(3 + world)
    B, S, d = 2, 5, 24 * world
    x = (rng.standard_normal((B, S, d)) * 2).astype(np.float32)
    w = (rng.standard_normal(d) * 0.1).astype(np.float32)
    gate = rng.standard_normal((B, S, d)).astype(np.float32) if gated \
        else None
    a = rng.standard_normal((B, S, d)).astype(np.float32)
    eps = 1e-5
    ins = [torch.from_numpy(t).requires_grad_()
           for t in (x, w) + (() if gate is None else (gate,))]
    want = rn_ref.rmsnorm_ref(ins[0], ins[1], eps=eps,
                              gate=ins[2] if gated else None)
    wgrads = torch.autograd.grad((want * torch.from_numpy(a)).sum(), ins)
    out = run_ranks(split_norm_on_ranks, world, x, w, gate, a, eps,
                    timeout=120)
    n = d // world
    for rank, got in enumerate(out):
        cols = slice(rank * n, (rank + 1) * n)
        for use_pallas, (y, grads) in got.items():
            assert _rel(y, want.detach().numpy()[..., cols]) < 1e-6
            for g, wg in zip(grads, wgrads):
                assert _rel(g, wg.numpy()[..., cols]) < 1e-6, use_pallas


@pytest.mark.parametrize("world", [2, 4])
def test_vocab_parallel_embedding_and_loss_against_the_whole_vocab(world):
    rng = np.random.default_rng(7)
    V, d, B, S = 32, 8, 2, 6
    table = rng.standard_normal((V, d)).astype(np.float32)
    tokens = rng.integers(0, V, (B, S), dtype=np.int32)
    logits = (rng.standard_normal((B, S, V)) * 4).astype(np.float32)
    labels = rng.integers(0, V, (B, S), dtype=np.int32)
    labels[0, :world] = np.arange(world) * (V // world)   # every rank owns one
    out = run_ranks(vocab_ops_on_ranks, world, table, tokens, logits, labels,
                    timeout=120)
    emb = torch.nn.functional.embedding(torch.from_numpy(tokens),
                                        torch.from_numpy(table)).numpy()
    lt = torch.from_numpy(logits).requires_grad_()
    gold = torch.gather(lt, -1, torch.from_numpy(labels).long()[..., None])
    want = torch.logsumexp(lt.float(), dim=-1) - gold[..., 0].float()
    (g,) = torch.autograd.grad(want.mean(), lt)
    v = V // world
    for rank, (e, ce, grad) in enumerate(out):
        np.testing.assert_array_equal(e, emb)
        assert _rel(ce, want.detach().numpy()) < 1e-6
        assert _rel(grad, g[..., rank * v:(rank + 1) * v].numpy()) < 1e-6


# --------------------------------------------- one step against JAX's
@pytest.mark.parametrize("arch,mesh_shape", CASES, ids=IDS)
def test_step_matches_jax_unsharded(arch, mesh_shape):
    _, jnew, jmu, jnu, jgrads, jm = _jax(arch)
    out = _ranks(arch, mesh_shape)
    for r in out:
        for k in ("loss", "ce", "aux_loss"):
            np.testing.assert_allclose(r["metrics"][k], jm[k], rtol=1e-5,
                                       atol=1e-7, err_msg=k)
        np.testing.assert_allclose(r["metrics"]["grad_norm"],
                                   jm["grad_norm"], rtol=TOL)
        assert r["grads"].keys() == jgrads.keys() == r["params"].keys()
        for path, g in r["grads"].items():
            assert _rel(g, jgrads[path]) < TOL, path
        for path, p in r["params"].items():
            np.testing.assert_allclose(p, jnew[path], rtol=TOL, atol=TOL,
                                       err_msg=path)
        for got, want in ((r["mu"], jmu), (r["nu"], jnu)):
            for path, m in got.items():
                assert _rel(m, want[path]) < TOL, path


@pytest.mark.parametrize("arch,mesh_shape", CASES, ids=IDS)
def test_whole_leaves_get_one_gradient_on_every_model_rank(arch, mesh_shape):
    """The leaves no rank splits (norms; K/V under the replicated-KV rule;
    MLA's w_dkv, w_krope and kv_norm; the router): each rank's gradient is
    the whole one, the same bits on every rank of a model group."""
    out = _ranks(arch, mesh_shape)
    whole = out[0]["whole_grads"]
    assert any(p.endswith("norm1/scale") for p in whole)
    if arch == "chatglm3-6b" and mesh_shape[1] == 4:     # KV 2 < 4 ranks
        assert {"layers/attn/wk/w", "layers/attn/wv/w"} <= set(whole)
    if arch == "deepseek-v2-lite-16b":
        assert {"layers/attn/w_dkv/w", "layers/attn/w_krope/w",
                "layers/moe/router/w"} <= set(whole)
    for r in out:
        same = [q for q in out if q["coord"]["data"] == r["coord"]["data"]]
        for path, g in r["whole_grads"].items():
            for q in same:
                np.testing.assert_array_equal(g, q["whole_grads"][path],
                                              err_msg=path)
            assert _rel(g, _jax(arch)[4][path]) < TOL, path


@pytest.mark.parametrize("arch,mesh_shape", CASES, ids=IDS)
def test_zero1_moments_are_local_slices_of_zero1_spec(arch, mesh_shape):
    out = _ranks(arch, mesh_shape)
    for r in out:
        for path, (got, want) in r["moment_shapes"].items():
            assert got == want, path
    if mesh_shape[0] > 1:          # ZeRO-1 splits some moment over data
        sizes = {p: np.prod(g) for p, (g, _) in out[0]["moment_shapes"]
                 .items()}
        full = {p: m.size for p, m in out[0]["mu"].items()}
        assert sum(sizes.values()) < sum(full.values()) / mesh_shape[1]


@pytest.mark.parametrize("arch,mesh_shape", CASES, ids=IDS)
def test_kernel_launches_per_rank(arch, mesh_shape):
    """Each rank of a tensor-parallel step launches what one rank's step
    does (``train_step.kernel_launches``): a kernel runs once a layer
    whatever the rank's share of the heads, but for the hybrid's gated
    norm, split over the model ranks into two launches a Mamba2 layer and
    forward run (the row sums, then the scaling)."""
    cfg = get_smoke_config(arch, dtype="float32")
    want = TS.kernel_launches(cfg, model_ranks=mesh_shape[1])
    split = TS.split_norm_launches(cfg, mesh_shape[1])
    runs = 1 if cfg.remat == "none" else 2
    assert split == (2 * runs * cfg.num_layers if cfg.family == "hybrid"
                     else 0)
    assert want["fused_rmsnorm"] == (TS.kernel_launches(cfg)["fused_rmsnorm"]
                                     + split // 2)
    for r in _ranks(arch, mesh_shape):
        got = dict(r["launches"])
        assert got.pop("fused_rmsnorm split") == split
        assert got == {k: want[k] for k in got}


def test_int8_gradients_over_data_on_two_by_two():
    """stablelm-3b on (2, 2) with the int8 gradient mean over ``data``: the
    loss taken before the update equal, the gradients within the scheme's
    bound of the f32 ones, replicas equal."""
    f32 = _ranks("stablelm-3b", (2, 2))
    int8 = _ranks("stablelm-3b", (2, 2), compress=True)
    for a, b in zip(f32, int8):
        assert a["metrics"]["loss"] == b["metrics"]["loss"]
        for path, g in a["grads"].items():
            top = float(np.abs(g).max())
            assert np.abs(b["grads"][path] - g).max() <= 2 / 127 * top, path
    assert any(not np.array_equal(a["grads"][p], b["grads"][p])
               for a, b in zip(f32, int8) for p in a["grads"])
    for path, p in int8[0]["params"].items():
        for r in int8[1:]:
            np.testing.assert_array_equal(r["params"][path], p)
