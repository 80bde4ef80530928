"""Query heads that do not divide over the ``model`` axis
(``tensor_parallel.head_slots``): each rank holds whole heads in padded
slots, its blocks of ``wq``, its bias and ``wo`` carry them, and a rank
attends with its real heads only. Held on gloo ranks of the CPU against
the JAX package's unsharded ``make_train_step`` and ``generate`` on the
same numpy weights.

The cases are the smoke configs of the two architectures whose heads do
not divide over 16 model ranks, made so that 6 heads do not divide over 4
ranks: qwen2-vl-7b with 6 query heads over 2 kv heads (GQA, M-RoPE,
``qkv_bias``: each group of 3 padded to 4 slots, 2 a rank) and
musicgen-medium with 6 heads over 6 kv heads (MHA, sinusoidal positions,
a GELU MLP: padded at the tail to 8 slots, rank 3 holding only padding),
on (1, 4), and on (2, 2), where 6 heads divide over 2 model ranks. One
spawn of ranks a training case and one a mesh shape for serving
(``tests/torch_ranks.py``), each kernel launch played by its plain
version.

Tolerances, each with its reason (those of test_torch_tensor_parallel.py
and test_torch_tp_serve.py, the same f32 arithmetic with sums split over
the ranks):
  * one step against JAX's: the loss 1e-5 relative; every gathered
    gradient and moment per leaf 1e-4 relative to the leaf's largest
    value, every updated leaf 1e-4 absolute and relative;
  * the padding entries of every rank's parameter and moment blocks: zero
    after four steps (their gradient is zero, and so is AdamW's update);
  * serving: greedy tokens equal; the logits of every step teacher-forced
    on JAX's tokens within 1e-5 of the step's largest |logit|; each rank's
    cache blocks within 1e-5 of each leaf's largest |value| of its block
    of the one-rank port cache;
  * launches per rank: exactly ``kernel_launches(..., rank=)``.
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
from repro.distributed.train_step import make_loss_fn as jmake_loss_fn
from repro.distributed.train_step import make_train_step as jmake_train_step
from repro.launch import serve as jserve
from repro.models import model as jM
from repro.optim import adamw as jadamw
from repro_torch import bridge
from repro_torch import tree as T
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.distributed import serve_step as ss
from repro_torch.distributed import sharding as SH
from repro_torch.distributed import tensor_parallel as TPm
from repro_torch.distributed import train_step as TS
from repro_torch.launch import serve
from repro_torch.launch.mesh import abstract_mesh
from torch_ranks import run_ranks, tp_serve_on_ranks, tp_step_on_ranks

OVERRIDES = {"qwen2-vl-7b": {"num_heads": 6, "num_kv_heads": 2},
             "musicgen-medium": {"num_heads": 6, "num_kv_heads": 6}}
OPT = dict(total_steps=10, warmup_steps=1)
TOL = 1e-4
SERVE_TOL = 1e-5
MORE_STEPS = 3
NEW, PROMPT, REQUESTS = 6, 8, 2
SHAPES = [(1, 4), (2, 2)]
CASES = [(arch, shape) for shape in SHAPES for arch in OVERRIDES]
IDS = [f"{arch}-{d}x{m}" for arch, (d, m) in CASES]


def _cfg(arch):
    return get_smoke_config(arch, dtype="float32", **OVERRIDES[arch])


def _jcfg(arch, **kw):
    return jget_smoke(arch, dtype="float32", **OVERRIDES[arch], **kw)


def _batch(cfg, B=2, S=16, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    if cfg.rope_kind == "mrope":
        pos = np.broadcast_to(pos, (3, B, S)).copy()
    return {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1),
            "positions": pos}


def _paths(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(p.key) for p in path): np.asarray(leaf)
            for path, leaf in flat}


def _rel(got, want):
    return float(np.abs(got - want).max()) / (float(np.abs(want).max())
                                              + 1e-30)


# ---------------------------------------------------------------- layout
@pytest.mark.parametrize("arch,n,per_rank,padding_ranks", [
    ("qwen2-vl-7b", 16, 2, 0), ("qwen2-vl-7b", 8, 4, 0),
    ("musicgen-medium", 16, 2, 4)])
def test_head_slots_of_the_full_configs(arch, n, per_rank, padding_ranks):
    """qwen2-vl-7b's 4 groups of 7 heads pad to groups of 8 (32 slots),
    each rank's slots in one group; musicgen-medium's 24 heads pad at the
    tail to 32 slots, ranks 12-15 holding padding alone. Every real head
    sits in one slot, and ``unsupported`` no longer refuses either."""
    cfg = get_config(arch)
    slots = TPm.head_slots(cfg, n)
    assert slots.per_rank == per_rank and len(slots.heads) == 32
    assert sorted(h for h in slots.heads if h >= 0) == list(
        range(cfg.num_heads))
    G = cfg.num_heads // cfg.num_kv_heads
    real = [slots.real(r) for r in range(n)]
    assert sum(k for _, k in real) == cfg.num_heads
    assert sum(k == 0 for _, k in real) == padding_ranks
    for first, k in real:                      # one kv head, or whole ones
        if k:
            assert (first // G == (first + k - 1) // G
                    or (first % G == 0 and k % G == 0))
    assert TPm.unsupported(cfg, abstract_mesh(data=16, model=n)) is None


def test_unsupported_still_refuses_straddling_heads():
    """Heads whose kv heads neither divide the ranks nor come whole a rank
    are refused with the reason (21 heads in 7 groups over 4 ranks)."""
    cfg = get_smoke_config("qwen2-vl-7b", num_heads=21, num_kv_heads=7)
    why = TPm.unsupported(cfg, abstract_mesh(data=1, model=4))
    assert why and "straddle" in why


@pytest.mark.parametrize("arch", list(OVERRIDES))
def test_pad_and_unpad_heads_round_trip(arch):
    """``pad_heads`` puts each real head in its slot and zeros elsewhere;
    ``unpad_heads`` gives the leaf back exactly, along either head dim."""
    cfg = _cfg(arch)
    slots = TPm.head_slots(cfg, 4)
    hd = cfg.head_dim
    rng = np.random.default_rng(0)
    wq = torch.from_numpy(rng.standard_normal((3, 5, 6 * hd)))
    wo = torch.from_numpy(rng.standard_normal((3, 6 * hd, 5)))
    for t, dim in ((wq, -1), (wo, -2)):
        p = TPm.pad_heads(t, dim, slots)
        assert p.shape[dim] == len(slots.heads) * hd
        assert torch.equal(TPm.unpad_heads(p, dim, slots), t)
        heads = p.unflatten(dim, (len(slots.heads), hd))
        for i, h in enumerate(slots.heads):
            got = heads.select(dim - 1, i)
            want = (t.unflatten(dim, (6, hd)).select(dim - 1, h) if h >= 0
                    else torch.zeros_like(got))
            assert torch.equal(got, want), (dim, i)


# --------------------------------------------------------------- training
@functools.lru_cache(maxsize=None)
def _jax_step(arch):
    jcfg = _jcfg(arch)
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
def _train_ranks(arch, shape):
    return run_ranks(tp_step_on_ranks, shape[0] * shape[1], arch, shape,
                     _jax_step(arch)[0], _batch(_cfg(arch)), OPT, False,
                     OVERRIDES[arch], MORE_STEPS, timeout=240)


@pytest.mark.parametrize("arch,shape", CASES, ids=IDS)
def test_train_step_matches_jax_unsharded(arch, shape):
    _, new, mu, nu, grads, metrics = _jax_step(arch)
    for r in _train_ranks(arch, shape):
        for k in ("loss", "ce", "aux_loss"):
            np.testing.assert_allclose(r["metrics"][k], metrics[k],
                                       rtol=1e-5, atol=1e-7, err_msg=k)
        np.testing.assert_allclose(r["metrics"]["grad_norm"],
                                   metrics["grad_norm"], rtol=TOL)
        assert r["grads"].keys() == grads.keys() == r["params"].keys()
        for path, g in r["grads"].items():
            assert _rel(g, grads[path]) < TOL, path
        for path, p in r["params"].items():
            np.testing.assert_allclose(p, new[path], rtol=TOL, atol=TOL,
                                       err_msg=path)
        for got, want in ((r["mu"], mu), (r["nu"], nu)):
            for path, m in got.items():
                assert _rel(m, want[path]) < TOL, path


@pytest.mark.parametrize("arch,shape", CASES, ids=IDS)
def test_zero1_moment_blocks_of_the_padded_leaves(arch, shape):
    """Each moment's block is its ``local_slices(zero1_spec)`` block of
    the leaf padded to its head slots."""
    for r in _train_ranks(arch, shape):
        for path, (got, want) in r["moment_shapes"].items():
            assert got == want, path


@pytest.mark.parametrize("arch,shape", CASES, ids=IDS)
def test_padding_stays_zero_after_training(arch, shape):
    ranks = _train_ranks(arch, shape)
    padded = TPm.head_slots(_cfg(arch), shape[1]) is not None
    assert padded == (shape[1] == 4)
    if not padded:
        assert all("padding" not in r for r in ranks)
        return
    for r in ranks:
        worst, n = r["padding"]
        assert worst == 0.0, (r["coord"], worst, n)
    assert sum(r["padding"][1] for r in ranks) > 0


@pytest.mark.parametrize("arch,shape", CASES, ids=IDS)
def test_gathered_tree_has_jax_leaf_shapes(arch, shape):
    jparams = _jax_step(arch)[0]
    want = {p: t.shape for p, t in _paths(jparams).items()}
    for r in _train_ranks(arch, shape):
        assert {p: t.shape for p, t in r["params"].items()} == want


@pytest.mark.parametrize("arch,shape", CASES, ids=IDS)
def test_train_launches_per_rank(arch, shape):
    """A rank of padding alone (musicgen-medium's rank 3 on (1, 4))
    launches no flash attention."""
    cfg = _cfg(arch)
    seen = set()
    for r in _train_ranks(arch, shape):
        want = TS.kernel_launches(cfg, model_ranks=shape[1],
                                  rank=r["coord"]["model"])
        got = {k: v for k, v in r["launches"].items()
               if k != "fused_rmsnorm split"}
        assert got == {k: v for k, v in want.items() if k in got}
        seen.add(want["flash_attention"])
    assert (0 in seen) == (arch == "musicgen-medium" and shape == (1, 4))


# ---------------------------------------------------------------- serving
@functools.lru_cache(maxsize=None)
def _jax_serve(arch):
    """JAX's weights, prompts, greedy ``generate`` and the logits of its
    prefill and decode steps teacher-forced on those tokens."""
    jcfg = _jcfg(arch, use_pallas=False)
    jparams = jM.init_params(jax.random.PRNGKey(1), jcfg)
    B = REQUESTS
    prompts = np.random.default_rng(B).integers(0, jcfg.vocab_size,
                                                (B, PROMPT), dtype=np.int32)
    tokens = np.asarray(jserve.generate(jparams, jcfg, jnp.asarray(prompts),
                                        max_new_tokens=NEW))
    prefill = jax.jit(jss.make_prefill_step(jcfg))
    decode = jax.jit(jss.make_decode_step(jcfg))
    lg, cache = prefill(jparams, {"tokens": jnp.asarray(tokens[:, :PROMPT]),
                                  "positions": jserve._positions(jcfg, B,
                                                                 PROMPT)})
    cache = jss.pad_cache(cache, jcfg, PROMPT + NEW)
    steps = [np.asarray(lg[:, 0])]
    for t in range(NEW - 1):
        s = PROMPT + t
        lg, cache = decode(jparams, {
            "tokens": jnp.asarray(tokens[:, s:s + 1]),
            "positions": jserve._positions(jcfg, B, 1, start=s)}, cache)
        steps.append(np.asarray(lg[:, 0]))
    return (jax.tree.map(np.asarray, jparams), prompts, tokens,
            np.stack(steps))


@functools.lru_cache(maxsize=None)
def _one_rank_caches(arch):
    params, _, tokens, _ = _jax_serve(arch)
    cfg = _cfg(arch)
    tp = bridge.to_torch(params, device="cpu")
    forced = torch.from_numpy(tokens.copy())
    B = tokens.shape[0]
    _, cache = ss.make_prefill_step(cfg)(tp, {
        "tokens": forced[:, :PROMPT].contiguous(),
        "positions": serve._positions(cfg, B, PROMPT, device="cpu")})
    first = {p: t.numpy().copy() for p, t in T.flatten(cache)}
    cache = ss.pad_cache(cache, cfg, PROMPT + NEW)
    for t in range(NEW - 1):
        s = PROMPT + t
        _, cache = ss.make_decode_step(cfg)(tp, {
            "tokens": forced[:, s:s + 1].contiguous(),
            "positions": serve._positions(cfg, B, 1, start=s,
                                          device="cpu")}, cache)
    return first, {p: t.numpy().copy() for p, t in T.flatten(cache)}


@functools.lru_cache(maxsize=None)
def _serve_ranks(shape):
    cases = []
    for arch in OVERRIDES:
        params, prompts, tokens, _ = _jax_serve(arch)
        cases.append((arch, params, prompts, tokens, NEW,
                      {"overrides": OVERRIDES[arch]}))
    return run_ranks(tp_serve_on_ranks, shape[0] * shape[1], shape, cases,
                     timeout=300)


def _serve_case(arch, shape):
    i = list(OVERRIDES).index(arch)
    return [(r["coord"], r["cases"][i]) for r in _serve_ranks(shape)]


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


@pytest.mark.parametrize("arch,shape", CASES, ids=IDS)
def test_serving_tokens_and_logits_match_jax(arch, shape):
    _, _, tokens, logits = _jax_serve(arch)
    for _, r in _serve_case(arch, shape):
        np.testing.assert_array_equal(r["tokens"], tokens)
        got = r["logits"]
        mine = logits[:, r["row0"]:r["row0"] + got.shape[1]]
        for step in range(NEW):
            err = np.abs(got[step] - mine[step]).max()
            assert err <= SERVE_TOL * np.abs(mine[step]).max(), (step, err)


@pytest.mark.parametrize("arch,shape", CASES, ids=IDS)
def test_serving_cache_blocks_match_the_one_rank_cache(arch, shape):
    cfg = _cfg(arch)
    mesh_shape = {"data": shape[0], "model": shape[1]}
    specs = SH.cache_pspec(cfg, abstract_mesh(**mesh_shape), REQUESTS)
    for which, whole in zip(("prefill_cache", "final_cache"),
                            _one_rank_caches(arch)):
        for coord, r in _serve_case(arch, shape):
            for path, full in whole.items():
                want = _block(full, specs[path], coord, mesh_shape)
                got = r[which][path]
                assert got.shape == want.shape, (which, path)
                err = np.abs(got - want).max(initial=0.0)
                assert err <= SERVE_TOL * np.abs(want).max(initial=0.0), (
                    which, path, err)


@pytest.mark.parametrize("arch,shape", CASES, ids=IDS)
def test_serving_launches_per_rank(arch, shape):
    cfg = _cfg(arch)
    for coord, r in _serve_case(arch, shape):
        want = ss.kernel_launches(cfg, NEW, tp=shape[1], rank=coord["model"])
        assert r["launches"] == want, coord
