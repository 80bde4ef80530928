"""Tensor-parallel serving of the port (``launch.serve.generate(mesh=)``,
``tensor_parallel.ServeLayout``, the ``tp`` of the prefill and decode steps)
on gloo ranks of the CPU, held against the JAX package's unsharded
``repro.launch.serve.generate`` on the same numpy weights (through
``bridge``), with ``use_pallas=False`` on the JAX side.

Every mesh shape runs one spawn of its ranks for all its cases
(``tests/torch_ranks.tp_serve_on_ranks``, cached), each launch played by
its kernel's plain version inside the rank; the ranks import no JAX, and
JAX's reference is computed here and passed in as numpy. The cases: dense
with its kv heads split (chatglm3-6b on (1, 2)) and under the replicated-KV
rule (chatglm3-6b's 2 kv heads over 4 ranks), stablelm-3b on (2, 2), MLA
with a leading dense layer and MoE (deepseek-v2-lite-16b on (1, 4)), MoE
(phi3.5-moe on (1, 2)), the hybrid (zamba2-7b on (1, 4) and (2, 2), its
gated norms split over the ranks), and dp_all's split vocabulary
(mamba2-130m on (2, 2) with 8 requests, whose rows split over the model
group, and with 2, where ``model`` drops out of the batch axes).

Tolerances, each with its reason:
  * greedy tokens: equal;
  * the logits of the prefill and of each decode step, teacher-forced on
    JAX's tokens: within 1e-5 of the step's largest |logit| (the same f32
    arithmetic, sums split over the ranks);
  * each rank's cache after the prefill and after the last step: within
    1e-5 of each leaf's largest |value| of its block (``cache_pspec``) of
    the one-rank port cache, teacher-forced alike;
  * each rank's launches: equal to ``kernel_launches(cfg, T, tp=)``;
  * ``launch.serve.teacher_forced`` over the mesh: the whole batch's logits
    on every rank, within 1e-5 of each step's largest |logit| of JAX's;
  * tokens sampled at temperature 0.7 over the mesh: equal to one-rank
    ``generate``'s from a generator seeded alike (the same f32 logits to
    rounding, and one draw of noise for the whole batch).
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
from repro.launch import serve as jserve
from repro.models import model as jM
from repro_torch import bridge
from repro_torch import tree as T
from repro_torch.configs import get_smoke_config
from repro_torch.distributed import serve_step as ss
from repro_torch.distributed import sharding as SH
from repro_torch.launch import serve
from repro_torch.launch.mesh import abstract_mesh
from torch_ranks import gather_vocab_on_ranks, run_ranks, tp_serve_on_ranks

NEW, PROMPT = 8, 10
TOL = 1e-5
# (arch, requests) by mesh shape: one spawn of ranks a shape
CASES = {(1, 2): [("chatglm3-6b", 4), ("phi3.5-moe-42b-a6.6b", 4)],
         (1, 4): [("chatglm3-6b", 4), ("deepseek-v2-lite-16b", 4),
                  ("zamba2-7b", 4)],
         (2, 2): [("stablelm-3b", 4), ("zamba2-7b", 4), ("mamba2-130m", 8),
                  ("mamba2-130m", 2)]}
PARAMS = [(shape, i) for shape, cases in CASES.items()
          for i in range(len(cases))]
IDS = [f"{CASES[s][i][0]}-{CASES[s][i][1]}req-{s[0]}x{s[1]}"
       for s, i in PARAMS]


@functools.lru_cache(maxsize=None)
def _jax(arch, B):
    """JAX's weights, prompts, greedy ``generate`` and the logits of its
    prefill and decode steps teacher-forced on those tokens, (steps, B,
    padded vocab)."""
    jcfg = jget_smoke(arch, dtype="float32", use_pallas=False)
    jparams = jM.init_params(jax.random.PRNGKey(1), jcfg)
    prompts = np.random.default_rng(B).integers(0, jcfg.vocab_size,
                                                (B, PROMPT), dtype=np.int32)
    tokens = np.asarray(jserve.generate(jparams, jcfg, jnp.asarray(prompts),
                                        max_new_tokens=NEW))
    prefill = jax.jit(jss.make_prefill_step(jcfg))
    decode = jax.jit(jss.make_decode_step(jcfg))
    pos = jserve._positions(jcfg, B, PROMPT)
    lg, cache = prefill(jparams, {"tokens": jnp.asarray(tokens[:, :PROMPT]),
                                  "positions": pos})
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
def _one_rank_caches(arch, B):
    """The one-rank port's caches (plain path, f32, JAX's weights) after
    the prefill and after the last step, teacher-forced on JAX's tokens:
    {path: numpy} each."""
    params, _, tokens, _ = _jax(arch, B)
    cfg = get_smoke_config(arch, dtype="float32", use_pallas=False)
    tp = bridge.to_torch(params, device="cpu")
    forced = torch.from_numpy(tokens.copy())
    _, cache = ss.make_prefill_step(cfg)(tp, {
        "tokens": forced[:, :PROMPT].contiguous(),
        "positions": serve._positions(cfg, B, PROMPT, device="cpu")})
    first = {p: t.numpy().copy() for p, t in T.flatten(cache)}
    cache = ss.pad_cache(cache, cfg, PROMPT + NEW)
    decode = ss.make_decode_step(cfg)
    for t in range(NEW - 1):
        s = PROMPT + t
        _, cache = decode(tp, {
            "tokens": forced[:, s:s + 1].contiguous(),
            "positions": serve._positions(cfg, B, 1, start=s,
                                          device="cpu")}, cache)
    return first, {p: t.numpy().copy() for p, t in T.flatten(cache)}


@functools.lru_cache(maxsize=None)
def _ranks(shape):
    cases = []
    for arch, B in CASES[shape]:
        params, prompts, tokens, _ = _jax(arch, B)
        cases.append((arch, params, prompts, tokens, NEW))
    return run_ranks(tp_serve_on_ranks, shape[0] * shape[1], shape, cases,
                     timeout=300)


def _case(shape, i):
    arch, B = CASES[shape][i]
    return arch, B, [(r["coord"], r["cases"][i]) for r in _ranks(shape)]


def _block(full, spec, coord, mesh_shape):
    """The block of ``full`` that the rank at ``coord`` holds under
    ``spec`` (``sharding.local_slices``, from a coordinate)."""
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
def test_greedy_tokens_equal_jax(shape, i):
    arch, B, ranks = _case(shape, i)
    want = _jax(arch, B)[2]
    for _, r in ranks:                       # every rank returns the whole
        np.testing.assert_array_equal(r["tokens"], want)


@pytest.mark.parametrize("shape,i", PARAMS, ids=IDS)
def test_teacher_forced_logits_match_jax(shape, i):
    arch, B, ranks = _case(shape, i)
    want = _jax(arch, B)[3]                  # (steps, B, V)
    for _, r in ranks:
        got = r["logits"]
        b = got.shape[1]
        mine = want[:, r["row0"]:r["row0"] + b]
        for step in range(NEW):
            err = np.abs(got[step] - mine[step]).max()
            assert err <= TOL * np.abs(mine[step]).max(), (step, err)


@pytest.mark.parametrize("shape,i", PARAMS, ids=IDS)
def test_each_rank_cache_is_its_block_of_the_one_rank_cache(shape, i):
    arch, B, ranks = _case(shape, i)
    cfg = get_smoke_config(arch, dtype="float32")
    mesh_shape = {"data": shape[0], "model": shape[1]}
    specs = SH.cache_pspec(cfg, abstract_mesh(**mesh_shape), B)
    for which, whole in zip(("prefill_cache", "final_cache"),
                            _one_rank_caches(arch, B)):
        for coord, r in ranks:
            got = r[which]
            assert set(got) == set(whole)
            for path, full in whole.items():
                want = _block(full, specs[path], coord, mesh_shape)
                assert got[path].shape == want.shape, (which, path)
                err = np.abs(got[path] - want).max(initial=0.0)
                assert err <= TOL * np.abs(want).max(initial=0.0), (
                    which, path, err)


@pytest.mark.parametrize("shape,i", PARAMS, ids=IDS)
def test_each_rank_launches_as_kernel_launches_says(shape, i):
    arch, B, ranks = _case(shape, i)
    cfg = get_smoke_config(arch, dtype="float32")
    want = ss.kernel_launches(cfg, NEW, tp=shape[1])
    for _, r in ranks:
        assert r["launches"] == want
    split = {"zamba2-7b": True}.get(arch, False)
    assert (want["fused_rmsnorm_split"] > 0) == split


@pytest.mark.parametrize("shape,i", PARAMS, ids=IDS)
def test_teacher_forced_helper_gives_every_rank_the_whole_batch(shape, i):
    arch, B, ranks = _case(shape, i)
    want = _jax(arch, B)[3]                  # (steps, B, V)
    for _, r in ranks:
        got = r["helper_logits"]
        assert got.shape == want.shape
        for step in range(NEW):
            err = np.abs(got[step] - want[step]).max()
            assert err <= TOL * np.abs(want[step]).max(), (step, err)


@functools.lru_cache(maxsize=None)
def _one_rank_sampled(arch, B):
    params, prompts, _, _ = _jax(arch, B)
    cfg = get_smoke_config(arch, dtype="float32")
    return serve.generate(bridge.to_torch(params, device="cpu"), cfg,
                          torch.from_numpy(prompts), max_new_tokens=NEW,
                          temperature=0.7,
                          generator=torch.Generator().manual_seed(5)).numpy()


@pytest.mark.parametrize("shape,i", PARAMS, ids=IDS)
def test_temperature_tokens_equal_one_rank_generate(shape, i):
    """At temperature 0.7 every rank returns one-rank ``generate``'s tokens
    from a generator seeded alike, also where the batch splits over
    ``data`` (and under dp_all over ``model``): requests on other ranks
    draw other noise, as on one rank."""
    arch, B, ranks = _case(shape, i)
    want = _one_rank_sampled(arch, B)
    assert not (want[:, PROMPT:] == _jax(arch, B)[2][:, PROMPT:]).all()
    for _, r in ranks:
        np.testing.assert_array_equal(r["sampled"], want)


def test_dp_all_split_rows_follows_the_serving_batch():
    """Under dp_all the model group's ranks hold other rows where the
    serving batch splits over ``model`` too: 8 requests on (2, 2) split
    (2 a rank), 2 drop ``model`` (1 a data rank, the group's ranks the
    same row)."""
    by_b = {B: r for (arch, B), r in zip(CASES[(2, 2)],
                                         _ranks((2, 2))[0]["cases"])
            if arch == "mamba2-130m"}
    assert by_b[8]["split_rows"] and not by_b[2]["split_rows"]
    assert by_b[8]["logits"].shape[1] == 2 and by_b[2]["logits"].shape[1] == 1


def test_split_rows_on_the_production_mesh():
    """On the 16 x 16 production mesh the serving batches of 32 and 128
    requests drop ``model`` from dp_all's batch axes, so ``split_rows`` is
    False; 256 requests split over both axes. Rank 0 of a fake process
    group, as the dry-run runs."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.distributed import tensor_parallel as TPm
    from repro_torch.launch.mesh import make_mesh
    cfg = get_smoke_config("mamba2-130m")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=256)
    try:
        mesh = make_mesh((16, 16), ("data", "model"), device="cpu")
        got = {B: TPm.serve_layout(cfg, mesh, B) for B in (32, 128, 256)}
    finally:
        dist.destroy_process_group()
    assert not got[32].tp.split_rows and not got[128].tp.split_rows
    assert got[32].batch_axes == ("data",) and got[32].rows == 2
    assert got[256].tp.split_rows and got[256].rows == 1


@pytest.mark.parametrize("temperature", [0.0, 0.7])
@pytest.mark.parametrize("split_rows", [False, True])
def test_gather_vocab_then_sample_equals_sample_of_the_whole(temperature,
                                                             split_rows):
    """``gather_vocab`` of 4 ranks' vocab columns, then ``sample``, gives
    every rank the tokens ``sample`` draws from the whole logits (its rows'
    where the ranks hold other rows), greedy and at temperature 0.7 from a
    generator seeded alike."""
    world = 4
    logits = np.random.default_rng(3).standard_normal(
        (8, 1, 64)).astype(np.float32)
    logits[:, :, -3:] += 100.0             # a padded tail that would win
    out = run_ranks(gather_vocab_on_ranks, world, logits, temperature,
                    split_rows, timeout=120)
    b = 8 // world if split_rows else 8
    for rank, got in enumerate(out):
        rows = logits[rank * b:(rank + 1) * b] if split_rows else logits
        want = ss.sample(torch.from_numpy(rows),
                         torch.Generator().manual_seed(0), temperature, 61)
        np.testing.assert_array_equal(got, want.numpy())
        assert (got < 61).all()


def test_unsupported_config_raises_with_the_reason():
    """A config the port cannot split is never served whole: the hybrid's
    8 SSD heads over 16 model ranks raise with ``unsupported``'s reason
    (6 query heads over 4 model ranks, refused before query heads were
    padded to slots, are served: tests/test_torch_tp_heads.py)."""
    from repro_torch.distributed import tensor_parallel as TPm
    cfg = get_smoke_config("zamba2-7b")
    with pytest.raises(NotImplementedError, match="8 SSD heads"):
        TPm.serve_layout(cfg, abstract_mesh(data=1, model=16), 4)
    six = get_smoke_config("stablelm-3b", num_heads=6, num_kv_heads=6)
    assert TPm.unsupported(six, abstract_mesh(data=1, model=4)) is None


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "zamba2-7b",
                                  "mamba2-130m", "deepseek-v2-lite-16b"])
def test_blocks_drawn_leaf_by_leaf_equal_the_whole_tree_sharded(
        arch, monkeypatch):
    """``ParamLayout.init_params`` (each drawn leaf cut to the rank's block
    as it is drawn, the whole tree never built) gives exactly
    ``shard_params`` of the whole ``init_params``, with the leaves above
    ``layers._DRAW_WHOLE`` drawn a slice of dim 0 at a time (the limits
    lowered so that the smoke configs' leaves cross them). Rank 0 of a
    fake process group of a (2, 2) mesh."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.distributed import tensor_parallel as TPm
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    monkeypatch.setattr(L, "_DRAW_WHOLE", 1000)
    monkeypatch.setattr(L, "_DRAW_SLICE", 1000)
    cfg = get_smoke_config(arch)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        layout = TPm.serve_layout(
            cfg, make_mesh((2, 2), ("data", "model"), device="cpu"), 4)
        got = layout.init_params(3, "cpu")
        want = layout.shard_params(M.init_params(cfg, seed=3, device="cpu"))
    finally:
        dist.destroy_process_group()
    assert [p for p, _ in T.flatten(got)] == [p for p, _ in T.flatten(want)]
    for (path, a), (_, b) in zip(T.flatten(got), T.flatten(want)):
        assert a.shape == b.shape and torch.equal(a, b), path


def test_drawn_leaves_holds_on_its_own_thread():
    """``layers.drawn_leaves`` replaces the leaves drawn on its own thread
    only: a model drawn on another thread meanwhile (service replicas run
    in threads) is drawn whole."""
    import threading

    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    cfg = get_smoke_config("stablelm-3b")
    other = {}
    with L.drawn_leaves(lambda t: t[:1]):
        mine = M.init_params(cfg, seed=0, device="cpu")
        th = threading.Thread(target=lambda: other.update(
            p=M.init_params(cfg, seed=0, device="cpu")))
        th.start()
        th.join()
    whole = M.init_params(cfg, seed=0, device="cpu")
    for (path, a), (_, b), (_, c) in zip(T.flatten(mine),
                                         T.flatten(other["p"]),
                                         T.flatten(whole)):
        assert torch.equal(b, c), path
    assert any(a.shape != c.shape for (_, a), (_, c) in zip(
        T.flatten(mine), T.flatten(whole)))
