"""The port's AdamW (``repro_torch.optim.adamw``) on the CPU: twins of the
JAX package's optimizer tests (tests/test_substrate.py), and its schedule,
global norm and update held against JAX's on the same numpy trees.

Tolerances: the schedule 1e-6 relative (the same f32 arithmetic, but the
two libraries' f32 cosines differ in the last bits); the update 1e-6
absolute and relative over several steps (f32, the same operations, one of
them fused into a multiply-add on one side)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro_torch import tree as T
from repro_torch.optim import adamw


def _tree(seed=0, dtype=np.float32):
    """A parameter-like tree with every decay-mask case, as numpy."""
    rng = np.random.default_rng(seed)

    def r(*shape):
        return rng.standard_normal(shape).astype(dtype)
    return {"embed": {"table": r(8, 4)},
            "layers": {"norm1": {"scale": r(2, 4)},
                       "attn": {"wq": {"w": r(2, 4, 4), "b": r(2, 4)}},
                       "ssm": {"A_log": r(2, 3), "D": r(2, 3),
                               "dt_bias": r(2, 3), "conv_x": r(2, 4, 4)}}}


def _to_torch(tree):
    return T.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


# ------------------------------------------------ twins of test_substrate.py
def test_adamw_optimizes_quadratic():
    cfg = adamw.OptimizerConfig(lr=0.1, weight_decay=0.0, warmup_steps=1,
                                total_steps=200, clip_norm=10.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = adamw.init(params)

    def loss(p):
        return torch.sum(torch.square(p["w"]))
    for _ in range(150):
        w = params["w"].detach().requires_grad_()
        (g,) = torch.autograd.grad(loss({"w": w}), [w])
        params, state, _ = adamw.update(cfg, state, {"w": g}, params)
    assert float(loss(params)) < 1e-2


def test_adamw_grad_clipping():
    g = {"w": torch.tensor([3e6, 4e6])}
    clipped, norm = adamw.clip_by_global_norm(g, 1.0)
    assert abs(float(norm) - 5e6) / 5e6 < 1e-5
    assert abs(float(torch.linalg.norm(clipped["w"])) - 1.0) < 1e-4
    assert clipped["w"].dtype == torch.float32


def test_adamw_schedule_shape():
    cfg = adamw.OptimizerConfig(lr=1.0, warmup_steps=10, total_steps=100,
                                min_lr_ratio=0.1)
    lrs = [float(adamw.schedule(cfg, torch.tensor(s))) for s in range(100)]
    assert lrs[0] < lrs[9] <= 1.0           # warmup
    assert lrs[99] < lrs[50] < lrs[11]      # cosine decay
    assert lrs[99] >= 0.1 * 0.99            # floor


def test_decay_mask_excludes_norms():
    cfg = adamw.OptimizerConfig(lr=0.0, weight_decay=1.0)
    params = {"norm": {"scale": torch.ones(4)}, "lin": {"w": torch.ones(4)}}
    state = adamw.init(params)
    zeros = T.tree_map(torch.zeros_like, params)
    new, _, _ = adamw.update(cfg, state, zeros, params)
    assert torch.allclose(new["norm"]["scale"], torch.ones(4))  # no decay


# ---------------------------------------------------------- against JAX's
@pytest.mark.parametrize("cfg", [
    adamw.OptimizerConfig(lr=1.0, warmup_steps=10, total_steps=100),
    adamw.OptimizerConfig(lr=3e-4, warmup_steps=1, total_steps=10,
                          min_lr_ratio=0.0),
    adamw.OptimizerConfig(lr=2e-3, warmup_steps=0, total_steps=1)],
    ids=["warmup10", "warmup1", "no-warmup"])
def test_schedule_matches_jax(cfg):
    jcfg = jadamw.OptimizerConfig(**vars(cfg))
    steps = np.arange(0, 120, dtype=np.int32)
    want = np.asarray(jax.vmap(lambda s: jadamw.schedule(jcfg, s))(steps))
    got = np.array([float(adamw.schedule(cfg, torch.tensor(s)))
                    for s in steps], np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_decay_mask_matches_jax():
    """The port's mask on every leaf path is JAX's on the same tree."""
    tree = _tree()
    want = {}
    jax.tree_util.tree_map_with_path(
        lambda path, _: want.setdefault(
            "/".join(str(p.key) for p in path), jadamw._decay_mask(path)),
        tree)
    got = {path: adamw._decay_mask(path) for path, _ in T.flatten(tree)}
    assert got == want
    assert set(got.values()) == {True, False}


@pytest.mark.parametrize("grad_scale", [1.0, 100.0], ids=["unclipped",
                                                          "clipped"])
def test_update_matches_jax(grad_scale):
    """Three updates of the same tree by the same gradients in both
    packages: parameters, both moments, the step, grad_norm and lr."""
    cfg = adamw.OptimizerConfig(lr=1e-2, warmup_steps=2, total_steps=5)
    jcfg = jadamw.OptimizerConfig(**vars(cfg))
    params_np = _tree(0)
    jparams = jax.tree.map(jnp.asarray, params_np)
    jstate = jadamw.init(jparams)
    params = _to_torch(params_np)
    state = adamw.init(params)
    for i in range(3):
        grads_np = jax.tree.map(lambda a: a * grad_scale, _tree(10 + i))
        jparams, jstate, jm = jadamw.update(
            jcfg, jstate, jax.tree.map(jnp.asarray, grads_np), jparams)
        params, state, m = adamw.update(cfg, state, _to_torch(grads_np),
                                        params)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]), rtol=1e-6)
    assert int(state.step) == int(jstate.step) == 3
    for got, want in ((params, jparams), (state.mu, jstate.mu),
                      (state.nu, jstate.nu)):
        for (path, g), w in zip(T.flatten(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-6, err_msg=path)


def test_update_keeps_bf16_params_and_f32_moments():
    cfg = adamw.OptimizerConfig(lr=1e-2, warmup_steps=1, total_steps=5)
    params = T.tree_map(lambda t: t.to(torch.bfloat16), _to_torch(_tree(0)))
    before = T.tree_map(torch.clone, params)
    state = adamw.init(params)
    grads = T.tree_map(lambda t: t.to(torch.bfloat16), _to_torch(_tree(1)))
    new, state, _ = adamw.update(cfg, state, grads, params)
    assert new is params                       # updated in place
    for p, b, m in zip(T.leaves(new), T.leaves(before), T.leaves(state.mu)):
        assert p.dtype == torch.bfloat16 and m.dtype == torch.float32
        assert not torch.equal(p, b)
