"""The port's MoE layer (``repro_torch/models/moe.py``) against the JAX
package's ``repro/models/moe.py`` on the same numpy inputs, with JAX's
parameters carried over the bridge.

Tolerances, each with its reason:
  * f32: ``moe_apply`` 1e-5 of max|want| (the same f32 math; the expert
    products sum in another order), the aux loss 1e-6 absolute; routing
    (top-k indices, kept slots) exactly, and every kept expert-buffer row
    bit for bit: a kept slot holds one token added to zeros;
  * bf16: 2e-2 of max|want|, the bf16 tolerance of the port's kernel tests
    (``tests/test_torch_kernels.py``): both sides round each product and the
    gated activation to bf16 at other places (JAX's bf16 silu rounds its
    sigmoid, PyTorch's does not).
Both group layouts run: one group per batch row (S > 1) and one global
group (decode, S == 1), each with the default capacity factor 1.25, which
drops tokens, and with a factor that drops none."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.models import moe as jmoe
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.models import moe

ARCHS = ["deepseek-v2-lite-16b", "phi3.5-moe-42b-a6.6b"]
# (B, S): prefill groups (a batch row each) and decode's one global group
LAYOUTS = [(2, 24), (16, 1)]
NO_DROPS = 16.0           # capacity_factor at which no expert overflows


def _setup(arch, dtype="float32", **over):
    jcfg = jget_smoke(arch, dtype=dtype, **over)
    cfg = get_smoke_config(arch, dtype=dtype, **over)
    jp = jmoe.init_moe(jax.random.PRNGKey(0), jcfg, jnp.dtype(dtype))
    p = bridge.to_torch(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, cfg, jp, p


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return float(np.abs(got.float().numpy() - want).max()
                 / np.abs(want).max())


def _keep(cfg, p, x):
    """The kept flags of the port's routing of x (B, S, d)."""
    B, S, d = x.shape
    G, Tg = (B, S) if S > 1 else (1, B)
    logits = x.reshape(G, Tg, d).float() @ p["router"]["w"]
    _, _, top_i = moe._route(logits, cfg)
    return moe._assign(top_i, cfg.num_experts, moe.moe_capacity(cfg, Tg))[1]


@pytest.mark.parametrize("drops", [True, False])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_jax_f32(arch, layout, drops):
    over = {} if drops else {"capacity_factor": NO_DROPS}
    jcfg, cfg, jp, p = _setup(arch, **over)
    x = _x((*layout, cfg.d_model))
    want, jaux = jmoe.moe_apply(jp, jnp.asarray(x), jcfg)
    got, aux = moe.moe_apply(p, torch.from_numpy(x), cfg)
    assert got.shape == x.shape and got.dtype == torch.float32
    assert _rel(got, want) < 1e-5
    assert aux.dtype == torch.float32 and aux.ndim == 0
    assert abs(float(aux) - float(jaux)) < 1e-6
    keep = _keep(cfg, p, torch.from_numpy(x))
    assert bool(keep.all()) != drops      # the default factor does drop


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_jax_bf16(arch, layout):
    jcfg, cfg, jp, p = _setup(arch, dtype="bfloat16")
    x = _x((*layout, cfg.d_model))
    xb = jnp.asarray(x, jnp.bfloat16)
    want, jaux = jmoe.moe_apply(jp, xb, jcfg)
    got, aux = moe.moe_apply(p, bridge.to_torch(np.asarray(xb), device="cpu"),
                             cfg)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    assert _rel(got, want) < 2e-2
    assert abs(float(aux) - float(jaux)) < 1e-6


@pytest.mark.parametrize("arch", ARCHS)
def test_routing_and_kept_slots_match_jax_exactly(arch):
    """top-k indices and renormalized weights from the same f32 logits, and
    the expert buffers: JAX's (G, E, C) slots against the port's (E, G, C)
    rows, bit for bit where a slot is kept. Capacity factor 0.5: half the
    choices overflow."""
    jcfg, cfg, jp, p = _setup(arch, capacity_factor=0.5)
    B, S, d = 2, 24, cfg.d_model
    E, C = cfg.num_experts, moe.moe_capacity(cfg, S)
    x = _x((B, S, d), seed=3)
    logits = x @ np.asarray(jp["router"]["w"])
    _, jtop_p, jtop_i = jmoe._route(jnp.asarray(logits), jcfg)
    _, top_p, top_i = moe._route(torch.from_numpy(logits), cfg)
    np.testing.assert_array_equal(top_i.numpy(), np.asarray(jtop_i))
    np.testing.assert_allclose(top_p.numpy(), np.asarray(jtop_p), rtol=1e-6)

    pos, keep = moe._assign(top_i, E, C)
    assert not bool(keep.all()) and bool(keep.any())
    dest = np.where(keep.numpy(), top_i.numpy() * C + pos.numpy(), E * C)
    jbuf = np.stack([np.asarray(jmoe._scatter(
        jnp.asarray(x[g]), [jnp.asarray(dest[g, :, j]) for j in
                            range(cfg.top_k)], (E + 1) * C)) for g in range(B)])
    group = torch.arange(B)[:, None, None]
    slot = torch.where(keep, (top_i * B + group) * C + pos, E * B * C)
    buf = moe._scatter(torch.from_numpy(x).reshape(B * S, d), slot,
                       E * B * C + 1)
    for g, t, j in zip(*np.nonzero(keep.numpy())):
        row = buf[int(slot[g, t, j])].numpy()
        np.testing.assert_array_equal(row, x[g, t])
        np.testing.assert_array_equal(row, jbuf[g, dest[g, t, j]])
    # every (expert, slot) below capacity is taken at most once
    kept = slot[keep]
    assert kept.unique().numel() == kept.numel()


@pytest.mark.parametrize("k", [1, 2, 6])
def test_top_k_ties_go_to_the_lower_expert_index_as_in_jax(k):
    """Equal router probabilities: jax.lax.top_k returns the lowest index
    first; the order sets slot priority, so the port must agree."""
    cfg = get_smoke_config("deepseek-v2-lite-16b", num_experts=8, top_k=k)
    jcfg = jget_smoke("deepseek-v2-lite-16b", num_experts=8, top_k=k)
    logits = np.zeros((3, 4, 8), np.float32)           # all tied
    logits[1] = np.array([0, 1, 1, 0, 1, 0, 1, 1], np.float32)
    logits[2, :, ::2] = 2.0                            # ties within the top
    logits[2, 1] = np.array([3, 3, 1, 1, 3, 0, 0, 3], np.float32)
    _, jtop_p, jtop_i = jmoe._route(jnp.asarray(logits), jcfg)
    _, top_p, top_i = moe._route(torch.from_numpy(logits), cfg)
    np.testing.assert_array_equal(top_i.numpy(), np.asarray(jtop_i))
    np.testing.assert_allclose(top_p.numpy(), np.asarray(jtop_p), rtol=1e-6)


def test_forced_ties_give_the_same_output_as_jax():
    """A router with tied columns (experts 0-3 copies of one another): every
    token's top-2 ties, so slot priority and capacity follow the tie order."""
    jcfg, cfg, jp, p = _setup("phi3.5-moe-42b-a6.6b")
    w = np.asarray(jp["router"]["w"]).copy()
    w[:, 1:] = w[:, :1]
    jp = {**jp, "router": {"w": jnp.asarray(w)}}
    p = {**p, "router": {"w": torch.from_numpy(w)}}
    x = _x((2, 24, cfg.d_model), seed=5)
    want, jaux = jmoe.moe_apply(jp, jnp.asarray(x), jcfg)
    got, aux = moe.moe_apply(p, torch.from_numpy(x), cfg)
    assert _rel(got, want) < 1e-5
    assert abs(float(aux) - float(jaux)) < 1e-6


@pytest.mark.parametrize("factor", [0.5, 1.0, 1.25, 2.0, 8.0])
@pytest.mark.parametrize("E,K", [(4, 2), (16, 2), (64, 6), (8, 1)])
@pytest.mark.parametrize("tokens", [1, 7, 8, 1024])
def test_moe_capacity_matches_jax(tokens, E, K, factor):
    over = dict(num_experts=E, top_k=K, capacity_factor=factor)
    want = jmoe.moe_capacity(jget_smoke("phi3.5-moe-42b-a6.6b", **over), tokens)
    assert moe.moe_capacity(get_smoke_config("phi3.5-moe-42b-a6.6b", **over),
                            tokens) == want


def test_moe_capacity_at_deepseek_full_size():
    """C differs between prefill (a group per row of 1,024 tokens) and decode
    (one group of the batch of 8)."""
    from repro_torch.configs import get_config
    cfg = get_config("deepseek-v2-lite-16b")
    assert moe.moe_capacity(cfg, 1024) == 120
    assert moe.moe_capacity(cfg, 8) == 6


def test_shared_experts_use_the_config_mlp():
    """deepseek's shared experts are built gated and applied with the
    config's ``mlp``, as in the reference."""
    jcfg, cfg, jp, p = _setup("deepseek-v2-lite-16b")
    assert set(p["shared"]) == {"w_in", "w_gate", "w_out"}
    assert p["shared"]["w_in"]["w"].shape == (cfg.d_model, cfg.d_ff_expert)
    # without the shared experts the two agree as well
    jp2 = {k: v for k, v in jp.items() if k != "shared"}
    p2 = {k: v for k, v in p.items() if k != "shared"}
    x = _x((2, 10, cfg.d_model), seed=7)
    want, _ = jmoe.moe_apply(jp2, jnp.asarray(x), jcfg)
    got, _ = moe.moe_apply(p2, torch.from_numpy(x), cfg)
    assert _rel(got, want) < 1e-5


def test_init_moe_layout_and_router_dtype():
    """Shapes as the reference's, the router f32 inside a bf16 layer,
    the expert weights bare (E, ...) tensors."""
    cfg = get_smoke_config("deepseek-v2-lite-16b")
    jcfg = jget_smoke("deepseek-v2-lite-16b")
    jp = jax.eval_shape(lambda k: jmoe.init_moe(k, jcfg, jnp.bfloat16),
                        jax.random.PRNGKey(0))
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg, torch.bfloat16,
                     "cpu", lead=(3,))
    flat = dict(jax.tree_util.tree_flatten_with_path(jp)[0])
    assert len(flat) == 7
    for path, leaf in flat.items():
        t = p
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == (3, *leaf.shape), path
        assert str(t.dtype).split(".")[-1] == str(leaf.dtype), path
    assert p["router"]["w"].dtype == torch.float32
    assert isinstance(p["w_in"], torch.Tensor)


def test_moe_gradient_reaches_the_router_through_the_gates():
    """The router's gradient flows through the renormalized top-k weights
    and the aux loss only (top-k indices carry none), as under jax.grad."""
    jcfg, cfg, jp, p = _setup("phi3.5-moe-42b-a6.6b")
    x = _x((2, 12, cfg.d_model), seed=9)

    def jloss(jp):
        y, aux = jmoe.moe_apply(jp, jnp.asarray(x), jcfg)
        return jnp.sum(y * y) + aux
    want = jax.grad(jloss)(jp)
    leaves = {k: v for k, v in
              [("router", p["router"]["w"]), ("w_in", p["w_in"]),
               ("w_gate", p["w_gate"]), ("w_out", p["w_out"])]}
    alias = {k: v.detach().requires_grad_() for k, v in leaves.items()}
    tp = {"router": {"w": alias["router"]}, "w_in": alias["w_in"],
          "w_gate": alias["w_gate"], "w_out": alias["w_out"]}
    y, aux = moe.moe_apply(tp, torch.from_numpy(x), cfg)
    grads = torch.autograd.grad((y * y).sum() + aux, list(alias.values()))
    for (name, _), g in zip(alias.items(), grads):
        w = np.asarray(want["router"]["w"] if name == "router" else want[name])
        assert np.abs(w).max() > 0, name
        assert _rel(g, w) < 1e-4, name


def test_dispatch_constraint_is_read_and_ignored():
    jcfg, cfg, jp, p = _setup("phi3.5-moe-42b-a6.6b")
    x = torch.from_numpy(_x((2, 8, cfg.d_model)))
    a, _ = moe.moe_apply(p, x, cfg)
    b, _ = moe.moe_apply(p, x, dataclasses.replace(
        cfg, moe_dispatch_constraint=True))
    assert torch.equal(a, b)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_bf16_gather_back_rounds_at_every_choice_as_jax(layout):
    """In bf16 the reference sums ``picked * gate`` for j = 0..K-1 into an
    output in x's dtype, rounding at every j. Weights and inputs of small
    integers (the gate's pre-activation 32, so silu rounds to it in bf16 on
    both sides) make every expert product exact, so the two outputs must
    agree bit for bit: only the gather-back's rounding is left to differ.
    Top-3: with two choices, rounding at each j and rounding the f32 sum
    once agree."""
    jcfg, cfg, jp, p = _setup("phi3.5-moe-42b-a6.6b", dtype="bfloat16",
                              capacity_factor=NO_DROPS, top_k=3)
    E, d, ff = cfg.num_experts, cfg.d_model, cfg.d_ff_expert
    rng = np.random.default_rng(11)
    x = rng.integers(-2, 3, (*layout, d)).astype(np.float32)
    x[..., 0] = 1.0
    w = {"router": rng.integers(-3, 4, (d, E)).astype(np.float32) / 4,
         "w_in": rng.integers(-1, 2, (E, d, ff)).astype(np.float32),
         "w_gate": np.zeros((E, d, ff), np.float32),
         "w_out": rng.integers(-1, 2, (E, ff, d)).astype(np.float32)}
    w["w_gate"][:, 0, :] = 32.0
    jp = {"router": {"w": jnp.asarray(w["router"])},
          **{k: jnp.asarray(v, jnp.bfloat16) for k, v in w.items()
             if k != "router"}}
    p = bridge.to_torch(jax.tree.map(np.asarray, jp), device="cpu")
    xb = jnp.asarray(x, jnp.bfloat16)
    want, _ = jmoe.moe_apply(jp, xb, jcfg)
    got, _ = moe.moe_apply(p, bridge.to_torch(np.asarray(xb), device="cpu"),
                           cfg)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
