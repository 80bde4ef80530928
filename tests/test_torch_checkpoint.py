"""The port's ``CheckpointManager`` on the CPU: twins of the JAX package's
checkpoint tests (tests/test_substrate.py), and the on-disk format shared
with it: a checkpoint written by either package restores into the other bit
for bit, bf16 leaves and the optimizer state included. No tolerance: every
comparison is exact."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import CheckpointManager as JManager
from repro.configs import get_smoke_config as jget_smoke
from repro.models import model as jM
from repro.optim import adamw as jadamw
from repro_torch import bridge
from repro_torch import tree as T
from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.configs import get_smoke_config
from repro_torch.distributed import train_step as TS
from repro_torch.models import model as M
from repro_torch.optim import adamw


# ------------------------------------------------ twins of test_substrate.py
def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    state = {"params": {"w": torch.arange(6, dtype=torch.bfloat16).reshape(2, 3),
                        "b": torch.ones(3, dtype=torch.float32)},
             "step_count": torch.tensor(7, dtype=torch.int32)}
    mgr.save(7, state)
    out = mgr.restore(template=state)
    assert out["step"] == 7
    got = out["tree"]
    assert got["params"]["w"].dtype == torch.bfloat16
    assert torch.equal(got["params"]["w"], state["params"]["w"])
    assert torch.equal(got["step_count"], state["step_count"])


def test_checkpoint_retention_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"x": torch.zeros(2)})
    assert mgr.all_steps() == [3, 4]
    assert mgr.latest_step() == 4
    assert sorted(os.listdir(tmp_path)) == ["step_00000003", "step_00000004"]


def test_checkpoint_async_then_restore(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    x = torch.full((4,), 3.0)
    mgr.save(1, {"x": x})
    x.fill_(5.0)                # the save took its host copy before returning
    mgr.wait()
    out = mgr.restore(template={"x": torch.zeros(4)})
    assert torch.equal(out["tree"]["x"], torch.full((4,), 3.0))


def test_checkpoint_meta_and_get(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(3, {"x": torch.arange(3), "cursor": 11}, extra_meta={"seed": 9})
    out = mgr.restore()
    assert out["meta"] == {"seed": 9, "cursor": 11}
    assert torch.equal(out["get"]("x"), torch.arange(3))
    with pytest.raises(ValueError, match="template"):
        mgr.restore(template={"x": torch.zeros(4, dtype=torch.int64)})
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore()


# --------------------------------------------- the format shared with JAX
def _states(arch="mamba2-130m"):
    """The same model and optimizer state in both packages: JAX's bf16
    smoke weights with random moments and a step, and the port's copy."""
    jcfg = jget_smoke(arch)
    jparams = jM.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(0)
    jopt = jadamw.OptState(
        step=jnp.asarray(5, jnp.int32),
        mu=jax.tree.map(lambda p: jnp.asarray(
            rng.standard_normal(p.shape), jnp.float32), jparams),
        nu=jax.tree.map(lambda p: jnp.asarray(
            rng.random(p.shape), jnp.float32), jparams))
    jstate = {"params": jparams, "opt": jopt}
    host = jax.tree.map(np.asarray, jstate)
    params = bridge.to_torch(host["params"], device="cpu")
    opt = adamw.OptState(step=torch.tensor(5, dtype=torch.int32),
                         mu=bridge.to_torch(host["opt"].mu, device="cpu"),
                         nu=bridge.to_torch(host["opt"].nu, device="cpu"))
    return jstate, {"params": params, "opt": opt}


def _zeros_like(state):
    return T.tree_map(torch.zeros_like, state)


def _assert_same_bits(port_state, jax_state):
    flat = jax.tree_util.tree_flatten_with_path(jax_state)[0]
    want = {"/".join(str(p.key) if hasattr(p, "key") else str(p)
                     for p in path): np.asarray(leaf) for path, leaf in flat}
    got = dict(T.flatten(port_state))
    assert got.keys() == want.keys()
    for key, t in got.items():
        w = want[key]
        assert tuple(t.shape) == w.shape, key
        if w.dtype.name == "bfloat16":
            assert t.dtype == torch.bfloat16, key
            np.testing.assert_array_equal(
                t.view(torch.int16).numpy().view(np.uint16),
                w.view(np.uint16), err_msg=key)
        else:
            np.testing.assert_array_equal(t.numpy(), w, err_msg=key)


def test_paths_match_jax():
    jstate, state = _states()
    from repro.checkpoint.checkpoint import _flatten as jflatten
    assert [k for k, _ in T.flatten(state)] == [k for k, _ in jflatten(jstate)]


@pytest.mark.parametrize("async_save", [False, True])
def test_port_checkpoint_restores_into_jax(tmp_path, async_save):
    jstate, state = _states()
    mgr = CheckpointManager(str(tmp_path), async_save=async_save)
    mgr.save(5, state, extra_meta={"arch": "mamba2-130m"})
    mgr.wait()
    out = JManager(str(tmp_path)).restore(template=jstate)
    assert out["step"] == 5 and out["meta"] == {"arch": "mamba2-130m"}
    _assert_same_bits(state, out["tree"])
    assert out["tree"]["params"]["embed"]["table"].dtype == jnp.bfloat16


@pytest.mark.parametrize("async_save", [False, True])
def test_jax_checkpoint_restores_into_the_port(tmp_path, async_save):
    jstate, state = _states("zamba2-7b")
    jmgr = JManager(str(tmp_path), async_save=async_save)
    jmgr.save(5, jstate)
    jmgr.wait()
    mgr = CheckpointManager(str(tmp_path))
    out = mgr.restore(template=_zeros_like(state))
    assert out["step"] == 5
    assert isinstance(out["tree"]["opt"], adamw.OptState)
    _assert_same_bits(out["tree"], jstate)
    with open(tmp_path / "step_00000005" / "manifest.json") as f:
        assert json.load(f)["arrays"]["params/embed/table"]["dtype"] == \
            "bfloat16"


def test_restored_state_continues_training_bit_for_bit(tmp_path):
    """Save after two steps, restore into a fresh tree, take the third step
    from both: the same bits (what chip_smoke.py checks on the card)."""
    cfg = get_smoke_config("mamba2-130m")
    params = M.init_params(cfg, seed=0, device="cpu")
    step = TS.make_train_step(cfg, adamw.OptimizerConfig(total_steps=10,
                                                         warmup_steps=1))
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16)))
    batch = {"tokens": tokens, "labels": tokens.roll(-1, 1),
             "positions": torch.arange(16).expand(2, 16)}
    opt = adamw.init(params)
    for _ in range(2):
        params, opt, _ = step(params, opt, batch)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, {"params": params, "opt": opt})
    fresh = {"params": M.init_params(cfg, seed=1, device="cpu")}
    fresh["opt"] = adamw.init(fresh["params"])
    back = mgr.restore(template=fresh)["tree"]
    a = step(params, opt, batch)
    b = step(back["params"], back["opt"], batch)
    assert float(a[2]["loss"]) == float(b[2]["loss"])
    for x, y in zip(T.leaves((a[0], a[1])), T.leaves((b[0], b[1]))):
        assert torch.equal(x, y)


@pytest.mark.parametrize("async_save", [False, True])
def test_moe_tree_round_trips_bit_for_bit(tmp_path, async_save):
    """deepseek's smoke tree (MLA, a leading dense layer, the MoE stack with
    bare (E, d, ff) expert weights and an f32 router inside the bf16 tree):
    through the port's checkpoint and back, into JAX's manager, and through
    ``bridge.to_numpy``, every leaf equal bit for bit in its own dtype."""
    jstate, state = _states("deepseek-v2-lite-16b")
    router = state["params"]["layers"]["moe"]["router"]["w"]
    assert router.dtype == torch.float32
    assert state["params"]["layers"]["moe"]["w_in"].dtype == torch.bfloat16
    mgr = CheckpointManager(str(tmp_path), async_save=async_save)
    mgr.save(5, state)
    back = mgr.restore(template=_zeros_like(state))["tree"]
    _assert_same_bits(back, jstate)
    assert back["params"]["layers"]["moe"]["router"]["w"].dtype == \
        torch.float32
    out = JManager(str(tmp_path)).restore(template=jstate)["tree"]
    assert out["params"]["layers"]["moe"]["router"]["w"].dtype == jnp.float32
    _assert_same_bits(state, out)
    host = bridge.to_numpy(back["params"])
    want = jax.tree.map(np.asarray, jstate["params"])
    assert jax.tree.structure(host) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(host), jax.tree.leaves(want)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert host["layers"]["moe"]["router"]["w"].dtype == np.float32
