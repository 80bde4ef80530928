"""Every function of the port's ``models/layers.py`` against its JAX twin at
f32, on the same numpy inputs.

Tolerance: 1e-5 absolute (values are O(1)); the two sides compute the same
f32 expressions, and only the order of sums in matmuls and XLA's vs
PyTorch's transcendental functions differ, which stays within a few ulp."""
import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.models import layers as jL
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import layers as L

TOL = 1e-5


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               rtol=tol, atol=tol)


def _rand(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _positions(B, S, mrope=False, start=0):
    base = np.arange(start, start + S, dtype=np.int32)
    if mrope:       # distinct t/h/w streams so each section is exercised
        return np.stack([np.broadcast_to(base * (i + 1), (B, S)) for i in range(3)])
    return np.broadcast_to(base, (B, S)).copy()


@pytest.mark.parametrize("bias", [False, True])
def test_linear(bias):
    x, w, b = _rand((2, 5, 8)), _rand((8, 12), 1), _rand((12,), 2)
    p = {"w": w, **({"b": b} if bias else {})}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    _close(L.linear(tp, torch.from_numpy(x)), jL.linear(p, jnp.asarray(x)))


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_rmsnorm(eps, use_pallas):
    x, w = _rand((3, 7, 64)), _rand((64,), 1, 0.1)
    got = L.rmsnorm({"scale": torch.from_numpy(w)}, torch.from_numpy(x), eps,
                    use_pallas)
    _close(got, jL.rmsnorm({"scale": jnp.asarray(w)}, jnp.asarray(x), eps))


@pytest.mark.parametrize("arch", ["chatglm3-6b", "gemma-7b"])
def test_embed_and_gemma_scaling(arch):
    cfg, jcfg = get_smoke_config(arch), jget_smoke(arch)
    table = _rand((cfg.padded_vocab, cfg.d_model))
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 9),
                                               dtype=np.int32)
    got = L.embed({"table": torch.from_numpy(table)}, torch.from_numpy(tokens),
                  cfg)
    _close(got, jL.embed({"table": jnp.asarray(table)}, jnp.asarray(tokens),
                         jcfg))


@pytest.mark.parametrize("tied", [False, True])
def test_unembed(tied):
    cfg, jcfg = get_smoke_config("gemma-7b"), jget_smoke("gemma-7b")
    x = _rand((2, 3, cfg.d_model))
    p = ({"table": _rand((cfg.padded_vocab, cfg.d_model), 1)} if tied
         else {"w": _rand((cfg.d_model, cfg.padded_vocab), 1)})
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    _close(L.unembed(tp, torch.from_numpy(x), cfg),
           jL.unembed(p, jnp.asarray(x), jcfg))


@pytest.mark.parametrize("arch,reduced", [
    ("chatglm3-6b", False),     # partial, rot_dim 64 of 128
    ("stablelm-3b", False),     # partial, rot_dim 20: odd half (10)
    ("gemma-7b", True),         # full
    ("qwen2-vl-7b", True),      # mrope (2, 3, 3) sections
    ("qwen2-vl-7b", False),     # mrope (16, 24, 24), theta 1e6
])
def test_rope_cos_sin_and_apply_rope(arch, reduced):
    cfg = get_smoke_config(arch) if reduced else get_config(arch)
    jcfg = jget_smoke(arch) if reduced else jget_config(arch)
    hd = cfg.head_dim
    rd = L.rot_dim_for(cfg, hd)
    assert rd == jL.rot_dim_for(jcfg, hd)
    mrope = cfg.rope_kind == "mrope"
    B, S, H = 2, 37, 3
    pos = _positions(B, S, mrope, start=5)
    cos, sin = L.rope_cos_sin(cfg, torch.from_numpy(pos), rd)
    jcos, jsin = jL.rope_cos_sin(jcfg, jnp.asarray(pos), rd)
    # angles reach ~40 rad at these positions: a 1-ulp difference in
    # inv_freq moves cos/sin by ~4e-6
    _close(cos, jcos, 2e-5)
    _close(sin, jsin, 2e-5)
    x = _rand((B, S, H, hd), 3)
    got = L.apply_rope(torch.from_numpy(x), torch.from_numpy(np.array(jcos)),
                       torch.from_numpy(np.array(jsin)))
    want = jL.apply_rope(jnp.asarray(x), jcos, jsin)
    _close(got, want)
    np.testing.assert_array_equal(got.numpy()[..., rd:], x[..., rd:])


@pytest.mark.parametrize("kind,pct,hd,want", [
    ("none", 1.0, 64, 0), ("full", 1.0, 64, 64), ("partial", 0.25, 80, 20),
    ("partial", 0.5, 128, 64), ("partial", 0.3, 10, 2)])
def test_rot_dim_for(kind, pct, hd, want):
    cfg = dataclasses.replace(get_smoke_config("chatglm3-6b"), rope_kind=kind,
                              rotary_pct=pct)
    jcfg = dataclasses.replace(jget_smoke("chatglm3-6b"), rope_kind=kind,
                               rotary_pct=pct)
    assert L.rot_dim_for(cfg, hd) == jL.rot_dim_for(jcfg, hd) == want


def test_sinusoidal_pos_embed():
    pos = _positions(2, 50)
    got = L.sinusoidal_pos_embed(torch.from_numpy(pos), 64, torch.float32)
    _close(got, jL.sinusoidal_pos_embed(jnp.asarray(pos), 64, jnp.float32), 2e-5)


@pytest.mark.parametrize("arch", ["chatglm3-6b",      # SwiGLU
                                  "gemma-7b",         # GeGLU, gelu-tanh
                                  "musicgen-medium"])  # plain gelu MLP
def test_mlp(arch):
    cfg, jcfg = get_smoke_config(arch), jget_smoke(arch)
    d, ff = cfg.d_model, cfg.d_ff
    p = {"w_in": {"w": _rand((d, ff), 1, d ** -0.5)},
         "w_out": {"w": _rand((ff, d), 2, ff ** -0.5)}}
    if cfg.gated_mlp:
        p["w_gate"] = {"w": _rand((d, ff), 3, d ** -0.5)}
    tp = {k: {"w": torch.from_numpy(v["w"])} for k, v in p.items()}
    x = _rand((2, 6, d), 4)
    _close(L.mlp(tp, torch.from_numpy(x), cfg),
           jL.mlp(p, jnp.asarray(x), jcfg))


def test_init_linear_distribution():
    gen = torch.Generator().manual_seed(0)
    p = L.init_linear(gen, 256, 512, torch.float32, "cpu", bias=True, lead=(3,))
    w = p["w"]
    sd = 1.0 / math.sqrt(256)
    assert w.shape == (3, 256, 512) and p["b"].shape == (3, 512)
    assert float(w.abs().max()) <= 2 * sd
    # std of N(0, sd^2) truncated at +-2 sd is 0.8796 sd
    assert abs(float(w.std()) / sd - 0.8796) < 0.01
    assert not bool(p["b"].any())
