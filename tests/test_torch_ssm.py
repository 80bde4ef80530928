"""The port's Mamba2 block (``models/ssm.py``) and its ssm (mamba2-130m) and
hybrid (zamba2-7b) model paths against the JAX package, at f32, on the same
numpy inputs and on JAX's weights carried over the bridge: the causal convs,
the block with its caches, the decode step, zamba2 with a tail of SSM layers
(its full width has 3; the smoke config has none), greedy tokens, the bridge
and ``pad_cache`` on hybrid trees, and ``init_params``/``init_cache``
against JAX's shapes, types and distributions.

Tolerance: 1e-4 absolute and relative for logits and caches, as the dense
model tests (the same f32 math through a few layers, sums in another order);
1e-5 for single functions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.distributed import serve_step as jss
from repro.launch import serve as jserve
from repro.models import model as jM
from repro.models import ssm as jssm
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.distributed import serve_step as ss
from repro_torch.launch import serve
from repro_torch.launch.serve import _positions
from repro_torch.models import model as M
from repro_torch.models import ssm

TOL = 1e-4
TAIL = {"num_layers": 5, "attn_every": 2}     # 2 groups of 2 + 1 tail layer
CASES = [("mamba2-130m", {}), ("zamba2-7b", {}), ("zamba2-7b", TAIL)]
IDS = ["mamba2-130m", "zamba2-7b", "zamba2-7b-tail"]


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               rtol=tol, atol=tol)


def _close_tree(port, ref, tol=TOL):
    if isinstance(port, dict):
        assert port.keys() == ref.keys()
        for k in port:
            _close_tree(port[k], ref[k], tol)
    else:
        assert tuple(port.shape) == tuple(np.shape(ref))
        _close(port, ref, tol)


def _rand(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _setup(arch, over, use_pallas=True, seed=0):
    jcfg = jget_smoke(arch, dtype="float32", **over)
    cfg = get_smoke_config(arch, dtype="float32", use_pallas=use_pallas, **over)
    jparams = jM.init_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, cfg, jparams, bridge.to_torch(jax.tree.map(np.asarray,
                                                            jparams),
                                               device="cpu")


def _batch(cfg, B, S, seed=0, start=0):
    rng = np.random.default_rng(seed)
    nb = {"tokens": rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32),
          "positions": np.broadcast_to(np.arange(start, start + S,
                                                 dtype=np.int32),
                                       (B, S)).copy()}
    return nb, {k: torch.from_numpy(v) for k, v in nb.items()}


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


# ------------------------------------------------------------------ the block
@pytest.mark.parametrize("S", [1, 3, 17])
def test_causal_conv_matches_jax(S):
    x, w = _rand((2, S, 24)), _rand((4, 24), seed=1)
    want = jssm.causal_conv(jnp.asarray(x), jnp.asarray(w))
    _close(ssm.causal_conv(torch.from_numpy(x), torch.from_numpy(w)), want,
           1e-5)


def test_causal_conv_step_matches_jax():
    x, w, c = _rand((2, 24)), _rand((4, 24), seed=1), _rand((2, 3, 24), seed=2)
    wy, wc = jssm.causal_conv_step(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(c))
    tc = torch.from_numpy(c)
    y, nc = ssm.causal_conv_step(torch.from_numpy(x), torch.from_numpy(w), tc)
    _close(y, wy, 1e-5)
    _close(nc, wc, 0)
    np.testing.assert_array_equal(tc.numpy(), c)     # the input is not written


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("S", [2, 40, 70])
def test_mamba2_full_matches_jax(S, use_pallas):
    """Output and prefill caches; S = 2 < K - 1 left-pads the conv caches,
    S = 40 and 70 leave ragged last chunks at chunk 32."""
    jcfg, cfg, jp, tp = _setup("mamba2-130m", {}, use_pallas)
    x = _rand((2, S, cfg.d_model), seed=S)
    lp = jax.tree.map(lambda t: t[0], jp["layers"]["ssm"])
    want, wc = jssm.mamba2_full(lp, jnp.asarray(x), jcfg, return_cache=True)
    got, c = ssm.mamba2_full(M._layer(tp["layers"]["ssm"], 0),
                             torch.from_numpy(x), cfg, return_cache=True)
    _close(got, want)
    _close_tree(c, wc)
    assert c["state"].dtype == torch.float32
    _, none = ssm.mamba2_full(M._layer(tp["layers"]["ssm"], 0),
                              torch.from_numpy(x), cfg)
    assert none is None


def test_mamba2_decode_matches_jax_and_writes_in_place():
    jcfg, cfg, jp, tp = _setup("mamba2-130m", {})
    B, K, di = 2, cfg.ssm_conv, cfg.ssm_d_inner
    GN, H = cfg.ssm_groups * cfg.ssm_state, cfg.ssm_heads
    cache = {"conv_x": _rand((B, K - 1, di), 1),
             "conv_B": _rand((B, K - 1, GN), 2),
             "conv_C": _rand((B, K - 1, GN), 3),
             "state": _rand((B, H, cfg.ssm_head_dim, cfg.ssm_state), 4)}
    x = _rand((B, 1, cfg.d_model), seed=5)
    lp = jax.tree.map(lambda t: t[1], jp["layers"]["ssm"])
    want, wc = jssm.mamba2_decode(lp, jnp.asarray(x), jcfg,
                                  jax.tree.map(jnp.asarray, cache))
    tc = bridge.to_torch(cache, device="cpu")
    held = dict(tc)
    got, nc = ssm.mamba2_decode(M._layer(tp["layers"]["ssm"], 1),
                                torch.from_numpy(x), cfg, tc)
    _close(got, want)
    _close_tree(nc, wc)
    for k in held:
        assert nc[k] is held[k]


# ------------------------------------------------------------------ the model
@pytest.mark.parametrize("use_pallas", [True, False])
def test_hybrid_with_tail_matches_jax(use_pallas):
    """Train logits, prefill logits + every cache, and one decode step of
    zamba2 with a tail (2 groups of 2 SSM layers + 1 tail layer)."""
    jcfg, cfg, jp, tp = _setup("zamba2-7b", TAIL, use_pallas)
    assert M._hybrid_layout(cfg) == (2, 1) and "ssm_tail" in tp
    B, S = 2, 40
    nb, tb = _batch(cfg, B, S)
    want, _, _ = jM.forward(jp, jcfg, nb, mode="train")
    got, _, _ = M.forward(tp, cfg, tb, mode="train")
    _close(got, want)
    jl, _, jc = jM.forward(jp, jcfg, nb, mode="prefill")
    tl, _, tc = M.forward(tp, cfg, tb, mode="prefill")
    _close(tl, jl)
    _close_tree(tc, jc)
    jc, tc = jss.pad_cache(jc, jcfg, S + 2), ss.pad_cache(tc, cfg, S + 2)
    nd, td = _batch(cfg, B, 1, seed=1, start=S)
    jd, jnc = jM.decode(jp, jcfg, nd, jc)
    dl, tnc = M.decode(tp, cfg, td, tc)
    _close(dl, jd)
    _close_tree(tnc, jnc)


@pytest.mark.parametrize("arch,over", CASES, ids=IDS)
def test_init_params_and_cache_match_jax_layout(arch, over):
    """The port's own weights have JAX's tree, shapes and types, and the
    same distributions (the std of every leaf of 2,000 values or more
    within 10%, constants equal, dt and A within their ranges);
    ``init_cache`` has JAX's tree, shapes and types."""
    over = {**over, "d_model": 128}
    jcfg = jget_smoke(arch, **over)
    cfg = get_smoke_config(arch, **over)
    want = dict(_leaves(jax.tree.map(np.asarray, jM.init_params(
        jax.random.PRNGKey(0), jcfg))))
    got = dict(_leaves(M.init_params(cfg, seed=0, device="cpu")))
    assert got.keys() == want.keys()
    for name, w in want.items():
        t = got[name]
        assert tuple(t.shape) == w.shape, name
        assert str(t.dtype).split(".")[-1] == w.dtype.name, name
        tf, wf = t.float().numpy(), w.astype(np.float32)
        if wf.std() == 0:
            np.testing.assert_array_equal(tf, wf)
        elif wf.size >= 2000:          # std known to ~2% from the sample
            assert abs(tf.std() / wf.std() - 1) < 0.1, name
    for name, t in got.items():
        if name.endswith("dt_bias"):
            dt = torch.nn.functional.softplus(t)
            assert float(dt.min()) >= 1e-3 * 0.999
            assert float(dt.max()) <= 0.1 * 1.001
        if name.endswith("A_log"):
            assert 0.0 <= float(t.min()) and float(t.max()) <= np.log(16.0)
    wc = dict(_leaves(jax.tree.map(np.asarray,
                                   jM.init_cache(jcfg, 2, 24))))
    tc = dict(_leaves({k: v for k, v in M.init_cache(
        cfg, 2, 24, device="cpu").items() if k != "index"}))
    assert tc.keys() == {k for k in wc if k != "index"}
    for name, t in tc.items():
        assert tuple(t.shape) == wc[name].shape, name
        assert str(t.dtype).split(".")[-1] == wc[name].dtype.name, name


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("arch,over", CASES, ids=IDS)
def test_greedy_generate_matches_jax_tokens(arch, over, use_pallas):
    jcfg, cfg, jp, tp = _setup(arch, over, use_pallas, seed=1)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (3, 37),
                                                dtype=np.int32)
    want = np.asarray(jserve.generate(jp, jcfg, jnp.asarray(prompts),
                                      max_new_tokens=8))
    got = serve.generate(tp, cfg, torch.from_numpy(prompts), max_new_tokens=8)
    assert got.dtype == torch.int32 and got.shape == (3, 45)
    np.testing.assert_array_equal(got.numpy(), want)


def test_hybrid_with_tail_decode_matches_full_forward():
    """Sequential decode from an empty cache == teacher-forced forward."""
    cfg = get_smoke_config("zamba2-7b", dtype="float32", **TAIL)
    B, S = 2, 12
    params = M.init_params(cfg, seed=0, device="cpu")
    _, batch = _batch(cfg, B, S)
    full, _, _ = M.forward(params, cfg, batch, mode="train")
    cache = M.init_cache(cfg, B, max_len=S, device="cpu")
    outs = []
    for t in range(S):
        db = {"tokens": batch["tokens"][:, t:t + 1],
              "positions": _positions(cfg, B, 1, start=t, device="cpu")}
        lg, cache = M.decode(params, cfg, db, cache)
        outs.append(lg)
    dec = torch.cat(outs, dim=1)
    rel = float((dec - full).abs().max()) / (float(full.abs().max()) + 1e-9)
    assert rel < 2e-3, f"decode/forward mismatch rel={rel:.2e}"


# ----------------------------------------------------- bridge, cache, serving
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,over", CASES[:1] + CASES[2:],
                         ids=[IDS[0], IDS[2]])
def test_bridge_round_trip_is_bit_exact(arch, over, dtype):
    """The hybrid's (n_groups, attn_every) stacked leaves and the f32
    A_log / D / dt_bias leaves, which stay f32 in a bf16 model."""
    cfg = jget_smoke(arch, dtype=dtype, **over)
    params = jax.tree.map(np.asarray, jM.init_params(jax.random.PRNGKey(3),
                                                     cfg))
    src = dict(_leaves(params))
    tp = bridge.to_torch(params, device="cpu")
    for name, t in _leaves(tp):
        f32 = name.rsplit("/", 1)[-1] in ("A_log", "D", "dt_bias")
        assert t.dtype == (torch.float32 if f32 or dtype == "float32"
                           else torch.bfloat16), name
        assert tuple(t.shape) == src[name].shape, name
    if over:
        n_groups = cfg.num_layers // cfg.attn_every
        assert tp["ssm_groups"]["ssm"]["wx"]["w"].shape[:2] == (
            n_groups, cfg.attn_every)
    out = dict(_leaves(bridge.to_numpy(tp)))
    assert out.keys() == src.keys()
    for name, a in src.items():
        assert out[name].dtype == a.dtype, name
        assert a.tobytes() == out[name].tobytes(), name


def test_pad_cache_on_a_hybrid_cache_matches_jax():
    """Only the attention K/V leaves grow (seq axis 2 of (n_groups, B, S,
    KV, hd)); conv windows and states stay as they are."""
    jcfg = jget_smoke("zamba2-7b", dtype="float32", **TAIL)
    cfg = get_smoke_config("zamba2-7b", dtype="float32", **TAIL)
    cache = jax.tree.map(np.asarray, jM.init_cache(jcfg, 3, 5))
    rng = np.random.default_rng(0)
    cache = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        a.dtype) if a.ndim else a, cache)
    want = jss.pad_cache(jax.tree.map(jnp.asarray, cache), jcfg, 9)
    tc = bridge.to_torch(cache, device="cpu")
    got = ss.pad_cache(tc, cfg, 9)
    assert got["attn"]["k"].shape == (2, 3, 9, cfg.num_kv_heads, cfg.head_dim)
    _close_tree(got, jax.tree.map(np.asarray, want), 0)
    for part in ("ssm_groups", "ssm_tail"):
        for k, t in got[part].items():
            assert t is tc[part][k], (part, k)


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-7b"])
def test_serve_batch_and_cli_on_cpu(arch):
    cfg = get_smoke_config(arch)
    res = serve.serve_batch(cfg, n_requests=2, prompt_len=9, max_new_tokens=4,
                            quiet=True, device="cpu")
    assert res["tokens"].shape == (2, 13) and res["tokens_per_s"] > 0
    serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--requests",
                "2", "--prompt-len", "6", "--max-new-tokens", "3"])

