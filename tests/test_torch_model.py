"""The port's model path against the JAX package, at f32, with the JAX
weights carried over the bridge: train logits and the MoE aux loss, prefill
logits + caches, and one decode step, for all ten smoke configs (the six
dense-path ones, the ssm (mamba2-130m) and hybrid (zamba2-7b) ones, and the
MoE family: deepseek-v2-lite-16b with MLA and a leading dense layer,
phi3.5-moe-42b-a6.6b with GQA), with the port's kernel flag on (its
wrappers take their plain versions on CPU tensors) and off. JAX runs
``use_pallas=False``, the path its own model tests hold.

Tolerance: 1e-4 absolute and relative; the same f32 math through two layers,
with sums in matmuls taken in another order. The MoE aux loss: 1e-6
absolute. The routing at smoke size takes the same decisions on both
sides (tests/test_torch_moe.py holds it exactly).
Plus twins of tests/test_models_smoke.py's shape, decode-vs-forward and MoE
tests on the port's own weights."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.models import model as jM
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.distributed.serve_step import pad_cache
from repro_torch.launch.serve import _positions
from repro_torch.models import model as M

DENSE_ARCHS = ["stablelm-3b", "stablelm-12b", "chatglm3-6b", "gemma-7b",
               "musicgen-medium", "qwen2-vl-7b"]
SSM_ARCHS = ["mamba2-130m", "zamba2-7b"]
MOE_ARCHS = ["deepseek-v2-lite-16b", "phi3.5-moe-42b-a6.6b"]
ARCHS = DENSE_ARCHS + SSM_ARCHS
ALL_ARCHS = ARCHS + MOE_ARCHS
TOL = 1e-4


def _batch(cfg, B, S, seed=0, start=0):
    """The same batch as numpy (for JAX) and as CPU tensors (for the port)."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
    base = np.arange(start, start + S, dtype=np.int32)
    pos = (np.broadcast_to(base, (3, B, S)) if cfg.rope_kind == "mrope"
           else np.broadcast_to(base, (B, S))).copy()
    nb = {"tokens": tokens, "positions": pos}
    if cfg.input_mode == "embeddings":
        nb["embeds"] = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    return nb, {k: torch.from_numpy(v) for k, v in nb.items()}


def _setup(arch, use_pallas):
    jcfg = jget_smoke(arch, dtype="float32")
    cfg = get_smoke_config(arch, dtype="float32", use_pallas=use_pallas)
    jparams = jM.init_params(jax.random.PRNGKey(0), jcfg)
    params = bridge.to_torch(jax.tree.map(np.asarray, jparams),
                             device="cpu")
    return jcfg, cfg, jparams, params


def _close(port, ref):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)


def _close_tree(port, ref):
    """Every leaf of a cache, with the same keys on both sides."""
    if isinstance(port, dict):
        assert port.keys() == ref.keys()
        for k in port:
            _close_tree(port[k], ref[k])
    else:
        assert tuple(port.shape) == tuple(np.shape(ref))
        _close(port, ref)


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_train_logits_match_jax(arch, use_pallas):
    jcfg, cfg, jparams, params = _setup(arch, use_pallas)
    nb, tb = _batch(cfg, 2, 16)
    want, jaux, _ = jM.forward(jparams, jcfg, nb, mode="train")
    got, aux, cache = M.forward(params, cfg, tb, mode="train")
    assert cache is None and aux.dtype == torch.float32 and aux.ndim == 0
    assert (float(aux) > 0) == (arch in MOE_ARCHS)
    assert abs(float(aux) - float(jaux)) < 1e-6
    _close(got, want)


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_prefill_and_decode_step_match_jax(arch, use_pallas):
    jcfg, cfg, jparams, params = _setup(arch, use_pallas)
    B, S = 2, 12
    nb, tb = _batch(cfg, B, S)
    jl, _, jc = jM.forward(jparams, jcfg, nb, mode="prefill")
    tl, _, tc = M.forward(params, cfg, tb, mode="prefill")
    _close(tl, jl)
    assert int(tc["index"]) == int(jc["index"]) == S
    assert tc["index"].dtype == torch.int32 and tc["index"].ndim == 0
    _close_tree(tc, jc)

    from repro.distributed.serve_step import pad_cache as jpad_cache
    jc = jpad_cache(jc, jcfg, S + 3)
    tc = pad_cache(tc, cfg, S + 3)
    nd, td = _batch(cfg, B, 1, seed=1, start=S)
    jd, jnc = jM.decode(jparams, jcfg, nd, jc)
    td_logits, tnc = M.decode(params, cfg, td, tc)
    _close(td_logits, jd)
    assert int(tnc["index"]) == S + 1
    _close_tree(tnc, jnc)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_prefill_and_decode_shapes(arch):
    cfg = get_smoke_config(arch)
    B, S = 2, 16
    params = M.init_params(cfg, seed=0, device="cpu")
    _, batch = _batch(cfg, B, S)
    logits, _, cache = M.forward(params, cfg, batch, mode="prefill")
    assert logits.shape == (B, 1, cfg.padded_vocab)
    assert int(cache["index"]) == S

    dc = M.init_cache(cfg, B, max_len=S + 1, device="cpu")
    dc["index"] = torch.tensor(S, dtype=torch.int32)
    db = {"tokens": batch["tokens"][:, :1],
          "positions": _positions(cfg, B, 1, start=S, device="cpu")}
    if cfg.input_mode == "embeddings":
        db["embeds"] = batch["embeds"][:, :1]
    dl, nc = M.decode(params, cfg, db, dc)
    assert dl.shape == (B, 1, cfg.padded_vocab)
    assert not bool(torch.isnan(dl.float()).any())
    assert int(nc["index"]) == S + 1


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_full_forward(arch):
    """Sequential decode from an empty cache == teacher-forced forward."""
    cfg = get_smoke_config(arch, dtype="float32")
    B, S = 2, 12
    params = M.init_params(cfg, seed=0, device="cpu")
    _, batch = _batch(cfg, B, S)
    full, _, _ = M.forward(params, cfg, batch, mode="train")
    cache = M.init_cache(cfg, B, max_len=S, device="cpu")
    outs = []
    for t in range(S):
        db = {"tokens": batch["tokens"][:, t:t + 1],
              "positions": _positions(cfg, B, 1, start=t, device="cpu")}
        if cfg.input_mode == "embeddings":
            db["embeds"] = batch["embeds"][:, t:t + 1]
        lg, cache = M.decode(params, cfg, db, cache)
        outs.append(lg)
    dec = torch.cat(outs, dim=1)
    rel = float((dec - full).abs().max()) / (float(full.abs().max()) + 1e-9)
    assert rel < 2e-3, f"{arch}: decode/forward mismatch rel={rel:.2e}"


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_decode_matches_with_nodrop_capacity(arch):
    """Twin of tests/test_models_smoke.py's: with no token dropped (capacity
    factor 8) sequential decode, whose routing groups the batch, equals the
    teacher-forced forward, whose routing groups each row."""
    cfg = get_smoke_config(arch, dtype="float32", capacity_factor=8.0)
    B, S = 2, 10
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
    rel = float((dec - full).abs().max()) / float(full.abs().max())
    assert rel < 2e-3, f"{arch}: rel={rel:.2e}"


def test_moe_aux_loss_nonzero():
    """Twin of tests/test_models_smoke.py's, on the port's bf16 weights."""
    cfg = get_smoke_config("phi3.5-moe-42b-a6.6b")
    params = M.init_params(cfg, seed=0, device="cpu")
    _, batch = _batch(cfg, 2, 16)
    _, aux, _ = M.forward(params, cfg, batch, mode="train")
    assert float(aux) > 0


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_params_and_cache_match_jax_layout(arch):
    """Leaf paths, shapes and dtypes of init_params and init_cache as the
    reference's: deepseek's leading dense layer apart (``dense_layers``),
    MLA's latent caches, the f32 router inside the bf16 tree."""
    jcfg, cfg = jget_smoke(arch), get_smoke_config(arch)
    jp = jax.eval_shape(lambda k: jM.init_params(k, jcfg),
                        jax.random.PRNGKey(0))
    jc = jax.eval_shape(lambda: jM.init_cache(jcfg, 2, 7))
    from repro_torch import tree as T
    for port, ref in ((M.init_params(cfg, seed=0, device="cpu"), jp),
                      (M.init_cache(cfg, 2, 7, device="cpu"), jc)):
        want = {"/".join(str(p.key) for p in path): leaf for path, leaf in
                jax.tree_util.tree_flatten_with_path(ref)[0]}
        got = dict(T.flatten(port))
        assert got.keys() == want.keys()
        for key, t in got.items():
            assert tuple(t.shape) == want[key].shape, key
            assert str(t.dtype).split(".")[-1] == str(want[key].dtype), key
    params = M.init_params(cfg, seed=0, device="cpu")
    assert params["layers"]["moe"]["router"]["w"].dtype == torch.float32
    assert params["layers"]["moe"]["w_in"].dtype == torch.bfloat16
    assert ("dense_layers" in params) == (arch == "deepseek-v2-lite-16b")


def test_config_copies_match_the_jax_configs():
    """The port's own copies of all ten configs and ModelConfig agree with
    the JAX package field by field, except the deliberate use_pallas
    default; ARCH_IDS lists the same archs in the same order."""
    import dataclasses
    from repro.configs import ARCH_IDS as JARCH_IDS
    from repro.configs import get_config as jget
    from repro_torch.configs import ARCH_IDS, get_config
    assert ARCH_IDS == JARCH_IDS and sorted(ALL_ARCHS) == sorted(ARCH_IDS)
    for arch in ALL_ARCHS:
        a, b = dataclasses.asdict(get_config(arch)), dataclasses.asdict(jget(arch))
        assert a.pop("use_pallas") is True and b.pop("use_pallas") is False
        assert a == b, arch
        assert get_config(arch).num_params() == jget(arch).num_params()
        assert (dataclasses.asdict(get_smoke_config(arch, use_pallas=False))
                == dataclasses.asdict(jget_smoke(arch)))
    # the MoE family's sizes (15.7 B and 41.9 B parameters)
    assert round(get_config("deepseek-v2-lite-16b").num_params() / 1e9, 1) \
        == 15.7
    assert round(get_config("phi3.5-moe-42b-a6.6b").num_params() / 1e9, 1) \
        == 41.9
