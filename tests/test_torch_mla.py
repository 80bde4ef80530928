"""The port's MLA (DeepSeek multi-head latent attention) against the JAX
package's ``repro/models/attention.py`` MLA half, in f32 on the same numpy
inputs with JAX's parameters carried over the bridge.

JAX runs ``use_pallas=False``: its flash kernel returns q's width where MLA's
value head is narrower (``ROADMAP.md``, reference caveat 3). The port runs
its kernel flag on and off; on CPU tensors its wrappers take their plain
versions. Tolerance 1e-5 of max|want| (the same f32 math through two
frameworks, sums in another order), caches 1e-5 absolute.

Also the flash wrapper's width pairs: it admits the (192, 128) pair it is
built for and the equal widths, and refuses any other before a launch."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.models import attention as jattn
from repro_torch import bridge
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import attention as attn

ARCH = "deepseek-v2-lite-16b"
TOL = 1e-5


def _setup(use_pallas, **over):
    jcfg = jget_smoke(ARCH, dtype="float32", **over)
    cfg = get_smoke_config(ARCH, dtype="float32", use_pallas=use_pallas,
                           **over)
    jp = jattn.init_mla(jax.random.PRNGKey(0), jcfg, jnp.float32)
    # a kv_norm scale away from zero, so the (1 + w) weight is exercised
    jp["kv_norm"]["scale"] = 0.1 * jax.random.normal(
        jax.random.PRNGKey(1), jp["kv_norm"]["scale"].shape)
    p = bridge.to_torch(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, cfg, jp, p


def _inputs(cfg, B, S, start=0, seed=0):
    x = np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(start, start + S, dtype=np.int32),
                          (B, S)).copy()
    return x, pos


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    err = float(np.abs(got.detach().numpy() - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), err


@pytest.mark.parametrize("use_pallas", [True, False])
def test_mla_latents_match_jax(use_pallas):
    jcfg, cfg, jp, p = _setup(use_pallas)
    x, pos = _inputs(cfg, 2, 10)
    jc, jk, (jcos, jsin) = jattn.mla_latents(jp, jnp.asarray(x), jcfg,
                                             jnp.asarray(pos))
    c, k, (cos, sin) = attn.mla_latents(p, torch.from_numpy(x), cfg,
                                        torch.from_numpy(pos))
    assert c.shape == (2, 10, cfg.kv_lora_rank)
    assert k.shape == (2, 10, 1, cfg.qk_rope_head_dim)
    for got, want in ((c, jc), (k, jk), (cos, jcos), (sin, jsin)):
        _close(got, want)


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("S", [1, 7, 16])
def test_mla_full_matches_jax(S, use_pallas):
    jcfg, cfg, jp, p = _setup(use_pallas)
    x, pos = _inputs(cfg, 2, S)
    want, (jc, jk) = jattn.mla_full(jp, jnp.asarray(x), jcfg,
                                    jnp.asarray(pos), return_kv=True)
    got, (c, k) = attn.mla_full(p, torch.from_numpy(x), cfg,
                                torch.from_numpy(pos), return_kv=True)
    _close(got, want)
    assert c.shape == (2, S, cfg.kv_lora_rank)
    assert k.shape == (2, S, cfg.qk_rope_head_dim)
    _close(c, jc)
    _close(k, jk)
    out, kv = attn.mla_full(p, torch.from_numpy(x), cfg,
                            torch.from_numpy(pos))
    assert kv is None and torch.equal(out, got)


@pytest.mark.parametrize("use_pallas", [True, False])
def test_mla_full_at_the_published_head_widths(use_pallas):
    """q/k 128 + 64 wide against v 128: the widths the flash kernel's MLA
    instantiation takes on the card."""
    over = dict(qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
                kv_lora_rank=64)
    jcfg, cfg, jp, p = _setup(use_pallas, **over)
    x, pos = _inputs(cfg, 1, 12, seed=2)
    want, _ = jattn.mla_full(jp, jnp.asarray(x), jcfg, jnp.asarray(pos))
    got, _ = attn.mla_full(p, torch.from_numpy(x), cfg, torch.from_numpy(pos))
    _close(got, want)


@pytest.mark.parametrize("use_pallas", [True, False])
def test_mla_decode_matches_jax_and_writes_in_place(use_pallas):
    """The absorbed-weight decode step against a prefilled cache: output and
    both caches as JAX's; the port writes the new rows into the caller's
    caches (JAX returns updated copies) and leaves the other rows."""
    jcfg, cfg, jp, p = _setup(use_pallas)
    B, S, Smax = 2, 9, 13
    x, pos = _inputs(cfg, B, S)
    _, (jc, jk) = jattn.mla_full(jp, jnp.asarray(x), jcfg, jnp.asarray(pos),
                                 return_kv=True)
    pad = ((0, 0), (0, Smax - S), (0, 0))
    jc, jk = jnp.pad(jc, pad), jnp.pad(jk, pad)
    xd, posd = _inputs(cfg, B, 1, start=S, seed=1)
    want, jc2, jk2 = jattn.mla_decode(jp, jnp.asarray(xd), jcfg,
                                      jnp.asarray(posd), jc, jk, S)
    ckv = torch.from_numpy(np.array(jc))
    krope = torch.from_numpy(np.array(jk))
    before = ckv.clone()
    got, c2, k2 = attn.mla_decode(p, torch.from_numpy(xd), cfg,
                                  torch.from_numpy(posd), ckv, krope,
                                  torch.tensor(S, dtype=torch.int32))
    _close(got, want)
    assert c2 is ckv and k2 is krope
    _close(ckv, jc2)
    _close(krope, jk2)
    assert torch.equal(ckv[:, :S], before[:, :S])
    assert torch.equal(ckv[:, S + 1:], before[:, S + 1:])


def test_mla_decode_matches_the_full_forward():
    """Step-by-step absorbed decode from an empty cache equals the full
    (decompressed) forward at every position (f32, 1e-4 relative)."""
    _, cfg, _, p = _setup(True)
    B, S = 2, 8
    x, pos = _inputs(cfg, B, S, seed=4)
    full, _ = attn.mla_full(p, torch.from_numpy(x), cfg, torch.from_numpy(pos))
    ckv = torch.zeros(B, S, cfg.kv_lora_rank)
    krope = torch.zeros(B, S, cfg.qk_rope_head_dim)
    outs = []
    for t in range(S):
        o, ckv, krope = attn.mla_decode(
            p, torch.from_numpy(x[:, t:t + 1]), cfg,
            torch.from_numpy(pos[:, t:t + 1]), ckv, krope,
            torch.tensor(t, dtype=torch.int32))
        outs.append(o)
    dec = torch.cat(outs, 1)
    rel = float((dec - full).abs().max() / full.abs().max())
    assert rel < 1e-4, rel


def test_init_mla_matches_jax_layout():
    cfg = get_smoke_config(ARCH)
    jcfg = jget_smoke(ARCH)
    jp = jax.eval_shape(lambda k: jattn.init_mla(k, jcfg, jnp.bfloat16),
                        jax.random.PRNGKey(0))
    p = attn.init_mla(torch.Generator().manual_seed(0), cfg, torch.bfloat16,
                      "cpu", lead=(2,))
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(flat) == 7
    for path, leaf in flat:
        t = p
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == (2, *leaf.shape), path
        assert t.dtype == torch.bfloat16, path


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_wrapper_admits_the_pairs_it_was_built_for(dtype):
    """``_check`` (what a CUDA launch checks first) on CPU tensors: equal
    widths and MLA's (192, 128) pass; any other pair raises."""
    def check(hd, hd_v):
        q = torch.zeros(1, 8, 4, hd, dtype=dtype)
        k = torch.zeros(1, 8, 2, hd, dtype=dtype)
        v = torch.zeros(1, 8, 2, hd_v, dtype=dtype)
        fa_ops._check(q, k, v)
    for hd, hd_v in fa_ops.HEAD_DIM_PAIRS:
        check(hd, hd_v)
    assert (192, 128) in fa_ops.HEAD_DIM_PAIRS
    assert all((hd, hd) in fa_ops.HEAD_DIM_PAIRS for hd in fa_ops.HEAD_DIMS)
    for hd, hd_v in ((192, 192), (128, 192), (24, 16), (128, 64), (192, 64)):
        with pytest.raises(ValueError, match="pairs built"):
            check(hd, hd_v)
    with pytest.raises(ValueError, match="does not match k"):
        fa_ops._check(torch.zeros(1, 8, 4, 192, dtype=dtype),
                      torch.zeros(1, 8, 2, 192, dtype=dtype),
                      torch.zeros(1, 7, 2, 128, dtype=dtype))


def test_deepseek_full_size_prefill_widths_are_built():
    """At deepseek-v2-lite-16b's own widths mla_full hands the kernel
    q/k (.., 16, 192) and v (.., 16, 128): a pair it is built for."""
    cfg = get_config(ARCH)
    hd = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    assert (hd, cfg.v_head_dim) == (192, 128)
    assert (hd, cfg.v_head_dim) in fa_ops.HEAD_DIM_PAIRS
