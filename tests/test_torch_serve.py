"""The port's serving path against the JAX package: greedy ``generate`` gives
the same tokens on the same (bridged) weights, plus twins of ``pad_cache`` and
the ``sample`` mask, and the entry points refuse to fall back to the CPU."""
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
from repro_torch.configs import get_smoke_config
from repro_torch.distributed import serve_step as ss
from repro_torch.launch import serve
from repro_torch.models import model as M


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("arch", ["chatglm3-6b", "stablelm-3b"])
def test_greedy_generate_matches_jax_tokens(arch, use_pallas):
    jcfg = jget_smoke(arch, dtype="float32")
    cfg = get_smoke_config(arch, dtype="float32", use_pallas=use_pallas)
    jparams = jM.init_params(jax.random.PRNGKey(1), jcfg)
    params = bridge.to_torch(jax.tree.map(np.asarray, jparams),
                             device="cpu")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (3, 10),
                                                dtype=np.int32)
    want = np.asarray(jserve.generate(jparams, jcfg, jnp.asarray(prompts),
                                      max_new_tokens=8))
    got = serve.generate(params, cfg, torch.from_numpy(prompts),
                         max_new_tokens=8)
    assert got.dtype == torch.int32 and got.shape == (3, 18)
    np.testing.assert_array_equal(got.numpy(), want)


def test_pad_cache_matches_jax():
    cfg = get_smoke_config("chatglm3-6b", dtype="float32")
    rng = np.random.default_rng(0)
    cache = {"index": np.asarray(5, np.int32),
             "layers": {n: rng.standard_normal((2, 3, 5, 4, 16)).astype(np.float32)
                        for n in ("k", "v")}}
    want = jss.pad_cache(jax.tree.map(jnp.asarray, cache),
                         jget_smoke("chatglm3-6b"), 9)
    got = ss.pad_cache(bridge.to_torch(cache, device="cpu"), cfg, 9)
    assert got["layers"]["k"].shape == (2, 3, 9, 4, 16)
    for n in ("k", "v"):
        np.testing.assert_array_equal(got["layers"][n].numpy(),
                                      np.asarray(want["layers"][n]))
    assert int(got["index"]) == 5
    # already long enough: unchanged
    same = ss.pad_cache(got, cfg, 7)
    assert same["layers"]["k"] is got["layers"]["k"]


def test_sample_masks_padded_vocab_like_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((4, 1, 64)).astype(np.float32)
    logits[:, :, 50:] += 100.0                 # padded tail would win unmasked
    want = np.asarray(jss.sample(jnp.asarray(logits), jax.random.PRNGKey(0),
                                 0.0, vocab_size=50))
    got = ss.sample(torch.from_numpy(logits), vocab_size=50)
    assert got.shape == (4, 1)
    np.testing.assert_array_equal(got.numpy(), want)
    assert bool((got < 50).all())
    gen = torch.Generator().manual_seed(0)
    hot = ss.sample(torch.from_numpy(logits), gen, temperature=1.0,
                    vocab_size=50)
    assert hot.shape == (4, 1) and bool((hot < 50).all())


def test_serve_batch_on_cpu_and_cli():
    cfg = get_smoke_config("stablelm-3b")
    res = serve.serve_batch(cfg, n_requests=2, prompt_len=8, max_new_tokens=4,
                            quiet=True, device="cpu")
    assert res["tokens"].shape == (2, 12) and res["tokens_per_s"] > 0
    serve.main(["--arch", "chatglm3-6b", "--smoke", "--device", "cpu",
                "--requests", "2", "--prompt-len", "6", "--max-new-tokens", "3"])


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("chatglm3-6b")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.serve_batch(cfg, n_requests=1, prompt_len=4, max_new_tokens=2,
                          device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.serve_batch(cfg, n_requests=1, prompt_len=4, max_new_tokens=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        M.init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--arch", "chatglm3-6b", "--smoke"])
