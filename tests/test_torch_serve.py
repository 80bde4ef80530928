"""The port's serving path against the JAX package: greedy ``generate`` gives
the same tokens on the same (bridged) weights, plus twins of ``pad_cache`` and
the ``sample`` mask, and the entry points refuse to fall back to the CPU.
Also the kernel launches of one ``generate`` that ``serve_step.kernel_launches``
predicts (``chip_smoke.py`` holds the card to it), counted on the CPU with each
launch played by its kernel's plain version."""
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
@pytest.mark.parametrize("arch", ["chatglm3-6b", "stablelm-3b",
                                  "deepseek-v2-lite-16b",
                                  "phi3.5-moe-42b-a6.6b"])
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


@pytest.mark.parametrize("arch", ["chatglm3-6b", "zamba2-7b"])
def test_teacher_forced_on_greedy_tokens_reproduces_them(arch):
    """``teacher_forced`` fed greedy ``generate``'s tokens gives logits
    whose argmax is each next token, and the cache of a prefill and
    steps - 1 decode steps; without ``keep_logits`` no logits."""
    cfg = get_smoke_config(arch, dtype="float32")
    params = M.init_params(cfg, seed=2, device="cpu")
    prompts = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (3, 10), dtype=np.int32))
    tokens = serve.generate(params, cfg, prompts, max_new_tokens=6)
    seen = []
    prefill_s, decode_ms, logits, cache = serve.teacher_forced(
        params, cfg, tokens, 10, on_prefill=seen.append)
    assert prefill_s > 0 and decode_ms > 0 and len(seen) == 1
    assert logits.shape == (6, 3, cfg.padded_vocab)
    np.testing.assert_array_equal(
        logits[..., :cfg.vocab_size].argmax(-1).t().numpy(),
        tokens[:, 10:].numpy())
    assert serve.teacher_forced(params, cfg, tokens, 10, warm=False,
                                keep_logits=False)[2] is None


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


def test_pad_cache_on_a_moe_mla_cache_matches_jax():
    """deepseek's cache: MLA's latent leaves (L, B, S, r) and (L, B, S,
    rope_d), in the leading dense layer's subtree and the MoE stack's."""
    jcfg = jget_smoke("deepseek-v2-lite-16b")
    cfg = get_smoke_config("deepseek-v2-lite-16b")
    rng = np.random.default_rng(1)
    cache = {"index": np.asarray(5, np.int32)}
    for stack, n in (("dense_layers", 1), ("layers", 1)):
        cache[stack] = {
            "c_kv": rng.standard_normal((n, 2, 5, 32)).astype(np.float32),
            "k_rope": rng.standard_normal((n, 2, 5, 8)).astype(np.float32)}
    want = jss.pad_cache(jax.tree.map(jnp.asarray, cache), jcfg, 9)
    got = ss.pad_cache(bridge.to_torch(cache, device="cpu"), cfg, 9)
    for stack in ("dense_layers", "layers"):
        assert got[stack]["c_kv"].shape == (1, 2, 9, 32)
        assert got[stack]["k_rope"].shape == (1, 2, 9, 8)
        for n in ("c_kv", "k_rope"):
            np.testing.assert_array_equal(got[stack][n].numpy(),
                                          np.asarray(want[stack][n]))
    # the prefill's own cache, grown for decode, has the reference's layout
    jparams = jM.init_params(jax.random.PRNGKey(0), jcfg)
    B, S = 2, 6
    tokens = np.zeros((B, S), np.int32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    _, _, jc = jM.forward(jparams, jcfg, {"tokens": tokens, "positions": pos},
                          mode="prefill")
    params = bridge.to_torch(jax.tree.map(np.asarray, jparams), device="cpu")
    _, _, tc = M.forward(params, cfg, {"tokens": torch.from_numpy(tokens),
                                       "positions": torch.from_numpy(pos)},
                         mode="prefill")
    jc, tc = jss.pad_cache(jc, jcfg, S + 4), ss.pad_cache(tc, cfg, S + 4)
    assert jax.tree.map(lambda a: a.shape, jc) == {
        k: ({n: tuple(t.shape) for n, t in v.items()} if isinstance(v, dict)
            else tuple(v.shape)) for k, v in tc.items()}


@pytest.mark.parametrize("arch,over", [
    ("deepseek-v2-lite-16b", {}), ("phi3.5-moe-42b-a6.6b", {}),
    ("chatglm3-6b", {}), ("zamba2-7b", {"num_layers": 5, "attn_every": 2}),
    ("mamba2-130m", {})])
def test_kernel_launches_of_generate(monkeypatch, arch, over):
    """Each launch played by its kernel's plain version (CPU tensors routed
    as CUDA tensors are): the counts of one generate are what
    ``serve_step.kernel_launches`` says. An MLA block runs three norms a step
    (norm1, norm2, kv_norm) and no decode attention; deepseek's leading
    dense layer counts as the MoE layers do."""
    from repro_torch.kernels import _grad
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.fused_rmsnorm import ops as rn_ops
    from repro_torch.kernels.ssd import ops as ssd_ops

    def played(mod, fn):
        def run(*args, **kw):
            mod.launches += 1
            return fn(*args, **kw)
        return run
    monkeypatch.setattr(_grad, "KERNEL_DEVICE", "cpu")
    for mod in (fa_ops, rn_ops, ssd_ops):
        monkeypatch.setattr(mod, "_launch", played(mod, mod.plain))
        monkeypatch.setattr(mod, "launches", 0)
    monkeypatch.setattr(da_ops, "launches", 0)
    monkeypatch.setattr(da_ops, "decode_attention",
                        played(da_ops, da_ops.decode_attention))
    cfg = get_smoke_config(arch, **over)
    new = 4
    serve.serve_batch(cfg, n_requests=2, prompt_len=7, max_new_tokens=new,
                      quiet=True, device="cpu")
    got = {"flash_attention": fa_ops.launches,
           "decode_attention": da_ops.launches,
           "fused_rmsnorm": rn_ops.launches, "ssd": ssd_ops.launches}
    assert got == ss.kernel_launches(cfg, new)


def test_kernel_launches_at_the_main_path_sizes():
    """The counts chip_smoke.py requires of one serve_batch of 32 new tokens
    at the MoE configurations' full widths (phi3.5-moe at 16 layers)."""
    from repro_torch.configs import get_config
    ds = ss.kernel_launches(get_config("deepseek-v2-lite-16b"), 32)
    assert ds == {"flash_attention": 27, "decode_attention": 0,
                  "fused_rmsnorm": 82 * 32, "ssd": 0}
    phi = ss.kernel_launches(get_config("phi3.5-moe-42b-a6.6b",
                                        num_layers=16), 32)
    assert phi == {"flash_attention": 16, "decode_attention": 16 * 31,
                   "fused_rmsnorm": 33 * 32, "ssd": 0}
    glm = ss.kernel_launches(get_config("chatglm3-6b"), 32)
    assert glm == {"flash_attention": 28, "decode_attention": 868,
                   "fused_rmsnorm": 1824, "ssd": 0}


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


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b",
                                  "phi3.5-moe-42b-a6.6b"])
def test_cli_serves_the_moe_family(arch, capsys):
    serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--requests",
                "2", "--prompt-len", "6", "--max-new-tokens", "3"])
    assert "2 requests x 3 new tokens" in capsys.readouterr().out


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


def test_serve_lm_twin_cli(capsys):
    """``launch/serve_lm.py``, the twin of examples/serve_lm.py, on the CPU:
    its two lines, and the tokens of ``serve_batch`` on its config."""
    from repro_torch.launch import serve_lm
    stats = serve_lm.main(["--arch", "mamba2-130m", "--requests", "2",
                           "--prompt-len", "8", "--max-new-tokens", "4",
                           "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.startswith("[serve_lm] mamba2-130m (reduced config, ")
    assert out.rstrip().endswith("tokens/s")
    want = serve.serve_batch(get_smoke_config("mamba2-130m"), n_requests=2,
                             prompt_len=8, max_new_tokens=4, quiet=True,
                             device="cpu")
    assert torch.equal(stats["tokens"], want["tokens"])


@pytest.mark.parametrize("arch", ["zamba2-7b", "chatglm3-6b"])
def test_cli_under_torchrun_gives_the_one_rank_tokens(arch):
    """``torchrun --nproc-per-node 2 ... --model-parallel 2 --device cpu``:
    the tensor-parallel serve (gloo, a (1, 2) mesh) prints, on rank 0
    alone, the new tokens of request 0 that one rank's ``serve_batch``
    gives on the same seed (each rank draws its blocks of the seed's
    weights and the global prompts)."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"),
               OMP_NUM_THREADS="2")
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.serve",
         "--arch", arch, "--smoke", "--model-parallel", "2", "--device",
         "cpu", "--requests", "2", "--prompt-len", "6",
         "--max-new-tokens", "4"],
        env=env, cwd=root, capture_output=True, text=True, timeout=180)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    lines = [ln for ln in r.stdout.splitlines() if "new tokens of request" in ln]
    assert len(lines) == 1 and "'model': 2" in lines[0]     # rank 0 prints
    want = serve.serve_batch(get_smoke_config(arch), n_requests=2,
                             prompt_len=6, max_new_tokens=4, quiet=True,
                             device="cpu")["tokens"][0, 6:].tolist()
    assert lines[0].endswith(str(want))
