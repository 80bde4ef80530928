"""The port's training path on the CPU (``repro_torch.distributed.train_step``,
``models.model``'s remat, the kernel wrappers' ``autograd.Function``s),
held against the JAX package on the same numpy inputs and against itself.

Tolerances, each with its reason:
  * one train step against JAX's unsharded ``make_train_step`` on weights
    carried over the bridge in f32: 1e-4 absolute and relative on the loss,
    ``grad_norm`` and every updated leaf (as tests/test_torch_model.py: the
    same f32 math, sums in another order), and both moments per leaf 1e-4
    relative to the leaf's largest (their values are far below 1e-4, so an
    absolute limit would hold nothing); the gradients themselves against
    ``jax.grad`` of JAX's loss, per leaf 1e-4 relative to its largest;
  * ``accum_steps=2`` against one step on the whole batch: gradients 1e-5
    relative to the leaf's largest (the same sums, split in two);
  * the remat policies, and each ``autograd.Function`` against autograd
    through its plain version: exact (the same operations recomputed);
  * the kernel path's gradients against the plain path's: 1e-5 relative to
    the leaf's largest (f32; the wrappers' plain versions sum in another
    order than the model's plain path).
The kernels' ``autograd.Function`` launches a CUDA kernel in its forward;
on the CPU the tests route CPU tensors to the launch (``_grad.KERNEL_DEVICE``)
and put the kernel's plain version in that launch's place (``_launch``),
which keeps the launch counts: the wrappers' own routing is what runs."""
import contextlib
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.distributed.train_step import make_loss_fn as jmake_loss_fn
from repro.distributed.train_step import make_train_step as jmake_train_step
from repro.models import model as jM
from repro.optim import adamw as jadamw
from repro_torch import bridge
from repro_torch import tree as T
from repro_torch.configs import get_smoke_config
from repro_torch.distributed import train_step as TS
from repro_torch.kernels import _grad
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.fused_rmsnorm import ops as rn_ops
from repro_torch.kernels.fused_rmsnorm import ref as rn_ref
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd import ref as ssd_ref
from repro_torch.models import model as M
from repro_torch.optim import adamw

ARCHS = ["stablelm-3b", "mamba2-130m", "zamba2-7b", "deepseek-v2-lite-16b",
         "phi3.5-moe-42b-a6.6b"]
TOL = 1e-4
OPT = dict(total_steps=10, warmup_steps=1)


def _batch(cfg, B=2, S=16, seed=0):
    """The same batch as numpy (for JAX) and as CPU tensors (for the port)."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
    base = np.arange(S, dtype=np.int32)
    pos = (np.broadcast_to(base, (3, B, S)) if cfg.rope_kind == "mrope"
           else np.broadcast_to(base, (B, S))).copy()
    nb = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1),
          "positions": pos}
    if cfg.input_mode == "embeddings":
        nb["embeds"] = rng.standard_normal((B, S, cfg.d_model)).astype(
            np.float32)
    return nb, {k: torch.from_numpy(v) for k, v in nb.items()}


def _jax_paths(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(p.key) for p in path): np.asarray(leaf)
            for path, leaf in flat}


@functools.lru_cache(maxsize=None)
def _jax_step(arch):
    """JAX's unsharded train step on its own f32 weights: (weights before,
    weights after, mu, nu as {path: numpy}, metrics)."""
    jcfg = jget_smoke(arch, dtype="float32")
    jparams = jM.init_params(jax.random.PRNGKey(0), jcfg)
    step = jax.jit(jmake_train_step(jcfg, jadamw.OptimizerConfig(**OPT)))
    nb, _ = _batch(jcfg)
    new, opt, metrics = step(jparams, jadamw.init(jparams), nb)
    return (jax.tree.map(np.asarray, jparams), _jax_paths(new),
            _jax_paths(opt.mu), _jax_paths(opt.nu),
            {k: float(v) for k, v in metrics.items()})


def _rel(a, b):
    return float((a - b).abs().max()) / (float(b.abs().max()) + 1e-30)


# -------------------------------------------- one train step against JAX's
@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch, use_pallas):
    """JAX runs use_pallas=False (its kernel flag runs only on a TPU); the
    port runs its plain path and, with use_pallas=True, its wrappers' plain
    versions (CPU tensors)."""
    jparams, jnew, jmu, jnu, jm = _jax_step(arch)
    cfg = get_smoke_config(arch, dtype="float32", use_pallas=use_pallas)
    params = bridge.to_torch(jparams, device="cpu")
    step = TS.make_train_step(cfg, adamw.OptimizerConfig(**OPT))
    _, tb = _batch(cfg)
    new, opt, m = step(params, adamw.init(params), tb)
    assert set(m) == {"loss", "ce", "aux_loss", "grad_norm", "lr"}
    for k in ("loss", "ce", "aux_loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m[k]), jm[k], rtol=TOL, atol=TOL,
                                   err_msg=k)
    assert int(opt.step) == 1
    flat = dict(T.flatten(new))
    assert flat.keys() == jnew.keys()
    for path, t in flat.items():
        np.testing.assert_allclose(t.numpy(), jnew[path], rtol=TOL, atol=TOL,
                                   err_msg=path)
    # after one step m/(sqrt(v)+eps) is about sign(g): the gradients' sizes
    # reach the comparison through the moments, held relative to each leaf
    for got, want in ((opt.mu, jmu), (opt.nu, jnu)):
        flat = dict(T.flatten(got))
        assert flat.keys() == want.keys()
        for path, t in flat.items():
            assert float(np.abs(want[path]).max()) > 0, path
            assert _rel(t, torch.tensor(want[path])) < TOL, path


@functools.lru_cache(maxsize=None)
def _jax_grads(arch):
    """``jax.grad`` of JAX's loss at the weights of ``_jax_step``."""
    jcfg = jget_smoke(arch, dtype="float32")
    jparams = _jax_step(arch)[0]
    nb, _ = _batch(jcfg)
    grads, _ = jax.jit(jax.grad(jmake_loss_fn(jcfg), has_aux=True))(
        jparams, nb)
    return _jax_paths(grads)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_jax(arch, use_pallas):
    """The port's gradients (``make_grad_fn``) against ``jax.grad`` of JAX's
    loss, on the same bridged f32 weights and batch, per leaf."""
    want = _jax_grads(arch)
    cfg = get_smoke_config(arch, dtype="float32", use_pallas=use_pallas)
    params = bridge.to_torch(_jax_step(arch)[0], device="cpu")
    _, tb = _batch(cfg)
    grads, _ = TS.make_grad_fn(cfg)(params, tb)
    flat = dict(T.flatten(grads))
    assert flat.keys() == want.keys()
    for path, g in flat.items():
        assert float(np.abs(want[path]).max()) > 0, path
        assert _rel(g, torch.tensor(want[path])) < TOL, path


def test_one_train_step_changes_every_arch_params():
    """Twin of tests/test_models_smoke.py::test_one_train_step on the port's
    own bf16 weights, for every ported family."""
    for arch in ARCHS + ["chatglm3-6b", "qwen2-vl-7b", "musicgen-medium"]:
        cfg = get_smoke_config(arch)
        params = M.init_params(cfg, seed=0, device="cpu")
        before = T.tree_map(torch.clone, params)
        step = TS.make_train_step(cfg, adamw.OptimizerConfig(**OPT))
        _, tb = _batch(cfg)
        new, _, m = step(params, adamw.init(params), tb)
        assert torch.isfinite(m["loss"]) and float(m["loss"]) > 0, arch
        diff = max(float((a.float() - b.float()).abs().max())
                   for a, b in zip(T.leaves(new), T.leaves(before)))
        assert diff > 0, arch


def test_train_step_leaves_no_grad_behind():
    cfg = get_smoke_config("stablelm-3b", dtype="float32")
    params = M.init_params(cfg, seed=0, device="cpu")
    step = TS.make_train_step(cfg, adamw.OptimizerConfig(**OPT))
    _, tb = _batch(cfg)
    opt = adamw.init(params)
    for _ in range(2):
        params, opt, _ = step(params, opt, tb)
    for t in T.leaves(params) + T.leaves(opt.mu) + T.leaves(opt.nu):
        assert t.grad is None and not t.requires_grad


# -------------------------------------------------------------- accumulation
@pytest.mark.parametrize("arch", ["stablelm-3b", "mamba2-130m", "qwen2-vl-7b"])
def test_accumulation_matches_the_whole_batch(arch):
    """accum_steps=2 (f32 accumulation over two microbatches along dim 0;
    qwen2-vl-7b's mrope positions cut along dim 1) against one pass over the
    whole batch."""
    cfg = get_smoke_config(arch, dtype="float32")
    params = M.init_params(cfg, seed=0, device="cpu")
    _, tb = _batch(cfg, B=4)
    whole, mw = TS.make_grad_fn(cfg)(params, tb)
    acc, ma = TS.make_grad_fn(cfg, accum_steps=2)(params, tb)
    np.testing.assert_allclose(float(ma["loss"]), float(mw["loss"]),
                               rtol=1e-6)
    for (path, a), w in zip(T.flatten(acc), T.leaves(whole)):
        assert a.dtype == torch.float32
        assert _rel(a, w) < 1e-5, path


def test_accumulation_and_compression_refusals():
    cfg = get_smoke_config("stablelm-3b")
    # the int8 mean runs over a mesh's data-parallel axes, as JAX's asserts
    with pytest.raises(ValueError, match="needs mesh and dp_axes"):
        TS.make_train_step(cfg, adamw.OptimizerConfig(),
                           grad_compression="int8")
    with pytest.raises(ValueError, match="unknown grad_compression"):
        TS.make_train_step(cfg, adamw.OptimizerConfig(),
                           grad_compression="bf16")
    params = M.init_params(cfg, seed=0, device="cpu")
    _, tb = _batch(cfg, B=3)
    with pytest.raises(ValueError, match="multiple of accum_steps"):
        TS.make_grad_fn(cfg, accum_steps=2)(params, tb)


def test_eval_step_matches_the_train_loss():
    cfg = get_smoke_config("stablelm-3b", dtype="float32")
    params = M.init_params(cfg, seed=0, device="cpu")
    _, tb = _batch(cfg)
    ev = TS.make_eval_step(cfg)(params, tb)
    _, m = TS.make_grad_fn(cfg)(params, tb)
    assert float(ev["loss"]) == float(m["loss"])
    assert ev["loss"].grad_fn is None


# --------------------------------------------------------------------- remat
@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_policies_give_the_same_gradients(arch, remat):
    cfg = get_smoke_config(arch, dtype="float32")
    params = M.init_params(cfg, seed=0, device="cpu")
    _, tb = _batch(cfg)
    want, mw = TS.make_grad_fn(dataclasses.replace(cfg, remat="none"))(
        params, tb)
    got, mg = TS.make_grad_fn(dataclasses.replace(cfg, remat=remat))(
        params, tb)
    assert float(mg["loss"]) == float(mw["loss"])
    for (path, g), w in zip(T.flatten(got), T.leaves(want)):
        torch.testing.assert_close(g, w, rtol=0, atol=0, msg=path)


def test_remat_rejects_an_unknown_policy():
    cfg = get_smoke_config("stablelm-3b", remat="everything")
    params = M.init_params(cfg, seed=0, device="cpu")
    _, tb = _batch(cfg)
    with pytest.raises(ValueError, match="remat"):
        TS.make_grad_fn(cfg)(params, tb)


# ------------------------------------------- the kernels' autograd.Functions
@contextlib.contextmanager
def _kernels_as_plain(monkeypatch):
    """CPU tensors routed as CUDA tensors are, into the kernels' launches,
    each launch played by its kernel's plain version (no grad, counted as a
    launch): flash attention's forward with its log-sum-exp by
    ``plain_lse``, its backward launch by ``plain_bwd`` (counted in
    ``backward_launches``)."""
    def launch(mod, plain, counter="launches"):
        def run(*args, **static):
            with torch.no_grad():
                out = plain(*args, **static)
            setattr(mod, counter, getattr(mod, counter) + 1)
            return out
        return run

    monkeypatch.setattr(_grad, "KERNEL_DEVICE", "cpu")
    for mod in (fa_ops, rn_ops, ssd_ops):
        monkeypatch.setattr(mod, "_launch", launch(mod, mod.plain))
    monkeypatch.setattr(fa_ops, "_launch_lse", launch(fa_ops, fa_ops.plain_lse))
    monkeypatch.setattr(fa_ops, "_launch_bwd",
                        launch(fa_ops, fa_ops.plain_bwd, "backward_launches"))
    yield


def test_plain_vjp_gradcheck(monkeypatch):
    """``_grad.PlainVJP``'s wiring in f64 (the kernels' plain versions
    compute in f32, so they do not admit gradcheck): an absent optional
    input, a static keyword, a second output without gradient."""
    def plain(a, absent, b, *, k):
        assert absent is None
        return (a * b).sin() * k, a.detach() + 1.0

    monkeypatch.setattr(_grad, "KERNEL_DEVICE", "cpu")
    rng = np.random.default_rng(5)
    a, b = (torch.from_numpy(rng.standard_normal((3, 4))).requires_grad_()
            for _ in range(2))
    out = _grad.call(lambda *t, **s: tuple(o.detach() for o in plain(*t, **s)),
                     plain, a, None, b, k=0.5)
    assert type(out[0].grad_fn).__name__ == "PlainVJPBackward"
    assert torch.autograd.gradcheck(
        lambda a, b: _grad.call(plain, plain, a, None, b, k=0.5)[0], (a, b))


def _leaves_requiring_grad(*arrays, dtype):
    return [torch.from_numpy(a).to(dtype).requires_grad_() for a in arrays]


def _same_grads(fn_kernel, fn_plain, inputs, seed=3):
    """Gradients of <out, r> through both, r random, on detached copies."""
    a = [t.detach().clone().requires_grad_() for t in inputs]
    b = [t.detach().clone().requires_grad_() for t in inputs]
    out_k, out_p = fn_kernel(*a), fn_plain(*b)
    assert out_k.grad_fn is not None
    torch.testing.assert_close(out_k, out_p, rtol=0, atol=0)
    r = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        tuple(out_p.shape)).astype(np.float32)).to(out_p.dtype)
    gk = torch.autograd.grad(out_k, a, r)
    gp = torch.autograd.grad(out_p, b, r)
    for x, y in zip(gk, gp):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def _backwards():
    return fa_ops.backward_launches, fa_ops.plain_backward_calls


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_function_gradients_are_the_plain_vjp(monkeypatch, dtype):
    """f32 takes the plain vjp: autograd's gradients through the plain
    version, bit for bit. bf16 takes the backward kernel's route, its launch
    played by ``ref.attention_bwd_ref``: the same output, and gradients
    within one bf16 rounding of the plain vjp's (both sum in f32 from the
    same inputs and round once to bf16, the sums in another order: 2^-7 of
    the largest), equal to the plain backward of the saved log-sum-exp."""
    rng = np.random.default_rng(0)
    B, S, H, KV, hd = 2, 24, 4, 2, 16
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)))
    with _kernels_as_plain(monkeypatch):
        n0, b0 = fa_ops.launches, _backwards()
        if dtype == torch.float32:
            _same_grads(lambda *t: fa_ops.flash_attention(*t, scale=0.25),
                        lambda *t: fa_ops.plain(*t, scale=0.25),
                        _leaves_requiring_grad(q, k, v, dtype=dtype))
            assert _backwards() == (b0[0], b0[1] + 1)
        else:
            a = _leaves_requiring_grad(q, k, v, dtype=dtype)
            b = [t.detach().clone().requires_grad_() for t in a]
            out = fa_ops.flash_attention(*a, scale=0.25)
            assert out.grad_fn.name() == "FlashAttentionBackward"
            torch.testing.assert_close(out, fa_ops.plain(*b, scale=0.25),
                                       rtol=0, atol=0)
            r = torch.from_numpy(rng.standard_normal(tuple(out.shape)).astype(
                np.float32)).to(dtype)
            got = torch.autograd.grad(out, a, r)
            want = torch.autograd.grad(fa_ops.plain(*b, scale=0.25), b, r)
            o, lse = fa_ops.plain_lse(*a, scale=0.25)
            same = fa_ops.plain_bwd(*a, o, lse, r, scale=0.25)
            for x, y, z in zip(got, want, same):
                torch.testing.assert_close(x, z, rtol=0, atol=0)
                assert float((x.float() - y.float()).abs().max()) <= \
                    2 ** -7 * float(y.float().abs().max())
            assert _backwards() == (b0[0] + 1, b0[1])
        assert fa_ops.launches == n0 + 1      # forward only; no relaunch


ROUTES = [(torch.bfloat16, hd, hd, True) for hd in fa_ops.BACKWARD_DIMS] + [
    (torch.bfloat16, 160, 160, False), (torch.bfloat16, 256, 256, False),
    (torch.bfloat16, 192, 128, False), (torch.float32, 80, 80, False),
    (torch.float32, 128, 128, False)]


@pytest.mark.parametrize("dtype,hd,hd_v,kernel", ROUTES)
def test_flash_route_is_chosen_from_dtype_and_width(monkeypatch, dtype, hd,
                                                    hd_v, kernel):
    """On the kernels' device the gradient's route follows the input alone:
    bf16 at the backward kernel's equal widths takes ``FlashAttention``
    (one backward launch), anything else the plain vjp (one plain backward);
    a CPU tensor off that device runs the plain version under autograd,
    with no ``Function`` and neither count."""
    assert fa_ops.kernel_backward(dtype, hd, hd_v) is kernel
    rng = np.random.default_rng(hd + hd_v)
    shapes = ((1, 8, 2, hd), (1, 8, 1, hd), (1, 8, 1, hd_v))
    inputs = _leaves_requiring_grad(
        *(rng.standard_normal(s).astype(np.float32) for s in shapes),
        dtype=dtype)
    b0 = _backwards()
    out = fa_ops.flash_attention(*inputs, scale=0.3)
    assert "Flash" not in out.grad_fn.name()
    assert "PlainVJP" not in out.grad_fn.name()
    out.float().sum().backward()
    assert _backwards() == b0
    with _kernels_as_plain(monkeypatch):
        out = fa_ops.flash_attention(*inputs, scale=0.3)
        assert out.grad_fn.name() == ("FlashAttentionBackward" if kernel
                                      else "PlainVJPBackward")
        out.float().sum().backward()
        assert _backwards() == ((b0[0] + 1, b0[1]) if kernel
                                else (b0[0], b0[1] + 1))


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_function_gradients_are_the_plain_vjp(monkeypatch, dtype,
                                                      gated):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, 32)).astype(np.float32)
    w = (0.1 * rng.standard_normal(32)).astype(np.float32)
    z = rng.standard_normal((3, 5, 32)).astype(np.float32)
    inputs = _leaves_requiring_grad(x, w, *([z] if gated else []),
                                    dtype=dtype)

    def kernel(x, w, *g):
        return rn_ops.rmsnorm(x, w, eps=1e-5, gate=g[0] if g else None)

    def plain(x, w, *g):
        return rn_ref.rmsnorm_ref(x, w, eps=1e-5, gate=g[0] if g else None)
    with _kernels_as_plain(monkeypatch):
        _same_grads(kernel, plain, inputs)


def _ssd_inputs(dtype):
    rng = np.random.default_rng(2)
    B, S, H, G, P, N = 2, 40, 4, 2, 8, 8
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)) - 1.0)).astype(
        np.float32)
    A = -np.exp(rng.uniform(0.0, 1.0, H)).astype(np.float32)
    Bm, Cm = (rng.standard_normal((B, S, G, N)).astype(np.float32)
              for _ in range(2))
    return (_leaves_requiring_grad(x, dtype=dtype)
            + _leaves_requiring_grad(dt, A, dtype=torch.float32)
            + _leaves_requiring_grad(Bm, Cm, dtype=dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_function_gradients_are_the_plain_vjp(monkeypatch, dtype):
    """bf16 differentiates ssd_chunked_tc, f32 ssd_chunked; chunk 16 over 40
    steps carries the state across chunks."""
    with _kernels_as_plain(monkeypatch):
        _same_grads(
            lambda *t: ssd_ops.ssd(*t, chunk=16, use_pallas=True)[0],
            lambda *t: ssd_ops.plain(*t, chunk=16)[0], _ssd_inputs(dtype))
    want = ssd_ref.ssd_chunked_tc if dtype == torch.bfloat16 else \
        ssd_ref.ssd_chunked
    inputs = _ssd_inputs(dtype)
    torch.testing.assert_close(ssd_ops.plain(*inputs, chunk=16)[0],
                               want(*inputs, chunk=16)[0], rtol=0, atol=0)


def test_ssd_function_refuses_a_gradient_of_the_final_state(monkeypatch):
    with _kernels_as_plain(monkeypatch):
        y, h = ssd_ops.ssd(*_ssd_inputs(torch.float32), chunk=16,
                           use_pallas=True)
        with pytest.raises(NotImplementedError, match="final state"):
            (y.sum() + h.sum()).backward()


def test_decode_attention_raises_under_grad():
    q = torch.randn(1, 1, 4, 16, requires_grad=True)
    k, v = torch.randn(1, 8, 2, 16), torch.randn(1, 8, 2, 16)
    vl = torch.tensor(5, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="no gradient"):
        da_ops.decode_attention(q, k, v, vl, scale=0.25)
    with torch.no_grad():                       # serving: no grad, no raise
        assert da_ops.decode_attention(q, k, v, vl, scale=0.25).shape == \
            (1, 1, 4, 16)


def _launches():
    return {"flash_attention": fa_ops.launches,
            "fused_rmsnorm": rn_ops.launches, "ssd": ssd_ops.launches,
            "decode_attention": da_ops.launches}


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
@pytest.mark.parametrize("arch", ARCHS)
def test_kernel_path_gradients_and_launches(monkeypatch, arch, remat):
    """A train step's gradients through the kernels' autograd.Functions
    (the launches played by the plain versions) against the plain path, and
    the launches counted: what chip_smoke.py checks on the card."""
    cfg = get_smoke_config(arch, dtype="float32", remat=remat)
    params = M.init_params(cfg, seed=0, device="cpu")
    _, tb = _batch(cfg)
    want, mw = TS.make_grad_fn(dataclasses.replace(cfg, use_pallas=False))(
        params, tb)
    with _kernels_as_plain(monkeypatch):
        before = _launches()
        got, mg = TS.make_grad_fn(cfg)(params, tb)
        after = _launches()
    assert {k: after[k] - before[k] for k in after} == \
        TS.kernel_launches(cfg)
    np.testing.assert_allclose(float(mg["loss"]), float(mw["loss"]),
                               rtol=1e-6)
    for (path, g), w in zip(T.flatten(got), T.leaves(want)):
        assert bool((g != 0).any()), path
        assert _rel(g, w) < 1e-5, path


@pytest.mark.parametrize("remat", ["none", "full"])
def test_kernel_path_bf16_takes_the_flash_backward(monkeypatch, remat):
    """stablelm-3b's smoke config in bf16 (head width 16): each attention
    call's gradient takes the backward kernel's route (its launch played by
    the plain backward), once a layer a step whether or not the layer is
    recomputed, and never the plain vjp (``flash_backwards``); the forward
    launches stay ``kernel_launches``'. Gradients against the plain path
    per leaf under 2e-2 of its largest: both run bf16 activations, and the
    two backwards round dq, dk and dv to bf16 at other points (the worst
    leaf reads 0.0085)."""
    cfg = get_smoke_config("stablelm-3b", dtype="bfloat16", remat=remat)
    params = M.init_params(cfg, seed=0, device="cpu")
    _, tb = _batch(cfg)
    want, mw = TS.make_grad_fn(dataclasses.replace(cfg, use_pallas=False))(
        params, tb)
    with _kernels_as_plain(monkeypatch):
        before, b0 = _launches(), _backwards()
        got, mg = TS.make_grad_fn(cfg)(params, tb)
        after, b1 = _launches(), _backwards()
    assert {k: after[k] - before[k] for k in after} == \
        TS.kernel_launches(cfg)
    assert TS.flash_backwards(cfg) == {"backward_launches": cfg.num_layers,
                                       "plain_backward_calls": 0}
    assert {"backward_launches": b1[0] - b0[0],
            "plain_backward_calls": b1[1] - b0[1]} == TS.flash_backwards(cfg)
    assert float(mg["loss"]) == float(mw["loss"])
    for (path, g), w in zip(T.flatten(got), T.leaves(want)):
        assert bool((g != 0).any()), path
        assert _rel(g.float(), w.float()) < 2e-2, path
