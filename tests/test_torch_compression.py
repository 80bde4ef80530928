"""The port's data-parallel gradient mean (``repro_torch.distributed.
compression``) against the JAX package's ``repro.distributed.compression``.

Tolerances, each with its reason:
  * ``quantize_int8`` and the one-rank int8 mean: equal bit for bit in f32
    (the same operations on the same f32 values);
  * the int8 mean on 2 and 4 gloo ranks against JAX's ``int8_psum_mean`` on
    as many forced host devices: equal bit for bit (the f32 sums of at most
    4 int8 values are exact in any order, and both sides scale them in the
    same order); and within |g|_inf/127 of the exact f32 mean, the scheme's
    bound (half a step of each phase);
  * the fp32 mean: 1e-6 relative to the largest value (f32 sums of 4 terms
    in another order);
  * ``make_local_grad_fn`` (stablelm-3b smoke, f32) against JAX's on 1 and
    2 devices: uncompressed, per leaf 1e-5 relative to the leaf's largest
    value (the same f32 arithmetic, sums in another order, as
    tests/test_torch_train.py's gradients hold at 1e-4); compressed, per
    leaf within 2/127 of the leaf's largest value (where the two sides' f32
    gradients, ~1e-6 apart, fall on either side of a rounding boundary,
    their int8 values are one step, 1/127 of the largest, apart).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.distributed import compression as JC
from repro.distributed.train_step import make_loss_fn as jmake_loss_fn
from repro.models import model as jM
from repro_torch.distributed import compression as C
from torch_ranks import local_grads_on_ranks, means_on_ranks, run_jax, \
    run_ranks

SIZE = 1001          # divides by neither 2 nor 4: the padded path


def _shards(n, seed=3):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((n, SIZE)).astype(np.float32)
    g[:, :7] *= 40.0                    # a few large entries set the scale
    return g


def test_quantize_int8_equals_jax_bit_for_bit():
    rng = np.random.default_rng(0)
    x = rng.standard_normal(4096).astype(np.float32) * 3
    x[:6] = [0.5, -0.5, 1.5, 2.5, 127.4, -400.0]    # ties and clipping
    for scale in (np.float32(1.0), np.float32(np.abs(x).max() / 127.0),
                  np.float32(0.013)):
        want = np.asarray(JC.quantize_int8(jnp.asarray(x), jnp.asarray(scale)))
        got = C.quantize_int8(torch.from_numpy(x), torch.tensor(scale))
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), want)


def test_int8_mean_one_rank_equals_jax_bit_for_bit():
    """The n == 1 branch: one quantization round trip, no collective."""
    x = _shards(1)[0]
    want = np.asarray(JC.int8_psum_mean(jnp.asarray(x), ("data",), 1))
    got = C.int8_psum_mean(torch.from_numpy(x), None, 1)
    np.testing.assert_array_equal(got.numpy(), want)
    assert float(np.abs(want - x).max()) <= np.abs(x).max() / 127 / 2 + 1e-7


_JAX_INT8_MEAN = """
from functools import partial
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.distributed.compression import int8_psum_mean, shard_map
g = np.load({path!r})
n = g.shape[0]
assert len(jax.devices()) == n
mesh = jax.make_mesh((n,), ("data",))

@partial(shard_map, mesh=mesh, in_specs=P("data"), out_specs=P("data"),
         check_vma=False)
def f(v):
    return int8_psum_mean(v[0], ("data",), n)[None]

np.save({out!r}, np.asarray(f(jnp.asarray(g))))
"""


@pytest.mark.parametrize("n", [2, 4])
def test_int8_and_fp32_means_on_gloo_ranks_against_jax(n, tmp_path):
    g = _shards(n)
    path, out = str(tmp_path / "g.npy"), str(tmp_path / "out.npy")
    np.save(path, g)
    run_jax(_JAX_INT8_MEAN.format(path=path, out=out), n)
    want = np.load(out)
    assert want.shape == (n, SIZE)
    results = run_ranks(means_on_ranks, n, g)
    exact = g.astype(np.float64).mean(0)
    for rank, (int8_mean, f32_mean) in enumerate(results):
        np.testing.assert_array_equal(int8_mean, want[rank])
        assert np.abs(int8_mean - exact).max() <= np.abs(g).max() / 127
        assert np.abs(f32_mean - exact).max() <= 1e-6 * np.abs(exact).max()


# ------------------------------------------------------- make_local_grad_fn
ARCH = "stablelm-3b"


def _batch(cfg, B=4, S=16):
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    return {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1),
            "positions": pos}


_JAX_LOCAL_GRADS = """
import jax, numpy as np
from repro.configs import get_smoke_config
from repro.distributed.compression import make_local_grad_fn
from repro.distributed.train_step import make_loss_fn
from repro.models import model as M
cfg = get_smoke_config({arch!r}, dtype="float32")
params = M.init_params(jax.random.PRNGKey(0), cfg)
batch = dict(np.load({path!r}))
mesh = jax.make_mesh((2,), ("data",))
out = {{}}
for compress in (False, True):
    g, m = jax.jit(make_local_grad_fn(make_loss_fn(cfg), mesh, ("data",),
                                      {{}}, compress=compress))(params, batch)
    for path, leaf in jax.tree_util.tree_flatten_with_path(g)[0]:
        key = "/".join(str(k.key) for k in path)
        out[f"{{int(compress)}}|{{key}}"] = np.asarray(leaf)
    out[f"{{int(compress)}}|loss"] = np.asarray(m["loss"])
np.savez({out!r}, **out)
"""


def _jax_local_grads_one_device(jparams, nb, compress):
    jcfg = jget_smoke(ARCH, dtype="float32")
    mesh = jax.make_mesh((1,), ("data",))
    g, m = jax.jit(JC.make_local_grad_fn(jmake_loss_fn(jcfg), mesh,
                                         ("data",), {}, compress=compress))(
        jparams, nb)
    flat = jax.tree_util.tree_flatten_with_path(g)[0]
    return ({"/".join(str(k.key) for k in path): np.asarray(leaf)
             for path, leaf in flat}, float(m["loss"]))


def _hold(got, want, compress):
    assert got.keys() == want.keys()
    for path, w in want.items():
        top = float(np.abs(w).max())
        err = float(np.abs(got[path] - w).max())
        assert err <= (2 / 127 if compress else 1e-5) * top + 1e-12, \
            (path, err, top)


def test_local_grad_fn_one_rank_against_jax():
    jcfg = jget_smoke(ARCH, dtype="float32")
    jparams = jax.tree.map(np.asarray,
                           jM.init_params(jax.random.PRNGKey(0), jcfg))
    nb = _batch(jcfg)
    ours = local_grads_on_ranks(0, 1, ARCH, jparams, nb)
    for compress in (False, True):
        want, wloss = _jax_local_grads_one_device(jparams, nb, compress)
        got, metrics = ours[compress]
        np.testing.assert_allclose(metrics["loss"], wloss, rtol=1e-5)
        _hold(got, want, compress)
    # the n == 1 branch: each leaf quantized once, within half a step
    for path, g in ours[True][0].items():
        plain = ours[False][0][path]
        assert np.abs(g - plain).max() <= np.abs(plain).max() / 127 / 2 + 1e-7


def test_local_grad_fn_two_ranks_against_jax(tmp_path):
    """Each rank takes its 2 rows of the 4; the gradients and the loss are
    the ranks' means, uncompressed and int8, the same on both ranks."""
    jcfg = jget_smoke(ARCH, dtype="float32")
    jparams = jax.tree.map(np.asarray,
                           jM.init_params(jax.random.PRNGKey(0), jcfg))
    nb = _batch(jcfg)
    path, out = str(tmp_path / "batch.npz"), str(tmp_path / "grads.npz")
    np.savez(path, **nb)
    run_jax(_JAX_LOCAL_GRADS.format(arch=ARCH, path=path, out=out), 2)
    ref = dict(np.load(out))
    results = run_ranks(local_grads_on_ranks, 2, ARCH, jparams, nb)
    for compress in (False, True):
        tag = f"{int(compress)}|"
        want = {k[len(tag):]: v for k, v in ref.items()
                if k.startswith(tag) and k != tag + "loss"}
        for ours in results:
            got, metrics = ours[compress]
            np.testing.assert_allclose(metrics["loss"], ref[tag + "loss"],
                                       rtol=1e-5)
            _hold(got, want, compress)
        for key in want:
            np.testing.assert_array_equal(results[0][compress][0][key],
                                          results[1][compress][0][key])
