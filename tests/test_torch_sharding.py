"""The port's sharding policy (``repro_torch.distributed.sharding``) and
meshes (``repro_torch.launch.mesh``) against the JAX package's: for every
arch on the production meshes (16x16 and 2x16x16, abstract: no ranks), the
param, ZeRO-1, batch and decode-cache specs equal JAX's leaf for leaf and
divide their dims; twins of tests/test_distributed.py's rule tests; and, on
two gloo ranks, each rank's block under a spec equal to DTensor's under the
spec's placements. Specs are compared as tuples (``tuple(PartitionSpec)``)."""
import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh, PartitionSpec as P

from repro.configs import SHAPES, cell_is_runnable
from repro.configs import get_config as jget_config
from repro.distributed import sharding as JSH
from repro.launch import specs as JSP
from repro_torch import tree as T
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.distributed import sharding as SH
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import Mesh, abstract_mesh, make_host_mesh, \
    make_mesh
from repro_torch.models.model import init_cache
from torch_ranks import blocks_on_ranks, run_ranks

MESHES = {"single_pod": dict(data=16, model=16),
          "multi_pod": dict(pod=2, data=16, model=16)}


def _jax_mesh(axes):
    return AbstractMesh(tuple(axes.values()), tuple(axes.keys()))


def _jax_specs(tree):
    """{path: tuple(spec)} of a JAX spec tree, paths joined as
    ``repro_torch.tree.flatten`` joins them."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {"/".join(str(k.key) if isinstance(k, jax.tree_util.DictKey)
                     else str(k) for k in path): tuple(spec)
            for path, spec in flat}


def _check_divisible(tree, specs, mesh, where):
    for path, leaf in T.flatten(tree):
        for dim, entry in zip(leaf.shape, specs[path]):
            axes = SH._axes_of(entry)
            assert dim % mesh.axes_size(axes) == 0, \
                f"{where} {path}: dim {dim} not divisible by {axes}"


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_opt_specs_equal_jax_and_divide(arch, mesh_name):
    axes = MESHES[mesh_name]
    mesh, jmesh = abstract_mesh(**axes), _jax_mesh(axes)
    cfg, jcfg = get_config(arch), jget_config(arch)
    params = SP.params_struct(cfg)
    assert all(t.device.type == "meta" for t in T.leaves(params))
    jparams = JSP.params_struct(jcfg)
    spec = SH.params_pspec(cfg, mesh, params)
    assert spec == _jax_specs(JSH.params_pspec(jcfg, jmesh, jparams))
    for (path, t), j in zip(T.flatten(params), jax.tree.leaves(jparams)):
        assert (tuple(t.shape), str(t.dtype)[6:]) == (j.shape, str(j.dtype))
    _check_divisible(params, spec, mesh, f"{arch} params")
    opt = SP.opt_state_struct(params)
    ospec = SH.opt_state_pspec(cfg, mesh, opt)
    assert ospec == _jax_specs(JSH.opt_state_pspec(
        jcfg, jmesh, JSP.opt_state_struct(jparams)))
    _check_divisible(opt, ospec, mesh, f"{arch} opt")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_and_batch_specs_equal_jax(arch):
    """The decode cache's specs at the runnable decode shapes (batch sharded,
    or the sequence when the batch cannot be: long_500k's batch 1) and the
    batch specs at batches that do and do not divide."""
    axes = MESHES["single_pod"]
    mesh, jmesh = abstract_mesh(**axes), _jax_mesh(axes)
    cfg, jcfg = get_config(arch), jget_config(arch)
    ran = 0
    for shape_name in ("decode_32k", "long_500k"):
        shape = SHAPES[shape_name]
        if not cell_is_runnable(jcfg, shape)[0]:
            continue
        ran += 1
        spec = SH.cache_pspec(cfg, mesh, shape.global_batch)
        assert spec == _jax_specs(JSH.cache_pspec(jcfg, jmesh,
                                                  shape.global_batch))
        cache = init_cache(cfg, shape.global_batch, shape.seq_len,
                           device="meta")
        _check_divisible(cache, spec, mesh, f"{arch} {shape_name} cache")
    assert ran
    for B in (1, 2, 16, 32, 256):
        assert SH.batch_axes(mesh, cfg, B) == tuple(
            JSH.batch_axes(jmesh, jcfg, B))
        assert SH.batch_pspec(cfg, mesh, B) == {
            k: tuple(v) for k, v in JSH.batch_pspec(jcfg, jmesh, B).items()}


def test_batch_axes_divisibility_fallback():
    cfg = get_config("mamba2-130m")                   # dp_all policy
    mesh = abstract_mesh(**MESHES["single_pod"])
    assert SH.batch_axes(mesh, cfg, 256) == ("data", "model")
    assert SH.batch_axes(mesh, cfg, 32) == ("data",)  # 32 % 256 != 0
    assert SH.batch_axes(mesh, cfg, 1) == ()
    dense = get_config("gemma-7b")
    assert SH.batch_axes(abstract_mesh(**MESHES["multi_pod"]), dense,
                         256) == ("pod", "data")
    assert SH.batch_pspec(cfg, mesh, 1)["tokens"] == (None, None)
    assert SH.batch_pspec(cfg, mesh, 256)["tokens"] == (("data", "model"),
                                                        None)


def test_replicated_kv_rule():
    mesh = abstract_mesh(**MESHES["single_pod"])
    # chatglm kv=2 < 16 -> replicated; zamba kv=32 -> sharded
    chat = get_config("chatglm3-6b")
    assert SH.param_spec(chat, mesh, "layers/attn/wk/w", 3) == (None,) * 3
    zam = get_config("zamba2-7b")
    assert SH.param_spec(zam, mesh, "shared_attn/attn/wk/w", 2)[-1] == "model"
    # musicgen kv=24: not divisible by 16 -> replicated
    mg = get_config("musicgen-medium")
    assert SH.param_spec(mg, mesh, "layers/attn/wk/w", 3)[-1] is None


def test_zero1_shards_over_data():
    mesh = abstract_mesh(**MESHES["single_pod"])
    assert SH.zero1_spec((None, "model"), (4096, 1024), mesh) == \
        ("data", "model")
    assert SH.zero1_spec((None,), (27,), mesh) == (None,)


def test_expert_weights_expert_parallel():
    mesh = abstract_mesh(**MESHES["single_pod"])
    cfg = get_config("deepseek-v2-lite-16b")
    assert SH.param_spec(cfg, mesh, "layers/moe/w_in", 4) == \
        (None, "model", None, None)
    # the dense MLP of a MoE arch does not take the expert rule
    assert SH.param_spec(cfg, mesh, "dense_layers/mlp/w_gate/w", 3) == \
        (None, None, "model")


def test_meshes_without_ranks():
    """One process with no process group: make_host_mesh is (1, 1), every
    coordinate 0, no group; a larger mesh raises; an abstract mesh has
    sizes and no ranks."""
    mesh = make_host_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "model": 1}
    assert mesh.coordinate() == {"data": 0, "model": 0}
    assert mesh.group(("data", "model")) is None
    assert SH.local_slices(("data", None), (4, 3), mesh) == \
        (slice(0, 4), slice(0, 3))
    with pytest.raises(RuntimeError, match="needs 2 ranks"):
        make_mesh((2, 1), ("data", "model"), device="cpu")
    ab = abstract_mesh(data=4, model=2)
    assert (ab.axis_names, ab.size) == (("data", "model"), 8)
    with pytest.raises(RuntimeError, match="no ranks"):
        ab.coordinate()
    with pytest.raises(RuntimeError, match="no process groups"):
        ab.group(("data",))
    assert isinstance(ab, Mesh)


def test_local_blocks_equal_dtensor_on_gloo_ranks():
    specs = [("data", None, None), (None, "model", None),
             (("data", "model"), None, None), ("data", "model", None),
             (None, None, None)]
    results = run_ranks(blocks_on_ranks, 4, specs)
    for rank, (blocks, world_group) in enumerate(results):
        assert world_group
        for spec, (coord, mine, dt) in zip(specs, blocks):
            assert coord == {"data": rank // 2, "model": rank % 2}
            np.testing.assert_array_equal(mine, dt, err_msg=str(spec))
    # the flattened (data, model) entry: rank r holds rows [2r, 2r + 2)
    for rank, (blocks, _) in enumerate(results):
        np.testing.assert_array_equal(
            blocks[2][1], np.arange(192, dtype=np.float32).reshape(
                8, 6, 4)[2 * rank:2 * rank + 2])
