"""The port's dry-run (``repro_torch.launch.dryrun``, ``launch.specs``,
``launch.mesh.make_production_mesh``, ``launch.opprof``) on the CPU, held
against the JAX package's where it has a counterpart.

  * the input specs of all ten full configs x four shapes (the decode cache
    included) equal JAX's ``jax.eval_shape`` structs, shape and dtype, leaf
    for leaf; the production meshes equal JAX's (its mesh needs 512 forced
    host devices, so it is read in a subprocess);
  * per family, the full-depth fake count equals the affine fit from the two
    probe depths (exact: each layer adds the same ops);
  * the fake step's counts equal the same step's on real CPU tensors (what
    chip_smoke.py phase 9 holds on the card);
  * ``run_cell`` on one cell per family, at smoke widths and the real
    shapes, returns ``ok`` with JAX's record keys; the CLI exits 0.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import SHAPES as JSHAPES
from repro.launch import specs as JSP
from repro_torch import tree as T
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed import sharding as SH
from repro_torch.launch import costmodel as CM
from repro_torch.launch import dryrun as D
from repro_torch.launch import opprof
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import abstract_mesh, make_production_mesh

ROOT = Path(__file__).resolve().parents[1]
ONE_CARD = abstract_mesh(data=1, model=1)
FAMILIES = {"dense": "stablelm-3b", "moe": "deepseek-v2-lite-16b",
            "ssm": "mamba2-130m", "hybrid": "zamba2-7b"}
# JAX's record keys (repro/launch/dryrun.py::run_cell) and roofline fields
JAX_RECORD_KEYS = {"arch", "shape", "mesh", "status", "n_devices",
                   "compile_s", "probe_compile_s", "memory", "cost",
                   "collectives", "roofline"}


def smoke(arch, **extra):
    """Overrides that turn the full config into the smoke one."""
    full, sm = get_config(arch), get_smoke_config(arch)
    over = {f.name: getattr(sm, f.name) for f in dataclasses.fields(sm)
            if f.name != "name" and getattr(sm, f.name) != getattr(full,
                                                                   f.name)}
    return {**over, **extra}


def cell(arch, kind, overrides, B=2, S=16):
    c, _ = D.lower_cell(arch, None, False, overrides,
                        shape=ShapeConfig(f"{kind}_{B}x{S}", S, B, kind),
                        mesh=ONE_CARD)
    return c


def _jax_leaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(p, "key", getattr(p, "name", p)))
                     for p in path): (tuple(leaf.shape), str(leaf.dtype))
            for path, leaf in flat}


def _port_leaves(tree):
    return {path: (tuple(t.shape), str(t.dtype).split(".")[-1])
            for path, t in T.flatten(tree)}


@functools.lru_cache(maxsize=None)
def _params(arch):
    return (_jax_leaves(JSP.params_struct(jget_config(arch))),
            _port_leaves(SP.params_struct(get_config(arch))))


@pytest.mark.parametrize("arch,shape", [(a, s) for a in ARCH_IDS
                                        for s in SHAPES])
def test_input_specs_equal_jax(arch, shape):
    cfg, jcfg = get_config(arch), jget_config(arch)
    sh, jsh = SHAPES[shape], JSHAPES[shape]
    want_params, got_params = _params(arch)
    assert got_params == want_params
    if sh.kind == "train":
        assert _port_leaves(SP.train_input_specs(cfg, sh)) == \
            _jax_leaves(JSP.train_input_specs(jcfg, jsh))
        # the optimizer state over the same tree
        opt = SP.opt_state_struct(SP.params_struct(cfg))
        assert {p: s for p, s in _port_leaves(opt).items()
                if p.startswith(".mu/")} == {
            f".mu/{p}": (s[0], "float32") for p, s in want_params.items()}
    elif sh.kind == "prefill":
        assert _port_leaves(SP.prefill_input_specs(cfg, sh)) == \
            _jax_leaves(JSP.prefill_input_specs(jcfg, jsh))
    else:
        batch, cache = SP.decode_input_specs(cfg, sh)
        jbatch, jcache = JSP.decode_input_specs(jcfg, jsh)
        assert _port_leaves(batch) == _jax_leaves(jbatch)
        assert _port_leaves(cache) == _jax_leaves(jcache)
    assert all(t.device.type == "meta"
               for t in T.leaves(SP.input_specs(cfg, sh)))


def test_production_meshes_equal_jax():
    code = ("import os\n"
            "os.environ['XLA_FLAGS'] = "
            "'--xla_force_host_platform_device_count=512'\n"
            "import json\n"
            "from repro.launch.mesh import make_production_mesh as m\n"
            "print(json.dumps([list(m(multi_pod=p).shape.items()) "
            "for p in (False, True)]))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    want = json.loads(res.stdout.strip().splitlines()[-1])
    for multi_pod, w in zip((False, True), want):
        mesh = make_production_mesh(multi_pod=multi_pod)
        assert [list(kv) for kv in mesh.shape.items()] == w
        assert mesh.size == (512 if multi_pod else 256)
        assert mesh.device_mesh is None           # no process group


def _counts(prof):
    return {"flops": prof.flops, "matmul_flops": prof.matmul_flops,
            "bytes accessed": prof.bytes, "n_ops": prof.n_ops}


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("family,layers", [("dense", 7), ("moe", 6),
                                           ("ssm", 7), ("hybrid", 6)])
def test_full_depth_count_is_the_affine_fit(family, layers, kind):
    """The port counts the full depth directly; two probe depths predict it
    exactly (the hybrid at whole groups: a tail is counted as part of a
    group, the JAX package's approximation)."""
    arch = FAMILIES[family]
    over = smoke(arch, num_layers=layers)
    cfg = get_config(arch, **over)
    ov_a, ov_b, n_a, n_b, n_t = CM.probe_depths(cfg)
    a, b = (_counts(cell(arch, kind, {**over, **ov}).run())
            for ov in (ov_a, ov_b))
    full = _counts(cell(arch, kind, over).run())
    fit = CM.extrapolate(a, b, n_a, n_b, n_t)
    assert {k: pytest.approx(v, rel=1e-12) for k, v in fit.items()} == full
    assert full["matmul_flops"] > a["matmul_flops"]


@pytest.mark.parametrize("arch,kind", [
    ("stablelm-3b", "train"), ("mamba2-130m", "train"),
    ("chatglm3-6b", "prefill"), ("chatglm3-6b", "decode"),
    ("zamba2-7b", "train"), ("deepseek-v2-lite-16b", "decode"),
    ("phi3.5-moe-42b-a6.6b", "prefill"), ("qwen2-vl-7b", "decode")])
def test_fake_step_counts_equal_the_real_step(arch, kind):
    """What phase 9 holds on the card, here on CPU tensors: the same
    matmul FLOPs, all FLOPs, argument bytes and peak above them."""
    c = cell(arch, kind, smoke(arch), B=2, S=32)
    fake, real = c.run(), c.run(fake=False)
    for attr in ("matmul_flops", "flops", "argument_bytes", "peak_bytes",
                 "output_bytes"):
        assert getattr(fake, attr) == getattr(real, attr), attr
    assert fake.matmul_flops > 0 and fake.collectives == []
    # one card: every argument unsharded, so the specs' bytes are the
    # storages' bytes
    assert D.argument_bytes(c.cfg, c.shape, ONE_CARD) == fake.argument_bytes


def test_op_profile_counts_and_storage_lifetimes():
    x = torch.ones(256, 256)
    prof = opprof.OpProfile()
    assert prof.hold(x, [x]) == x.numel() * 4
    with prof:
        y = x @ x
        z = y * 2
        del y
        w = z + 1
        ref = torch.ones(1).untyped_storage()
        del z, w
    n = 256 * 256 * 4
    assert prof.peak_bytes == 2 * n + 4
    assert prof.live_bytes == 4                  # only ``ref``'s storage
    del ref
    assert prof.live_bytes == 0
    assert prof.matmul_flops == prof.flops == 2 * 256 ** 3
    assert opprof.top_dots(prof) == [{"out_shape": (256, 256), "contract_k": 256,
                                "flops": 2 * 256 ** 3, "count": 1,
                                "example": "mm"}]
    assert opprof.collective_report(prof) == []
    assert prof.collective_bytes() == {"count": 0, "total": 0}
    assert prof.bytes >= 3 * n + 2 * n + 2 * n


@pytest.mark.parametrize("family,shape,multi_pod", [
    ("dense", "train_4k", False), ("moe", "prefill_32k", True),
    ("ssm", "train_4k", True), ("hybrid", "long_500k", False)])
def test_run_cell_per_family(family, shape, multi_pod):
    arch = FAMILIES[family]
    # the tensor-parallel steps split whole heads (and experts) over the 16
    # model ranks
    heads = {"dense": {"num_heads": 16},
             "moe": {"num_heads": 16, "num_kv_heads": 16,
                     "num_experts": 16},
             "hybrid": {"d_model": 128, "num_heads": 16,
                        "num_kv_heads": 16}}.get(family, {})
    rec = D.run_cell(arch, shape, multi_pod, smoke(arch, **heads),
                     verbose=False)
    assert rec["status"] == "ok", rec.get("traceback")
    assert JAX_RECORD_KEYS <= set(rec)
    assert rec["n_devices"] == (512 if multi_pod else 256)
    assert set(rec["memory"]) == {"argument_size_in_bytes",
                                  "output_size_in_bytes",
                                  "temp_size_in_bytes"}
    assert rec["cost"]["flops"] > 0 and rec["cost"]["bytes accessed"] > 0
    terms = rec["roofline"]
    assert terms["step_time_s"] == max(terms["compute_s"], terms["memory_s"],
                                       terms["collective_s"])
    coll = rec["collectives"]
    if family == "ssm":
        # dp_all as the port runs it: the vocabulary split over the 16 model
        # ranks, each holding one row of the batch. The group's tokens and
        # labels gathered (int32, int64), the embeddings summed to their
        # rows (an all-reduce) and the hidden rows gathered, each again in
        # the backward (bf16); the loss's three f32 all-reduces; the
        # gradient mean in f32, the vocabulary's block over data, every
        # other leaf over (data, model); the 3 metrics; the norm's split
        # part; the ZeRO-1 all-gathers over data of each leaf a free dim of
        # which divides (bf16, the rank's block)
        cfg = get_config(arch, **smoke(arch))
        mesh = make_production_mesh(multi_pod=True)
        params = SP.params_struct(cfg)
        leaves = T.flatten(params)
        n = sum(t.numel() for _, t in leaves)
        m, S, d = 16, SHAPES[shape].seq_len, cfg.d_model
        vocab = cfg.padded_vocab * d
        rows = m * S                        # the model group's tokens
        specs = SH.params_pspec(cfg, mesh, params)
        zero1 = [t.numel() // mesh.axes_size([a for e in specs[p]
                                              for a in SH._axes_of(e)]) * 2
                 for p, t in leaves
                 if "data" in SH.zero1_spec(specs[p], tuple(t.shape), mesh)]
        reduce = (2 * rows * d * 2 + 3 * rows * 4
                  + 4 * (n - vocab + vocab // m) + 12 + 4)
        gather = rows * 4 + rows * 8 + 2 * rows * d * 2 + sum(zero1)
        assert coll == {"all-reduce": reduce, "all-gather": gather,
                        "count": 5 + len(leaves) + 2 + 4 + len(zero1),
                        "total": reduce + gather}
        assert rec["rows_per_rank"] == 1
    elif SHAPES[shape].kind == "train":
        # the rank's own tensor-parallel program: its all-reduces (the
        # layers', the loss's, the gradient mean over data) and the ZeRO-1
        # all-gathers over data
        assert coll["all-reduce"] > 0 and coll["all-gather"] > 0
        assert coll["total"] == coll["all-reduce"] + coll["all-gather"]
    elif family == "moe":
        # the rank's tensor-parallel prefill on its row of the 32 (over
        # pod x data, 32 ranks): the vocab-parallel embedding's all-reduce
        # and one after each block's attention and its MLP or experts (the
        # MoE layer's shared experts in the same one), in bf16 (d, S rows)
        cfg = get_config(arch, **smoke(arch, **heads))
        rows = SHAPES[shape].global_batch // 32 * SHAPES[shape].seq_len
        n = 1 + 2 * cfg.num_layers
        assert rec["rows_per_rank"] == 1 and rec["program"] == "per rank"
        assert coll == {"all-reduce": n * rows * cfg.d_model * 2,
                        "count": n, "total": n * rows * cfg.d_model * 2}
    else:
        # long_500k: the sequence-parallel decode of the batch of 1, a
        # rank's block of the cache 524,288 / 16 positions long; beside the
        # same step on 16 model ranks alone (the whole cache a rank), the
        # data group's two all-reduces a shared-block call: the max of the
        # partials' log-sum-exp (B x heads a rank, f32) and the sum of
        # (w * o, w) (B x heads x head_dim + B x heads, f32)
        cfg = get_config(arch, **smoke(arch, **heads))
        assert rec["rows_per_rank"] == 1 and rec["program"] == "per rank"
        assert rec["seq_parallel"] == {"data_ranks": 16,
                                       "block_positions": 524288 // 16}
        alone, _ = D.lower_cell(arch, shape, False, smoke(arch, **heads),
                                mesh=abstract_mesh(data=1, model=16))
        base = alone.run().collective_bytes()
        calls = cfg.num_layers // cfg.attn_every
        h = cfg.num_heads // 16
        assert coll["all-reduce"] - base["all-reduce"] == calls * 4 * (
            h + h * cfg.head_dim + h)
        assert coll["count"] - base["count"] == 2 * calls
    assert "split" not in rec and "tensor_parallel" not in coll


def test_tp16_cell_matmul_flops_on_the_fake_group_equal_real_ranks():
    """A tp16 train cell (stablelm-3b's smoke config, 2 x 16 tokens) on a
    (2, 2) mesh: the per-rank program's matmul FLOPs and collective bytes
    on rank 0 of the fake process group equal ``opprof``'s count of the
    same program on 4 real gloo ranks (every rank's)."""
    from torch_ranks import dryrun_cell_on_ranks, run_ranks
    over = smoke("stablelm-3b")
    c, _ = D.lower_cell("stablelm-3b", None, False, over,
                        shape=ShapeConfig("train_2x16", 16, 2, "train"),
                        mesh=abstract_mesh(data=2, model=2))
    fake = c.run()
    whole = cell("stablelm-3b", "train", over).run()
    assert fake.matmul_flops < whole.matmul_flops      # the rank's share
    real = run_ranks(dryrun_cell_on_ranks, 4, "stablelm-3b", over, (2, 2),
                     2, 16, timeout=180)
    for flops, coll in real:
        assert flops == fake.matmul_flops
        assert coll == fake.collective_bytes()


def test_run_cell_skips_what_the_port_cannot_split():
    """Cells whose tensor-parallel program the port lacks are skipped with
    the reason: SSD heads that do not divide. The hybrid family's tp16
    train cell runs (its heads, 16 SSD and 16 attention heads at this
    width, split over the 16 model ranks) with the split gated norm's
    collectives. 28 query heads over 16 model ranks run too (the train,
    prefill and decode cells), in 32 padded slots, the record saying so."""
    over = smoke("zamba2-7b", d_model=128, num_heads=16, num_kv_heads=16)
    rec = D.run_cell("zamba2-7b", "train_4k", False, over, verbose=False)
    assert rec["status"] == "ok", rec.get("traceback")
    coll = rec["collectives"]
    assert coll["all-reduce"] > 0 and coll["all-gather"] > 0
    whole = D.run_cell("zamba2-7b", "train_4k", False, smoke("zamba2-7b"),
                       verbose=False)
    assert whole["status"] == "skipped" and "8 SSD heads" in whole["why"]
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        rec = D.run_cell("qwen2-vl-7b", shape, False,
                         smoke("qwen2-vl-7b", num_heads=28), verbose=False)
        assert rec["status"] == "ok", rec.get("traceback")
        assert rec["program"] == "per rank"
        heads = rec["heads"]
        assert (heads["heads"], heads["slots"], heads["slots_per_rank"],
                heads["padding_only_ranks"]) == (28, 32, 2, 0)
        assert heads["padding_matmul_flops"] > 0


@functools.lru_cache(maxsize=None)
def _new_cells_on_real_ranks(shape):
    """The cells of ``NEW_CELLS`` on ``shape`` run by 4 real gloo ranks,
    one spawn: [(matmul FLOPs, collective bytes) per rank] by cell."""
    from torch_ranks import dryrun_cells_on_ranks, run_ranks
    cells = [(arch, smoke(arch, **extra), kind)
             for arch, extra, kind, s in NEW_CELLS if s == shape]
    B = 1 if shape == (2, 2) else 4
    out = run_ranks(dryrun_cells_on_ranks, 4, cells, shape, B, 16,
                    timeout=240)
    return [[r[i] for r in out] for i in range(len(cells))]


# the cells this slice adds, at smoke size: query heads padded to slots
# (6 heads over 4 model ranks, train and decode) and the sequence-parallel
# decode of one request (the hybrid's cache over 2 data ranks)
NEW_CELLS = [
    ("qwen2-vl-7b", {"num_heads": 6, "num_kv_heads": 2}, "train", (1, 4)),
    ("musicgen-medium", {"num_heads": 6, "num_kv_heads": 6}, "decode",
     (1, 4)),
    ("zamba2-7b", {}, "decode", (2, 2))]


@pytest.mark.parametrize("i", range(len(NEW_CELLS)),
                         ids=[f"{a}-{k}-{s[0]}x{s[1]}"
                              for a, _, k, s in NEW_CELLS])
def test_new_cells_on_the_fake_group_equal_real_ranks(i):
    """The padded heads' cells (4 requests of 16 tokens on (1, 4)) and the
    sequence-parallel decode (1 request, a cache of 16 positions over 2
    data ranks of a (2, 2) mesh): the per-rank program's matmul FLOPs and
    collective bytes on rank 0 of the fake process group equal
    ``opprof``'s count of the same program on rank 0 of 4 real gloo ranks,
    and the collective bytes on every rank. Where the heads are padded the
    ranks' attention FLOPs differ with their real heads, rank 0's the
    most."""
    arch, extra, kind, shape = NEW_CELLS[i]
    over = smoke(arch, **extra)
    B = 1 if shape == (2, 2) else 4
    c, _ = D.lower_cell(arch, None, False, over,
                        shape=ShapeConfig(f"{kind}_{B}x16", 16, B, kind),
                        mesh=abstract_mesh(data=shape[0], model=shape[1]))
    assert c.per_rank
    fake = c.run()
    assert fake.collective_bytes()["all-reduce"] > 0
    j = [k for k, cell in enumerate(c for c in NEW_CELLS if c[3] == shape)
         if cell == NEW_CELLS[i]][0]
    ranks = _new_cells_on_real_ranks(shape)[j]
    assert ranks[0][0] == fake.matmul_flops
    for flops, real in ranks:
        assert flops <= fake.matmul_flops
        assert real == fake.collective_bytes()
    assert (len({flops for flops, _ in ranks}) > 1) == (shape == (1, 4))


@pytest.mark.parametrize("arch", ["zamba2-7b", "mamba2-130m"])
def test_split_cells_on_the_fake_group_equal_real_ranks(arch):
    """The hybrid family's tensor-parallel train cell and dp_all's split
    vocabulary (smoke configs, 4 x 16 tokens, a (2, 2) mesh): the per-rank
    program's matmul FLOPs and collective bytes on rank 0 of the fake
    process group equal ``opprof``'s count of the same program on 4 real
    gloo ranks (every rank's)."""
    from torch_ranks import dryrun_cell_on_ranks, run_ranks
    over = smoke(arch)
    c, _ = D.lower_cell(arch, None, False, over,
                        shape=ShapeConfig("train_4x16", 16, 4, "train"),
                        mesh=abstract_mesh(data=2, model=2))
    fake = c.run()
    coll = fake.collective_bytes()
    assert coll["all-reduce"] > 0 and coll["all-gather"] > 0
    real = run_ranks(dryrun_cell_on_ranks, 4, arch, over, (2, 2), 4, 16,
                     timeout=180)
    for flops, coll in real:
        assert flops == fake.matmul_flops
        assert coll == fake.collective_bytes()


SERVING = [(arch, kind) for arch in ("stablelm-3b", "phi3.5-moe-42b-a6.6b",
                                      "zamba2-7b")
           for kind in ("prefill", "decode")]


@functools.lru_cache(maxsize=None)
def _serving_on_real_ranks():
    """The serving cells of ``SERVING`` run by 4 real gloo ranks on a
    (2, 2) mesh, one spawn: [(matmul FLOPs, collective bytes) per rank] by
    cell."""
    from torch_ranks import dryrun_cells_on_ranks, run_ranks
    cells = [(arch, smoke(arch), kind) for arch, kind in SERVING]
    out = run_ranks(dryrun_cells_on_ranks, 4, cells, (2, 2), 4, 16,
                    timeout=240)
    return {key: [r[i] for r in out] for i, key in enumerate(SERVING)}


@pytest.mark.parametrize("arch,kind", SERVING)
def test_tp16_serving_cells_on_the_fake_group_equal_real_ranks(arch, kind):
    """A tp16 prefill and decode cell (dense, MoE and the hybrid smoke
    configs, 4 requests of 16 tokens, the decode cache 16 long; their 4
    heads, 4 experts and 8 SSD heads divide over 2 model ranks) on a
    (2, 2) mesh: the per-rank program's matmul FLOPs and collective bytes
    on rank 0 of the fake process group equal ``opprof``'s count of the
    same program on 4 real gloo ranks (every rank's), and they are a
    rank's share, with the tensor-parallel all-reduces."""
    over = smoke(arch)
    c, _ = D.lower_cell(arch, None, False, over,
                        shape=ShapeConfig(f"{kind}_4x16", 16, 4, kind),
                        mesh=abstract_mesh(data=2, model=2))
    assert c.per_rank
    fake = c.run()
    coll = fake.collective_bytes()
    assert coll["all-reduce"] > 0
    whole = cell(arch, kind, over, B=2).run()        # a data rank's rows
    assert fake.matmul_flops < whole.matmul_flops
    for flops, real in _serving_on_real_ranks()[(arch, kind)]:
        assert flops == fake.matmul_flops
        assert real == coll


def test_run_cell_skips_long_context_on_full_attention():
    rec = D.run_cell("gemma-7b", "long_500k", False, verbose=False)
    assert rec["status"] == "skipped" and "long_500k" in rec["why"]


def test_table_rows_from_records():
    rec = D.run_cell("mamba2-130m", "decode_32k", False, smoke("mamba2-130m"),
                     verbose=False)
    rows = D.table_rows([rec, {"status": "skipped"}])
    assert rows[0]["name"] == "roofline.single_pod.mamba2-130m.decode_32k"
    assert rows[0]["us_per_call"] == round(rec["roofline"]["step_time_s"]
                                           * 1e6)
    assert rows[-1]["derived"].startswith("1 cells run, 1 skipped")


def test_cli_one_cell(tmp_path):
    # the decode cell runs the rank's tensor-parallel step: its heads
    # divide over the 16 model ranks
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    sets = [a for k, v in smoke("stablelm-3b", num_heads=16,
                                num_kv_heads=16).items()
            for a in ("--set", f"{k}={v}")]
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "stablelm-3b", "--shape", "decode_32k", "--mesh", "multi", *sets],
        env=env, cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    out = res.stdout
    rec = json.loads(out[out.index("{"):])
    assert rec["status"] == "ok" and rec["n_devices"] == 512


def test_mesh_group_over_two_of_three_axes():
    """A group over several axes of a larger mesh (the multi-pod cells'
    batch axes): the ranks sharing the other coordinates, in the order
    ``axes_index`` counts them; created once per mesh."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_mesh
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")
        group = mesh.group(("pod", "data"))
        assert dist.get_process_group_ranks(group) == [0, 2, 4, 6]
        assert mesh.group(("pod", "data")) is group
        assert dist.get_process_group_ranks(
            mesh.group(("data", "model"))) == [0, 1, 2, 3]
        with pytest.raises(ValueError, match="order"):
            mesh.group(("data", "pod"))
    finally:
        dist.destroy_process_group()
