"""The port's training driver (``repro_torch.launch.train``) on the CPU.

Against JAX: the port's ``train()`` on the f32 smoke configs of
chatglm3-6b and mamba2-130m, started from JAX's initial weights (carried
over the bridge), against a loop of JAX's unsharded ``make_train_step``
over the JAX package's pipeline batches (JAX's own ``train()`` cannot be
the reference: ROADMAP.md, reference caveat 1). Against itself: resume,
elastic restart from 2 gloo ranks onto 1, data parallelism on 2 ranks,
accumulation, int8 gradients, the hybrid family's refusal of a model
axis, the CLI (alone and under ``torchrun``), and twins of
examples/train_lm.py and quickstart section 2. Tensor parallel (gloo ranks):
chatglm3-6b on (1, 2) and (2, 2) against the JAX loop, an elastic restart
from (2, 2) onto (1, 1) and (1, 4), and the checkpoint read back by the JAX
package's manager.

Tolerances, each with its reason:
  * the loss per step against the JAX loop, on one rank and
    tensor-parallel: 1e-4 relative (the same f32
    arithmetic with sums in another order, as tests/test_torch_train.py's
    one step; the six steps read at most 1.7e-7);
  * resume, and a batch that does not divide over the ranks (each rank
    takes it whole, as one rank does): equal bit for bit (the same
    operations on the same values);
  * 2 ranks against 1, and an elastic restart (data-parallel, or
    tensor-parallel from (2, 2)): 1e-5 relative per loss and
    1e-4 relative to each leaf's largest value per final parameter (the
    gradient is the f32 mean of two halves' means, summed in another order);
  * ``accum_steps=2`` against 1: 1e-5 relative per loss (the same sums in
    two parts);
  * int8 gradients against f32 ones: the first loss equal bit for bit (it
    is taken before any update); later ones within 5e-3 relative (the
    quantized gradients move the weights by other amounts; five steps read
    at most 3.5e-4 on 1 rank and on 2).
"""
import dataclasses
import functools
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.data import pipeline as jpipe
from repro.distributed.train_step import make_train_step as jmake_train_step
from repro.models import model as jM
from repro.optim import adamw as jadamw
from repro_torch import bridge
from repro_torch import tree as T
from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.distributed import train_step as TS
from repro_torch.kernels import _grad
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.fused_rmsnorm import ops as rn_ops
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.launch import train as train_mod
from repro_torch.launch.mesh import abstract_mesh
from repro_torch.optim import adamw
from torch_ranks import ROOT, run_ranks, tp_train_on_ranks, train_on_ranks

OPT = dict(total_steps=10, warmup_steps=2)
RUN = dict(global_batch=4, seq_len=16, seed=0)


def _train(arch, **kw):
    cfg = get_smoke_config(arch, dtype="float32")
    return train_mod.train(cfg, device="cpu", quiet=True,
                           opt_cfg=adamw.OptimizerConfig(**OPT),
                           **{**RUN, **kw})


def _final(out):
    return {p: t.numpy() for p, t in T.flatten(out["params"])}


def _close_params(got, want, rel):
    assert got.keys() == want.keys()
    for path, w in want.items():
        assert np.abs(got[path] - w).max() <= rel * np.abs(w).max() + 1e-12, \
            path


# ------------------------------------------------- against a JAX loop
@pytest.mark.parametrize("arch", ["chatglm3-6b", "mamba2-130m"])
def test_train_matches_a_jax_loop(arch, monkeypatch):
    steps = 6
    jcfg = jget_smoke(arch, dtype="float32")
    jparams = jM.init_params(jax.random.PRNGKey(0), jcfg)
    host = jax.tree.map(np.asarray, jparams)
    jstep = jax.jit(jmake_train_step(jcfg, jadamw.OptimizerConfig(**OPT)))
    stream = jpipe.make_loader(jcfg, jpipe.DataConfig(**{
        "seq_len": RUN["seq_len"], "global_batch": RUN["global_batch"],
        "seed": RUN["seed"]}))
    jopt, want = jadamw.init(jparams), []
    for _ in range(steps):
        jparams, jopt, m = jstep(jparams, jopt, next(stream))
        want.append(float(m["loss"]))

    monkeypatch.setattr(train_mod.M, "init_params",
                        lambda cfg, seed=0, device="cpu":
                        bridge.to_torch(host, device=device))
    out = _train(arch, steps=steps)
    assert out.keys() == {"losses", "params", "opt_state", "final_loss",
                          "steps", "step_s"}
    assert len(out["step_s"]) == steps and out["final_loss"] == \
        out["losses"][-1]
    np.testing.assert_allclose(out["losses"], want, rtol=1e-4)
    assert int(out["opt_state"].step) == steps


# ---------------------------------------------------------- against itself
def test_resume_equals_the_uninterrupted_run_bit_for_bit(tmp_path):
    """4 steps with a checkpoint every 2, then a resume to 8: steps 4-7 and
    the final weights and moments as in one run of 8; the checkpoint holds
    the data cursor."""
    arch = "chatglm3-6b"
    full = _train(arch, steps=8)
    d = str(tmp_path / "ckpt")
    first = _train(arch, steps=4, ckpt_dir=d, ckpt_every=2)
    assert CheckpointManager(d).all_steps() == [2, 4]
    meta = CheckpointManager(d).restore()["meta"]
    assert meta["data"] == {"step": 4, "seed": RUN["seed"]}
    rest = _train(arch, steps=8, ckpt_dir=d, resume=True)
    assert first["losses"] + rest["losses"] == full["losses"]
    for a, b in zip(T.leaves((full["params"], full["opt_state"])),
                    T.leaves((rest["params"], rest["opt_state"]))):
        assert torch.equal(a, b)
    assert CheckpointManager(d).latest_step() == 8


def test_accum_steps_two_matches_one():
    one = _train("mamba2-130m", steps=4)
    two = _train("mamba2-130m", steps=4, accum_steps=2)
    np.testing.assert_allclose(two["losses"], one["losses"], rtol=1e-5)


def test_compress_grads_on_one_rank():
    plain = _train("chatglm3-6b", steps=5)
    int8 = _train("chatglm3-6b", steps=5, compress_grads=True)
    assert int8["losses"][0] == plain["losses"][0]
    np.testing.assert_allclose(int8["losses"], plain["losses"], rtol=5e-3)
    assert int8["losses"] != plain["losses"]           # the int8 path ran


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """One spawn of 2 gloo ranks (chatglm3-6b, tp16: data parallel over
    ``data``) for the multi-rank tests: 5 steps f32, 5 steps int8, a batch of
    3 (does not divide), and 4 steps with a checkpoint for the elastic
    restart."""
    d = str(tmp_path_factory.mktemp("elastic") / "ckpt")
    opt = adamw.OptimizerConfig(**OPT)
    runs = [dict(RUN, steps=5, opt_cfg=opt),
            dict(RUN, steps=5, opt_cfg=opt, compress_grads=True),
            dict(RUN, steps=3, opt_cfg=opt, global_batch=3),
            dict(RUN, steps=4, opt_cfg=opt, ckpt_dir=d, ckpt_every=4)]
    results = run_ranks(train_on_ranks, 2, "chatglm3-6b", runs,
                        timeout=240)
    return results, d


def test_two_ranks_match_one_rank(two_ranks):
    results, _ = two_ranks
    one = _train("chatglm3-6b", steps=5)
    for rank in range(2):
        losses, final = results[rank][0]
        np.testing.assert_allclose(losses, one["losses"], rtol=1e-5)
        _close_params(final, _final(one), 1e-4)
    for a, b in zip(results[0][0][1].values(), results[1][0][1].values()):
        np.testing.assert_array_equal(a, b)          # replicas stay equal


def test_batch_that_does_not_divide_goes_to_every_rank_whole(two_ranks):
    results, _ = two_ranks
    one = _train("chatglm3-6b", steps=3, global_batch=3)
    for rank in range(2):
        assert results[rank][2][0] == one["losses"]


def test_compress_grads_on_two_ranks(two_ranks):
    results, _ = two_ranks
    one = _train("chatglm3-6b", steps=5)
    for rank in range(2):
        losses, _ = results[rank][1]
        assert losses[0] == results[rank][0][0][0]   # before any update
        np.testing.assert_allclose(losses, one["losses"], rtol=5e-3)
        assert losses != results[rank][0][0]
    for a, b in zip(results[0][1][1].values(), results[1][1][1].values()):
        np.testing.assert_array_equal(a, b)


def test_elastic_restart_two_ranks_then_one(two_ranks):
    """A checkpoint written by 2 ranks at step 4, resumed by 1 rank to step
    8, against one rank for all 8."""
    results, d = two_ranks
    assert CheckpointManager(d).latest_step() == 4
    rest = _train("chatglm3-6b", steps=8, ckpt_dir=d, resume=True)
    full = _train("chatglm3-6b", steps=8)
    np.testing.assert_allclose(results[0][3][0] + rest["losses"],
                               full["losses"], rtol=1e-5)
    _close_params(_final(rest), _final(full), 1e-4)


def test_tp16_refused_on_a_model_axis():
    """What the port cannot split over a model axis is refused with the
    reason: the hybrid family's 6 SSD heads (d_model 48) over 4 ranks (the
    port splits whole heads). Its heads that divide, and the dense and MoE
    families, run (below)."""
    cfg = get_smoke_config("zamba2-7b", d_model=48)
    with pytest.raises(NotImplementedError, match="6 SSD heads"):
        train_mod.train(cfg, steps=1, global_batch=2, seq_len=8,
                        mesh=abstract_mesh(data=1, model=4), device="cpu")


@pytest.mark.parametrize("arch,mesh_shape", [("zamba2-7b", (2, 2)),
                                             ("mamba2-130m", (1, 4))])
def test_split_families_train_matches_a_jax_loop(arch, mesh_shape):
    """``train()`` of the hybrid family tensor-parallel (zamba2-7b on (2,
    2)) and of dp_all's split vocabulary (mamba2-130m on (1, 4), a row a
    rank) from JAX's weights: the losses of 6 steps against a loop of
    JAX's unsharded step on its pipeline's batches, and the final
    parameters, gathered, the same on every rank."""
    host, want = _jax_run(arch, 6)
    run = dict(RUN, steps=6, opt_cfg=adamw.OptimizerConfig(**OPT))
    out = run_ranks(tp_train_on_ranks, mesh_shape[0] * mesh_shape[1], arch,
                    mesh_shape, host, [run], timeout=240)
    for losses, final in (r[0] for r in out):
        np.testing.assert_allclose(losses, want, rtol=1e-4)
        _close_params(final, out[0][0][1], 0.0)


# ------------------------------------------ tensor parallel and ZeRO-1
@functools.lru_cache(maxsize=None)
def _jax_run(arch, steps):
    """JAX's initial f32 weights (numpy) and the losses of a loop of its
    unsharded step over the JAX package's pipeline batches."""
    jcfg = jget_smoke(arch, dtype="float32")
    jparams = jM.init_params(jax.random.PRNGKey(0), jcfg)
    host = jax.tree.map(np.asarray, jparams)
    jstep = jax.jit(jmake_train_step(jcfg, jadamw.OptimizerConfig(**OPT)))
    stream = jpipe.make_loader(jcfg, jpipe.DataConfig(**RUN))
    jopt, losses = jadamw.init(jparams), []
    for _ in range(steps):
        jparams, jopt, m = jstep(jparams, jopt, next(stream))
        losses.append(float(m["loss"]))
    return host, losses


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    """chatglm3-6b from JAX's weights: 6 steps on (1, 2) and on (2, 2), 4
    steps on (2, 2) with a checkpoint, resumed to 8 on (1, 4) (each resume
    from its own copy of the checkpoint)."""
    arch, opt = "chatglm3-6b", adamw.OptimizerConfig(**OPT)
    host, _ = _jax_run(arch, 6)
    d = str(tmp_path_factory.mktemp("tp_elastic") / "ckpt")
    six = dict(RUN, steps=6, opt_cfg=opt)
    out = {(1, 2): run_ranks(tp_train_on_ranks, 2, arch, (1, 2), host,
                             [six], timeout=240),
           (2, 2): run_ranks(tp_train_on_ranks, 4, arch, (2, 2), host,
                             [six, dict(RUN, steps=4, opt_cfg=opt, ckpt_dir=d,
                                        ckpt_every=4)], timeout=240)}
    resumed = {}
    for shape in ((1, 1), (1, 4)):
        copy = str(tmp_path_factory.mktemp(f"resume_{shape[1]}") / "ckpt")
        shutil.copytree(d, copy)
        run = dict(RUN, steps=8, opt_cfg=opt, ckpt_dir=copy, resume=True)
        if shape == (1, 1):
            resumed[shape] = _tp_train_here(arch, host, run)
        else:
            resumed[shape] = run_ranks(tp_train_on_ranks, 4, arch, shape,
                                       host, [run], timeout=240)[0][0]
    return out, resumed, d, host


def _tp_train_here(arch, host, run):
    real = train_mod.M.init_params
    train_mod.M.init_params = (lambda cfg, seed=0, device="cpu":
                               bridge.to_torch(host, device=device))
    try:
        r = train_mod.train(get_smoke_config(arch, dtype="float32"),
                            device="cpu", quiet=True, **run)
    finally:
        train_mod.M.init_params = real
    return r["losses"], _final(r)


@pytest.mark.parametrize("mesh_shape", [(1, 2), (2, 2)])
def test_tensor_parallel_train_matches_a_jax_loop(tp_runs, mesh_shape):
    _, want = _jax_run("chatglm3-6b", 6)
    results = tp_runs[0][mesh_shape]
    for losses, final in (r[0] for r in results):
        np.testing.assert_allclose(losses, want, rtol=1e-4)
        _close_params(final, results[0][0][1], 0.0)   # the same on every rank


@pytest.mark.parametrize("resume_on", [(1, 1), (1, 4)])
def test_elastic_restart_from_two_by_two(tp_runs, resume_on):
    """A checkpoint written at step 4 on (2, 2), resumed to step 8 on
    another mesh, against one rank's uninterrupted 8 steps."""
    out, resumed, _, host = tp_runs
    first = out[(2, 2)][0][1][0]
    full = _tp_train_here("chatglm3-6b", host,
                          dict(RUN, steps=8,
                               opt_cfg=adamw.OptimizerConfig(**OPT)))
    losses, final = resumed[resume_on]
    np.testing.assert_allclose(first + losses, full[0], rtol=1e-5)
    _close_params(final, full[1], 1e-4)


def test_tensor_parallel_checkpoint_reads_back_through_jax(tp_runs):
    """The (2, 2) run's checkpoint holds the whole tree in the JAX
    package's format: JAX's CheckpointManager restores it into its own
    tree, equal to what the port reads."""
    from repro.checkpoint.checkpoint import CheckpointManager as JManager
    _, _, d, host = tp_runs
    jparams = jax.tree.map(jax.numpy.asarray, host)
    back = JManager(d).restore(template={"params": jparams,
                                         "opt": jadamw.init(jparams)})
    assert back["step"] == 4
    mine = CheckpointManager(d).restore()["get"]
    flat = jax.tree_util.tree_flatten_with_path(back["tree"])[0]
    assert len(flat) == 2 * len(T.leaves(host)) + len(T.leaves(host)) + 1
    for path, leaf in flat:
        key = "/".join(str(getattr(p, "key", getattr(p, "name", p)))
                       for p in path)
        key = key.replace("opt/mu", "opt/.mu").replace(
            "opt/nu", "opt/.nu").replace("opt/step", "opt/.step")
        np.testing.assert_array_equal(np.asarray(leaf), mine(key).numpy(),
                                      err_msg=key)


def test_driver_launches_the_kernels_every_step(monkeypatch):
    """The kernel wrappers' own routing (CPU tensors sent to the launch, each
    launch played by the plain version, as tests/test_torch_train.py does):
    every step of the driver launches ``kernel_launches(cfg)``."""
    def launch(mod):
        def run(*args, **static):
            with torch.no_grad():
                out = mod.plain(*args, **static)
            mod.launches += 1
            return out
        return run
    monkeypatch.setattr(_grad, "KERNEL_DEVICE", "cpu")
    for mod in (fa_ops, rn_ops, ssd_ops):
        monkeypatch.setattr(mod, "_launch", launch(mod))
    for arch in ("stablelm-3b", "mamba2-130m"):
        cfg = get_smoke_config(arch, dtype="float32")
        before = {m: m.launches for m in (fa_ops, rn_ops, ssd_ops)}
        train_mod.train(cfg, steps=3, device="cpu", quiet=True, **RUN)
        got = {m.__name__.split(".")[-2]: m.launches - n
               for m, n in before.items()}
        want = TS.kernel_launches(cfg)
        assert got == {k: 3 * want[k] for k in got}, arch


# ------------------------------------------------------------------- the CLI
def _cli(*prefix):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="2")
    r = subprocess.run([*prefix, "-m", "repro_torch.launch.train", "--arch",
                        "mamba2-130m", "--smoke", "--steps", "3", "--batch",
                        "4", "--seq-len", "32", "--device", "cpu"],
                       env=env, cwd=ROOT, capture_output=True, text=True,
                       timeout=180)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    return r.stdout


def test_cli_runs_alone():
    out = _cli(sys.executable)
    assert "[train] done: final loss" in out


def test_cli_runs_under_torchrun_on_two_ranks():
    out = _cli(sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", "2")
    assert out.count("[train] done: final loss") == 1      # rank 0 logs


def test_cli_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_mod.main(["--arch", "mamba2-130m", "--smoke", "--steps", "1"])


# -------------------------------------------------------------------- twins
def test_train_lm_twin_at_a_narrow_width(tmp_path):
    """examples/train_lm.py's run (mamba2-130m's family, bf16, checkpoints
    along the way) at d_model 64, 2 layers, 20 steps of 4 x 64 tokens: the
    loss falls, as the example asserts."""
    cfg = dataclasses.replace(get_config("mamba2-130m"), d_model=64,
                              num_layers=2)
    out = train_mod.train(cfg, steps=20, global_batch=4, seq_len=64,
                          ckpt_dir=str(tmp_path), ckpt_every=10,
                          log_every=10, quiet=True, device="cpu")
    assert out["final_loss"] < out["losses"][0]
    assert CheckpointManager(str(tmp_path)).all_steps() == [10, 20]


def test_train_lm_twin_cli():
    """``launch/train_lm.py``, the twin of examples/train_lm.py, on the CPU
    at its quick-check width: the loss falls and the checkpoints land."""
    from repro_torch.launch import train_lm
    d = os.path.join(os.environ.get("TMPDIR", "/tmp"), f"tlm_{os.getpid()}")
    try:
        out = train_lm.main(["--steps", "20", "--d-model", "64", "--batch",
                             "4", "--seq-len", "64", "--ckpt-dir", d,
                             "--device", "cpu"])
        assert out["final_loss"] < out["losses"][0]
        assert CheckpointManager(d).all_steps() == [20]
    finally:
        shutil.rmtree(d, ignore_errors=True)


def test_quickstart_tiny_training_twin():
    """examples/quickstart.py section 2: gemma-7b's smoke config, 5 steps."""
    out = train_mod.train(get_smoke_config("gemma-7b"), steps=5,
                          global_batch=2, seq_len=32, quiet=True,
                          device="cpu")
    assert np.isfinite(out["final_loss"]) and len(out["losses"]) == 5
