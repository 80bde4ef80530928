"""The slice as a whole: the hybrid AI-HPC campaign of the JAX package's
``examples/hybrid_campaign.py`` (run as it is, through the JAX runtime with
the JAX model) against the port's twin ``repro_torch.launch.hybrid_campaign``
(the port's runtime and model), on the CPU, at the example's reduced size and
seed. Both in f32 (the example's config with ``dtype="float32"``); the port
starts from the example's initial weights, carried across with
``bridge.py``.

The numpy side (docking scores, selections) must be equal; each round's SST
loss within 1e-4 relative, and the inference output too."""
import importlib.util
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.configs import get_smoke_config as jget_smoke
from repro.models import model as jM
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.launch import hybrid_campaign as HC

ROOT = Path(__file__).resolve().parents[1]
LOSS_RTOL = 1e-4


def _load_example():
    spec = importlib.util.spec_from_file_location(
        "hybrid_campaign_example", ROOT / "examples" / "hybrid_campaign.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_run():
    """The example's main() with its defaults (2 rounds, 16 candidates, 3
    steps, sequence 32), its config in f32; every submitted task recorded
    and its initial weights kept."""
    ex = _load_example()
    mp = pytest.MonkeyPatch()
    init, submitted = {}, []

    def init_params(key, cfg):
        init["params"] = jM_init(key, cfg)
        return init["params"]

    class RecordingTaskManager(ex.TaskManager):
        def submit_tasks(self, descriptions):
            out = super().submit_tasks(descriptions)
            submitted.extend(out if isinstance(out, list) else [out])
            return out

    jM_init = jM.init_params
    try:
        mp.setattr(ex, "get_smoke_config",
                   lambda arch, **kw: jget_smoke(arch, dtype="float32", **kw))
        mp.setattr(jM, "init_params", init_params)
        mp.setattr(ex, "TaskManager", RecordingTaskManager)
        mp.setattr(sys, "argv", ["hybrid_campaign.py"])
        ex.main()
    finally:
        mp.undo()
    by_stage = {}
    for t in submitted:
        assert t.state.value == "DONE", (t.uid, t.error)
        by_stage.setdefault(t.description.stage, []).append(t)
    n = len(by_stage["sst_train"])
    batch = len(by_stage["docking"]) // n
    scores = [np.asarray([t.result for t in by_stage["docking"]
                          [i * batch:(i + 1) * batch]]) for i in range(n)]
    return {"params": jax.tree.map(np.asarray, init["params"]),
            "scores": scores,
            "selections": [np.argsort(s)[: batch // 2] for s in scores],
            "losses": [t.result for t in by_stage["sst_train"]],
            "inference": [t.result for t in by_stage["inference"]],
            "tokens": [t.description.args[0] for t in by_stage["sst_train"]]}


@pytest.fixture(scope="module")
def port_run(jax_run):
    cfg = get_smoke_config("stablelm-3b", d_model=96, num_layers=2,
                           dtype="float32")
    return HC.run_campaign(cfg, params=bridge.to_torch(jax_run["params"],
                                                       device="cpu"),
                           device="cpu", quiet=True)


def test_campaign_numpy_side_equal(jax_run, port_run):
    assert len(port_run["scores"]) == len(jax_run["scores"]) == 2
    for got, want in zip(port_run["scores"], jax_run["scores"]):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(port_run["selections"], jax_run["selections"]):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(port_run["tokens"], jax_run["tokens"]):
        np.testing.assert_array_equal(got, want)


def test_campaign_losses_within_tolerance(jax_run, port_run):
    got, want = np.asarray(port_run["losses"]), np.asarray(jax_run["losses"])
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=0)


def test_campaign_inference_within_tolerance(jax_run, port_run):
    for got, want in zip(port_run["inference"], jax_run["inference"]):
        np.testing.assert_allclose(np.asarray(got, np.float32),
                                   np.asarray(want, np.float32),
                                   rtol=LOSS_RTOL, atol=1e-6)


def test_campaign_tasks_done_on_their_backends(port_run):
    tasks = port_run["tasks"]
    assert [len(tasks[k]) for k in ("docking", "sst_train", "inference")] \
        == [32, 2, 2]
    assert {t.backend for t in tasks["docking"] + tasks["inference"]} \
        == {"dragon"}
    assert {t.backend for t in tasks["sst_train"]} == {"flux"}
    assert all(t.state.value == "DONE" for ts in tasks.values() for t in ts)
    assert all(len(s) == 3 for s in port_run["step_s"])
    # the flux partition's mesh, the port's one-process Mesh, reached them
    assert [m.shape for m in port_run["meshes"]] == [{"data": 1,
                                                     "model": 1}] * 2


def test_campaign_cli_on_the_cpu(capsys):
    HC.main(["--iterations", "1", "--docking-batch", "4", "--train-steps",
             "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[campaign] iter 0: docked 4" in out
    assert "complete: 6/6 tasks" in out
