"""``repro_torch.launch.quickstart`` against the JAX package's
``examples/quickstart.py``, on the CPU: section 1's metrics (makespan,
utilization, every field of ``compute_metrics``) equal to those the
example computes, exactly; section 2's loss finite and falling; section 3's
six tasks DONE on dragon, flux and popen with the payloads' results; the
CLI with ``--device cpu``."""
import importlib.util
import math
from pathlib import Path

import pytest

from repro_torch.launch import quickstart as Q

ROOT = Path(__file__).resolve().parents[1]


def _jax_quickstart():
    spec = importlib.util.spec_from_file_location(
        "jax_quickstart", ROOT / "examples" / "quickstart.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_sim_experiment_equals_the_jax_quickstarts(monkeypatch, capsys):
    ex = _jax_quickstart()
    seen = []

    def recorded(*args, **kw):
        seen.append(ex_metrics(*args, **kw))
        return seen[-1]

    ex_metrics = ex.compute_metrics
    monkeypatch.setattr(ex, "compute_metrics", recorded)
    ex.sim_experiment()
    want_out = capsys.readouterr().out
    got = Q.sim_experiment()
    got_out = capsys.readouterr().out
    assert list(got) == ["srun", "flux"] and len(seen) == 2
    for name, want in zip(got, seen):
        assert got[name].__dict__ == want.__dict__, name
    assert got_out == want_out
    # the paper's contrast at 4 nodes: flux fills the cores srun leaves idle
    assert got["flux"].makespan < got["srun"].makespan
    assert got["flux"].utilization > 1.9 * got["srun"].utilization


def test_training_and_hybrid_sections_on_the_cpu():
    out = Q.tiny_training("cpu")
    losses = out["losses"]
    assert len(losses) == 5 and all(math.isfinite(x) for x in losses)
    assert out["final_loss"] < losses[0]
    tasks = Q.hybrid_middleware("cpu")
    assert [t.state.value for t in tasks] == ["DONE"] * 6
    assert [t.result for t in tasks[:4]] == [0.0, 1.0, 3.0, 6.0]
    assert [t.backend for t in tasks] == ["dragon"] * 4 + ["flux", "popen"]
    assert tasks[5].result.strip() == "Linux"


def test_cli_runs_on_the_cpu_and_refuses_a_missing_card(capsys):
    Q.main(["--device", "cpu"])
    out = capsys.readouterr().out
    for section in ("== 1.", "== 2.", "== 3.", "6/6 tasks done"):
        assert section in out
    import torch
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Q.main([])
