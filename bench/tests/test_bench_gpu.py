"""On the card: each cell's short run through the whole harness comes out
correct and reports its metrics (``python -m pytest -q bench/tests -m
gpu`` on a machine with the card; skips without one)."""
import time

import pytest

from bench import harness

CELLS = [w["name"] for w in harness.manifest()["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_cell_on_card(card, cell, trace):
    out = harness.run_workload(cell, 2**31 + 101, 3.0, trace,
                               t_start=time.perf_counter())
    assert out["correct"], out["checks"]
    man = harness.manifest()
    kind = "per_layer" if trace else "end_to_end"
    assert set(out["metrics"]) == set(harness.cell_metrics(man, cell, kind))
    assert out["device"]["platform"] == "gpu"
    if trace:
        assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
