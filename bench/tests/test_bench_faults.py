"""A run with its timed path broken underneath comes out not correct:
the harness's look for a card skipped, everything else of a run driven on
the CPU at a smoke size in float32, against each cell's own limits. Each
fault the cell can have: a step that returns its state unchanged, half
of the batch left out (the mean over the rest), an answer altered where
it is produced. (One card: no exchange between cards to leave out.) A
sound run of the same size comes out correct."""
import time

import pytest

from bench import harness
from bench.tests.conftest import smoke_of

CELLS = {w["name"]: w for w in harness.manifest()["workloads"]}


def run(cell, fault):
    conf, traffic = smoke_of(cell)
    return harness.run_workload(
        cell, 2**31 + 17, 1.0, False, t_start=time.perf_counter(),
        device="cpu", overrides=dict(conf, dtype="float32"),
        traffic_overrides=traffic, fault=fault, log=lambda msg: None)


def faults_of(cell):
    loop, _, _ = harness.load_cell(cell, 1, device="cpu",
                                   overrides=smoke_of(cell)[0])
    return loop.FAULTS


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_sound_run_is_correct(cell):
    out = run(cell, None)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("cell, fault", [
    (c, f) for c in sorted(CELLS) for f in faults_of(c)])
def test_fault_is_not_correct(cell, fault):
    out = run(cell, fault)
    assert not out["correct"], (fault, out["checks"])
