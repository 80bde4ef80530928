"""The control of each cell's comparison: the reference computed a
precision below the configuration's (fp8 products for bf16), put in the
program's place, comes out not correct against the cell's limits, while
the program itself, in the configuration's bf16, comes out correct. At a
smoke size on the CPU; ``bench/calibrate.py`` reads the same numbers on
the card at the cells' own sizes, from which the limits were set."""
import pytest

from bench import harness
from bench.tests.conftest import smoke_of

CELLS = sorted(w["name"] for w in harness.manifest()["workloads"])

fails = harness.over_limits


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_holds(cell):
    conf, traffic = smoke_of(cell)
    loop, ctx, limits = harness.load_cell(
        cell, 2**31 + 23, device="cpu", overrides=conf,
        traffic_overrides=traffic, log=lambda msg: None)
    c = loop.Cell(ctx)
    c.setup()
    c.window(1.0)
    c.release()
    got = loop.readings(c, control=True)
    assert not fails(got["program"], limits), got["program"]
    assert fails(got["control"], limits), got["control"]
    for fault in set(got) - {"program", "control"}:
        assert fails(got[fault], limits), (fault, got[fault])
