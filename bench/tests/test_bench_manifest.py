"""BENCHMARK.json against its rules: keys, names, units,
bounds, the files each entry is found by, and which cells report what."""
import json
import math
import re

import pytest

from bench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}

MAN = harness.manifest()


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(MAN["command"]) <= 32
    assert 1 <= len(MAN["paths"]) <= 16
    for p in MAN["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch") and p != "benchmarks"
    for word in MAN["command"]:
        assert 1 <= len(word) <= 200 and "\n" not in word and "\t" not in word
        if "/" in word:
            assert any(word.startswith(p + "/") for p in MAN["paths"])
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51
    assert len(json.dumps(MAN)) <= 64 * 1024


def test_names_units_and_unique():
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in MAN[kind]]
        assert len(names) == len(set(names)), kind
        for n in names:
            assert NAME.match(n), n
    metrics = MAN["end_to_end"] + MAN["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES


def test_entry_keys():
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert 1 <= len(m["layer"]) <= 200


def test_four_chip_cells_are_few():
    cells = MAN["workloads"]
    four = sum(w["chips"] == 4 for w in cells)
    assert four <= max(1, math.floor(0.25 * len(cells)))


def test_every_entry_is_found_by_name():
    used = set()
    for w in MAN["workloads"]:
        files = harness.cell_files(MAN, w["name"])
        for role, path in files.items():
            assert path.is_file(), (w["name"], role, path)
        used.add(w["config"])
        conf = json.loads(files["config"].read_text())
        entry = next(c for c in MAN["configs"] if c["name"] == w["config"])
        assert conf["reduced"] == entry["reduced"]
        assert (harness.BENCH / "reference" / f"{conf['reference']}.py"
                ).is_file()
        assert "smoke" in json.loads(files["traffic"].read_text())
    assert used == {c["name"] for c in MAN["configs"]}
    files = [c["file"] for c in MAN["configs"]]
    assert len(files) == len(set(files))
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert (harness.BENCH / "metrics" / f"{m['name']}.py").is_file()


REFERENCE_API = ("leaves", "split", "logits", "token_logprobs",
                 "cross_entropy", "train", "matmul_params",
                 "attention_fwd_flops")


@pytest.mark.parametrize("entry", MAN["configs"], ids=lambda c: c["name"])
def test_config_holds_each_width_once(entry):
    """The published keys are the file's own; the port reads each width
    from them by ``port_keys`` and holds none of them again in ``port``."""
    conf = json.loads((harness.ROOT / entry["file"]).read_text())
    for field, key in conf["port_keys"].items():
        assert key in conf, (field, key)
        assert field not in conf["port"], field
    m = harness.port_config(conf)
    assert set(conf["smoke"]) <= set(m)
    ref = harness.reference_of(conf)
    for name in REFERENCE_API:
        assert callable(getattr(ref, name)), name


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_each_cell_reports_what_it_must(cell):
    e2e = harness.cell_metrics(MAN, cell, "end_to_end")
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = harness.cell_metrics(MAN, cell, "per_layer")
    assert layer
    by = {m["name"]: m for m in MAN["per_layer"]}
    for name in layer:
        assert by[name]["moves"] in e2e, name


def test_per_layer_metrics_move_an_end_to_end_metric():
    e2e = {m["name"] for m in MAN["end_to_end"]}
    cells = {w["name"] for w in MAN["workloads"]}
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e
        assert m["workloads"] and set(m["workloads"]) <= cells
    for m in MAN["end_to_end"]:
        assert set(m.get("workloads", cells)) <= cells


def test_roofline_and_mfu_names():
    names = [m["name"] for m in MAN["per_layer"]]
    for n in names:
        if "_roofline" in n or "mfu" in n:
            assert next(m for m in MAN["per_layer"]
                        if m["name"] == n)["unit"] == "%"
    moved = {m["moves"] for m in MAN["per_layer"] if "_roofline" in m["name"]}
    for e2e in moved:
        assert any("mfu" in m["name"] and m["moves"] == e2e
                   for m in MAN["per_layer"])


def test_files_are_named_from_name_characters():
    for path in harness.BENCH.rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(harness.ROOT).as_posix()
        assert PATH.match(rel), rel
