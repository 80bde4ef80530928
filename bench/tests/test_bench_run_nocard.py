"""``bench/run.py`` refuses to run without the cards a cell asks for, and
prints no result; it never falls back to the CPU."""
import os
import shutil
import subprocess
import sys

import pytest

from bench import harness


def run(cwd, *args):
    env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    env["CUDA_VISIBLE_DEVICES"] = ""            # no card, even on a GPU host
    return subprocess.run([sys.executable, "bench/run.py", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env=env)


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  harness.manifest()["workloads"]])
def test_no_card_no_result(cell):
    p = run(harness.ROOT, "--workload", cell, "--seed", str(2**31 + 5),
            "--seconds", "1", "--trace", "0")
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA card" in p.stderr


def test_unknown_workload_fails():
    p = run(harness.ROOT, "--workload", "nope", "--seed", "1", "--seconds",
            "1", "--trace", "0")
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_benchmark_alone_fails(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's files
    (no program) runs nothing."""
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cell = harness.manifest()["workloads"][0]["name"]
    p = run(tmp_path, "--workload", cell, "--seed", "3", "--seconds", "1",
            "--trace", "0")
    assert p.returncode != 0 and p.stdout.strip() == ""
