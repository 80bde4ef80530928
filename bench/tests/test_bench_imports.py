"""Nothing the benchmark runs imports JAX or the JAX package ``repro``
(top-level names compared whole: ``repro_torch`` is the port), and the
plain reference imports nothing of the program."""
import ast
import json
import subprocess
import sys

from bench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def modules():
    """Every module of the harness, its loops, traffic readers, metrics
    and reference, as paths."""
    return sorted(p for p in harness.BENCH.rglob("*.py")
                  if "tests" not in p.parts)


def test_no_module_imports_jax_or_the_jax_package():
    code = f"""
import importlib.util, json, sys
sys.path[:0] = [{str(harness.ROOT / 'src')!r}, {str(harness.ROOT)!r}]
import bench.harness
for i, path in enumerate({[str(p) for p in modules()]!r}):
    spec = importlib.util.spec_from_file_location("bench_mod_%d" % i, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
import repro_torch.runtime, repro_torch.models.model
print(json.dumps(sorted({{n.split('.')[0] for n in sys.modules}})))
"""
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=harness.ROOT)
    assert p.returncode == 0, p.stderr
    tops = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert not tops & FORBIDDEN
    assert "repro_torch" in tops


def imported(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_sources_name_no_forbidden_module():
    for path in harness.BENCH.rglob("*.py"):
        assert not imported(path) & FORBIDDEN, path


def test_reference_imports_nothing_of_the_program():
    for path in (harness.BENCH / "reference").glob("*.py"):
        assert "repro_torch" not in imported(path), path
    names = sorted(p.stem for p in (harness.BENCH / "reference").glob("*.py")
                   if p.stem != "__init__")
    code = f"""
import importlib, sys, json
sys.path[:0] = [{str(harness.ROOT)!r}]
for name in {names!r}:
    importlib.import_module("bench.reference." + name)
print(json.dumps(sorted({{n.split('.')[0] for n in sys.modules}})))
"""
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    tops = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert not tops & (FORBIDDEN | {"repro_torch"})


def test_run_refuses_a_forbidden_module():
    sys.modules.setdefault("repro", type(sys)("repro"))
    try:
        assert harness.forbidden_modules() == ["repro"]
    finally:
        del sys.modules["repro"]
    assert harness.forbidden_modules() == []
