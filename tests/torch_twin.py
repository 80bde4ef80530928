"""Twins of the JAX package's runtime tests on the port.

The port's runtime modules (``core``, ``runtime``, ``sched``, ``services``,
``faults``, ``observability``) are copies of the JAX package's with their
imports rewritten, so a runtime test of the JAX package holds the port to
the same assertions once its module paths are rewritten the same way.
``twin_of(name)`` reads ``tests/<name>``, rewrites every
``repro.<runtime subpackage>`` path to ``repro_torch.<...>``, runs the
result as a module of its own and returns its test functions, for a
``tests/test_torch_*.py`` file to take into its namespace:

    globals().update(twin_of("test_faults.py", skip=(...)))

Line numbers are the original file's, so a failure points at the
reference test's line. Tests marked ``slow`` are left to the original.
"""
import re
import sys
import types
from pathlib import Path

TESTS = Path(__file__).resolve().parent
_RUNTIME_PATH = re.compile(
    r"\brepro\.(core|runtime|sched|services|faults|observability)\b")


def rewrite(source: str) -> str:
    """The JAX package's runtime module paths in ``source`` as the port's."""
    return _RUNTIME_PATH.sub(r"repro_torch.\1", source)


def _slow(fn) -> bool:
    return any(m.name == "slow" for m in getattr(fn, "pytestmark", ()))


def twin_of(name: str, skip=()):
    """``{test name: function}`` of ``tests/<name>`` run on the port, less
    the names in ``skip`` (each must exist) and the ``slow`` tests. The
    module is registered in ``sys.modules``, so payloads defined in it
    pickle by reference into forked worker processes."""
    path = TESTS / name
    source = rewrite(path.read_text())
    assert "import jax" not in source and "from jax" not in source, name
    mod = types.ModuleType(f"torch_twin_{path.stem}")
    mod.__file__ = str(path)
    sys.modules[mod.__name__] = mod
    exec(compile(source, str(path), "exec"), mod.__dict__)
    tests = {k: v for k, v in vars(mod).items()
             if k.startswith("test_") and callable(v)}
    missing = set(skip) - set(tests)
    assert not missing, f"{name} has no {sorted(missing)}"
    return {k: v for k, v in tests.items() if k not in skip and not _slow(v)}
