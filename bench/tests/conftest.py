"""The benchmark's own tests, on the CPU at smoke sizes (the card's are
marked ``gpu`` and skip without one). They import neither JAX nor the JAX
package; run them from the repository's root:

    python -m pytest -q bench/tests
"""
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def smoke_of(cell: str):
    """(configuration overrides, traffic overrides) that cut ``cell`` to
    the smoke size its files give (each file's ``smoke`` block): the
    loops' flow and arithmetic at a size a test run holds."""
    from bench import harness
    files = harness.cell_files(harness.manifest(), cell)
    return (json.loads(files["config"].read_text())["smoke"],
            json.loads(files["traffic"].read_text())["smoke"])


@pytest.fixture
def card():
    """Skips the test unless a CUDA card is there (decided when the test
    runs, never at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
