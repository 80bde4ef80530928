"""Run one cell of the port's benchmark once and print its result line.

    python bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout of the repository, on a machine with as many
CUDA cards as the cell asks for. It loads, warms up, measures for
``--seconds``, checks what the timed path produced against the plain
reference, and prints one JSON object as the last line of its standard
output: the end-to-end metrics with ``--trace 0``, the per-layer ones with
``--trace 1``. Without the cards it exits non-zero and prints no result;
it never falls back to the CPU.

The kernels build into ``build/kernels/`` inside the checkout (the port's
own cache), and any other compiler cache goes under ``build/bench-cache/``
there, so only a cell's first run in a checkout compiles.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _cache_dirs():
    cache = ROOT / "build" / "bench-cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(cache / sub)
    # a library that would load JAX on its own is kept from doing so
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _cache_dirs()
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    from bench import harness
    chips = next((w["chips"] for w in harness.manifest()["workloads"]
                  if w["name"] == args.workload), None)
    if chips is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              , file=sys.stderr)
        return 3
    try:
        out = harness.run_workload(args.workload, args.seed, args.seconds,
                                   bool(args.trace), t_start=T_START)
    except BaseException:                                  # noqa: BLE001
        traceback.print_exc()
        return 1
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
