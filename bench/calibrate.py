"""Readings for a cell's limits, many seeds in one process on the card:
the program's numbers, and on the control seeds those of the reference
computed a precision lower in the program's place (and of the faults a
loop can plant in the reference), each against the float32 reference.

    python bench/calibrate.py --workload <name> --seeds 1 2 3 ...
        [--control-seeds 1 2 3] [--seconds 3]

One JSON line a seed, with ``over_limits``: for each set of readings, the
numbers that the cell's limits refuse. The benchmark's runs never run this; the limits in
``bench/limits/`` are set from what it prints (``PERF.md`` gives the
readings beside each limit).
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    for p in (ROOT / "src", ROOT):
        sys.path.insert(0, str(p))
    import torch
    if not torch.cuda.is_available():
        print("calibrate needs a CUDA card", file=sys.stderr)
        return 3
    from bench import harness
    for seed in args.seeds:
        t0 = time.perf_counter()
        loop, ctx, limits = harness.load_cell(args.workload, seed)
        cell = loop.Cell(ctx)
        cell.setup()
        cell.window(args.seconds)
        cell.release()
        gc.collect()
        torch.cuda.empty_cache()
        out = loop.readings(cell, seed in args.control_seeds)
        # each reading against the cell's limits, as a run compares them
        out["over_limits"] = {k: harness.over_limits(v, limits)
                              for k, v in out.items()}
        del cell
        gc.collect()
        torch.cuda.empty_cache()
        print(json.dumps({"seed": seed, "seconds": time.perf_counter() - t0,
                          **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
