"""Read the gap of ``chip_smoke.py`` phase 15 (c)'s bf16 sequence-parallel
decode on other draws of the weights, without holding it to its limit: for
each seed, zamba2-7b bf16 at full size, one prompt of 32,800 tokens and 8
new ones with a cache of 40,960 positions, on (2, 1) (two ranks sharing
the card over gloo, the cache's sequence over ``data``) teacher-forced on
a one-rank run's tokens, max|diff|/max|logit| of the worst step.
SEQ_BF16_TOL is set from these readings (twice the largest, rounded up).

Needs one CUDA card; from the root of a checkout:

  python3 scripts/seq_decode_bf16_seeds.py [SEED ...]     # default: 0 1 2 3

It prints one JSON line last.
"""
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as C  # noqa: E402


def main():
    import torch
    seeds = [int(a) for a in sys.argv[1:]] or [0, 1, 2, 3]
    C.check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = C.card_line()
    print(f"[seeds] {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build_all()
    print(f"[seeds] kernels built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    out = {"card": card, "seq_bf16_tol": C.SEQ_BF16_TOL, "seeds": {}}
    for seed in seeds:
        t0 = time.perf_counter()
        out["seeds"][seed] = C.seq_bf16_gap_of_seed(torch, card, seed)
        print(f"[seeds] seed {seed}: gap {out['seeds'][seed]:.4e}; "
              f"{time.perf_counter() - t0:.1f} s  [{card}]", flush=True)
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
