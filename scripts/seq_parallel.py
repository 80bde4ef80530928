"""Run ``chip_smoke.py``'s phase 15 alone on one CUDA card: the decode
kernel's softmax partial, query heads padded to slots over ``model`` (16
ranks sharing the card over gloo) and the sequence-parallel decode of one
request (2 and 4 ranks), with every check of the phase. Builds the kernels
first. From the root of a checkout:

  python3 scripts/seq_parallel.py

It prints the phase's lines and, last, one JSON line of its launches and
the lse mode's reading.
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
    C.check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = C.card_line()
    print(f"[phase15] {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build_all()
    print(f"[phase15] kernels built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    launches, lse = C.seq_parallel_on_card(torch, card)
    print(json.dumps({"launches": launches, "lse_block": lse}), flush=True)


if __name__ == "__main__":
    main()
