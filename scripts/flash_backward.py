"""Run ``chip_smoke.py``'s flash-attention reading at stablelm-3b's training
shape alone on one CUDA card: the forward kernel, the backward kernel (held
against the plain vjp in f32, then timed through autograd and alone, with
each of its two kernels' device time), the plain version's vjp and SDPA's
forward and backward. Builds the kernels first. From the root of a
checkout:

  python3 scripts/flash_backward.py

It prints the reading's lines and, last, one JSON line of its record.
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
    import torch.nn.functional as F
    C.check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = C.card_line()
    print(f"[flash backward] {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build_all()
    print(f"[flash backward] kernels built in {time.perf_counter() - t0:.1f}"
          f" s", flush=True)
    cfg = get_config("stablelm-3b")
    B, S = C.TRAIN_BATCH, C.TRAIN_SEQ
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    gen = torch.Generator(device="cuda").manual_seed(C.SEED)
    q, k, v = (torch.randn((B, S, n, hd), generator=gen, device="cuda"
                           ).to(torch.bfloat16) for n in (H, KV, KV))
    r = C.flash_backward_times(torch, F, C.Timer(torch), q, k, v,
                               hd ** -0.5, card)
    print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main()
