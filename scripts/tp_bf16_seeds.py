"""Read the bf16 tensor-parallel gaps of ``chip_smoke.py``'s phases 12 (b)
and 13 (b) on other draws of the weights, without holding them to their
limits: for each seed, phase 12 (b)'s relative loss gaps (stablelm-3b and
zamba2-7b at ``TP_BF16``'s depths, 3 training steps on 2 ranks against
a one-rank run of the same weights) and phase 13 (b)'s logit gaps
(chatglm3-6b and zamba2-7b at full width and ``TPS_BF16_DEPTH``'s
layers, 8 x 1,024 + 32 on 2 ranks,
teacher-forced on a one-rank run's tokens, max|diff|/max|logit| of the
worst step). The prompts and the training batch stay those of the script's
seed; only the weights change. Then phase 13's decode-shape reading of the
split-row RMSNorm, once as ``chip_smoke.py`` takes it and once timed by the
CUDA graph alone. TP_FIRST_LOSS_GAP, TP_LOSS_GAP and TPS_BF16_TOL are set
from these readings.

Needs one CUDA card; from the root of a checkout:

  python3 scripts/tp_bf16_seeds.py [SEED ...]     # default: 1 2 3 4

It prints one JSON line last and writes it to chiprun_out/tp_bf16_seeds.json.
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
    seeds = [int(a) for a in sys.argv[1:]] or [1, 2, 3, 4]
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
    out = {"card": card, "tp_first_loss_gap": C.TP_FIRST_LOSS_GAP,
           "tp_loss_gap": C.TP_LOSS_GAP,
           "tps_bf16_tol": C.TPS_BF16_TOL, "seeds": {}}
    norm = C.split_norm_decode_on_card(torch, card)
    graph = C.split_norm_decode_on_card(torch, card, tries=0)
    out["split_norm_decode"] = {
        "checked": {k: norm[k] for k in ("sumsq_ms", "scale_ms", "ms",
                                         "bound_ms", "timed_by")},
        "graph": {k: graph[k] for k in ("sumsq_ms", "scale_ms", "ms",
                                        "timed_by")}}
    for seed in seeds:
        t0 = time.perf_counter()
        _, train = C.tp_bf16_on_card(torch, card, seed, hold=False)
        _, serve = C.tps_bf16_on_card(torch, card, seed, hold=False)
        out["seeds"][seed] = {"train_loss_gaps": train,
                              "serve_logit_gap": serve}
        print(f"[seeds] seed {seed}: phase 12 (b) loss gaps {train}; phase "
              f"13 (b) logit gaps {serve}; {time.perf_counter() - t0:.1f} s "
              f" [{card}]", flush=True)
        torch.cuda.empty_cache()
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    line = json.dumps(out)
    with open(os.path.join(ROOT, "chiprun_out", "tp_bf16_seeds.json"),
              "w") as f:
        f.write(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()
