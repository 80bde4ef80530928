"""Time the training driver's step in a given checkout, to compare two
commits on one card: mamba2-130m at full size through
``repro_torch.launch.train.train()``, 12 steps of 8 x 512 tokens, the
median of steps 2-12 (the host-bound step of phase 8 of chip_smoke.py).

  python scripts/driver_step.py PATH_TO_CHECKOUT

Run it for each checkout in turns (parent, change, change, parent) in one
call on the card.
"""
import os
import statistics
import sys

if __name__ == "__main__":
    root = os.path.abspath(sys.argv[1])
    sys.path.insert(0, os.path.join(root, "src"))
    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.launch.train import train
    if not repro_torch.__file__.startswith(root):
        raise SystemExit(f"imported {repro_torch.__file__}, not {root}")
    out = train(get_config("mamba2-130m"), steps=12, global_batch=8,
                seq_len=512, quiet=True)
    print(f"[driver_step] {sys.argv[1]}: mamba2-130m step median "
          f"{statistics.median(out['step_s'][1:]):.4f} s (steps 2-12); "
          f"losses {out['losses'][:3]}", flush=True)
