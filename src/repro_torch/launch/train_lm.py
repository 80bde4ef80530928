"""End-to-end LM pretraining example on the port, the twin of the JAX
package's ``examples/train_lm.py``: a ~100M-parameter mamba2-family model
trained for a few hundred steps with checkpoint/restart, through
``launch/train.py``'s ``train()``.

Full run:
  PYTHONPATH=src python -m repro_torch.launch.train_lm --steps 300
Quick check on the CPU:
  PYTHONPATH=src python -m repro_torch.launch.train_lm --steps 30 \
      --d-model 256 --device cpu

It trains on the CUDA card unless ``--device cpu`` is given; without CUDA
the default raises. The checkpoints go under the temporary directory
(``TMPDIR``) unless ``--ckpt-dir`` names another.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

from repro_torch.configs import get_config
from repro_torch.launch.train import train


def main(argv=None):
    """The example's run; returns ``train``'s dict."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=512)
    ap.add_argument("--d-model", type=int, default=768,
                    help="768 = the true mamba2-130m width (~130M params)")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_train_lm"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config("mamba2-130m")
    if args.d_model != cfg.d_model:
        cfg = dataclasses.replace(
            cfg, d_model=args.d_model,
            num_layers=max(2, cfg.num_layers * args.d_model // 768 // 2))
    print(f"[train_lm] {cfg.name}: {cfg.num_params()/1e6:.1f}M params, "
          f"{cfg.num_layers} layers, d_model={cfg.d_model}")
    out = train(cfg, steps=args.steps, global_batch=args.batch,
                seq_len=args.seq_len, ckpt_dir=args.ckpt_dir,
                ckpt_every=50, resume=args.resume, log_every=10,
                device=args.device)
    first, last = out["losses"][0], out["final_loss"]
    print(f"[train_lm] loss {first:.3f} -> {last:.3f} over {args.steps} steps")
    if not last < first:
        raise RuntimeError("training failed to reduce loss")
    return out


if __name__ == "__main__":
    main()
