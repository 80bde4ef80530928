"""Batched serving example on the port, the twin of the JAX package's
``examples/serve_lm.py``: prefill + autoregressive decode of random
prompts with a reduced (smoke) config of any of the 10 archs via --arch.

  PYTHONPATH=src python -m repro_torch.launch.serve_lm --arch chatglm3-6b
  PYTHONPATH=src python -m repro_torch.launch.serve_lm --arch mamba2-130m \
      --requests 16 --device cpu

It serves on the CUDA card unless ``--device cpu`` is given; without CUDA
the default raises. The example speaks of caches sharded over a host mesh,
which its run never builds (it serves in one process, and JAX's
``generate`` takes a mesh and never uses it); the twin serves in one
process too. Serving over a mesh of ranks, the caches split by
``cache_pspec``, is ``launch/serve.py``'s (``--model-parallel`` under
``torchrun``).
"""
from __future__ import annotations

import argparse

from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.launch.serve import serve_batch


def main(argv=None):
    """The example's run; returns ``serve_batch``'s stats."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="chatglm3-6b", choices=ARCH_IDS)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = get_smoke_config(args.arch)
    print(f"[serve_lm] {args.arch} (reduced config, "
          f"{cfg.num_params()/1e3:.0f}K params)")
    stats = serve_batch(cfg, n_requests=args.requests,
                        prompt_len=args.prompt_len,
                        max_new_tokens=args.max_new_tokens,
                        device=args.device)
    print(f"[serve_lm] {stats['tokens_per_s']:.1f} tokens/s")
    return stats


if __name__ == "__main__":
    main()
