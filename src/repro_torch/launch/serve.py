"""Serving entry point: batched prefill + autoregressive decode on one device.

Run: ``python -m repro_torch.launch.serve --arch chatglm3-6b [--smoke]
[--device cpu]``. The device is the CUDA card unless ``--device cpu`` is
given; without CUDA the default raises.

JAX's ``jit`` and ``donate_argnums=(2,)`` become eager calls and an in-place
cache update: each decode step writes its K/V rows into the caches that
prefill filled and ``pad_cache`` grew, and nothing in the loop waits on the
device (tokens stay on it until the caller reads them).
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.distributed.serve_step import (make_decode_step,
                                                make_prefill_step, pad_cache,
                                                sample)
from repro_torch.models import model as M


def _positions(cfg: ModelConfig, B: int, S: int, start: int = 0, *,
               device="cuda") -> torch.Tensor:
    base = torch.arange(start, start + S, dtype=torch.int32, device=device)
    if cfg.rope_kind == "mrope":
        return base[None, None].expand(3, B, S)
    return base[None].expand(B, S)


def generate(params, cfg: ModelConfig, prompts: torch.Tensor, *,
             max_new_tokens: int = 32, temperature: float = 0.0,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """prompts (B, S) int32 on the serving device -> (B, S + max_new_tokens)."""
    B, S = prompts.shape
    dev = resolve_device(prompts.device)
    prefill = make_prefill_step(cfg)
    decode = make_decode_step(cfg)

    batch = {"tokens": prompts, "positions": _positions(cfg, B, S, device=dev)}
    logits, cache = prefill(params, batch)
    cache = pad_cache(cache, cfg, S + max_new_tokens)
    tokens = [sample(logits, generator, temperature, cfg.vocab_size)]
    for t in range(max_new_tokens - 1):
        db = {"tokens": tokens[-1],
              "positions": _positions(cfg, B, 1, start=S + t, device=dev)}
        logits, cache = decode(params, db, cache)
        tokens.append(sample(logits, generator, temperature, cfg.vocab_size))
    return torch.cat([prompts] + [t.to(prompts.dtype) for t in tokens], dim=1)


def serve_batch(cfg: ModelConfig, *, n_requests: int = 8, prompt_len: int = 64,
                max_new_tokens: int = 16, seed: int = 0, params=None,
                quiet: bool = False, device="cuda") -> Dict[str, object]:
    """Batched-request serving measurement (throughput in tokens/s).

    Returns ``tokens_per_s`` and ``wall_s`` as the JAX version does, plus the
    generated ``tokens`` (B, prompt_len + max_new_tokens)."""
    dev = resolve_device(device)
    params = params if params is not None else M.init_params(cfg, seed=seed,
                                                             device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    prompts = torch.randint(0, cfg.vocab_size, (n_requests, prompt_len),
                            generator=gen, device=dev, dtype=torch.int32)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = generate(params, cfg, prompts, max_new_tokens=max_new_tokens,
                   generator=gen)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    toks = n_requests * max_new_tokens
    if not quiet:
        print(f"[serve] {n_requests} requests x {max_new_tokens} new tokens "
              f"in {dt:.2f}s -> {toks/dt:.1f} tok/s on {dev}")
    if out.shape != (n_requests, prompt_len + max_new_tokens):
        raise RuntimeError(f"generate returned shape {tuple(out.shape)}")
    if not bool(((out >= 0) & (out < cfg.vocab_size)).all()):
        raise RuntimeError("generate returned tokens outside the vocabulary")
    return {"tokens_per_s": toks / dt, "wall_s": dt, "tokens": out}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = (get_smoke_config(args.arch) if args.smoke
           else get_config(args.arch))
    serve_batch(cfg, n_requests=args.requests, prompt_len=args.prompt_len,
                max_new_tokens=args.max_new_tokens, device=args.device)


if __name__ == "__main__":
    main()
