"""Serving entry point: batched prefill + autoregressive decode, on one
device or tensor-parallel over a mesh of ranks.

Run: ``python -m repro_torch.launch.serve --arch chatglm3-6b [--smoke]
[--device cpu]``. The device is the CUDA card unless ``--device cpu`` is
given; without CUDA the default raises. Under ``torchrun``,
``--model-parallel N`` serves on the mesh (world / N, N) of axes ("data",
"model"), as ``launch/train.py`` trains: NCCL on the cards, one rank a
card, gloo with ``--device cpu``. Rank 0 prints.

On a mesh (``generate``'s ``mesh``, the mesh JAX's ``generate`` takes) the
ranks hold the parameters and caches as JAX's ``params_pspec`` and
``cache_pspec`` lay them out (``tensor_parallel.ServeLayout``): each data
rank serves its rows of the batch (``sharding.batch_axes``), the model
group runs the tensor-parallel prefill and decode steps (under dp_all only
the vocabulary is split), every rank samples from the logits gathered over
the vocabulary, and the tokens are gathered so that every rank returns the
whole batch. A batch that no batch axis divides (batch 1 on a mesh with
several data ranks) is served sequence-parallel: every rank holds the
whole batch and its block of the cache's sequence over ``data``, and a
decode step combines the blocks' softmax partials over the data group
(``tensor_parallel.SeqPar``). A config that the port cannot split raises
with the reason (``tensor_parallel.unsupported``); it is never served
whole instead.

JAX's ``jit`` and ``donate_argnums=(2,)`` become eager calls and an in-place
cache update: each decode step writes its K/V rows into the caches that
prefill filled and ``pad_cache`` grew, and nothing in the loop waits on the
device (tokens stay on it until the caller reads them; the collectives are
issued in one order on every rank).
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.distributed.serve_step import (make_decode_step,
                                                make_prefill_step, pad_cache,
                                                sample)
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import model as M


def _positions(cfg: ModelConfig, B: int, S: int, start: int = 0, *,
               device="cuda") -> torch.Tensor:
    base = torch.arange(start, start + S, dtype=torch.int32, device=device)
    if cfg.rope_kind == "mrope":
        return base[None, None].expand(3, B, S)
    return base[None].expand(B, S)


def generate(params, cfg: ModelConfig, prompts: torch.Tensor, *,
             max_new_tokens: int = 32, temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             mesh=None, max_len: Optional[int] = None) -> torch.Tensor:
    """prompts (B, S) int32 on the serving device -> (B, S + max_new_tokens).
    ``max_len``: the caches' capacity (default S + max_new_tokens).

    With a ``mesh`` of several ranks (see the module docstring) ``params``
    are this rank's blocks (``tensor_parallel.serve_layout(cfg, mesh,
    B).shard_params`` of the whole tree, or its ``init_params``) and
    ``prompts`` the whole batch on every rank; every rank returns the whole
    result. Temperature sampling gives the tokens of one-rank ``generate``
    from a generator seeded alike: every rank draws from the logits of the
    whole batch (gathered over its axes) and keeps its rows, so no two
    requests share their noise. A one-device local mesh (a Flux partition
    of one card, ``make_local_mesh``) serves as one rank, the prompts on
    its device; a local mesh of several devices raises NotImplementedError:
    ``generate`` over it runs on a group of ranks spawned over its devices
    (``launch/ranks.run_on_mesh``, the flux executor's route for such a
    partition), each with the group's mesh."""
    B, S = prompts.shape
    dev = resolve_device(prompts.device)
    layout = TP.serve_layout(cfg, mesh, B)
    TP.check_local(mesh, prompts, "the prompts")
    tp = layout.tp if layout is not None else None
    vtp = M.vocab_group(cfg, tp)
    capacity = max_len or S + max_new_tokens
    sp = layout.seq_par(capacity) if layout is not None else None
    if layout is not None:
        prompts = layout.my_rows(prompts)
    b = prompts.shape[0]
    prefill = make_prefill_step(cfg, tp, sp)
    decode = make_decode_step(cfg, tp, sp)

    def draw(logits):
        full = TP.gather_vocab(logits, vtp)
        if layout is None or temperature <= 0.0:
            return sample(full, generator, temperature, cfg.vocab_size)
        return layout.my_rows(sample(layout.gather_rows(full), generator,
                                     temperature, cfg.vocab_size))

    batch = {"tokens": prompts, "positions": _positions(cfg, b, S, device=dev)}
    logits, cache = prefill(params, batch)
    cache = pad_cache(cache, cfg, capacity if sp is None else sp.rows)
    tokens = [draw(logits)]
    for t in range(max_new_tokens - 1):
        db = {"tokens": tokens[-1],
              "positions": _positions(cfg, b, 1, start=S + t, device=dev)}
        logits, cache = decode(params, db, cache)
        tokens.append(draw(logits))
    out = torch.cat([prompts] + [t.to(prompts.dtype) for t in tokens], dim=1)
    return out if layout is None else layout.gather_rows(out)


def teacher_forced(params, cfg: ModelConfig, tokens: torch.Tensor,
                   prompt_len: int, *, layout=None, warm: bool = True,
                   keep_logits: bool = True, on_warm=None, on_prefill=None,
                   max_len: Optional[int] = None):
    """The prefill of ``tokens[:, :prompt_len]`` and the decode steps fed
    ``tokens[:, prompt_len + t]`` at step t, as ``generate`` runs them on
    its own samples, timed: a warm-up prefill (unless not ``warm``), the
    timed prefill, the timed decode loop. ``tokens`` (B, S + steps) is the
    whole batch; over a ``layout`` (a ``ServeLayout``; None: one rank) each
    rank runs its rows.

    Returns the prefill's seconds, the decode's ms a step, the logits of
    every step over the whole padded vocabulary for the whole batch,
    (steps, B, padded vocab) f32 on every rank (None unless
    ``keep_logits``: then the loop gathers nothing), and the final cache
    (this rank's blocks). ``on_warm()`` runs after the warm-up,
    ``on_prefill(cache)`` with the prefill's cache before the decode.
    ``max_len``: the caches' capacity (default the tokens' length)."""
    dev = resolve_device(tokens.device)
    S = prompt_len
    tp = layout.tp if layout is not None else None
    vtp = M.vocab_group(cfg, tp)
    capacity = max_len or tokens.shape[1]
    sp = layout.seq_par(capacity) if layout is not None else None
    rows = layout.my_rows(tokens) if layout is not None else tokens
    b, steps = rows.shape[0], tokens.shape[1] - S
    batch = {"tokens": rows[:, :S].contiguous(),
             "positions": _positions(cfg, b, S, device=dev)}
    prefill = make_prefill_step(cfg, tp, sp)
    decode = make_decode_step(cfg, tp, sp)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    if warm:
        prefill(params, batch)
        sync()
    if on_warm is not None:
        on_warm()
    t0 = time.perf_counter()
    lg, cache = prefill(params, batch)
    sync()
    prefill_s = time.perf_counter() - t0
    out = None
    if keep_logits:
        out = torch.empty((steps, b, cfg.padded_vocab), dtype=torch.float32,
                          device=dev)
        out[0] = TP.gather_vocab(lg, vtp)[:, 0]
    if on_prefill is not None:
        on_prefill(cache)
    cache = pad_cache(cache, cfg, capacity if sp is None else sp.rows)
    sync()
    t0 = time.perf_counter()
    for t in range(steps - 1):
        db = {"tokens": rows[:, S + t:S + t + 1],
              "positions": _positions(cfg, b, 1, start=S + t, device=dev)}
        lg, cache = decode(params, db, cache)
        if keep_logits:
            out[t + 1] = TP.gather_vocab(lg, vtp)[:, 0]
    sync()
    decode_ms = (time.perf_counter() - t0) * 1e3 / max(steps - 1, 1)
    if keep_logits and layout is not None:
        out = layout.gather_rows(out.transpose(0, 1).contiguous()
                                 ).transpose(0, 1)
    return prefill_s, decode_ms, out, cache


def serve_batch(cfg: ModelConfig, *, n_requests: int = 8, prompt_len: int = 64,
                max_new_tokens: int = 16, seed: int = 0, params=None,
                quiet: bool = False, device="cuda",
                mesh=None) -> Dict[str, object]:
    """Batched-request serving measurement (throughput in tokens/s).

    Returns ``tokens_per_s`` and ``wall_s`` as the JAX version does, plus the
    generated ``tokens`` (B, prompt_len + max_new_tokens). On a ``mesh`` of
    several ranks every rank draws the global prompts from the seed (as
    ``launch.train.train`` draws its batch) and serves its part
    (``generate``); ``params``, where given, is the whole tree, of which
    each rank keeps its blocks; else each rank draws only its blocks of the
    seed's weights (``ParamLayout.init_params``). The wall time is this
    rank's."""
    dev = resolve_device(device)
    layout = TP.serve_layout(cfg, mesh, n_requests)
    if params is None:
        params = (M.init_params(cfg, seed=seed, device=dev) if layout is None
                  else layout.init_params(seed, dev))
    elif layout is not None:
        params = layout.shard_params(params)
    gen = torch.Generator(device=dev).manual_seed(seed)
    prompts = torch.randint(0, cfg.vocab_size, (n_requests, prompt_len),
                            generator=gen, device=dev, dtype=torch.int32)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = generate(params, cfg, prompts, max_new_tokens=max_new_tokens,
                   generator=gen, mesh=mesh)
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
    ap.add_argument("--device", default="cuda",
                    help="cuda (NCCL between ranks) or cpu (gloo)")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="ranks of the mesh's model axis (tensor parallelism "
                         "under tp16, the vocabulary under dp_all)")
    args = ap.parse_args(argv)
    cfg = (get_smoke_config(args.arch) if args.smoke
           else get_config(args.arch))
    try:
        mesh = make_host_mesh(args.model_parallel, device=args.device)
        lead = not dist.is_initialized() or dist.get_rank() == 0
        res = serve_batch(cfg, n_requests=args.requests,
                          prompt_len=args.prompt_len,
                          max_new_tokens=args.max_new_tokens,
                          device=args.device, mesh=mesh, quiet=not lead)
        if lead:
            print(f"[serve] {mesh.shape} mesh: new tokens of request 0 "
                  f"{res['tokens'][0, args.prompt_len:].tolist()}",
                  flush=True)
        return res
    finally:
        if dist.is_initialized():          # joined by the host mesh
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
