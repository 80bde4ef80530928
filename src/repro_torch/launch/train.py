"""End-to-end training driver of the port, as the JAX package's
``repro/launch/train.py``.

Builds the mesh and the batch axes, runs the data pipeline, train steps,
periodic checkpointing with restart (``--resume`` restores the latest step
and the data cursor; checkpoints hold the whole tree, so a run resumes onto
another number of ranks: elastic restart), and optional int8 gradient
compression.

Data parallelism: every rank draws the *global* batch from the stream (one
host) and keeps its rows inside the step (``distributed/compression.py``,
by ``sharding.batch_axes``), so the global batch at a step is the same at
any world size; a batch that does not divide goes to every rank whole. The
parameters and optimizer state are replicated: the tensor-parallel and
ZeRO-1 layouts of ``distributed/sharding.py`` are not executed (ROADMAP.md,
item 12b), and a tp16 model on a mesh whose ``model`` axis is larger than 1
is refused. Under the dp_all policy the vocab matrices, which JAX splits
over ``model``, stay whole on every rank (the same arithmetic).

On the card (the default) ranks use NCCL; with ``--device cpu``, gloo.

CPU example:
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \\
      --smoke --steps 20 --batch 8 --seq-len 256 --device cpu
Two data-parallel ranks on the CPU:
  PYTHONPATH=src torchrun --standalone --nproc-per-node 2 \\
      -m repro_torch.launch.train \\
      --arch mamba2-130m --smoke --steps 20 --batch 8 --seq-len 256 \\
      --device cpu
"""
from __future__ import annotations

import argparse
import functools
import time
from typing import Any, Dict

import torch
import torch.distributed as dist

from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.pipeline import DataConfig, PrefetchingLoader, make_loader
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.train_step import make_train_step
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import model as M
from repro_torch.optim import adamw


def _host_batch(batch, *, pin: bool) -> Dict[str, torch.Tensor]:
    """A numpy batch as CPU tensors, in page-locked memory for the card (run
    in the prefetch thread, so the copy to the card can be asynchronous)."""
    out = {k: torch.from_numpy(v) for k, v in batch.items()}
    return {k: v.pin_memory() for k, v in out.items()} if pin else out


def _is_lead() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def train(cfg, *, steps: int, global_batch: int, seq_len: int,
          mesh=None, ckpt_dir: str = "", ckpt_every: int = 0,
          resume: bool = False, accum_steps: int = 1,
          compress_grads: bool = False, log_every: int = 10,
          seed: int = 0, opt_cfg=None, quiet: bool = False,
          device="cuda") -> Dict[str, Any]:
    """Train ``cfg`` from step 0 (or the latest checkpoint) to ``steps``.

    Returns JAX's dict (``losses``, ``params``, ``opt_state``,
    ``final_loss``, ``steps``) and ``step_s``: each step's seconds, from
    taking its batch to reading its loss. Rank 0 writes the checkpoints and
    the log."""
    dev = resolve_device(device)
    mesh = mesh if mesh is not None else make_host_mesh(device=dev)
    if SH.policy_for(cfg) == "tp16" and mesh.shape.get(SH.MODEL_AXIS, 1) > 1:
        raise NotImplementedError(
            f"{cfg.name} takes the tp16 policy, and tensor-parallel "
            f"execution over the model axis ({mesh.shape[SH.MODEL_AXIS]} "
            f"ranks here) is not ported (ROADMAP.md, item 12b)")
    opt_cfg = opt_cfg or adamw.OptimizerConfig(total_steps=max(steps, 2),
                                               warmup_steps=max(2, steps // 10))
    dp_axes = SH.batch_axes(mesh, cfg, global_batch)
    lead = _is_lead()
    say = lead and not quiet

    params = M.init_params(cfg, seed=seed, device=dev)
    opt_state = adamw.init(params)
    dcfg = DataConfig(seq_len=seq_len, global_batch=global_batch, seed=seed)
    stream = make_loader(cfg, dcfg)

    start_step = 0
    ckpt = CheckpointManager(ckpt_dir) if ckpt_dir else None
    if ckpt and resume and ckpt.latest_step() is not None:
        restored = ckpt.restore(template={"params": params, "opt": opt_state})
        params = restored["tree"]["params"]
        opt_state = restored["tree"]["opt"]
        start_step = restored["step"]
        # the cursor is the step (one batch a step); a checkpoint without
        # one (the JAX driver's) resumes the stream there
        stream.load_state_dict(restored["meta"].get(
            "data", {"step": start_step, "seed": seed}))
        if say:
            print(f"[train] resumed from step {start_step} onto {mesh.size} "
                  f"ranks", flush=True)

    def save(step: int):
        if lead:
            ckpt.save(step, {"params": params, "opt": opt_state},
                      extra_meta={"data": {"step": step, "seed": seed}})

    step_fn = make_train_step(
        cfg, opt_cfg, accum_steps=accum_steps,
        grad_compression="int8" if compress_grads else None,
        mesh=mesh, dp_axes=dp_axes)
    loader = PrefetchingLoader(
        map(functools.partial(_host_batch, pin=dev.type == "cuda"), stream),
        depth=dcfg.prefetch)

    losses, step_s = [], []
    t0 = time.time()
    try:
        for step in range(start_step, steps):
            t = time.perf_counter()
            batch = {k: v.to(dev, non_blocking=True)
                     for k, v in next(loader).items()}
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            loss = metrics["loss"].item()
            step_s.append(time.perf_counter() - t)
            losses.append(loss)
            if say and (step % log_every == 0 or step == steps - 1):
                print(f"[train] step {step:5d} loss {loss:8.4f} "
                      f"gnorm {metrics['grad_norm'].item():7.3f} "
                      f"lr {metrics['lr'].item():.2e} "
                      f"({time.time() - t0:.1f}s)", flush=True)
            if ckpt and ckpt_every and (step + 1) % ckpt_every == 0:
                save(step + 1)
        if ckpt:
            save(steps)
            ckpt.wait()
    finally:
        loader.close()
    return {"losses": losses, "params": params, "opt_state": opt_state,
            "final_loss": losses[-1] if losses else float("nan"),
            "steps": steps, "step_s": step_s}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--d-model", type=int, default=0,
                    help="override d_model for --smoke scaling")
    ap.add_argument("--device", default="cuda",
                    help="cuda (NCCL between ranks) or cpu (gloo)")
    args = ap.parse_args(argv)

    if args.smoke:
        overrides = {"d_model": args.d_model} if args.d_model else {}
        cfg = get_smoke_config(args.arch, **overrides)
    else:
        cfg = get_config(args.arch)
    try:
        out = train(cfg, steps=args.steps, global_batch=args.batch,
                    seq_len=args.seq_len, ckpt_dir=args.ckpt_dir,
                    ckpt_every=args.ckpt_every, resume=args.resume,
                    accum_steps=args.accum,
                    compress_grads=args.compress_grads, device=args.device)
        if _is_lead():
            print(f"[train] done: final loss {out['final_loss']:.4f}")
    finally:
        if dist.is_initialized():          # joined by train's host mesh
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
