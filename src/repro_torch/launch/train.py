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
any world size; a batch that does not divide goes to every rank whole.

On a mesh of several ranks the parameters and AdamW moments are laid out
as JAX's ``params_pspec``/``opt_state_pspec`` shard them
(``distributed/tensor_parallel.TrainLayout``), ZeRO-1 over ``data``: under
tp16 tensor parallelism over ``model`` (the hybrid family's Mamba2 heads
too), under dp_all (mamba2-130m) the vocabulary split over ``model``,
whose ranks hold other rows of the batch. Every rank builds the whole tree
from the seed and keeps its blocks, so a run starts from the same weights
on any mesh; a checkpoint holds the whole tree, gathered before rank 0
writes it (the JAX package's format), and a restore takes each rank's
blocks of it, on whatever mesh it runs (elastic restart).

On the card (the default) ranks use NCCL; with ``--device cpu``, gloo.

CPU example:
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \\
      --smoke --steps 20 --batch 8 --seq-len 256 --device cpu
Two data-parallel ranks on the CPU:
  PYTHONPATH=src torchrun --standalone --nproc-per-node 2 \\
      -m repro_torch.launch.train \\
      --arch mamba2-130m --smoke --steps 20 --batch 8 --seq-len 256 \\
      --device cpu
Tensor-parallel over four cards (a (1, 4) mesh, NCCL):
  PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \\
      -m repro_torch.launch.train --arch chatglm3-6b --steps 5 \\
      --batch 8 --seq-len 1024 --model-parallel 4
"""
from __future__ import annotations

import argparse
import functools
import statistics
import time
from typing import Any, Dict

import torch
import torch.distributed as dist

from repro_torch import tree as T
from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.pipeline import DataConfig, PrefetchingLoader, make_loader
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding as SH
from repro_torch.distributed import tensor_parallel as TP
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


def _restore(ckpt, layout, params, opt_state):
    """The latest checkpoint as (params, opt_state, step, meta): the whole
    tree onto the template's devices, or with a ``layout`` each rank's
    blocks of it (of any mesh's checkpoint: it holds the whole tree)."""
    if layout is None:
        r = ckpt.restore(template={"params": params, "opt": opt_state})
        return r["tree"]["params"], r["tree"]["opt"], r["step"], r["meta"]
    r = ckpt.restore()

    def read(prefix, tree, specs):
        leaves = []
        for path, leaf in T.flatten(tree):
            t = r["get"](f"{prefix}/{path}")
            if tuple(t.shape) != layout.shapes[path] or t.dtype != leaf.dtype:
                raise ValueError(f"{prefix}/{path}: checkpoint {t.dtype} "
                                 f"{tuple(t.shape)}, model {leaf.dtype} "
                                 f"{layout.shapes[path]}")
            leaves.append(layout.block(path, t, specs).to(leaf.device))
        return T.unflatten(tree, leaves)
    opt = adamw.OptState(
        step=r["get"]("opt/.step").to(opt_state.step.device),
        mu=read("opt/.mu", opt_state.mu, layout.moment_specs),
        nu=read("opt/.nu", opt_state.nu, layout.moment_specs))
    return (read("params", params, layout.specs), opt, r["step"],
            r["meta"])


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
    the log. On a mesh of several ranks ``params`` and ``opt_state`` are
    this rank's blocks (``TP.train_layout(cfg, mesh).gather_params`` makes
    them whole)."""
    dev = resolve_device(device)
    mesh = mesh if mesh is not None else make_host_mesh(device=dev)
    layout = TP.train_layout(cfg, mesh)
    opt_cfg = opt_cfg or adamw.OptimizerConfig(total_steps=max(steps, 2),
                                               warmup_steps=max(2, steps // 10))
    dp_axes = SH.batch_axes(mesh, cfg, global_batch)
    lead = _is_lead()
    say = lead and not quiet

    params = M.init_params(cfg, seed=seed, device=dev)
    if layout is not None:            # the whole tree is freed here
        params = layout.shard_params(params)
    opt_state = adamw.init(params, layout)
    dcfg = DataConfig(seq_len=seq_len, global_batch=global_batch, seed=seed)
    stream = make_loader(cfg, dcfg)

    start_step = 0
    ckpt = CheckpointManager(ckpt_dir) if ckpt_dir else None
    if ckpt and resume and ckpt.latest_step() is not None:
        params, opt_state, start_step, meta = _restore(ckpt, layout, params,
                                                       opt_state)
        # the cursor is the step (one batch a step); a checkpoint without
        # one (the JAX driver's) resumes the stream there
        stream.load_state_dict(meta.get(
            "data", {"step": start_step, "seed": seed}))
        if say:
            print(f"[train] resumed from step {start_step} onto {mesh.size} "
                  f"ranks", flush=True)

    def save(step: int):
        state = {"params": params, "opt": opt_state}
        if layout is not None:        # collective: every rank gathers
            state = {"params": layout.gather_params(params),
                     "opt": opt_state._replace(
                         mu=layout.gather_moments(opt_state.mu),
                         nu=layout.gather_moments(opt_state.nu))}
        if lead:
            ckpt.save(step, state,
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


def _peak_gb_by_rank(dev):
    """Every rank's ``max_memory_allocated`` in GB (collective), or None
    off the card."""
    if dev.type != "cuda":
        return None
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    if not dist.is_initialized():
        return [round(peak, 2)]
    t = torch.zeros(dist.get_world_size(), dtype=torch.float64, device=dev)
    t[dist.get_rank()] = peak
    dist.all_reduce(t)
    return [round(x, 2) for x in t.tolist()]


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
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="ranks of the mesh's model axis (tensor parallelism "
                         "under tp16, the vocabulary under dp_all)")
    args = ap.parse_args(argv)

    if args.smoke:
        overrides = {"d_model": args.d_model} if args.d_model else {}
        cfg = get_smoke_config(args.arch, **overrides)
    else:
        cfg = get_config(args.arch)
    try:
        mesh = make_host_mesh(args.model_parallel, device=args.device)
        out = train(cfg, steps=args.steps, global_batch=args.batch,
                    mesh=mesh,
                    seq_len=args.seq_len, ckpt_dir=args.ckpt_dir,
                    ckpt_every=args.ckpt_every, resume=args.resume,
                    accum_steps=args.accum,
                    compress_grads=args.compress_grads, device=args.device)
        peaks = _peak_gb_by_rank(resolve_device(args.device))
        if _is_lead():
            print(f"[train] done: final loss {out['final_loss']:.4f}")
            if len(out["step_s"]) > 1:
                med = statistics.median(out["step_s"][1:])
                print(f"[train] {mesh.shape} mesh: step {med:.4f} s (median "
                      f"after the first), "
                      f"{args.batch * args.seq_len / med:.0f} tokens/s"
                      + (f"; peak memory by rank {peaks} GB" if peaks
                         else ""), flush=True)
    finally:
        if dist.is_initialized():          # joined by train's host mesh
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
