"""Dry-run of every (architecture x input-shape x mesh) cell of the port on
fake tensors: the counterpart of the JAX package's ``repro/launch/dryrun.py``,
which lowers and compiles each cell on 512 placeholder CPU devices.

PyTorch has no ahead-of-time compile. Each cell runs its train, prefill or
decode step once under ``FakeTensorMode`` (shapes and dtypes, no memory, no
arithmetic) and ``opprof.OpProfile`` (every aten op counted), with
``use_pallas=False``: the CUDA kernels are ``ctypes`` calls and cannot run
on fake tensors, and JAX's dry-run ran its plain path too. The step runs the
rank's own batch, the global batch over the size of ``sharding.batch_axes``:

  * train cells run ``make_train_step`` with the production mesh's data
    axes on rank 0 of a fake process group of the mesh's size (c10d's
    ``fake`` backend: every collective returns at once), on the global
    batch, of which the rank keeps its rows: the exact per-rank program the
    port runs, its gradient mean's all-reduces included. A tp16 cell's rank
    holds its blocks of the parameters and of the ZeRO-1 moments and runs
    the tensor-parallel step (``distributed/tensor_parallel.py``), the
    hybrid family's too; a dp_all cell's rank holds its block of the
    vocabulary and its ZeRO-1 moments. Its FLOPs, bytes and collectives
    are that rank's own;
  * prefill and decode cells run the per-rank serving program on rank 0
    of the fake group too (``tensor_parallel.ServeLayout``, as
    ``launch.serve.generate(mesh=)`` serves): the rank's rows of the batch
    (``batch_axes`` of the serving batch), its blocks of the parameters
    and, for decode, of the cache (``model.init_cache(mesh=)`` by
    ``cache_pspec``); under tp16 the tensor-parallel prefill or decode
    step, under dp_all the split vocabulary. Their records carry the
    collectives. The long_500k cells (batch 1, which no batch axis
    divides) run the sequence-parallel decode step: the rank's block of
    the cache's 524,288 positions over ``data`` (524,288 / 16), the data
    group's two all-reduces a shared-block call (``combine_partials``)
    among its collectives (``seq_parallel`` in the record).

What the record holds, per device:
  * ``memory.argument_size_in_bytes``: parameters, ZeRO-1 optimizer state,
    batch and decode cache, each leaf's bytes over the mesh axes its spec in
    ``distributed/sharding.py`` shards it over;
  * ``memory.temp_size_in_bytes``: the peak of the live bytes the step
    allocated above its arguments (``output_size_in_bytes``: what it
    returned), of the program the port runs;
  * ``cost``: the FLOPs (``matmul_flops``: mm, bmm, addmm, baddbmm) and
    the bytes of every op's inputs and outputs (unfused: an upper bound on
    XLA's post-fusion "bytes accessed");
  * ``collectives``: what the step ran, by kind (``dp_all`` cells,
    mamba2-130m: the model group's tokens, labels and hidden rows gathered
    for the split vocabulary, the loss's all-reduces, the gradient mean
    over all 256 ranks (the vocabulary's over ``data``) and the ZeRO-1
    all-gathers; tp16 cells: the tensor-parallel all-reduces, the gradient
    mean over ``data`` and the ZeRO-1 all-gathers; serving cells: the
    tensor-parallel all-reduces, under dp_all the vocabulary's);
  * ``roofline``: ``roofline.derive`` in H100 terms.

A cell whose tensor-parallel program the port lacks is skipped, with the
reason (``tensor_parallel.unsupported``: SSD heads that do not divide over
the ``model`` axis, or query heads that no padded layout keeps on one kv
head a rank); none of the 80 is. The query heads of qwen2-vl-7b (28) and
musicgen-medium (24), which do not divide over 16 model ranks, are padded
to 32 slots (``tensor_parallel.head_slots``): their records say how
(``heads``), with the matmul FLOPs the padding adds against an even split
of the heads.

Usage:
  python -m repro_torch.launch.dryrun --arch gemma-7b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --sweep --out results/dryrun_torch.json
  python -m repro_torch.launch.dryrun --table --out results/dryrun_torch.json
"""
from __future__ import annotations

import argparse
import ast
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import tree as T
from repro_torch.configs import ARCH_IDS, SHAPES, cell_is_runnable, get_config
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed import sharding as SH
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.distributed.serve_step import (make_decode_step,
                                                make_prefill_step)
from repro_torch.distributed.train_step import make_train_step
from repro_torch.launch import opprof
from repro_torch.launch import roofline as RL
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import Mesh, make_mesh, make_production_mesh
from repro_torch.models.model import init_cache
from repro_torch.optim.adamw import OptimizerConfig


def _sharded_bytes(tree, specs: Dict[str, Tuple], mesh: Mesh) -> int:
    """Bytes per device of a tree of (meta) tensors under ``specs``."""
    total = 0
    for path, leaf in T.flatten(tree):
        spec = specs[path]
        split = math.prod(mesh.axes_size(SH._axes_of(e)) for e in spec)
        total += leaf.numel() * leaf.element_size() // split
    return total


def _batch_spec(cfg: ModelConfig, mesh: Mesh, shape: ShapeConfig, batch):
    bp = SH.batch_pspec(cfg, mesh, shape.global_batch)
    if shape.kind != "decode":
        return {k: bp[k] for k in batch}
    bax = SH._entry(SH.batch_axes(mesh, cfg, shape.global_batch))
    return {k: ((None, bax, None) if k == "positions" and
                cfg.rope_kind == "mrope" else
                (bax, None, None) if k == "embeds" else (bax, None))
            for k in batch}


def argument_bytes(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh) -> int:
    """The step's argument bytes per device under the port's specs."""
    params = SP.params_struct(cfg)
    n = _sharded_bytes(params, SH.params_pspec(cfg, mesh, params), mesh)
    if shape.kind == "train":
        opt = SP.opt_state_struct(params)
        n += _sharded_bytes(opt, SH.opt_state_pspec(cfg, mesh, opt), mesh)
        batch = SP.train_input_specs(cfg, shape)
    elif shape.kind == "prefill":
        batch = SP.prefill_input_specs(cfg, shape)
    else:
        batch, cache = SP.decode_input_specs(cfg, shape)
        n += _sharded_bytes(cache, SH.cache_pspec(cfg, mesh,
                                                  shape.global_batch), mesh)
    spec = _batch_spec(cfg, mesh, shape, batch)
    return n + _sharded_bytes(batch, {k: spec[k] for k in batch}, mesh)


@dataclasses.dataclass
class Cell:
    """One cell's step, ready to run: ``run`` gives its ``OpProfile``."""
    cfg: ModelConfig
    shape: ShapeConfig
    mesh: Mesh
    dp_axes: Tuple[str, ...]
    rows: int                                  # the rank's batch rows

    @property
    def per_rank(self) -> bool:
        """Whether the step is a rank's program over the mesh."""
        return self.mesh.size > 1

    def inputs(self, make, layout=None):
        """The step's arguments, each leaf ``make(meta tensor)``; with the
        step's ``layout``, the rank's blocks of the parameters, of the
        moments (train) and of the decode cache."""
        cfg, shape = self.cfg, self.shape
        params = SP.params_struct(cfg)
        if layout is not None:
            params = layout.shard_params(params)
        params = T.tree_map(make, params)
        if shape.kind == "train":
            # every rank draws the global batch and keeps its rows
            return (params, SP.opt_state_struct(params, layout),
                    T.tree_map(make, SP.train_input_specs(cfg, shape)))
        local = dataclasses.replace(shape, global_batch=self.rows)
        if shape.kind == "prefill":
            return params, T.tree_map(make, SP.prefill_input_specs(cfg, local))
        batch, cache = SP.decode_input_specs(cfg, local)
        if layout is not None:
            cache = init_cache(cfg, shape.global_batch, shape.seq_len,
                               device="meta", mesh=self.mesh)
        return params, T.tree_map(make, batch), T.tree_map(make, cache)

    def step(self, mesh: Mesh):
        """The step on ``mesh``, with its ``layout`` (None on one rank)."""
        if self.shape.kind == "train":
            return make_train_step(self.cfg, OptimizerConfig(), mesh=mesh,
                                   dp_axes=self.dp_axes)
        layout = (TP.serve_layout(self.cfg, mesh, self.shape.global_batch)
                  if self.per_rank else None)
        tp = layout.tp if layout is not None else None
        sp = (layout.seq_par(self.shape.seq_len) if layout is not None
              and self.shape.kind == "decode" else None)
        step = (make_prefill_step(self.cfg, tp) if self.shape.kind ==
                "prefill" else make_decode_step(self.cfg, tp, sp))
        step.layout = layout
        return step

    def run(self, *, device="cpu", fake: bool = True,
            mesh: Optional[Mesh] = None) -> opprof.OpProfile:
        """Run the step once under ``OpProfile``: on fake tensors (the
        dry-run), or on real ones on ``device`` (random values in each
        leaf's dtype, zero integers). A train step over several ranks runs
        on rank 0 of a fake process group, or on ``mesh``, a mesh of this
        cell's shape over real ranks (each rank runs this). Returns the
        profile, with ``argument_bytes`` (the arguments' storages) and
        ``output_bytes`` (what the step returned) set."""
        world = self.per_rank and mesh is None
        with _fake_world(self.mesh) if world else contextlib.nullcontext(
                mesh or self.mesh) as mesh:
            step = self.step(mesh)
            # every input is made under the fake mode: no real tensor in
            mode = (FakeTensorMode(allow_non_fake_inputs=False) if fake
                    else contextlib.nullcontext())
            with mode:
                args = self.inputs(lambda m: _make(m, device),
                                   getattr(step, "layout", None))
            prof = opprof.OpProfile()
            prof.argument_bytes = prof.hold(args)
            with mode, prof:
                out = step(*args)
            prof.output_bytes = prof.live_bytes
            del out, args
        return prof


def _make(m: torch.Tensor, device) -> torch.Tensor:
    """A tensor of ``m``'s shape and dtype on ``device``, drawn in its own
    dtype (no wider copy raises the peak before the step)."""
    if m.dtype.is_floating_point:
        return torch.randn(m.shape, dtype=m.dtype, device=device).mul_(0.02)
    return torch.zeros(m.shape, dtype=m.dtype, device=device)


@contextlib.contextmanager
def _fake_world(mesh: Mesh):
    """Rank 0 of a fake process group of ``mesh.size`` ranks (c10d's
    ``fake`` backend), with ``mesh``'s axes over it; torn down after."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry-run needs a process without a process "
                           "group")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=mesh.size)
    try:
        yield make_mesh(tuple(mesh.shape.values()), mesh.axis_names,
                        device="cpu")
    finally:
        dist.destroy_process_group()


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               cfg_overrides: Optional[Dict[str, Any]] = None, *,
               shape: Optional[ShapeConfig] = None,
               mesh: Optional[Mesh] = None):
    """Build the cell's step on the plain path. Returns (cell, meta), or
    (None, {"skipped": why}). ``shape`` and ``mesh`` replace the named
    shape and the production mesh (a cell of another size, as chip_smoke.py
    runs on one card)."""
    cfg = dataclasses.replace(get_config(arch, **(cfg_overrides or {})),
                              use_pallas=False)
    shape = shape or SHAPES[shape_name]
    ok, why = cell_is_runnable(cfg, shape)
    if not ok:
        return None, {"skipped": why}
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    dp_axes = (SH.batch_axes(mesh, cfg) if shape.kind == "train" else
               SH.batch_axes(mesh, cfg, shape.global_batch))
    why = TP.unsupported(cfg, mesh)
    if why:
        return None, {"skipped": f"skip: {why}"}
    cell = Cell(cfg, shape, mesh, dp_axes,
                shape.global_batch // mesh.axes_size(dp_axes))
    meta = {"arch": arch, "shape": shape.name,
            "mesh": "multi_pod" if multi_pod else "single_pod",
            "n_devices": mesh.size, "cfg": cfg, "shape_cfg": shape}
    return cell, meta


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             cfg_overrides: Optional[Dict[str, Any]] = None,
             verbose: bool = True) -> Dict[str, Any]:
    """Full cell record: the full-depth step on fake tensors -> memory,
    cost, collectives and the roofline terms."""
    mesh_name = "multi_pod" if multi_pod else "single_pod"
    base = {"arch": arch, "shape": shape_name, "mesh": mesh_name}
    t0 = time.time()
    try:
        cell, meta = lower_cell(arch, shape_name, multi_pod, cfg_overrides)
        if cell is None:
            return {**base, "status": "skipped", "why": meta["skipped"]}
        prof = cell.run()
        args = argument_bytes(cell.cfg, cell.shape, cell.mesh)
    except Exception as e:                        # one cell's fault: recorded
        return {**base, "status": "compile_error",
                "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-2000:]}
    run_s = time.time() - t0
    cfg, mesh = cell.cfg, cell.mesh
    coll = prof.collective_bytes()
    cost = {"flops": prof.flops, "bytes accessed": prof.bytes,
            "matmul_flops": prof.matmul_flops}
    notes = layout_notes(cfg, cell.shape, mesh, cell.dp_axes)
    axes = cell.dp_axes
    if cell.per_rank and SH.policy_for(cfg) == "tp16":
        axes = (*axes, SH.MODEL_AXIS)         # the tensor-parallel ones too
    if "seq_parallel" in notes:
        axes = (*axes, SH.DATA_AXIS)          # the partials' combine
    terms = RL.derive(arch, cell.shape, cfg, mesh_name, mesh.size, cost, coll,
                      peak_bytes_dev=prof.peak_bytes,
                      link_bw=RL.link_bandwidth(mesh.shape, axes))
    rec = {**base, "status": "ok", "n_devices": mesh.size,
           "compile_s": round(run_s, 1), "probe_compile_s": 0.0,
           "memory": {"argument_size_in_bytes": args,
                      "output_size_in_bytes": prof.output_bytes,
                      "temp_size_in_bytes": prof.peak_bytes},
           "cost": cost,
           "collectives": {k: (round(v) if isinstance(v, float) else v)
                           for k, v in coll.items()},
           "roofline": terms.to_dict(),
           "rows_per_rank": cell.rows, "n_ops": prof.n_ops,
           "program": "per rank" if cell.per_rank else "one rank"}
    rec.update(notes)
    if verbose:
        print(f"[dryrun] {arch} x {shape_name} x {mesh_name}: "
              f"run {run_s:.1f}s  "
              f"compute {terms.compute_s*1e3:.2f}ms  "
              f"memory {terms.memory_s*1e3:.2f}ms  "
              f"coll {terms.collective_s*1e3:.2f}ms  "
              f"-> {terms.bottleneck}  hw_frac={terms.hw_frac:.3f}  "
              f"useful={terms.useful_ratio:.2f}", flush=True)
    return rec


def layout_notes(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh,
                 dp_axes) -> Dict[str, Any]:
    """What a cell's record says of the port's layouts beyond the specs:
    ``heads``, where the query heads are padded to slots over ``model``
    (the slots a rank, the ranks holding padding alone, and the matmul
    FLOPs a rank's padded slots add to the q and out projections against
    an even split of the heads, H / n a rank, at this cell's tokens a
    rank, forward and, for train, backward); ``seq_parallel``, where the
    decode cache's sequence is split over ``data`` (its ranks and the
    positions of a rank's block; not for the ssm family, whose cache has no
    sequence)."""
    out: Dict[str, Any] = {}
    n = mesh.shape.get(SH.MODEL_AXIS, 1)
    slots = TP.head_slots(cfg, n)
    if slots is not None:
        tokens = (shape.global_batch // mesh.axes_size(dp_axes)
                  * (1 if shape.kind == "decode" else shape.seq_len))
        extra = slots.per_rank - cfg.num_heads / n       # heads a rank
        passes = 3 if shape.kind == "train" else 1
        out["heads"] = {
            "layout": ("kv groups padded" if cfg.num_heads > cfg.num_kv_heads
                       else "padded at the tail"),
            "heads": cfg.num_heads, "slots": len(slots.heads),
            "slots_per_rank": slots.per_rank,
            "padding_only_ranks": sum(not slots.real(r)[1]
                                      for r in range(n)),
            "padding_matmul_flops": round(
                passes * 2 * 2 * tokens * cfg.d_model * cfg.head_dim
                * extra * cfg.num_layers)}
    if (shape.kind == "decode" and cfg.family != "ssm"
            and not SH.batch_axes(mesh, cfg, shape.global_batch)):
        n_data = mesh.shape.get(SH.DATA_AXIS, 1)
        if n_data > 1:
            out["seq_parallel"] = {"data_ranks": n_data,
                                   "block_positions": shape.seq_len // n_data}
    return out


def table_rows(recs) -> list:
    """The roofline table of ``benchmarks/roofline_table.py``, one row per
    ok cell and a summary, from dry-run records."""
    ok = [r for r in recs if r.get("status") == "ok"]
    skipped = [r for r in recs if r.get("status") == "skipped"]
    rows = []
    for r in sorted(ok, key=lambda r: (r["mesh"], r["arch"], r["shape"])):
        t = r["roofline"]
        rows.append({
            "name": f"roofline.{r['mesh']}.{r['arch']}.{r['shape']}",
            "us_per_call": round(t["step_time_s"] * 1e6),
            "derived": (f"compute={t['compute_s']*1e3:.1f}ms "
                        f"memory={t['memory_s']*1e3:.1f}ms "
                        f"coll={t['collective_s']*1e3:.1f}ms "
                        f"bound={t['bottleneck']} "
                        f"useful={t['useful_ratio']:.2f} "
                        f"hw_frac={t['hw_frac']:.3f}"),
        })
    rows.append({
        "name": "roofline.summary", "us_per_call": 0,
        "derived": (f"{len(ok)} cells run, {len(skipped)} skipped "
                    f"(long_500k on full-attention archs, per spec); H100 "
                    f"data-sheet terms"),
    })
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--table", action="store_true",
                    help="print the roofline table of the records in --out")
    ap.add_argument("--out", default="results/dryrun_torch.json")
    ap.add_argument("--resume", action="store_true",
                    help="skip cells already in --out")
    ap.add_argument("--set", action="append", default=[],
                    help="config override key=value (repeatable); "
                         "values parsed as python literals where possible")
    args = ap.parse_args()

    if args.table:
        with open(args.out) as f:
            for row in table_rows(json.load(f)):
                print(f"{row['name']},{row['us_per_call']},{row['derived']}")
        return

    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        try:
            overrides[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            overrides[k] = v

    if not args.sweep:
        rec = run_cell(args.arch, args.shape, args.mesh == "multi",
                       cfg_overrides=overrides or None)
        print(json.dumps(rec, indent=2, default=str))
        if rec["status"] == "compile_error":
            raise SystemExit(1)
        return

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results = []
    done = set()
    if args.resume and os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
        done = {(r["arch"], r["shape"], r["mesh"]) for r in results
                if r["status"] in ("ok", "skipped")}
    n_err = 0
    for mesh_name in ("single_pod", "multi_pod"):
        for arch in ARCH_IDS:
            for shape_name in SHAPES:
                key = (arch, shape_name, mesh_name)
                if key in done:
                    continue
                rec = run_cell(arch, shape_name, mesh_name == "multi_pod",
                               cfg_overrides=overrides or None)
                results = [r for r in results
                           if (r["arch"], r["shape"], r["mesh"]) != key]
                results.append(rec)
                if rec["status"] == "compile_error":
                    n_err += 1
                    print(f"[dryrun] ERROR {key}: {rec['error']}", flush=True)
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1, default=str)
    print(f"[dryrun] sweep done: {len(results)} cells, {n_err} errors",
          flush=True)
    raise SystemExit(1 if n_err else 0)


if __name__ == "__main__":
    main()
