"""Helpers of the port's multi-rank and multi-device CPU tests.

``run_ranks`` spawns gloo ranks of ``torch.distributed`` on localhost, each
calling ``fn(rank, world, *args)``, and returns what each returned; every
wait has a deadline (this suite runs without pytest-timeout). ``run_jax``
runs a snippet in a fresh interpreter whose JAX sees ``n_devices`` forced
host devices (``XLA_FLAGS`` must be set before JAX loads), with a timeout.

The rank bodies live here too, below: a spawned rank imports the module of
its function, and this one imports no JAX (the test modules do, which
would cost each rank seconds).
"""
import multiprocessing as mp
import os
import queue
import socket
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _entry(fn, rank, world, port, results, args):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(2)
    try:
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                world_size=world, rank=rank)
        try:
            results.put((rank, True, fn(rank, world, *args)))
        finally:
            dist.destroy_process_group()
    except Exception:                                    # noqa: BLE001
        results.put((rank, False, traceback.format_exc()))


def run_ranks(fn, world: int, *args, timeout: float = 120.0):
    """[fn(rank, world, *args) for each rank], run in ``world`` spawned
    processes joined into one gloo group. Raises with a rank's traceback if
    one failed, and kills them all at the deadline."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_entry,
                         args=(fn, rank, world, port, results, args))
             for rank in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    out, errors = {}, []
    try:
        while len(out) + len(errors) < world:   # drain before joining
            try:
                rank, ok, payload = results.get(timeout=0.5)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in out]
                if dead or time.monotonic() > deadline:
                    missing = sorted(set(range(world)) - set(out))
                    errors.append(f"ranks {missing} gave nothing (exited: "
                                  f"{dead}; timeout {timeout} s)")
                    break
                continue
            if ok:
                out[rank] = payload
            else:           # the others may wait on it in a collective
                errors.append(f"rank {rank}:\n{payload}")
                deadline = min(deadline, time.monotonic() + 5)
    finally:
        for p in procs:
            p.join(timeout=max(0.1, deadline - time.monotonic()))
            if p.is_alive():
                p.kill()
                p.join()
    assert not errors, "\n".join(errors)
    assert not any(p.is_alive() for p in procs)
    return [out[r] for r in range(world)]


def run_jax(code: str, n_devices: int, timeout: float = 180.0):
    """Run ``code`` in a fresh interpreter with ``n_devices`` CPU devices for
    JAX; fails with its output if it does not exit 0 in time."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={n_devices}",
               PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    return r.stdout


# ------------------------------------------------------------ rank bodies
def blocks_on_ranks(rank, world, specs):
    """Each spec's block of one tensor on this rank of a (2, world / 2)
    mesh: by ``sharding.local_slices``, and by DTensor's
    ``distribute_tensor`` under the spec's placements."""
    import torch
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((2, world // 2), ("data", "model"), device="cpu")
    x = torch.arange(8 * 6 * 4, dtype=torch.float32).reshape(8, 6, 4)
    out = []
    for spec in specs:
        mine = x[SH.local_slices(spec, x.shape, mesh)]
        dt = distribute_tensor(x, mesh.device_mesh,
                               SH.placements(spec, mesh)).to_local()
        out.append((mesh.coordinate(), mine.numpy(), dt.numpy()))
    world_group = mesh.group(("data", "model")) is \
        torch.distributed.group.WORLD
    return out, world_group


def means_on_ranks(rank, world, g):
    """The int8 and fp32 means of the rows g[rank] over the ranks."""
    import torch
    from repro_torch.distributed import compression as C
    from repro_torch.launch.mesh import make_host_mesh
    group = make_host_mesh(device="cpu").group(("data",))
    x = torch.from_numpy(g[rank].copy())
    out = C.int8_psum_mean(x, group, world)
    assert torch.equal(x, torch.from_numpy(g[rank]))     # input untouched
    return out.numpy(), C.fp32_mean(x, group, world).numpy()


def local_grads_on_ranks(rank, world, arch, params, batch):
    """``make_local_grad_fn`` over ``make_grad_fn`` (f32 smoke config of
    ``arch``) on the global numpy ``batch``, uncompressed and int8:
    {compress: ({path: grad}, {metric})}."""
    import torch
    from repro_torch import bridge
    from repro_torch import tree as T
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed import compression as C
    from repro_torch.distributed import train_step as TS
    from repro_torch.launch.mesh import make_host_mesh
    cfg = get_smoke_config(arch, dtype="float32")
    mesh = make_host_mesh(device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = {}
    for compress in (False, True):
        fn = C.make_local_grad_fn(TS.make_grad_fn(cfg), mesh, ("data",), {},
                                  compress=compress)
        grads, metrics = fn(bridge.to_torch(params, device="cpu"), tb)
        out[compress] = ({p: g.numpy() for p, g in T.flatten(grads)},
                         {k: float(v) for k, v in metrics.items()})
    return out


def train_on_ranks(rank, world, arch, runs):
    """``launch.train.train`` of the f32 smoke config of ``arch`` on the
    host mesh of these ranks, once per kwargs of ``runs``: [(losses,
    {path: final param})]."""
    from repro_torch import tree as T
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.train import train
    cfg = get_smoke_config(arch, dtype="float32")
    out = []
    for kw in runs:
        r = train(cfg, device="cpu", quiet=True, **kw)
        out.append((r["losses"], {p: t.numpy() for p, t in
                                  T.flatten(r["params"])}))
    return out


def play_launches():
    """Route CPU tensors to the kernel wrappers' launches and put each
    kernel's plain version in its launch's place, counted (what
    tests/test_torch_train.py does with monkeypatch, for a spawned rank).
    Returns the wrapper modules by kernel name."""
    import torch
    from repro_torch.kernels import _grad
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.fused_rmsnorm import ops as rn_ops
    from repro_torch.kernels.ssd import ops as ssd_ops

    def launch(mod, plain, split=False):
        def run(*args, **static):
            with torch.no_grad():
                out = plain(*args, **static)
            mod.launches += 1
            if split or static.get("width") is not None:
                mod.split_launches += 1
            return out
        return run
    _grad.KERNEL_DEVICE = "cpu"
    mods = {"flash_attention": fa_ops, "fused_rmsnorm": rn_ops,
            "ssd": ssd_ops}
    for mod in mods.values():
        mod._launch = launch(mod, mod.plain)
    # the split-row RMSNorm's row-sum pass
    rn_ops._launch_sumsq = launch(rn_ops, rn_ops.plain_sumsq, split=True)
    return mods


def collectives_on_ranks(rank, world, xs, a):
    """``copy_to_tp`` and ``reduce_from_tp`` over a (1, world) mesh: each
    one's forward and the gradient of sum(out * a[rank]) as numpy."""
    import torch
    from repro_torch.distributed import tensor_parallel as TPm
    from repro_torch.launch.mesh import make_mesh
    tp = TPm.model_group(make_mesh((1, world), ("data", "model"),
                                   device="cpu"))
    weight = torch.from_numpy(a[rank])
    out = {}
    for name, fn, x in (("copy", TPm.copy_to_tp, xs[0]),
                        ("reduce", TPm.reduce_from_tp, xs[rank])):
        t = torch.from_numpy(x).requires_grad_()
        y = fn(t, tp)
        (g,) = torch.autograd.grad((y * weight).sum(), t)
        out[name] = (y.detach().numpy(), g.numpy())
    return out


def row_collectives_on_ranks(rank, world, xs, a):
    """``sum_over_tp``, ``gather_rows`` and ``scatter_rows`` over a (1,
    world) mesh, each on this rank's ``xs[rank]``: the forward and the
    gradient of sum(out * weight) as numpy, the weight this rank's
    ``a[rank]`` (of the output's shape)."""
    import torch
    from repro_torch.distributed import tensor_parallel as TPm
    from repro_torch.launch.mesh import make_mesh
    tp = TPm.model_group(make_mesh((1, world), ("data", "model"),
                                   device="cpu"))
    out = {}
    for name, fn in (("sum", TPm.sum_over_tp), ("gather", TPm.gather_rows),
                     ("scatter", TPm.scatter_rows)):
        t = torch.from_numpy(xs[rank].copy()).requires_grad_()
        y = fn(t, tp)
        (g,) = torch.autograd.grad((y * torch.from_numpy(a[name][rank]))
                                   .sum(), t)
        out[name] = (y.detach().numpy(), g.numpy())
    return out


def split_norm_on_ranks(rank, world, x, w, gate, a, eps):
    """``tensor_parallel.split_rmsnorm`` of this rank's columns of x (and
    of the gate, where given) over a (1, world) mesh, by the kernel's
    wrapper (its plain versions on the CPU) and by the plain path: for
    each, the output and the gradients of sum(out * a's columns) with
    respect to this rank's columns of x, the gate and w."""
    import torch
    from repro_torch.distributed import tensor_parallel as TPm
    from repro_torch.launch.mesh import make_mesh
    tp = TPm.model_group(make_mesh((1, world), ("data", "model"),
                                   device="cpu"))
    n = x.shape[-1] // world
    cols = slice(rank * n, (rank + 1) * n)
    out = {}
    for use_pallas in (True, False):
        ins = [torch.from_numpy(t[..., cols].copy()).requires_grad_()
               for t in (x, w) + (() if gate is None else (gate,))]
        y = TPm.split_rmsnorm({"scale": ins[1]}, ins[0],
                              ins[2] if gate is not None else None, eps,
                              use_pallas, tp)
        grads = torch.autograd.grad(
            (y * torch.from_numpy(a[..., cols].copy())).sum(), ins)
        out[use_pallas] = (y.detach().numpy(),
                           [g.numpy() for g in grads])
    return out


def vocab_ops_on_ranks(rank, world, table, tokens, logits, labels):
    """``vocab_embed`` and ``vocab_parallel_ce`` on this rank's vocab rows
    of ``table`` and columns of ``logits`` over a (1, world) mesh: (the
    embeddings, per-token losses, the gradient of their mean with respect
    to this rank's logit columns)."""
    import torch
    from repro_torch.distributed import tensor_parallel as TPm
    from repro_torch.launch.mesh import make_mesh
    tp = TPm.model_group(make_mesh((1, world), ("data", "model"),
                                   device="cpu"))
    n = table.shape[0] // world
    rows = torch.from_numpy(table[rank * n:(rank + 1) * n].copy())
    emb = TPm.vocab_embed(rows, torch.from_numpy(tokens), tp)
    v = logits.shape[-1] // world
    cols = torch.from_numpy(
        logits[..., rank * v:(rank + 1) * v].copy()).requires_grad_()
    ce = TPm.vocab_parallel_ce(cols, torch.from_numpy(labels), tp)
    (g,) = torch.autograd.grad(ce.mean(), cols)
    return emb.numpy(), ce.detach().numpy(), g.numpy()


def tp_step_on_ranks(rank, world, arch, mesh_shape, params, batch, opt,
                     compress=False, overrides=None, more_steps=0):
    """One tensor-parallel ``make_train_step`` of the f32 smoke config of
    ``arch`` (``overrides`` on it) on a (data, model) mesh of
    ``mesh_shape``, from the whole weights ``params`` (numpy), with each
    kernel launch played by its plain version. Returns numpy and plain
    values: the metrics; the gradients and updated parameters and moments
    gathered whole; this rank's gradients of the leaves whole on every
    rank; each moment's local shape beside the shape of its
    ``local_slices(zero1_spec)`` block of the (head-padded) leaf; the
    launches (and the split-row RMSNorm's among them, ``fused_rmsnorm
    split``); this rank's coordinate. Where the heads are padded to slots,
    ``padding``: after ``more_steps`` more steps, the largest |value| of
    this rank's parameter and moment entries in padding slots, and how
    many there are."""
    import torch
    from repro_torch import bridge
    from repro_torch import tree as T
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed import train_step as TS
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import adamw
    mods = play_launches()
    cfg = get_smoke_config(arch, dtype="float32", **(overrides or {}))
    mesh = make_mesh(tuple(mesh_shape), ("data", "model"), device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    B = tb["tokens"].shape[0]
    step = TS.make_train_step(cfg, adamw.OptimizerConfig(**opt), mesh=mesh,
                              dp_axes=SH.batch_axes(mesh, cfg, B),
                              grad_compression="int8" if compress else None)
    layout = step.layout
    local = layout.shard_params(bridge.to_torch(params, device="cpu"))
    state = adamw.init(local, layout)
    grads, _ = step.grad_fn(local, tb)
    for mod in mods.values():
        mod.launches = 0
    mods["fused_rmsnorm"].split_launches = 0
    new, state, metrics = step(local, state, tb)
    launches = {name: mod.launches for name, mod in mods.items()}
    launches["fused_rmsnorm split"] = mods["fused_rmsnorm"].split_launches

    def numpy(tree):
        return {p: t.numpy().copy() for p, t in T.flatten(tree)}
    shapes = {}
    for path, m in T.flatten(state.mu):
        full = layout.padded_shapes[path]
        want = SH.local_slices(layout.moment_specs[path], full, mesh)
        shapes[path] = (tuple(m.shape),
                        tuple(s.stop - s.start for s in want))
    out = {"coord": mesh.coordinate(),
           "metrics": {k: float(v) for k, v in metrics.items()},
           "grads": numpy(layout.gather_params(grads)),
           "params": numpy(layout.gather_params(new)),
           "mu": numpy(layout.gather_moments(state.mu)),
           "nu": numpy(layout.gather_moments(state.nu)),
           "whole_grads": {p: g.numpy().copy() for p, g in T.flatten(grads)
                           if not layout.split_over_model(p)},
           "moment_shapes": shapes, "launches": launches}
    if layout.heads is not None:          # the steps update ``new`` in place
        out["padding"] = _padding_after(layout, new, state, tb, step,
                                        more_steps)
    return out


def _padding_after(layout, params, state, batch, step, steps):
    """(the largest |value| of this rank's parameter and moment entries in
    padding head slots after ``steps`` more steps, their number)."""
    import torch
    from repro_torch import tree as T
    from repro_torch.distributed import tensor_parallel as TPm
    for _ in range(steps):
        params, state, _ = step(params, state, batch)
    worst, n = 0.0, 0
    for (path, p), m, v in zip(T.flatten(params), T.leaves(state.mu),
                               T.leaves(state.nu)):
        if TPm.head_dim_of(path) is None:
            continue
        pad = layout.block(path, torch.ones(layout.shapes[path])) == 0
        blk = layout.moment_block(path)
        mpad = pad if blk is None else pad[blk[1]]
        for t, mask in ((p, pad), (m, mpad), (v, mpad)):
            if mask.any():
                worst = max(worst, float(t[mask].abs().amax()))
            n += int(mask.sum())
    return worst, n


def tp_train_on_ranks(rank, world, arch, mesh_shape, params, runs):
    """``launch.train.train`` of the f32 smoke config of ``arch`` on a
    (data, model) mesh of ``mesh_shape``, from the whole weights ``params``
    (numpy) where given, once per kwargs of ``runs``: [(losses, {path:
    final parameter, gathered})]."""
    from repro_torch import bridge
    from repro_torch import tree as T
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed import tensor_parallel as TPm
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import make_mesh
    cfg = get_smoke_config(arch, dtype="float32")
    mesh = make_mesh(tuple(mesh_shape), ("data", "model"), device="cpu")
    if params is not None:
        train_mod.M.init_params = (lambda cfg, seed=0, device="cpu":
                                   bridge.to_torch(params, device=device))
    layout = TPm.train_layout(cfg, mesh)
    out = []
    for kw in runs:
        r = train_mod.train(cfg, device="cpu", quiet=True, mesh=mesh, **kw)
        final = layout.gather_params(r["params"]) if layout else r["params"]
        out.append((r["losses"], {p: t.numpy() for p, t in
                                  T.flatten(final)}))
    return out


def carved_tp_step_on_ranks(rank, world, arch):
    """A (2, world / 2) mesh carved into 2 partitions along ``data``; each
    rank takes one tensor-parallel step of the f32 smoke config of ``arch``
    on its partition's mesh and the one-rank step on the same weights and
    batch. Returns (each partition's ranks and shape, this rank's
    partition, the two losses, the largest gap between the gathered
    updated parameters and the one-rank ones relative to each leaf's
    largest value)."""
    import torch
    from repro_torch import tree as T
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.partition import carve_submeshes
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed import train_step as TS
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    cfg = get_smoke_config(arch, dtype="float32")
    parts = carve_submeshes(make_mesh((2, world // 2), ("data", "model"),
                                      device="cpu"), 2)
    mine = [p for p in parts if rank in p.mesh.device_mesh.mesh.flatten()
            .tolist()][0]
    gen = torch.Generator().manual_seed(mine.index)
    tok = torch.randint(0, cfg.vocab_size, (2, 17), generator=gen,
                        dtype=torch.int32)
    batch = {"tokens": tok[:, :-1].contiguous(),
             "labels": tok[:, 1:].contiguous(),
             "positions": torch.arange(16, dtype=torch.int32)[None].expand(
                 2, 16)}
    opt = adamw.OptimizerConfig(total_steps=10, warmup_steps=1)
    whole = M.init_params(cfg, seed=0, device="cpu")
    one = TS.make_train_step(cfg, opt)
    want = T.tree_map(torch.clone, whole)
    want, _, m1 = one(want, adamw.init(want), batch)
    step = TS.make_train_step(cfg, opt, mesh=mine.mesh,
                              dp_axes=SH.batch_axes(mine.mesh, cfg, 2))
    local = step.layout.shard_params(whole)
    new, _, m = step(local, adamw.init(local, step.layout), batch)
    got = step.layout.gather_params(new)
    gap = max(float((a - b).abs().max() / b.abs().max())
              for a, b in zip(T.leaves(got), T.leaves(want)))
    return ([(p.index, p.mesh.shape, p.mesh.device_mesh.mesh.tolist())
             for p in parts], mine.index, float(m["loss"]),
            float(m1["loss"]), gap)


def dryrun_cell_on_ranks(rank, world, arch, overrides, mesh_shape, B, S):
    """The dry-run's train cell of ``arch`` (``overrides`` on its config)
    on a (data, model) mesh of ``mesh_shape``, run on real CPU tensors on
    these gloo ranks: (matmul FLOPs, collective bytes by kind)."""
    return dryrun_cells_on_ranks(rank, world, [(arch, overrides, "train")],
                                 mesh_shape, B, S)[0]


def dryrun_cells_on_ranks(rank, world, cells, mesh_shape, B, S):
    """The dry-run's cells (arch, overrides on its config, kind) of
    ``B`` x ``S`` tokens on a (data, model) mesh of ``mesh_shape``, run on
    real CPU tensors on these gloo ranks: [(matmul FLOPs, collective bytes
    by kind)] in the order of ``cells``."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import abstract_mesh, make_mesh
    data, model = mesh_shape
    mesh = make_mesh((data, model), ("data", "model"), device="cpu")
    out = []
    for arch, overrides, kind in cells:
        cell, _ = D.lower_cell(arch, None, False, overrides,
                               shape=ShapeConfig(f"{kind}_{B}x{S}", S, B,
                                                 kind),
                               mesh=abstract_mesh(data=data, model=model))
        prof = cell.run(fake=False, mesh=mesh)
        out.append((prof.matmul_flops, prof.collective_bytes()))
    return out


def tp_step_on_card(rank, world, arch):
    """A tensor-parallel step of the f32 smoke config of ``arch`` on a
    (1, world) mesh of ranks that share CUDA card 0 over gloo, in its two
    parts, the kernels launched on the card; rank 0 also takes the
    one-rank step's gradients on the card and the one-rank AdamW update on
    the gathered gradients. Returns (this rank's launches, loss, and on
    rank 0: the one-rank loss, the largest gradient gap and the largest
    updated-leaf gap, each relative to the leaf's largest value)."""
    import torch
    from repro_torch import tree as T
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed import train_step as TS
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.fused_rmsnorm import ops as rn_ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import _positions
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = get_smoke_config(arch, dtype="float32")
    mesh = make_mesh((1, world), ("data", "model"), device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    tok = torch.randint(0, cfg.vocab_size, (2, 65), generator=gen,
                        device=dev, dtype=torch.int32)
    batch = {"tokens": tok[:, :-1].contiguous(),
             "labels": tok[:, 1:].contiguous(),
             "positions": _positions(cfg, 2, 64, device=dev)}
    opt = adamw.OptimizerConfig(total_steps=10, warmup_steps=1)
    step = TS.make_train_step(cfg, opt, mesh=mesh)
    whole = M.init_params(cfg, seed=0, device=dev)
    local = step.layout.shard_params(whole)
    state = adamw.init(local, step.layout)
    before = (fa_ops.launches, rn_ops.launches)
    grads, m = step.grad_fn(local, batch)
    adamw.update(opt, state, grads, local, step.layout)
    torch.cuda.synchronize()
    launches = {"flash_attention": fa_ops.launches - before[0],
                "fused_rmsnorm": rn_ops.launches - before[1]}
    grads = step.layout.gather_params(grads)
    new = step.layout.gather_params(local)
    if rank:
        return launches, float(m["loss"]), None
    rg, rm = TS.make_grad_fn(cfg)(whole, batch)
    g_gap = max(float((a - b).abs().max() / b.abs().max())
                for a, b in zip(T.leaves(grads), T.leaves(rg)))
    adamw.update(opt, adamw.init(whole), grads, whole)
    p_gap = max(float((a - b).abs().max() / b.abs().max())
                for a, b in zip(T.leaves(new), T.leaves(whole)))
    return launches, float(m["loss"]), (float(rm["loss"]), g_gap, p_gap)


def _count_decode_attention():
    """Count the decode-attention wrapper's calls (on a CPU tensor it takes
    its plain version itself, uncounted) as launches."""
    from repro_torch.kernels.decode_attention import ops as da_ops
    real = da_ops.decode_attention

    def counted(*args, **kw):
        da_ops.launches += 1
        return real(*args, **kw)
    da_ops.decode_attention = counted
    return da_ops


def tp_serve_on_ranks(rank, world, mesh_shape, cases):
    """Tensor-parallel serving of f32 smoke configs on a (data, model) mesh
    of ``mesh_shape``, each kernel launch played by its plain version. For
    each (arch, whole weights, prompts, forced tokens, new tokens) of
    ``cases`` (numpy): ``launch.serve.generate`` over the mesh (its tokens
    and this rank's launches, the split-row RMSNorm's among them), then the
    prefill and decode steps teacher-forced on ``forced``: the logits of
    every step over the whole vocabulary for this rank's rows, and this
    rank's cache blocks after the prefill and after the last step; the
    logits of ``launch.serve.teacher_forced`` on ``forced`` (the whole
    batch's); the tokens of ``generate`` at temperature 0.7 from a
    generator seeded 5. A case may end in a dict of ``overrides`` on the
    config and ``max_len``, the caches' capacity (default prompt + new: a
    sequence-parallel decode's blocks are of max_len / data)."""
    import torch
    from repro_torch import bridge
    from repro_torch import tree as T
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed import serve_step as ss
    from repro_torch.distributed import tensor_parallel as TPm
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    mods = play_launches()
    mods["decode_attention"] = _count_decode_attention()
    mesh = make_mesh(tuple(mesh_shape), ("data", "model"), device="cpu")
    out = []
    for arch, params, prompts, forced, new, *extra in cases:
        extra = extra[0] if extra else {}
        cfg = get_smoke_config(arch, dtype="float32",
                               **extra.get("overrides", {}))
        B, S = prompts.shape
        max_len = extra.get("max_len") or S + new
        layout = TPm.serve_layout(cfg, mesh, B)
        sp = layout.seq_par(max_len)
        local = layout.shard_params(bridge.to_torch(params, device="cpu"))
        for mod in mods.values():
            mod.launches = 0
        mods["fused_rmsnorm"].split_launches = 0
        tokens = serve.generate(local, cfg, torch.from_numpy(prompts),
                                max_new_tokens=new, mesh=mesh,
                                max_len=max_len)
        launches = {name: mod.launches for name, mod in mods.items()}
        launches["fused_rmsnorm_split"] = mods["fused_rmsnorm"].split_launches

        tp = layout.tp
        vtp = M.vocab_group(cfg, tp)
        rows = layout.my_rows(torch.from_numpy(forced))
        b = rows.shape[0]
        prefill = ss.make_prefill_step(cfg, tp, sp)
        decode = ss.make_decode_step(cfg, tp, sp)
        lg, cache = prefill(local, {
            "tokens": rows[:, :S].contiguous(),
            "positions": serve._positions(cfg, b, S, device="cpu")})
        steps = [TPm.gather_vocab(lg, vtp)[:, 0]]
        after_prefill = {p: t.numpy().copy() for p, t in T.flatten(cache)}
        cache = ss.pad_cache(cache, cfg, max_len if sp is None else sp.rows)
        for t in range(new - 1):
            lg, cache = decode(local, {
                "tokens": rows[:, S + t:S + t + 1].contiguous(),
                "positions": serve._positions(cfg, b, 1, start=S + t,
                                              device="cpu")}, cache)
            steps.append(TPm.gather_vocab(lg, vtp)[:, 0])
        helper = serve.teacher_forced(local, cfg, torch.from_numpy(forced),
                                      S, layout=layout, warm=False,
                                      max_len=max_len)[2]
        sampled = serve.generate(local, cfg, torch.from_numpy(prompts),
                                 max_new_tokens=new, temperature=0.7,
                                 generator=torch.Generator().manual_seed(5),
                                 mesh=mesh, max_len=max_len)
        out.append({"tokens": tokens.numpy(), "launches": launches,
                    "helper_logits": helper.numpy(),
                    "sampled": sampled.numpy(),
                    "split_rows": bool(tp is not None and tp.split_rows),
                    "seq_rows": sp.rows if sp is not None else None,
                    "row0": mesh.axes_index(layout.batch_axes) * b,
                    "logits": torch.stack(steps).numpy(),
                    "prefill_cache": after_prefill,
                    "final_cache": {p: t.numpy().copy()
                                    for p, t in T.flatten(cache)}})
    return {"coord": mesh.coordinate(), "cases": out}


def gather_vocab_on_ranks(rank, world, logits, temperature, split_rows):
    """``tensor_parallel.gather_vocab`` of this rank's vocab columns of
    ``logits`` (B, 1, V) over a (1, world) mesh, then ``serve_step.sample``
    from a generator seeded 0 (the vocabulary's padded tail past V - 3
    masked): the tokens. With ``split_rows`` the ranks hold other rows of
    the batch (B / world each) and the columns given are those of the
    group's rows; the tokens are this rank's rows'."""
    import dataclasses
    import torch
    from repro_torch.distributed import serve_step as ss
    from repro_torch.distributed import tensor_parallel as TPm
    from repro_torch.launch.mesh import make_mesh
    tp = TPm.model_group(make_mesh((1, world), ("data", "model"),
                                   device="cpu"))
    tp = dataclasses.replace(tp, split_rows=split_rows)
    v = logits.shape[-1] // world
    mine = torch.from_numpy(logits[..., rank * v:(rank + 1) * v].copy())
    full = TPm.gather_vocab(mine, tp)
    gen = torch.Generator().manual_seed(0)
    return ss.sample(full, gen, temperature, logits.shape[-1] - 3).numpy()


def combine_on_ranks(rank, world, o, lse):
    """``tensor_parallel.combine_partials`` of this rank's partial (o[rank]
    (B, 1, H, hd), lse[rank] (B, H)) over a (world, 1) mesh's data group."""
    import torch
    from repro_torch.distributed import tensor_parallel as TPm
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((world, 1), ("data", "model"), device="cpu")
    sp = TPm.SeqPar(mesh.group(("data",)), world,
                    mesh.coordinate()["data"], 0)
    return TPm.combine_partials(torch.from_numpy(o[rank]),
                                torch.from_numpy(lse[rank]), sp).numpy()


def seq_decode_on_card(rank, world, prompt_len, new, capacity):
    """One request of zamba2-7b's f32 smoke config served sequence-parallel
    on a (world, 1) mesh of ranks that share CUDA card 0 over gloo, the
    kernels launched on the card; rank 0 also runs the one-rank kernel path.
    Returns (tokens, this rank's launches, rank 0's one-rank (tokens,
    teacher-forced logits), this rank's teacher-forced logits)."""
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed import tensor_parallel as TPm
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    mods = {name: __import__(f"repro_torch.kernels.{name}.ops",
                             fromlist=["ops"])
            for name in ("flash_attention", "decode_attention",
                         "fused_rmsnorm", "ssd")}
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = get_smoke_config("zamba2-7b", dtype="float32")
    mesh = make_mesh((world, 1), ("data", "model"), device=dev)
    layout = TPm.serve_layout(cfg, mesh, 1)
    whole = M.init_params(cfg, seed=0, device=dev)
    local = layout.shard_params(whole)
    gen = torch.Generator(device=dev).manual_seed(0)
    prompts = torch.randint(0, cfg.vocab_size, (1, prompt_len),
                            generator=gen, device=dev, dtype=torch.int32)
    ref = None
    if not rank:
        tok = serve.generate(whole, cfg, prompts, max_new_tokens=new,
                             max_len=capacity)
        lg = serve.teacher_forced(whole, cfg, tok, prompt_len, warm=False,
                                  max_len=capacity)[2]
        ref = (tok.cpu().numpy(), lg.cpu().numpy())
    for mod in mods.values():
        mod.launches = 0
    mods["fused_rmsnorm"].split_launches = 0
    tokens = serve.generate(local, cfg, prompts, max_new_tokens=new,
                            mesh=mesh, max_len=capacity)
    torch.cuda.synchronize()
    launches = {name: mod.launches for name, mod in mods.items()}
    launches["fused_rmsnorm_split"] = mods["fused_rmsnorm"].split_launches
    logits = serve.teacher_forced(local, cfg, tokens, prompt_len,
                                  layout=layout, warm=False,
                                  max_len=capacity)[2]
    return tokens.cpu().numpy(), launches, ref, logits.cpu().numpy()


# ------------------------------------------- flux tasks on rank groups
# Callables of flux tasks on partitions of several CPU devices: the flux
# executor spawns a rank group over the partition and each rank calls the
# task with ``mesh=`` the group's mesh (``repro_torch.launch.ranks``).
def flux_train_step(arch, params, batch, opt, mesh=None):
    """One ``make_train_step`` of the f32 smoke config of ``arch`` over the
    rank mesh from the whole numpy ``params``, on the global numpy
    ``batch``: the loss (a tensor), the updated leaves gathered whole
    (tensors), this rank's coordinate and the launches played."""
    import torch
    from repro_torch import bridge
    from repro_torch import tree as T
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed import train_step as TS
    from repro_torch.optim import adamw
    mods = play_launches()
    cfg = get_smoke_config(arch, dtype="float32")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    step = TS.make_train_step(cfg, adamw.OptimizerConfig(**opt), mesh=mesh,
                              dp_axes=SH.batch_axes(mesh, cfg,
                                                    tb["tokens"].shape[0]))
    layout = step.layout
    local = layout.shard_params(bridge.to_torch(params, device="cpu"))
    new, _, metrics = step(local, adamw.init(local, layout), tb)
    return {"loss": metrics["loss"], "coord": mesh.coordinate(),
            "shape": mesh.shape, "world": torch.distributed.get_world_size(),
            "params": dict(T.flatten(layout.gather_params(new))),
            "launches": {n: m.launches for n, m in mods.items()}}


def flux_generate(arch, params, prompts, new, mesh=None):
    """``generate`` of the f32 smoke config of ``arch`` over the rank mesh,
    from the whole numpy ``params``: the tokens (a tensor)."""
    import torch
    from repro_torch import bridge
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed import tensor_parallel as TPm
    from repro_torch.launch.serve import generate
    cfg = get_smoke_config(arch, dtype="float32")
    layout = TPm.serve_layout(cfg, mesh, prompts.shape[0])
    local = layout.shard_params(bridge.to_torch(params, device="cpu"))
    return generate(local, cfg, torch.from_numpy(prompts),
                    max_new_tokens=new, mesh=mesh)


def flux_train(arch, steps, opt, ckpt_every=0, checkpoint=None,
               resume_from=None, mesh=None):
    """``launch/train.py``'s ``train()`` of the f32 smoke config of ``arch``
    over the rank mesh (4 x 16 tokens a step), checkpointing into the
    manager's directory where the task has one and resuming where the
    executor names a step: the losses of the steps run, and the step it
    resumed from."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.train import train
    from repro_torch.optim import adamw
    cfg = get_smoke_config(arch, dtype="float32")
    out = train(cfg, steps=steps, global_batch=4, seq_len=16, mesh=mesh,
                ckpt_dir=checkpoint.directory if checkpoint else "",
                ckpt_every=ckpt_every, resume=resume_from is not None,
                opt_cfg=adamw.OptimizerConfig(**opt), quiet=True,
                device="cpu")
    return {"losses": out["losses"], "resume_from": resume_from}


def flux_barrier(directory, n, timeout=60.0, mesh=None):
    """Wait until ``n`` ranks (of any groups) have entered: each leaves a
    file in ``directory``. Passes only where the groups run at once."""
    import os
    import time
    open(os.path.join(directory, str(os.getpid())), "w").close()
    deadline = time.monotonic() + timeout
    while len(os.listdir(directory)) < n:
        if time.monotonic() > deadline:
            raise TimeoutError(f"{len(os.listdir(directory))} of {n} ranks "
                               f"entered in {timeout} s")
        time.sleep(0.05)
    return mesh.shape


def flux_raise(bad_rank, mesh=None):
    """Rank ``bad_rank`` raises; the others wait for it in a collective."""
    import torch
    import torch.distributed as dist
    if dist.get_rank() == bad_rank:
        raise ValueError(f"rank {bad_rank} fails on purpose")
    dist.all_reduce(torch.ones(1))
    return "unreachable"


def flux_sleep(seconds, mesh=None):
    import time
    time.sleep(seconds)
    return seconds
