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
