"""Flux tasks over partitions of several cards of one host, each run on a
rank group that the flux executor spawns over its partition's cards
(``repro_torch.launch.ranks``; NCCL over distinct cards), at full size:

  1. two (1, 2) partitions (cards 0-1 and 2-3) each training stablelm-3b
     through ``launch/train.py``'s ``train()``, 5 steps of 8 x 1,024
     tokens, first one task alone, then two at once;
  2. one (1, 4) partition training zamba2-7b (6.75 B parameters, whose
     AdamW state one card does not hold), 5 steps of 8 x 1,024;
  3. the same partition serving phi3.5-moe-42b-a6.6b at all 32 layers
     (83.8 GB of bf16 weights, which one card does not hold), each rank
     drawing only its blocks of the seed's weights: ``generate`` of 8 x
     1,024 + 32, then the prefill and the decode steps timed on their own
     (``launch.serve.teacher_forced``).

Each task prints its spawn seconds (until every rank had its card and its
process group), its wall through the runtime, the median step s or the
prefill s and decode ms a step, and each rank's card and peak memory; a
JSON line of the readings comes last. Run from the root of a checkout on a
machine with four cards:

  python scripts/flux_rank_groups.py

``--device cpu --smoke`` rehearses it on four CPU devices with the smoke
configs (gloo, 2 steps of 4 x 64, 4 x 16 + 4 tokens).
"""
import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

FULL = dict(steps=5, batch=8, seq=1024, prompt=1024, new=32)
SMOKE = dict(steps=2, batch=4, seq=64, prompt=16, new=4)
SEED = 0


def _cfg(arch, smoke, dtype=None):
    from repro_torch.configs import get_config, get_smoke_config
    kw = {"dtype": dtype} if dtype else {}
    return get_smoke_config(arch, **kw) if smoke else get_config(arch, **kw)


def train_task(arch, smoke, shape, mesh=None):
    """A rank's body: ``train()`` of ``arch`` over the group's mesh."""
    from repro_torch.launch.train import train
    cfg = _cfg(arch, smoke, "float32" if smoke else None)
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    out = train(cfg, steps=shape["steps"], global_batch=shape["batch"],
                seq_len=shape["seq"], mesh=mesh, quiet=True, device=dev,
                seed=SEED)
    return {"losses": out["losses"], "step_s": out["step_s"]}


def serve_task(arch, smoke, shape, mesh=None):
    """A rank's body: ``generate`` of ``arch`` over the group's mesh, the
    rank's blocks of the seed's weights drawn on its card, then the
    prefill and decode steps timed on the tokens."""
    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.launch.serve import generate, teacher_forced
    cfg = _cfg(arch, smoke, "float32" if smoke else None)
    cuda = torch.cuda.is_available()
    dev = torch.device("cuda", torch.cuda.current_device()) if cuda \
        else torch.device("cpu")
    B, S = shape["batch"], shape["prompt"]
    layout = TP.serve_layout(cfg, mesh, B)
    t0 = time.perf_counter()
    params = layout.init_params(SEED, dev)
    if cuda:
        torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(SEED)
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                            device=dev, dtype=torch.int32)
    t0 = time.perf_counter()
    tokens = generate(params, cfg, prompts, max_new_tokens=shape["new"],
                      mesh=mesh)
    if cuda:
        torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    prefill_s, decode_ms, _, _ = teacher_forced(params, cfg, tokens, S,
                                                layout=layout,
                                                keep_logits=False)
    return {"init_s": init_s, "generate_s": gen_s, "prefill_s": prefill_s,
            "decode_ms": decode_ms, "tokens": tokens[:, S:].cpu()}


def _submit(rt, descs, timeout):
    tasks = rt.submit(descs)
    if not rt.wait(timeout=timeout):
        raise SystemExit("the flux tasks did not end in time")
    bad = [(t.uid, t.state.value, t.error) for t in tasks
           if t.state.value != "DONE"]
    if bad:
        raise SystemExit(f"flux tasks failed: {bad}")
    return tasks


def _reading(rt, task, what, card):
    g = rt.agent.backends["flux"].rank_groups[task.uid]
    wall = task.timestamps["DONE"] - task.timestamps["RUNNING"]
    r = dict(task.result)
    r.pop("tokens", None)
    out = {"what": what, "backend": g["backend"], "devices": g["devices"],
           "spawn_s": g["spawn_s"], "group_s": g["wall_s"], "task_s": wall,
           "peak_gb_by_rank": [x["peak_gb"] for x in g["ranks"]],
           "current_by_rank": [x["current"] for x in g["ranks"]], **r}
    if "step_s" in r:
        out["median_step_s"] = statistics.median(r["step_s"][1:]
                                                 or r["step_s"])
    line = (f"[groups] {what}: {g['backend']} on {g['devices']}, spawn "
            f"{g['spawn_s']:.2f} s, task {wall:.2f} s (the group "
            f"{g['wall_s']:.2f} s)")
    if "step_s" in r:
        line += (f"; losses {[round(x, 4) for x in r['losses']]}, step s "
                 f"{[round(x, 4) for x in r['step_s']]} (median after the "
                 f"first {out['median_step_s']:.4f})")
    else:
        line += (f"; weights drawn in {r['init_s']:.1f} s, generate "
                 f"{r['generate_s']:.3f} s, prefill {r['prefill_s']:.4f} s, "
                 f"decode {r['decode_ms']:.3f} ms a step")
    line += f"; peak GB by rank {out['peak_gb_by_rank']}  [{card}]"
    print(line, flush=True)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--smoke", action="store_true")
    args = ap.parse_args()
    from repro_torch.core.local import LocalRuntime
    from repro_torch.core.task import TaskDescription
    from repro_torch.launch.mesh import make_local_mesh
    shape = SMOKE if args.smoke else FULL
    if args.device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
            raise SystemExit("needs four cards")
        torch.backends.cuda.matmul.allow_tf32 = False
        import subprocess
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip().splitlines()[0]
        devices = [torch.device("cuda", i) for i in range(4)]
    else:
        card = "cpu"
        devices = [torch.device("cpu", i) for i in range(4)]
    print(f"[groups] {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    timeout = 3000.0

    def desc(fn, *a):
        return TaskDescription(kind="executable", coupling="tight", fn=fn,
                               args=a, walltime=timeout)

    readings = []
    rt = LocalRuntime(mesh=make_local_mesh(2, devices=devices),
                      n_partitions=2)
    try:
        t, = _submit(rt, [desc(train_task, "stablelm-3b", args.smoke,
                               shape)], timeout)
        readings.append(_reading(rt, t, "stablelm-3b train (1, 2) alone",
                                 card))
        t0 = time.perf_counter()
        both = _submit(rt, [desc(train_task, "stablelm-3b", args.smoke,
                                 shape) for _ in range(2)], timeout)
        wall = time.perf_counter() - t0
        for i, t in enumerate(both):
            readings.append(_reading(
                rt, t, f"stablelm-3b train (1, 2) task {i} of two at once "
                f"(partition {t.partition})", card))
        print(f"[groups] two stablelm-3b tasks at once: {wall:.2f} s for "
              f"both  [{card}]", flush=True)
    finally:
        rt.shutdown()
    rt = LocalRuntime(mesh=make_local_mesh(4, devices=devices),
                      n_partitions=1)
    try:
        t, = _submit(rt, [desc(train_task, "zamba2-7b", args.smoke, shape)],
                     timeout)
        readings.append(_reading(rt, t, "zamba2-7b train (1, 4)", card))
        t, = _submit(rt, [desc(serve_task, "phi3.5-moe-42b-a6.6b",
                               args.smoke, shape)], timeout)
        readings.append(_reading(
            rt, t, f"phi3.5-moe-42b-a6.6b serve (1, 4), {shape['batch']} x "
            f"{shape['prompt']} + {shape['new']}", card))
    finally:
        rt.shutdown()
    print(json.dumps({"card": card, "readings": readings}))


if __name__ == "__main__":
    main()
