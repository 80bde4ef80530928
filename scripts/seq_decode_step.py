"""One decode step of the long_500k cell on the cards of one host: zamba2-7b
at full size (bf16), batch 1, a cache of 524,288 positions, run under
``torch.distributed.run`` (NCCL, one rank a card) on two layouts of the
same cache and weights:

  * (world, 1): sequence-parallel, each rank the cache's block of
    524,288 / world positions and the whole weights (ROADMAP item 12h);
  * (1, world): tensor-parallel, each rank its heads of the whole
    sequence and its blocks of the weights (the serving layout of PR 24).

A 524,288-token prefill is not the cell. The cache is drawn instead: each
attention layer's K and V in chunks of CHUNK positions, each chunk from a
generator seeded by (seed, layer, leaf, chunk) on the card, so that every
layout draws the same values (a rank draws the chunks of its positions
and keeps its heads); the Mamba2 states and conv windows whole from a
generator a leaf, then cut to the rank's block. The step decodes the token
at position 524,287 against every cached row. Prints, per layout, the
decode ms a step (the median of STEPS timed steps after a warm-up, each
between two synchronizations; the Mamba2 states advance each step, the
attention cache row is rewritten with the same values) and every card's
peak memory; rank 0 then prints the largest gap between the two layouts'
first-step logits, max|diff|/max|logit|, against LIMIT.

  python -m torch.distributed.run --standalone --nproc-per-node 4 \\
      scripts/seq_decode_step.py [--smoke --capacity N --device cpu]
"""
import argparse
import json
import os
import statistics
import sys
import time
import zlib

import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

from repro_torch import tree as T  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.distributed import tensor_parallel as TP  # noqa: E402
from repro_torch.distributed.serve_step import make_decode_step  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.serve import _positions  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

SEED, CHUNK, STEPS = 0, 4096, 5
# the two layouts each differ from one rank's by at most the bf16 limits
# chip_smoke.py set for them: the tensor-parallel serving of zamba2-7b at
# full size (TP_SERVE_FULL_TOL, which chip_smoke.py held phase 13 (b) to
# before that phase's depth was cut) and the sequence-parallel decode
# (SEQ_BF16_TOL)
import chip_smoke as C  # noqa: E402
TP_SERVE_FULL_TOL = 0.2
LIMIT = TP_SERVE_FULL_TOL + C.SEQ_BF16_TOL


def _gen(dev, *key):
    """A generator on ``dev`` seeded by SEED and ``key``, the same in every
    process (``hash`` of a string is not)."""
    return torch.Generator(device=dev).manual_seed(
        zlib.crc32(repr((SEED,) + key).encode()))


def draw_cache(cfg, mesh, capacity, dev):
    """A rank's blocks (``cache_pspec``) of the cache drawn alike on every
    layout (see the module docstring), ``index`` at capacity - 1."""
    specs = SH.cache_pspec(cfg, mesh, 1)
    cache = M.init_cache(cfg, 1, capacity, device=dev, mesh=mesh)
    whole = M.init_cache(cfg, 1, capacity, device="meta")
    out = []
    for (path, t), (_, w) in zip(T.flatten(cache), T.flatten(whole)):
        if path == "index":
            t.fill_(capacity - 1)
        elif path.split("/")[-1] in ("k", "v"):
            sl = SH.local_slices(specs[path], tuple(w.shape), mesh)
            rows, heads = sl[2], sl[3]
            for layer in range(w.shape[0]):
                for c in range(rows.start // CHUNK,
                               -(-rows.stop // CHUNK)):
                    x = torch.randn((1, CHUNK) + tuple(w.shape[3:]),
                                    generator=_gen(dev, path, layer, c),
                                    device=dev) * 0.5
                    lo, hi = max(c * CHUNK, rows.start), min(
                        (c + 1) * CHUNK, rows.stop)
                    t[layer, :, lo - rows.start:hi - rows.start] = (
                        x[:, lo - c * CHUNK:hi - c * CHUNK, heads].to(
                            t.dtype))
        else:
            x = torch.randn(tuple(w.shape), generator=_gen(dev, path),
                            device=dev) * 0.1
            sl = SH.local_slices(specs[path], tuple(w.shape), mesh)
            t.copy_(x[sl].to(t.dtype))
            del x
        out.append(t)
    return T.unflatten(cache, out)


def run_layout(cfg, shape, capacity, dev, lead):
    """(first-step logits over the whole vocabulary on the host, decode ms
    of the timed steps' median, each card's peak GB) on a mesh of
    ``shape``."""
    mesh = make_mesh(shape, ("data", "model"), device=dev)
    layout = TP.serve_layout(cfg, mesh, 1)
    sp = layout.seq_par(capacity)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    params = layout.init_params(SEED, dev)
    cache = draw_cache(cfg, mesh, capacity, dev)
    decode = make_decode_step(cfg, layout.tp, sp)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, 1),
                                     generator=gen, device=dev,
                                     dtype=torch.int32),
             "positions": _positions(cfg, 1, 1, start=capacity - 1,
                                     device=dev)}
    logits, _ = decode(params, batch, cache)
    logits = TP.gather_vocab(logits, M.vocab_group(cfg, layout.tp))
    first = logits[0, 0, :cfg.vocab_size].float().cpu()
    times = []
    for _ in range(STEPS):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        decode(params, batch, cache)
        torch.cuda.synchronize(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.zeros(mesh.size, dtype=torch.float64, device=dev)
    peak[dist.get_rank()] = torch.cuda.max_memory_allocated(dev) / 1e9
    dist.all_reduce(peak)
    if lead:
        print(f"[seq_step] {cfg.name} bf16, 1 x 1 against a cache of "
              f"{capacity} positions, (data, model) {shape}: decode "
              f"{statistics.median(times):.3f} ms a step (median of "
              f"{STEPS}: {[round(t, 3) for t in times]}), peak "
              f"{[round(p, 2) for p in peak.tolist()]} GB by card",
              flush=True)
    del params, cache
    return first, statistics.median(times), peak.tolist()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--capacity", type=int, default=524288)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    cpu = args.device == "cpu"
    if cpu:                       # a rehearsal on gloo ranks of the CPU
        torch.cuda.synchronize = torch.cuda.empty_cache = (
            lambda *a, **k: None)
        torch.cuda.reset_peak_memory_stats = lambda *a, **k: None
        torch.cuda.max_memory_allocated = lambda *a, **k: 0
    dist.init_process_group("gloo" if cpu else "nccl")
    rank, world = dist.get_rank(), dist.get_world_size()
    dev = (torch.device("cpu") if cpu
           else torch.device("cuda", int(os.environ["LOCAL_RANK"])))
    if not cpu:
        torch.cuda.set_device(dev)
    lead = rank == 0
    cfg = (get_smoke_config("zamba2-7b") if args.smoke
           else get_config("zamba2-7b"))
    if lead:
        print(f"[seq_step] {C.card_line() if not cpu else 'cpu'}; "
              f"{world} ranks", flush=True)
    try:
        seq = run_layout(cfg, (world, 1), args.capacity, dev, lead)
        heads = run_layout(cfg, (1, world), args.capacity, dev, lead)
        if lead:
            a, b = seq[0], heads[0]
            gap = float((a - b).abs().max() / b.abs().max())
            agree = bool(a.argmax() == b.argmax())
            print(f"[seq_step] first-step logits, (world, 1) against (1, "
                  f"world): max|diff|/max|logit| {gap:.4e} (limit {LIMIT}), "
                  f"argmax equal {agree}", flush=True)
            print(json.dumps({"seq_ms": seq[1], "heads_ms": heads[1],
                              "seq_peak_gb": seq[2],
                              "heads_peak_gb": heads[2], "gap": gap,
                              "limit": LIMIT, "argmax_equal": agree}))
            if not gap < LIMIT:
                raise SystemExit(f"the layouts' logits differ: {gap}")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
