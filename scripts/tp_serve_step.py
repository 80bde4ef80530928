"""Time tensor-parallel serving on the cards of one host: run under
``torch.distributed.run`` (NCCL, one rank a card), it serves ARCH on the
mesh (world / MP, MP) as ``python -m repro_torch.launch.serve --arch ARCH
--model-parallel MP`` does, with each rank drawing only its blocks of the
seed's bf16 weights, 8 requests of 1,024 prompt tokens and 32 greedy new
tokens: one ``generate`` (wall s, new tokens/s), then the prefill and the
decode steps timed on their own (``launch.serve.teacher_forced``: a warm-up
prefill, the timed prefill, the 31 decode steps fed the generated tokens,
no logits kept), and every card's peak memory.

  python -m torch.distributed.run --standalone --nproc-per-node 4 \\
      scripts/tp_serve_step.py ARCH MP [NUM_LAYERS]
"""
import os
import sys
import time

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch import tree as T  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed import tensor_parallel as TP  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.launch.serve import generate, teacher_forced  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

B, S, NEW, SEED = 8, 1024, 32, 0


def main():
    arch, mp = sys.argv[1], int(sys.argv[2])
    cfg = get_config(arch, **({"num_layers": int(sys.argv[3])}
                              if len(sys.argv) > 3 else {}))
    mesh = make_host_mesh(mp, device="cuda")
    dev = torch.device("cuda", torch.cuda.current_device())
    lead = not dist.is_initialized() or dist.get_rank() == 0
    layout = TP.serve_layout(cfg, mesh, B)
    t0 = time.perf_counter()
    params = (M.init_params(cfg, seed=SEED, device=dev) if layout is None
              else layout.init_params(SEED, dev))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(SEED)
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                            device=dev, dtype=torch.int32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tokens = generate(params, cfg, prompts, max_new_tokens=NEW, mesh=mesh)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    prefill_s, decode_ms, _, _ = teacher_forced(params, cfg, tokens, S,
                                                layout=layout,
                                                keep_logits=False)
    peak = torch.zeros(mesh.size, dtype=torch.float64, device=dev)
    peak[dist.get_rank() if dist.is_initialized() else 0] = (
        torch.cuda.max_memory_allocated(dev) / 1e9)
    if dist.is_initialized():
        dist.all_reduce(peak)
    if lead:
        n = sum(t.numel() for t in T.leaves(M.init_params(cfg,
                                                           device="meta")))
        print(f"[tp_serve] {arch} ({cfg.num_layers} layers, {n / 1e9:.2f} B "
              f"params, bf16) on {mesh.shape}: weights drawn in {init_s:.1f} "
              f"s; generate {B} x {S} + {NEW}: {wall:.3f} s, "
              f"{B * NEW / wall:.1f} new tokens/s; prefill {prefill_s:.4f} "
              f"s, decode {decode_ms:.3f} ms/step "
              f"({B * 1e3 / decode_ms:.1f} new tokens/s); peak memory by "
              f"card {[round(x, 2) for x in peak.tolist()]} GB; new tokens "
              f"of request 0 {tokens[0, S:S + 8].tolist()}...", flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
