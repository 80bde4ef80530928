"""Flux partitions over every card of this machine: ``chip_smoke.py``'s
phase 14 alone, with the kernels built first. ``LocalRuntime(mesh=
make_local_mesh(), n_partitions=cards)`` carves one partition a card; (a)
each kernel on each card against its plain version, and launches from a
thread whose current device is card 0 onto the last card's tensors; (b)
max(2, cards) stablelm-3b train tasks at full size, each on its own card,
beside the same seeds' steps on card 0; (c) cards + 1 ``generate`` tasks
of stablelm-3b, 1,024 prompt tokens and 32 new, beside ``generate`` on
card 0. Prints each task's card, losses or tokens, wall times and peak
memory, and the launches of each kernel by card (a JSON line, last).

  python scripts/flux_partitions.py
"""
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.decode_attention import ops as da_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.fused_rmsnorm import ops as rn_ops  # noqa: E402
from repro_torch.kernels.ssd import ops as ssd_ops  # noqa: E402


def main():
    cs.check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    print(f"[device] {torch.cuda.get_device_name(0)} "
          f"x{torch.cuda.device_count()}; nvidia-smi: {card}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)
    _build.build_all()
    ops_of = {"flash_attention": fa_ops, "decode_attention": da_ops,
              "fused_rmsnorm": rn_ops, "ssd": ssd_ops}
    launches = cs.flux_partitions_on_card(torch, ops_of, card)
    print(json.dumps({part: {name: {str(c): n for c, n in by.items()}
                             for name, by in counts.items()}
                      for part, counts in launches.items()}))


if __name__ == "__main__":
    main()
