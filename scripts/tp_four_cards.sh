#!/bin/bash
# Tensor-parallel training through the CLI of repro_torch.launch.train on
# one and on four cards of one host (NCCL, one rank a card), 5 steps of
# 8 x 1,024 tokens each: stablelm-3b on one card, on (1, 4) and on (2, 2);
# chatglm3-6b at full size on (1, 4); zamba2-7b at full size (6.75 B
# parameters, which do not fit one card with their AdamW state) on (1, 4)
# and on (2, 2); mamba2-130m under dp_all on (2, 2), its vocabulary split
# over the model axis. Each run prints its losses, the median step time,
# tokens/s and every card's peak memory. Run from the root of a checkout
# on a machine with four cards:
#   bash scripts/tp_four_cards.sh
set -o pipefail
export PYTHONPATH=src
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda, torch.cuda.device_count())'
run() {
  echo "=== $*"
  python -m torch.distributed.run --standalone "$@" 2>&1 | grep -E '^\[train\]|Error|error' | tail -12
}
run --nproc-per-node 1 -m repro_torch.launch.train --arch stablelm-3b --steps 5 --batch 8 --seq-len 1024
run --nproc-per-node 4 -m repro_torch.launch.train --arch stablelm-3b --steps 5 --batch 8 --seq-len 1024 --model-parallel 4
run --nproc-per-node 4 -m repro_torch.launch.train --arch stablelm-3b --steps 5 --batch 8 --seq-len 1024 --model-parallel 2
run --nproc-per-node 4 -m repro_torch.launch.train --arch chatglm3-6b --steps 5 --batch 8 --seq-len 1024 --model-parallel 4
run --nproc-per-node 4 -m repro_torch.launch.train --arch zamba2-7b --steps 5 --batch 8 --seq-len 1024 --model-parallel 4
run --nproc-per-node 4 -m repro_torch.launch.train --arch zamba2-7b --steps 5 --batch 8 --seq-len 1024 --model-parallel 2
run --nproc-per-node 4 -m repro_torch.launch.train --arch mamba2-130m --steps 5 --batch 8 --seq-len 1024 --model-parallel 2
