#!/bin/bash
# Tensor-parallel serving on one and on four cards of one host (NCCL, one
# rank a card), 8 requests of 1,024 prompt tokens and 32 greedy new tokens:
# phi3.5-moe-42b-a6.6b at all 32 layers on (1, 4), which no single card
# holds (83.8 GB in bf16); chatglm3-6b on one card, on (1, 4) and on (2, 2);
# zamba2-7b and deepseek-v2-lite-16b on (1, 4). Each run times generate,
# the prefill and a decode step (scripts/tp_serve_step.py) and prints every
# card's peak memory; the serve CLI itself runs once under the launcher.
# Run from the root of a checkout on a machine with four cards:
#   bash scripts/tp_serve_four_cards.sh
set -o pipefail
export PYTHONPATH=src
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda, torch.cuda.device_count())'
run() {
  echo "=== $*"
  python -m torch.distributed.run --standalone "$@" 2>&1 | grep -E '^\[serve\]|^\[tp_serve\]|Error|error' | tail -12
}
run --nproc-per-node 4 -m repro_torch.launch.serve --arch chatglm3-6b --requests 8 --prompt-len 1024 --max-new-tokens 32 --model-parallel 4
run --nproc-per-node 4 scripts/tp_serve_step.py phi3.5-moe-42b-a6.6b 4
run --nproc-per-node 1 scripts/tp_serve_step.py chatglm3-6b 1
run --nproc-per-node 4 scripts/tp_serve_step.py chatglm3-6b 4
run --nproc-per-node 4 scripts/tp_serve_step.py chatglm3-6b 2
run --nproc-per-node 4 scripts/tp_serve_step.py zamba2-7b 4
run --nproc-per-node 4 scripts/tp_serve_step.py deepseek-v2-lite-16b 4
