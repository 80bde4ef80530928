#!/bin/bash
# The long_500k cell's decode step on the four cards of one host (NCCL, one
# rank a card): zamba2-7b at full size, batch 1, a cache of 524,288
# positions drawn in chunks from a seed, sequence-parallel on (4, 1) (the
# cache's sequence over data) against tensor-parallel on (1, 4) (heads over
# model); the decode ms a step, every card's peak memory and the two
# layouts' logit gap (scripts/seq_decode_step.py). From the root of a
# checkout on a machine with four cards:
#   bash scripts/seq_decode_four_cards.sh
set -o pipefail
export PYTHONPATH=src
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda, torch.cuda.device_count())'
python -c 'from repro_torch.kernels import _build; _build.build_all()' >/dev/null
python -m torch.distributed.run --standalone --nproc-per-node 4 \
  scripts/seq_decode_step.py 2>&1 | grep -vE 'socket.cpp|^W[0-9]|\*\*\*\*' | tail -12
