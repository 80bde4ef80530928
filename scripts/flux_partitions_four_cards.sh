#!/bin/bash
# Flux partitions over the four cards of one host: the
# runtime's LocalRuntime carves a partition a card and runs co-scheduled
# tasks on them at once (scripts/flux_partitions.py, chip_smoke.py's phase
# 14): each kernel on each card, four stablelm-3b train tasks at full size
# against one alone, five generate tasks (1,024 + 32 tokens) against one
# alone, with each task's card, losses or tokens, wall times and every
# card's peak memory.
# Run from the root of a checkout on a machine with four cards:
#   bash scripts/flux_partitions_four_cards.sh
set -o pipefail
export PYTHONPATH=src
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda, torch.cuda.device_count())'
python scripts/flux_partitions.py
# Flux tasks over partitions of several cards, each on a rank group the
# flux executor spawns over its cards (NCCL): stablelm-3b on two (1, 2)
# partitions at once, zamba2-7b training and phi3.5-moe-42b-a6.6b (32
# layers) serving on one (1, 4) partition
python scripts/flux_rank_groups.py
