#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA H100.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one CUDA
card and ``nvcc`` (``/usr/local/cuda``), and fails without them.

Phases, each printing its lines; any failed check exits non-zero:
  1. device: the card's name, count and power limit;
  2. build: the four CUDA kernels from the checkout's sources (one nvcc per
     source, in parallel), with ptxas' registers and spills, and the tensor
     core instructions in the SASS (cuobjdump): HGMMA (wgmma) in every bf16
     flash-attention instantiation (MLA's (192, 128) one named), HMMA
     (mma.sync) in every bf16 decode-attention and SSD-scan one;
  3. kernel vs plain: each kernel's wrapper on CUDA tensors at the main
     paths' shapes against its plain PyTorch version, tolerance stated
     (RMSNorm gated and ungated at every main-path width, 8 and 8,192 rows,
     and at d = 77, deepseek's 2,048 and MLA's kv_norm at 512; flash
     attention also at the training path's head_dim 80, B 8, S 1,024, 32
     heads over 32 KV heads, and at deepseek-v2-lite-16b's MLA prefill, q/k
     192 wide and v 128, 16 heads over 16);
  4. kernel times (CUDA events, L2 flushed before each launch) beside the
     least time the card could take, the plain version and a library call;
     the 8-row RMSNorm's from the profiler's device time; the gated RMSNorm
     (zamba2-7b's and mamba2-130m's Mamba2 norm) beside the three eager
     calls it replaces; flash and decode attention also at zamba2-7b's
     shape, beside SDPA, and decode attention's device time per call from
     the profiler (split and combine kernels); the SSD scan at zamba2-7b's
     and mamba2-130m's shapes; the host time per call of the wrappers and
     eager calls of a decode step; at the training path's shapes flash
     attention's forward at stablelm-3b's beside its backward kernel (the
     forward's log-sum-exp launch held against the launch without it and
     the plain log-sum-exp, the backward against the plain vjp in f32;
     through autograd, alone and by kernel;
     ``flash_backward_times``, which ``scripts/flash_backward.py`` runs
     alone), and RMSNorm's at 8,192 x 2,560 beside its backward (its
     autograd.Function's: the plain version recomputed and its vjp, checked
     equal to the plain vjp), each beside the plain vjp alone and the
     library's forward and backward; flash attention at the MLA shape
     beside SDPA on the same 128-wide V;
  5. main paths, each served with ``serve_batch`` at full width with random
     bf16 weights from a seed: 8 requests of 1,024 prompt tokens, 32 greedy
     new tokens, with the kernels' launch counts set to 0 just before and
     read just after. chatglm3-6b (28 layers, d_model 4,096), zamba2-7b (81
     Mamba2 layers and one shared attention block every 6, d_model 3,584),
     mamba2-130m (24 Mamba2 layers, d_model 768), deepseek-v2-lite-16b at
     full size (27 layers: 1 dense, 26 MoE of 64 routed experts top-6 and 2
     shared; MLA; d_model 2,048) and phi3.5-moe-42b-a6.6b at full width
     with 16 of its 32 layers (d_model 4,096, 16 experts top-2; the 32
     would not fit the card). Each is then held by the kernel and plain
     paths teacher-forced on the kernel path's tokens, the logits of every
     step compared in f32 and in bf16, and its prefill and decode times.
     The MoE paths run that comparison at full width and 4 layers and
     count the routing decisions that flip between the two f32 paths; the
     f32 logits are held where none did;
  6. where the time of one prefill and one decode step goes
     (torch.profiler), for each of the five, and the per-launch device
     time of the kernels there;
  7. training through ``make_train_step`` (AdamW, remat "full", the kernels
     in every forward and recompute, in the backward flash attention's
     backward kernel and the other kernels' plain vjps) with random bf16
     weights from a seed: stablelm-3b at full
     width and depth (32 layers, d_model 2,560) and mamba2-130m at full
     size, five steps each on one fixed batch of 8 x 1,024 tokens; each
     loss finite and the fifth below the first, each step's launch counts
     and flash backwards by route (``flash_backwards``) exact; one more step in its two parts (forward and backward, then the
     update) with every leaf's gradient finite and nonzero; step time,
     tokens/s, peak memory and the model-FLOP share. Then the kernel path's
     f32 gradients against the plain path's (stablelm-3b at full width and 4
     layers, mamba2-130m at full size), and a checkpoint round trip
     (mamba2-130m: saved after step 2, restored into a fresh tree, step 3
     from both equal bit for bit);
  8. the training driver, ``launch/train.py``'s ``train()``, on one rank
     (synthetic stream, pinned host batches, the loss read every step),
     with random bf16 weights from the script's seed and each step's kernel
     launches counted: stablelm-3b at full width and depth, five steps of
     8 x 1,024 tokens, its step time and tokens/s beside phase 7's direct
     step and its peak memory; mamba2-130m at full size at
     examples/train_lm.py's shape (8 x 512): 12 steps, then 8 with a
     checkpoint every 4 and a resume to 12, whose steps 8-11 must equal the
     uninterrupted run's bit for bit (the cursor at 8, the first batch the
     stream's eighth), the loss finite and falling, the save and restore
     seconds and bytes and the step after an async save; and int8 gradient
     compression on one rank (each leaf within |g|_inf/127 of the
     uncompressed gradient, the compressed step's time beside the plain);
  9. the dry-run (``launch/dryrun.py``) held against the card, on a one-card
     mesh: stablelm-3b's and mamba2-130m's train steps at 8 x 1,024 and
     chatglm3-6b's prefill at 8 x 1,024 and decode step at cache 1,056, each
     run once on fake tensors on the CPU and once on the card on the plain
     path under the same ``OpProfile``: their matmul FLOPs equal; the kernel
     path's time of phases 5 and 7 not below the floor the counts give; the
     dry-run's peak memory against ``max_memory_allocated``;
 10. the port's runtime (``repro_torch.runtime``, real engine) driving the
     kernels: launch/hybrid_campaign.py with full stablelm-3b as its
     surrogate (its losses against the same steps called directly), an LM
     service of two replicas on dragon at 8 of the surrogate's 32 layers
     (tokens against direct
     ``generate``), a checkpoint-restart of mamba2-130m through the runtime
     (bit for bit), and no-op function-task throughput alone and beside a
     flux training task;
 11. the rest of the paper's runtime over the same tasks: (a) phase 10's
     campaign as Stages through ``TaskManager.run_campaign`` under a
     ``Watcher`` with a stall rule (losses equal in every bit to phase
     10's, the streamed breakdown equal to the post-hoc one, the lifecycle
     telescoping, no alert, ``compute_metrics``, a Chrome trace read back,
     a ``RunReport`` round trip); (b) an LM service of two replicas on
     dragon under a ``CampaignScheduler`` and a ``RestartPolicy``, watched,
     with a ``ChaosController`` node fault on dragon while requests are
     served (no request lost, tokens equal to direct ``generate``, launches
     equal to the ``generate`` calls started, ``fault_metrics`` and the
     time to recover).
 12. tensor parallelism over ``model`` and ZeRO-1 over ``data``
     (``distributed/tensor_parallel.py``), on ranks spawned on this card and
     joined over gloo: first the RMSNorm kernel's split-row mode (the row
     sums, then the scaling from the summed row) against its plain versions
     at zamba2-7b's gated norm on two ranks, f32 and bf16, and its device
     times beside their bound; (a) f32 at full width, one step against the
     one-rank kernel-path step (chatglm3-6b on (1, 4), its 2 kv heads under
     the replicated-KV rule; stablelm-3b on (2, 2); deepseek's dense layer
     and one MoE layer on (1, 4), each 2 layers; zamba2-7b at 7 layers, a
     group of 6 Mamba2 layers, the shared block and a tail layer, on (1, 4)
     and (2, 2), its gated norms in the split mode; mamba2-130m at full size
     under dp_all on (2, 2), its vocabulary split over ranks holding other
     rows): the loss, every gathered gradient, updated leaf and moment, and
     each rank's kernel launches; (b) bf16 at full width, three steps of
     phase 7's batch on (1, 2): stablelm-3b at 16 of its 32 layers (the
     depth cut to make room for phase 16) and zamba2-7b at 13 layers (two
     groups and a tail), each beside a one-rank run of the same weights,
     with step time, tokens/s, each
     rank's peak memory and the seconds in collectives (gloo through host
     memory, not NCCL). The cases of (a) run in one call of 4 ranks, those
     of (b) in one of 2; the ranks of each size are spawned once, for
     phases 12, 13 and 15 (``on_card_ranks``): a spawn takes seconds to
     reach the card.
 13. tensor-parallel serving (``launch/serve.py``'s ``generate`` over a
     mesh, ``tensor_parallel.ServeLayout``) on ranks spawned on this card
     over gloo, as phase 12: first the RMSNorm kernel's split-row mode at
     a decode step's shape (8 rows, 3,584 of zamba2-7b's 7,168 columns)
     against its plain versions, with its device time a launch beside its
     bound (``kernel_ms_per_launch``: a reading that fails its own check
     is never printed);
     (a) f32 at full width, 8 requests of 128 prompt tokens and 8 new
     tokens, in one call of 4 ranks, each rank drawing only its blocks of
     the seed's weights, against the one-rank kernel-path ``generate`` of
     the same weights (chatglm3-6b on (1, 4) under the replicated-KV rule,
     deepseek-v2-lite-16b and phi3.5-moe at 2 layers on (1, 4), zamba2-7b
     at 7 layers on (1, 4) and (2, 2), mamba2-130m under dp_all on (2, 2)):
     greedy tokens, the logits of every step teacher-forced, each rank's
     cache blocks after the prefill and the last step, each rank's
     launches of the four kernels; (b) bf16 at full width on (1, 2), phase
     5's batch, in one call of 2 ranks: chatglm3-6b at 7 of its 28
     layers and zamba2-7b at 13 of its 81 (the depth cut to make room for
     phase 16) teacher-forced on a one-rank run's tokens, the logits against it
     (phases 12 (b) and 13 (b) are held to limits set from four draws of
     the weights, ``scripts/tp_bf16_seeds.py``), the prefill s, decode ms a step, each rank's peak memory and seconds in
     collectives.
 14. Flux partitions over the cards of this process (ROADMAP item 8c):
     ``LocalRuntime(mesh=make_local_mesh(), n_partitions=cards)``, a
     partition a card, every task inside its partition's placement: (a)
     each kernel in a task on each card at phase 3's main-path shapes
     against its plain version (with more than one card, also launched
     from a thread whose current device is card 0 onto the last card's
     tensors); (b) max(2, cards) stablelm-3b train tasks at full width and
     depth, 2 steps of phase 7's batch each, each from its own seed on its
     card, losses equal in every bit to the same seeds' steps on card 0,
     the tasks overlapping on more than one card; (c) cards + 1 tasks
     serving phase 10 (b)'s request through ``generate``, tokens equal to
     direct ``generate``, decode ms a step beside one task alone; each
     part's launches by kernel and card exact. On one card the extra tasks
     queue through the one partition. ``scripts/flux_partitions.py`` runs
     this phase alone on every card of a machine.
 15. query heads padded to slots over ``model`` (ROADMAP item 12f) and the
     sequence-parallel decode of one request (item 12h), on ranks spawned
     on this card over gloo: (a) the decode kernel's softmax partial
     (``return_lse``) against its plain version, f32 and bf16, blocks with
     no valid row, some and all, the blocks' partials combined against the
     whole-cache kernel, and its time at zamba2-7b's per-rank block beside
     its bound, the plain partial and aten's efficient attention; (b)
     qwen2-vl-7b on (1, 8) and musicgen-medium on (1, 16), f32 at full
     width and 1 layer (2 before phase 16 needed the room): one train step
     against the one-rank step, the
     padding entries zero after training, serving against the one-rank
     ``generate``, each rank's launches (musicgen-medium's ranks 12-15
     launch no attention kernel); (c) batch 1, the cache's sequence over
     ``data``: zamba2-7b f32 at 7 layers on (2, 1) and (2, 2) and
     mamba2-130m on (2, 2), decoding across the block boundary, tokens,
     logits and cache blocks against one rank; zamba2-7b bf16 at full size
     on (2, 1), 1 x 32,800 + 8, the logits against one rank's, the prefill
     s, decode ms a step, seconds in collectives and peak memory a rank;
     the data group's combine timed. ``scripts/seq_parallel.py`` runs this
     phase alone.
 16. a Flux task's step over a partition of several local cards (ROADMAP
     item 8d): the flux executor runs it on a rank group spawned over the
     partition's devices (``launch/ranks.py``), each rank with a mesh over
     the group; here every partition lists card 0 more than once, so the
     ranks share the card over gloo. First, alone, on a (2, 1) partition
     (d) a task whose rank 1 raises after taking its card (the task FAILED
     with its traceback, no rank left, the card's free memory back); then
     at once, on three (1, 2) partitions, (a) two stablelm-3b f32 train
     tasks (full width, 2 layers, phase 12 (a)'s case and limits against
     the one-rank kernel-path step) and (c) a chatglm3-6b f32 ``generate``
     task (2 layers, 8 x 128 + 8, tokens equal to one-rank ``generate``),
     and (b) the (2, 1) partition's next task, stablelm-3b's step on (2,
     1); each rank's card, spawn and wall seconds, peak memory and exact
     launches.
Phase 5's serving paths are not cut to fit the time limit; the depth of
phases 10 (b), 11 (b), 12 (b) and 13 (b) is. The ranks of phases 12, 13
and 15 compare their blocks on rank 0 through CUDA IPC (``_gather0``),
and the ranks of each size are spawned once (``on_card_ranks``). Each
phase's seconds are printed as it ends (``[device] phase ... took``); the
script's time is in PERF.md §6.
The line before the last is the ``{"kernels": [...]}`` summary (with each
kernel's launches per serve_batch, per train step, per driver step, per
part of phases 10 and 11, per rank of each phase 12 step, per rank of
each phase 13 case, per part of phase 14 by card, per rank of each
phase 15 case and per rank of each phase 16 task; the decode kernel's
lse-mode reading under
``lse_block``; the RMSNorm
kernel's split-row launches, phases 12's and 13's, as an entry of their
own, with its decode-shape reading); the last is ``{"ok": true,
"device": {...}}``.
"""
import contextlib
import dataclasses
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM peaks (NVIDIA data sheet, dense) and the bound of each kernel:
# one set of terms for the card, the roofline's
import numpy as np  # noqa: E402

from repro_torch.device import same_device  # noqa: E402
from repro_torch.launch.roofline import (  # noqa: E402
    HBM_BW as PEAK_BYTES_PER_S, PEAK_FLOPS_BY_DTYPE as PEAK_FLOPS, add_bound,
    kernel_bound, ssd_work)

# phase 7: training at full width and depth, five steps on one batch
TRAIN_PATHS = ("stablelm-3b", "mamba2-130m")
TRAIN_WIDTH = {"stablelm-3b": (32, 2560), "mamba2-130m": (24, 768)}
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 1024, 5
# f32 gradient parity, kernel path against plain path (depth at full width)
PARITY_DEPTH = {"stablelm-3b": 4, "mamba2-130m": 24}
# limits set from the first run's readings (H100 80GB HBM3, 700 W): per leaf
# at most 6.6e-06 (stablelm-3b) and 1.9e-05 (mamba2-130m), the loss equal in
# every bit on both (first set at 1e-3 and 1e-5)
GRAD_LEAF_TOL, GRAD_LOSS_TOL = 1e-4, 1e-6

# phase 8: the training driver. stablelm-3b at phase 7's shape; mamba2-130m
# at examples/train_lm.py's (batch 8, seq_len 512): an uninterrupted run,
# then a run cut at DRIVER_CUT with a checkpoint every DRIVER_EVERY steps
# and a resume to DRIVER_STEPS
DRIVER_LM_BATCH, DRIVER_LM_SEQ = 8, 512
DRIVER_STEPS, DRIVER_CUT, DRIVER_EVERY = 12, 8, 4

SPIN_CYCLES = 400_000       # ~0.2 ms at 1.98 GHz: above any wrapper's host time

# phase 9: the dry-run (launch/dryrun.py) of cells this script runs at full
# width, on a one-card mesh: (arch, step, seq_len or cache length, batch)
DRYRUN_CELLS = (("stablelm-3b", "train", TRAIN_SEQ, TRAIN_BATCH),
                ("mamba2-130m", "train", TRAIN_SEQ, TRAIN_BATCH),
                ("chatglm3-6b", "prefill", 1024, 8),
                ("chatglm3-6b", "decode", 1024 + 32, 8))
# max_memory_allocated of the plain path's step over the dry-run's
# arguments plus temporaries. The first runs (H100 80GB HBM3, 700.00 W) read
# 1.0000 to 1.0017 over the four cells: the allocator rounds blocks up, and
# a fresh process allocates the cuBLAS workspace in its first product
MEM_RATIO_BAND = (0.999, 1.01)

PATHS = ("chatglm3-6b", "zamba2-7b", "mamba2-130m", "deepseek-v2-lite-16b",
         "phi3.5-moe-42b-a6.6b")
PROFILED = PATHS
FULL_WIDTH = {"chatglm3-6b": (28, 4096), "zamba2-7b": (81, 3584),
              "mamba2-130m": (24, 768), "deepseek-v2-lite-16b": (27, 2048),
              "phi3.5-moe-42b-a6.6b": (16, 4096)}
# phi3.5-moe's 32 layers take 83.8 GB in bf16, more than the card's 80 GB:
# it is served at full width with 16 of them (~42 GB)
SERVE_LAYERS = {"phi3.5-moe-42b-a6.6b": 16}
# The MoE paths' kernel-vs-plain comparisons run at full width and this
# depth (deepseek's dense layer and 3 MoE layers; phi's first 4): the f32
# weights of either at full depth would not fit beside the bf16 ones.
MOE_HOLD_DEPTH = 4
N_REQUESTS, PROMPT_LEN, NEW_TOKENS, SEED = 8, 1024, 32, 0
# bf16 kernel-vs-plain tolerances as in the JAX package's kernel tests;
# f32 differs only by the order of sums. SSD: relative to max|want|, as the
# JAX package's test_ssd_pallas_vs_naive, against the recurrence ssd_naive in
# f32 (at chunk 256 under fast decay the plain ssd_chunked is itself ~1e-5
# from it: exponents taken as differences of large f32 prefix sums; the
# kernels keep them in f64). The bf16 kernel against its plain version
# ssd_chunked_tc (the same roundings, sums in another order): 1e-2, since
# the two round y to bf16 from f32 sums that differ in the last bits, so an
# entry may land one bf16 step (2^-8 of it) away.
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
NORM_TOL = {"float32": 2e-5, "bfloat16": 0.05}
# The gated RMSNorm in bf16 (the Mamba2 norm): the same, but its outputs
# reach 8 and more (g = y * silu(z) is heavy-tailed), where one rounding step
# of the output is 0.0625; there the bound is one bf16 step, 2^-7 of |want|.
SSD_TOL = {"float32": 1e-5, "bfloat16": 3e-2}
SSD_TC_TOL = 1e-2
# Kernel path vs plain path at full width, teacher-forced, per step:
# max|diff|/max|logit|. In f32 the paths differ by the order of sums only.
# The card read at most 1.3e-5 (chatglm3-6b), 2.1e-5 (zamba2-7b) and 8.1e-6
# (mamba2-130m) over the 32 steps, and the bf16 control (the bf16 kernel path
# against the same f32 plain path) at least 3.2e-2, 6.0e-2 and 3.0e-2, which
# the script requires to fail this limit. In bf16 the kernel path's distance
# to the f32 plain path, over the bf16 plain path's, read 1.03, 1.10 and 0.99.
F32_LOGIT_TOL = 1e-4
BF16_ERR_RATIO = 1.5
# aten calls of one decode step of the kernel path as this script read them
# before the gate was fused into the norm and the wrapper lost its two views
# (H100 80GB HBM3, 700 W)
ATEN_CALLS_BEFORE = {"chatglm3-6b": 5197, "zamba2-7b": 26652,
                     "mamba2-130m": 6452}
# Routing is discontinuous: where the two f32 paths' hidden states differ in
# the last bits, a token whose k-th and (k+1)-th router weights nearly tie
# may go to another expert. The f32 check holds the logits at positions
# whose routing (every token of the row, in every layer and step so far)
# took the same decisions on both paths, and needs at least this share of
# the positions to be such.
MIN_CLEAN_SHARE = 0.5

# phase 10: the runtime (repro_torch.runtime) on the card. (a) the hybrid
# campaign of launch/hybrid_campaign.py with full-width, full-depth
# stablelm-3b as its surrogate: 2 rounds of 8 candidates, the SST batch
# 8 x 1,024 (phase 7's shape), 3 steps a round; its losses against the same
# steps called directly, bit for bit or within CAMPAIGN_LOSS_RTOL; (b) an
# LM service of 2 replicas on dragon, 16 requests of one 1,024-token prompt
# and 32 greedy new tokens each, the campaign's weights cut to their first
# SERVICE_DEPTH layers (the depth cut to keep the script within its
# 1,200 s: a request's decode is host-bound, its time by layer; at all 32
# layers the service's three passes took ~84 s); (c) checkpoint-restart
# through the
# runtime: mamba2-130m at 8 x 512, a checkpoint every 2 steps, a crash after
# step 4, resumed to step 6; (d) function-task throughput, no-op tasks
# through dragon and funcpool, alone and beside a flux task training
# stablelm-3b on the card
CAMPAIGN_ITERS, CAMPAIGN_DOCK, CAMPAIGN_STEPS = 2, 8, 3
CAMPAIGN_SEQ = TRAIN_SEQ
CAMPAIGN_LOSS_RTOL = 1e-6
SERVICE_REPLICAS, SERVICE_REQUESTS, SERVICE_DEPTH = 2, 16, 8
RESTART_STEPS, RESTART_EVERY, RESTART_CRASH = 6, 2, 4
THROUGHPUT_TASKS = 2000
THROUGHPUT_WORKERS = 4
TASK_TIMEOUT_S = 600

# phase 11: the rest of the paper's runtime on the card (Campaign, analytics,
# chaos, observability). (a) phase 10 (a)'s campaign as Stages through
# TaskManager.run_campaign under a Watcher ticking every WATCH_INTERVAL_S
# wall seconds; (b) an LM service of CHAOS_REPLICAS replicas on dragon
# under a CampaignScheduler, CHAOS_REQUESTS requests of phase 10 (b)'s
# shape, one node fault on dragon while requests are served. The rules'
# thresholds and the fault's time are set from this run's phase 10
# readings: (a)'s stall window STALL_FACTOR times phase 10 (a)'s longest
# train task (no task completes while one runs); (b)'s p99 limit phase 10
# (b)'s two-replica p99 (over 16 requests; 8 here), and the fault FAULT_AT
# of the way into one request served alone; (b) serves phase 10 (b)'s
# SERVICE_DEPTH layers. (b) has no stall rule: a replica never completes
# as a task does, it stops
WATCH_INTERVAL_S = 0.25
CHAOS_REPLICAS, CHAOS_REQUESTS = 2, 8
STALL_FACTOR = 2.0
FAULT_AT = 0.5

# phase 12: tensor parallelism over ``model`` and ZeRO-1 over ``data``
# (distributed/tensor_parallel.py) on ranks spawned on card 0 and joined over
# gloo (NCCL refuses two ranks on one device; gloo stages CUDA tensors
# through host memory). (a) f32 at full width and TP_DEPTH layers, one step
# of TP_BATCH x TRAIN_SEQ tokens per (arch, (data, model)) case against the
# one-rank kernel-path step on the same weights: chatglm3-6b's replicated-KV
# rule (2 kv heads over 4 ranks), stablelm-3b with ZeRO-1, deepseek's dense
# layer and one MoE layer (MLA; 64 experts as 16 a rank). The loss within
# GRAD_LOSS_TOL, every gathered gradient within GRAD_LEAF_TOL of its
# largest value (phase 7's limits), every gathered updated leaf and moment
# within GRAD_LEAF_TOL of the one-rank AdamW update on the same gradients
# (against the independent one-rank step Adam's first update m/(sqrt(v)+eps)
# turns rounding-level differences of gradients near eps into differences
# up to the learning rate). zamba2-7b (its gated norms in the RMSNorm
# kernel's split-row mode) at TP_DEPTH_OF's depth: one group of 6 Mamba2
# layers, the shared block, a tail layer (0.98 B parameters; a one-rank
# reference of full depth would not fit beside its ranks on one card);
# mamba2-130m at full size under dp_all with a row a rank, so the ranks of a
# model group hold other rows. (b) bf16 at full width on (1, 2), phase 7's
# batch and optimizer, TP_STEPS steps: stablelm-3b at 16 of its 32 layers
# (cut to make room for phase 16 within the script's 1,200 s; at full depth
# it was held to phase 7's first losses) and zamba2-7b at 13 layers (two
# groups and a tail, 1.45 B), each against a one-rank run of the same
# weights. The relative
# loss gaps are held by model, the first step (no update yet) on its own:
# twice the largest gap that four draws of the weights read, rounded up
# (seeds 0-3, `python3 scripts/tp_bf16_seeds.py 0 1 2 3`, H100 80GB HBM3,
# 700 W: stablelm-3b at 16 layers at most 5.18e-5 at step 1 and 1.83e-3
# after (1.06e-4 and 2.17e-3 at full depth), zamba2-7b 5.24e-5 and
# 5.60e-3; bf16 training moves apart in its updates).
TP_CASES = (("chatglm3-6b", (1, 4)), ("stablelm-3b", (2, 2)),
            ("deepseek-v2-lite-16b", (1, 4)), ("zamba2-7b", (1, 4)),
            ("zamba2-7b", (2, 2)), ("mamba2-130m", (2, 2)))
TP_DEPTH, TP_BATCH = 2, 2
TP_DEPTH_OF = {"zamba2-7b": 7, "mamba2-130m": 24}
TP_BATCH_OF = {"mamba2-130m": 4}
TP_BF16 = (("stablelm-3b", (1, 2), 16), ("zamba2-7b", (1, 2), 13))
TP_STEPS = 3
TP_FIRST_LOSS_GAP = {"stablelm-3b": 1.1e-4, "zamba2-7b": 1.2e-4}
TP_LOSS_GAP = {"stablelm-3b": 4e-3, "zamba2-7b": 1.2e-2}
TP_TIMEOUT_S = 900

# phase 13: tensor-parallel serving (launch/serve.py's generate over a mesh,
# tensor_parallel.ServeLayout) on ranks spawned on card 0 over gloo, as
# phase 12. (a) f32 at full width and cut depth, TPS_REQUESTS requests of
# TPS_PROMPT prompt tokens and TPS_NEW new tokens per case, in one call of
# 4 ranks, against the one-rank kernel-path generate of the same weights on
# rank 0: greedy tokens equal, the logits of every step teacher-forced on
# the tensor-parallel tokens within phase 5's F32_LOGIT_TOL (the MoE cases
# on the rows whose routing took the same decisions, MIN_CLEAN_SHARE of
# them at least), each rank's cache block after the prefill and after the
# last step within CACHE_TOL of the one-rank cache's (each leaf gathered
# and compared on rank 0), each rank's launches of the four kernels.
# chatglm3-6b's 2 kv heads over 4 ranks (the replicated-KV rule: the decode
# kernel reads a view of the whole cache), deepseek's dense layer and one
# MoE layer (MLA; 16 of its 64 experts a rank), phi3.5-moe's first 2 layers
# (4 of 16 experts, 2 of 8 kv heads a rank), zamba2-7b at TP_DEPTH_OF's 7
# layers on (1, 4) and (2, 2) (its gated norms in the split-row mode, at
# decode steps on 8 rows), mamba2-130m at full size under dp_all on (2, 2)
# (8 requests: the model group's ranks hold other rows). (b) bf16 at full
# width on (1, 2), phase 5's batch, in one call of 2 ranks: chatglm3-6b and
# zamba2-7b at TPS_BF16_DEPTH's layers, each rank drawing only its blocks of the seed's
# weights; the logits teacher-forced on a one-rank run's tokens (in this
# process, the same weights) within TPS_BF16_TOL of each step's largest,
# by model,
# and the prefill s, decode ms a step, each rank's peak memory and seconds
# in collectives (a second pass, each collective timed between two
# synchronizations).
TPS_CASES = (("chatglm3-6b", (1, 4)), ("deepseek-v2-lite-16b", (1, 4)),
             ("phi3.5-moe-42b-a6.6b", (1, 4)), ("zamba2-7b", (1, 4)),
             ("zamba2-7b", (2, 2)), ("mamba2-130m", (2, 2)))
TPS_REQUESTS, TPS_PROMPT, TPS_NEW = 8, 128, 8
CACHE_TOL = 1e-4
TPS_BF16 = ("chatglm3-6b", "zamba2-7b")
# (b)'s depth, cut to make room for phase 16 within the script's 1,200 s:
# a quarter of chatglm3-6b's 28 layers, and 2 of zamba2-7b's 13 groups of 6
# Mamba2 layers (each with its shared attention block) and one tail layer,
# phase 12 (b)'s depth
TPS_BF16_DEPTH = {"chatglm3-6b": 7, "zamba2-7b": 13}
# twice the largest gap that four draws of the weights read at
# TPS_BF16_DEPTH's layers, rounded up (seeds 0-3, `python3
# scripts/tp_bf16_seeds.py 0 1 2 3`, H100 80GB HBM3, 700 W: chatglm3-6b
# 2.115e-2 to 2.305e-2, zamba2-7b 3.382e-2 to 3.742e-2; at full depth
# 4.53e-2 to 4.85e-2 and 8.62e-2 to 9.55e-2 set 0.1 and 0.2, which
# scripts/seq_decode_step.py keeps for zamba2-7b at full size; two bf16
# paths that round in other places, the split's partial sums once more a
# layer)
TPS_BF16_TOL = {"chatglm3-6b": 0.05, "zamba2-7b": 0.08}

# phase 14: Flux partitions over the cards of this process (ROADMAP item
# 8c), LocalRuntime(mesh=make_local_mesh(), n_partitions=cards), every
# flux task inside its partition's placement. (a) one task a partition runs
# each of the four kernels on its card at phase 3's main-path shapes (bf16:
# chatglm3-6b's prefill and decode attention and its 8,192 x 4,096 norm,
# zamba2-7b's SSD scan against ssd_chunked_tc) with phase 3's limits; with
# more than one card a thread whose current device is card 0 then launches
# each onto tensors of the last card. (b) max(2, cards) stablelm-3b train
# tasks at full width and depth, phase 7's batch and optimizer,
# FLUX_TRAIN_STEPS steps each, task i's weights drawn from seed SEED + i
# on its card: each task's losses equal in every bit to the same seed's
# steps taken directly on card 0 (cards of one model; an unequal pair fails
# with its gap). (c) cards + 1 tasks each serving phase 10 (b)'s request
# (one PROMPT_LEN prompt, NEW_TOKENS greedy tokens, its own prompt) through
# launch/serve.py's generate: tokens equal to generate called directly on
# card 0, each task's decode ms a step (launch.serve.teacher_forced on its
# tokens) beside one task alone. On one card every queued task runs through
# the one partition
FLUX_TRAIN_STEPS = 2

# phase 15: query heads padded to slots over ``model`` (ROADMAP item 12f)
# and the sequence-parallel decode of one request (item 12h), on ranks
# spawned on card 0 over gloo as phases 12 and 13. (a) the decode kernel's
# softmax partial (decode_attention(..., return_lse=True)) against its plain
# version, f32 and bf16, o within ATTN_TOL and the log-sum-exp within
# LSE_TOL (absolute; an f32 sum in both paths, the bf16 products summed in
# another order), on blocks with no valid row, some and all; the blocks'
# partials combined against the whole-cache kernel within ATTN_TOL; its time
# at zamba2-7b's per-rank block of LSE_BLOCK positions. (b) HEADS_CASES, f32
# at full width and HEADS_DEPTH layers, a spawn of ranks a case (the two
# in one spawn of 16 ran the card out of memory): qwen2-vl-7b's 28 heads in
# 32 slots over 8 model ranks and musicgen-medium's 24 in 32 over 16
# (ranks 12-15 padding alone), each rank drawing its blocks in turn: one
# train step of HEADS_BATCH x HEADS_SEQ, the loss, every gradient and every
# updated leaf gathered on rank 0 (``_gather0``) against the one-rank step
# (phase 12 (a)'s limits; the moments, which the gradients set, are not
# gathered), the
# padding entries zero after HEADS_MORE_STEPS more steps, and
# serving of TPS_REQUESTS x TPS_PROMPT + TPS_NEW against one rank (phase 13
# (a)'s limits); each rank's launches. (c) batch 1 served
# sequence-parallel, the cache's sequence over ``data``: SEQ_F32_CASES f32
# at full width (zamba2-7b at SEQ_DEPTH_OF's 7 layers, phase 13 (a)'s cut)
# with a cache of SEQ_CAPACITY positions, a prompt of SEQ_PROMPT and SEQ_NEW
# new tokens (decoding crosses the block boundary at SEQ_CAPACITY / 2):
# tokens equal the one-rank run's, teacher-forced logits within SEQ_F32_TOL,
# each rank's cache block within CACHE_TOL of its block of the one-rank
# cache after the prefill and the last step, launches as kernel_launches
# says; then zamba2-7b bf16 at full size on (2, 1), a cache of
# SEQ_BF16_CAPACITY and a prompt of SEQ_BF16_PROMPT (both ranks hold
# rows), teacher-forced on a one-rank run's tokens, the logits within
# SEQ_BF16_TOL, prefill s, decode ms a step, seconds in collectives and
# peak memory a rank; the data group's combine timed on 2 ranks.
LSE_TOL = {"float32": 2e-5, "bfloat16": 1e-3}
LSE_BLOCK = 16384
HEADS_CASES = (("qwen2-vl-7b", (1, 8)), ("musicgen-medium", (1, 16)))
# one layer since phase 16 (two before), to make room for it within the
# script's 1,200 s: every layer holds the same padded slots
HEADS_DEPTH, HEADS_BATCH, HEADS_SEQ, HEADS_MORE_STEPS = 1, 2, 256, 1
SEQ_F32_CASES = (("zamba2-7b", (2, 1)), ("zamba2-7b", (2, 2)),
                 ("mamba2-130m", (2, 2)))
SEQ_DEPTH_OF = {"zamba2-7b": 7}
SEQ_CAPACITY, SEQ_PROMPT, SEQ_NEW = 8192, 4090, 16
SEQ_F32_TOL = 1e-5
SEQ_BF16_CAPACITY, SEQ_BF16_PROMPT, SEQ_BF16_NEW = 40960, 32768 + 32, 8
# twice the largest gap that four draws of the weights read, rounded up
# (seeds 0-3, scripts/seq_decode_bf16_seeds.py, H100 80GB HBM3, 700 W:
# 2.869e-02 to 3.098e-02, the prefill's logits equal in every bit; the
# decode steps' attention merged over the ranks in f32, then rounded once)
SEQ_BF16_TOL = 0.07

# phase 16: a Flux task's step over a partition of several local cards
# (ROADMAP item 8d). The flux executor runs such a task on a rank group it
# spawns over the partition's devices (launch/ranks.py): one process a
# device, joined into one process group (gloo where a card repeats, as
# here: every partition lists card 0 more than once), each rank calling the
# task with mesh= a mesh over the group. (a) LocalRuntime(mesh=
# make_local_mesh(2, devices=[cuda:0] * 6), n_partitions=3), three (1, 2)
# partitions at once: two stablelm-3b train tasks, phase 12 (a)'s case over
# the group's mesh (f32, full width, TP_DEPTH layers, one step of TP_BATCH x
# TRAIN_SEQ, rank 0 holding the loss, every gathered gradient, updated leaf
# and moment against the one-rank kernel-path step within phase 12 (a)'s
# limits), their bodies overlapping in time; and (c) a generate task,
# chatglm3-6b f32 at full width and TP_DEPTH layers, TPS_REQUESTS x
# TPS_PROMPT + TPS_NEW, each rank drawing its blocks of the seed's weights:
# tokens equal to one-rank generate in this process. A (2, 1) partition
# (make_local_mesh(1, devices=[cuda:0] * 2)) runs first, alone, (d) a task
# whose ranks each take FLUX_FAIL_GB of the card and whose rank 1 then
# raises while rank 0 waits for it in a collective: the task FAILED with
# rank 1's traceback, no rank left, the card's free memory back within
# FLUX_MEM_SLACK of what it was before the group (read for up to
# FLUX_MEM_WAIT_S: the driver frees a dead process's memory on its own
# time); then, beside (a) and (c), (b) the partition's next task,
# stablelm-3b's train step on (2, 1) (ZeRO-1 over data), DONE and held as
# (a). Every rank on card 0, its
# launches exact (the report's, counted in the rank from the task's start;
# the train body sets them to 0 after rank 0's one-rank reference, whose
# launches stay in rank 0's count by card).
FLUX_FAIL_GB = 2.0
FLUX_MEM_SLACK = 256 << 20
FLUX_MEM_WAIT_S = 20.0
FLUX_RANK_WALLTIME_S = 600.0


def check(ok, msg):
    if not ok:
        print(f"FAIL: {msg}", flush=True)
        sys.exit(1)


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Median time of one launch in ms, from CUDA events, with the 50 MB L2
    flushed before each launch as the main path finds it between layers.
    A device-side spin after the flush lets the host issue the launch before
    the start event is reached, so no host time falls between the events."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")

    def __call__(self, fn, iters=20, warmup=3):
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(iters):
            self.flush.zero_()
            torch.cuda._sleep(SPIN_CYCLES)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)


def max_err(a, b):
    return (a.float() - b.float()).abs().max().item()


def rel_err(a, b):
    return max_err(a, b) / (b.float().abs().max().item() + 1e-9)


# the flash backward kernel against the plain vjp computed in f32, per
# gradient max|diff| / max|want| (tests/test_torch_gpu.py's BWD_TOL): P and
# dS rounded to bf16 as tensor-core operands and each gradient once to bf16
FLASH_BWD_TOL = 1e-2
# the forward's log-sum-exp against the plain version's in f32, max|diff| /
# max|want|: both in f32 from the same bf16 scores, summed in other orders
FLASH_LSE_TOL = 1e-5


def flash_backward_times(torch, F, timer, q, k, v, scale, card):
    """Phase 4's flash attention at stablelm-3b's training shape (bf16 q, k,
    v of (B, S, H, hd)): the forward kernel and its log-sum-exp launch; the
    backward kernel through its autograd.Function (the training path's
    call), its launch alone and the device time of each of its two kernels
    (profiler: ``flash_bwd_dq``, which also writes D, and
    ``flash_bwd_wgmma``), beside its bound; the plain version and its vjp
    (still the route of f32 and of the widths the kernel lacks); SDPA's
    forward and backward, the library's yardstick. The log-sum-exp launch's
    output is held equal in every bit to the launch without it, and its
    log-sum-exp within FLASH_LSE_TOL of the plain version's; the kernel's
    gradients against the plain vjp in f32 (FLASH_BWD_TOL), one backward
    launch and no plain vjp counted. Returns the record."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.flash_attention import ops as fa_ops
    B, S, H, hd = q.shape
    pairs = B * H * S * (S + 1) // 2
    gen = torch.Generator(device=q.device).manual_seed(SEED + 1)
    dy = torch.randn(q.shape, generator=gen, device=q.device).to(q.dtype)
    leaves = [a.detach().requires_grad_() for a in (q, k, v)]
    b0 = (fa_ops.backward_launches, fa_ops.plain_backward_calls)
    y = fa_ops.flash_attention(*leaves, scale=scale)
    check(y.grad_fn.name() == "FlashAttentionBackward",
          f"flash attention under grad took {y.grad_fn.name()}, not the "
          f"backward kernel's route")
    got = torch.autograd.grad(y, leaves, dy, retain_graph=True)
    torch.cuda.synchronize()
    check((fa_ops.backward_launches, fa_ops.plain_backward_calls)
          == (b0[0] + 1, b0[1]), "the backward was not one backward launch")
    f32 = [a.detach().float().requires_grad_() for a in (q, k, v)]
    want = torch.autograd.grad(fa_ops.plain(*f32, scale=scale), f32,
                               dy.float())
    errs = [rel_err(a, b) for a, b in zip(got, want)]
    del f32, want
    print(f"[check] flash backward kernel at {tuple(q.shape)} bf16 vs the "
          f"plain vjp in f32: dq, dk, dv max|diff| / max|want| "
          + ", ".join(f"{e:.2e}" for e in errs)
          + f" (limit {FLASH_BWD_TOL})", flush=True)
    check(max(errs) < FLASH_BWD_TOL, f"flash backward errors {errs}")
    o, lse = fa_ops._launch_lse(q, k, v, scale=scale)
    same = torch.equal(y, o) and torch.equal(
        o, fa_ops._launch(q, k, v, scale=scale))
    check(same, "the forward with its log-sum-exp is not the forward "
          "without it, bit for bit")
    lse_err = rel_err(lse, fa_ops.plain_lse(q, k, v, scale=scale)[1])
    print(f"[check] flash forward's log-sum-exp at {tuple(q.shape)} bf16 vs "
          f"the plain version's: max|diff| / max|want| {lse_err:.2e} (limit "
          f"{FLASH_LSE_TOL}); its output equal in every bit to the launch "
          f"without it", flush=True)
    check(lse_err < FLASH_LSE_TOL, f"flash log-sum-exp error {lse_err}")
    y_p = fa_ops.plain(*leaves, scale=scale)
    lv = [a.transpose(1, 2) for a in leaves]
    y_l = F.scaled_dot_product_attention(*lv, is_causal=True, scale=scale)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            fa_ops._launch_bwd(q, k, v, o, lse, dy, scale=scale)
        torch.cuda.synchronize()
    # the two kernels, by name
    parts = {(re.search(r"flash_bwd_\w+", name) or [name[:40]])[0]:
             round(ms / 10, 5) for name, ms, _ in device_rows(prof)}
    r = dict(
        ms=timer(lambda: fa_ops.flash_attention(q, k, v, scale=scale), 50),
        lse_ms=timer(lambda: fa_ops._launch_lse(q, k, v, scale=scale), 50),
        bwd_ms=timer(lambda: torch.autograd.grad(y, leaves, dy,
                                                 retain_graph=True), 20),
        bwd_launch_ms=timer(lambda: fa_ops._launch_bwd(q, k, v, o, lse, dy,
                                                       scale=scale), 20),
        bwd_parts_ms=parts, bwd_errors=errs, lse_error=lse_err,
        plain_ms=timer(lambda: fa_ops.plain(q, k, v, scale=scale), 10),
        vjp_ms=timer(lambda: torch.autograd.grad(y_p, leaves, dy,
                                                 retain_graph=True), 10),
        library_ms=timer(lambda: F.scaled_dot_product_attention(
            *(a.transpose(1, 2) for a in (q, k, v)), is_causal=True,
            scale=scale), 50),
        library_bwd_ms=timer(lambda: torch.autograd.grad(
            y_l, lv, dy.transpose(1, 2), retain_graph=True), 20),
        # the two products forward, q, k, v read and o written once; five
        # in the backward (S = Q K^T again, dP, dV, dK, dQ), q, k, v, o, dO
        # read and dq, dk, dv written once
        flops=4 * hd * pairs, bytes=2 * 4 * q.numel(), dtype="bfloat16")
    add_bound(r)
    bwd = dict(flops=10 * hd * pairs, bytes=2 * 8 * q.numel(),
               dtype="bfloat16")
    add_bound(bwd)
    r.update(bwd_bound_ms=bwd["bound_ms"], bwd_bound_by=bwd["bound_by"])
    print(f"[time] flash_attention at stablelm-3b's training shape "
          f"{tuple(q.shape)} bf16: forward kernel {r['ms']:.4f} ms (with its "
          f"log-sum-exp {r['lse_ms']:.4f}; bound {r['bound_ms']:.4f}, "
          f"{r['bound_by']}; {r['bound_ms'] / r['ms']:.1%} of it); backward "
          f"kernel {r['bwd_ms']:.4f} ms through autograd, {r['bwd_launch_ms']:.4f}"
          f" ms its launch alone (bound {r['bwd_bound_ms']:.4f}, "
          f"{r['bwd_bound_by']}; {r['bwd_bound_ms'] / r['bwd_launch_ms']:.1%} "
          f"of it; device ms by kernel {parts}); plain forward "
          f"{r['plain_ms']:.4f} ms, its vjp {r['vjp_ms']:.4f} ms; library "
          f"forward {r['library_ms']:.4f} ms, backward "
          f"{r['library_bwd_ms']:.4f} ms  [{card}]", flush=True)
    del y, y_p, y_l, got, o, lse
    return r


def device_rows(prof):
    """(name, device ms, count) of the device-side events (kernels, copies)
    of a profile: CPU ops would count twice."""
    return [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")
            and e.self_device_time_total > 0]


def device_ms_per_call(torch, fn, n=50):
    """Device time of one call of fn, from the profiler: for calls shorter
    than their host launch, which CUDA events would time instead."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(ms for _, ms, _ in device_rows(prof)) / n


def kernel_ms_per_launch(torch, fn, kernel, n=50, tries=3):
    """Device time of the one launch of a kernel whose name holds
    ``kernel`` that each call of fn makes, and what took it: the profiler,
    where a profile of n calls holds exactly n such launches (a profile that missed some is
    taken again, ``tries`` times in all); else CUDA events around a CUDA
    graph of n calls, replayed (the graph's gaps between its launches
    included: at most the time). A reading that fails its check is never
    returned."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        rows = [(ms, c) for name, ms, c in device_rows(prof)
                if kernel in name]
        if sum(c for _, c in rows) == n:
            return sum(ms for ms, _ in rows) / n, "profiler"
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        graph.replay()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e) / n)
    del graph
    return statistics.median(times), "CUDA graph"


def sass_counts(lib_path, opcode):
    """{kernel function: count of `opcode` instructions} in a built library's
    SASS (cuobjdump from the toolkit that built it)."""
    from repro_torch.kernels import _build
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib_path)], check=True,
                          capture_output=True, text=True, timeout=300).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = 0
        elif fn is not None and re.search(rf"\b{opcode}\b", line):
            counts[fn] += 1
    return counts


def _noop(i):
    """A function task that does nothing (phase 10's throughput)."""
    return i


def _touch_cuda():
    """A function task that asks for the card: in a worker forked after the
    parent set up CUDA, torch refuses."""
    import torch
    return float(torch.ones(1, device="cuda").sum())


def main():
    import torch
    import torch.nn.functional as F
    started = time.perf_counter()
    mark = [started]

    def lap(what):
        """Print the seconds since the last lap: each phase's own time."""
        now = time.perf_counter()
        print(f"[device] {what} took {now - mark[0]:.1f} s", flush=True)
        mark[0] = now

    # ------------------------------------------------------------ 1. device
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    check(torch.cuda.device_count() >= 1, "no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    card = card_line()
    print(f"[device] {kind} x{count}; nvidia-smi: {card}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)

    from repro_torch.configs import get_config
    from repro_torch.distributed.serve_step import kernel_launches
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.decode_attention import ref as da_ref
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.fused_rmsnorm import ops as rn_ops
    from repro_torch.kernels.fused_rmsnorm import ref as rn_ref
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd import ref as ssd_ref
    ops_of = {"flash_attention": fa_ops, "decode_attention": da_ops,
              "fused_rmsnorm": rn_ops, "ssd": ssd_ops}

    # ------------------------------------------------------------- 2. build
    t0 = time.perf_counter()
    logs = _build.build_all()
    check(sorted(logs) == sorted(_build.CUDA_KERNELS) == sorted(ops_of),
          f"built {sorted(logs)}, not the four kernels {sorted(ops_of)}")
    for name, log in logs.items():
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", log)]
        spills = [int(m) for m in re.findall(r"(\d+) bytes spill stores", log)]
        check(regs, f"no ptxas report for {name}")
        print(f"[build] {name}: {len(regs)} kernel instantiations, "
              f"{min(regs)}-{max(regs)} registers/thread, "
              f"{sum(s > 0 for s in spills)} with spills (max {max(spills)} "
              f"bytes)")
    print(f"[build] CUDA kernels built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    # the bf16 kernels run on the tensor cores: flash attention through wgmma
    # (HGMMA), decode attention and the SSD scan through mma.sync (HMMA)
    for name, kernel, opcode in (("flash_attention", "flash_fwd_wgmma", "HGMMA"),
                                 ("flash_attention", "flash_bwd_dq", "HGMMA"),
                                 ("flash_attention", "flash_bwd_wgmma", "HGMMA"),
                                 ("decode_attention", "decode_fwd_split_mma",
                                  "HMMA"),
                                 ("ssd", "ssd_fwd_mma", "HMMA")):
        counts = sass_counts(_build._target(name), opcode)
        tc = {fn: n for fn, n in counts.items() if kernel in fn}
        print(f"[build] {name} SASS: {sum(tc.values())} {opcode} in "
              f"{len(tc)} bf16 {kernel} instantiations (min "
              f"{min(tc.values(), default=0)} each), "
              f"{sum(counts.values()) - sum(tc.values())} elsewhere", flush=True)
        check(tc and min(tc.values()) > 0,
              f"a bf16 {kernel} instantiation has no {opcode}: {tc}")
        if kernel == "flash_fwd_wgmma":
            # MLA's prefill: q/k 192 wide, v 128 (the template's mangling)
            mla = [n for fn, n in tc.items() if "ILi192ELi128E" in fn]
            print(f"[build] flash_attention (192, 128) instantiation for "
                  f"MLA: {mla[0] if mla else 0} HGMMA", flush=True)
            check(mla and mla[0] > 0, f"no (192, 128) flash instantiation "
                  f"with HGMMA: {sorted(tc)}")

    lap("phases 1 and 2 (the device, the build)")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32).to(dtype)

    cfgs = {arch: get_config(arch, **({"num_layers": SERVE_LAYERS[arch]}
                                      if arch in SERVE_LAYERS else {}))
            for arch in PATHS}
    glm = cfgs["chatglm3-6b"]
    zam = cfgs["zamba2-7b"]
    dsk = cfgs["deepseek-v2-lite-16b"]
    phi = cfgs["phi3.5-moe-42b-a6.6b"]
    # MLA's prefill widths: q/k nope + rope, v its own
    dsk_hd = dsk.qk_nope_head_dim + dsk.qk_rope_head_dim
    sl3 = get_config("stablelm-3b")
    B, S = N_REQUESTS, PROMPT_LEN
    S_cache = PROMPT_LEN + NEW_TOKENS
    results = {}

    # --------------------------------------------------- 3. kernel vs plain
    def flash_case(b, s, h, kv, dh, dtype, dh_v=None):
        dh_v = dh_v or dh
        q, k, v = (randn(b, s, h, dh, dtype=dtype), randn(b, s, kv, dh, dtype=dtype),
                   randn(b, s, kv, dh_v, dtype=dtype))
        scale = dh ** -0.5
        got = fa_ops.flash_attention(q, k, v, scale=scale)
        torch.cuda.synchronize()
        want = fa_ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                    v.transpose(1, 2), scale=scale).transpose(1, 2)
        return max_err(got, want), (q, k, v, scale)

    def decode_case(b, s, h, kv, dh, valid, dtype):
        q = randn(b, 1, h, dh, dtype=dtype)
        k, v = randn(b, s, kv, dh, dtype=dtype), randn(b, s, kv, dh, dtype=dtype)
        vl = torch.full((), valid, dtype=torch.int32, device=dev)
        got = da_ops.decode_attention(q, k, v, vl, scale=dh ** -0.5)
        torch.cuda.synchronize()
        want = da_ref.decode_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                           v.transpose(1, 2), vl,
                                           scale=dh ** -0.5).transpose(1, 2)
        return max_err(got, want), (q, k, v, vl, dh ** -0.5)

    def norm_case(rows, dim, dtype, gated):
        x, w = randn(rows, dim, dtype=dtype), randn(dim, dtype=dtype) * 0.1
        gate = randn(rows, dim, dtype=dtype) if gated else None
        got = rn_ops.rmsnorm(x, w, eps=glm.norm_eps, gate=gate)
        torch.cuda.synchronize()
        check(got.shape == x.shape and got.dtype == x.dtype,
              f"fused_rmsnorm ({rows}, {dim}) output")
        want = rn_ref.rmsnorm_ref(x, w, eps=glm.norm_eps, gate=gate).float()
        tol = NORM_TOL["float32" if dtype == torch.float32 else "bfloat16"]
        bound = torch.full_like(want, tol)
        if gated and dtype == torch.bfloat16:
            bound = torch.maximum(bound, want.abs() * 2.0 ** -7)
        diff = (got.float() - want).abs()
        return diff.max().item(), (diff / bound).max().item(), (x, w, gate)

    def ssd_case(shape, chunk, dtype, slow_decay):
        """dt = softplus(z - 4) (slow decay) carries the state across
        chunks as the model's small dt does; softplus(z) as the JAX tests.
        The oracle is the recurrence ssd_naive in f32 (on the bf16 inputs in
        bf16); max|err| of y is taken against the plain ssd_chunked, in f32
        against the oracle. Also the distance to the bf16 kernel's plain
        version ssd_chunked_tc (checked) or, in f32, to ssd_chunked and its
        own distance to ssd_naive (printed)."""
        b, s, h, g, p, n = shape
        x = randn(b, s, h, p, dtype=dtype)
        dt = F.softplus(randn(b, s, h, dtype=torch.float32)
                        - (4.0 if slow_decay else 0.0))
        A = -torch.exp(torch.rand(h, generator=gen, device=dev) * 2.0)
        Bm, Cm = randn(b, s, g, n, dtype=dtype), randn(b, s, g, n, dtype=dtype)
        y, hf = ssd_ops.ssd(x, dt, A, Bm, Cm, chunk=chunk, use_pallas=True)
        torch.cuda.synchronize()
        check(y.dtype == x.dtype and hf.dtype == torch.float32
              and tuple(hf.shape) == (b, h, p, n), f"ssd {shape} outputs")

        def rel2(a, b):
            return max(rel_err(a[0], b[0]), rel_err(a[1], b[1]))

        oracle = ssd_ref.ssd_naive(x.float(), dt, A, Bm.float(), Cm.float())
        chunked = ssd_ref.ssd_chunked(x, dt, A, Bm, Cm, chunk=chunk)
        if dtype == torch.float32:
            plain_err = None
            note = (f"; vs ssd_chunked {rel2((y, hf), chunked):.3e}, "
                    f"ssd_chunked vs ssd_naive {rel2(chunked, oracle):.3e}")
            chunked = oracle
        else:
            tc = ssd_ref.ssd_chunked_tc(x, dt, A, Bm, Cm, chunk=chunk)
            plain_err = rel2((y, hf), tc)
            note = (f"; vs its plain version ssd_chunked_tc {plain_err:.3e} "
                    f"(tol {SSD_TC_TOL})")
        return (rel2((y, hf), oracle), max_err(y, chunked[0]),
                (x, dt, A, Bm, Cm, chunk), note, plain_err)

    zH, zP, zN = zam.ssm_heads, zam.ssm_head_dim, zam.ssm_state
    mam = cfgs["mamba2-130m"]
    ssd_shapes = (
        ("zamba2-7b prefill", (B, S, zH, zam.ssm_groups, zP, zN), zam.ssm_chunk),
        ("mamba2-130m prefill", (B, S, mam.ssm_heads, mam.ssm_groups,
                                 mam.ssm_head_dim, mam.ssm_state), mam.ssm_chunk),
        ("ragged, grouped", (1, 1000, 8, 2, 64, 64), 256))
    inputs = {}
    for dtype_name, dtype in (("bfloat16", torch.bfloat16),
                              ("float32", torch.float32)):
        for label, shape in (
                ("chatglm3-6b prefill", (B, S, glm.num_heads, glm.num_kv_heads,
                                         glm.head_dim)),
                ("zamba2-7b prefill", (B, S, zam.num_heads, zam.num_kv_heads,
                                       zam.head_dim)),
                ("stablelm-3b hd80 ragged", (2, 200, 32, 32, 80)),
                ("stablelm-3b train", (B, S, sl3.num_heads, sl3.num_kv_heads,
                                       sl3.head_dim)),
                ("deepseek-v2-lite-16b prefill",
                 (B, S, dsk.num_heads, dsk.num_kv_heads, dsk_hd,
                  dsk.v_head_dim)),
                ("deepseek-v2-lite-16b ragged, G 4", (2, 200, 16, 4, dsk_hd,
                                                      dsk.v_head_dim)),
                ("phi3.5-moe-42b-a6.6b prefill",
                 (B, S, phi.num_heads, phi.num_kv_heads, phi.head_dim))):
            err, args = flash_case(*shape[:5], dtype, *shape[5:])
            tol = ATTN_TOL[dtype_name]
            print(f"[check] flash_attention {label} {shape} {dtype_name}: "
                  f"max|err| {err:.3e} (tol {tol})", flush=True)
            check(err < tol, f"flash_attention {shape} {dtype_name}: {err}")
            if dtype_name == "bfloat16" and label.endswith(("prefill",
                                                            "train")):
                inputs[f"flash_attention/{label.split()[0]}"] = args
                if label.startswith("chatglm"):
                    results["flash_attention"] = {"max_abs_err": err}
        for label, (h, kv, dh), valid in (
                ("chatglm3-6b", (glm.num_heads, glm.num_kv_heads, glm.head_dim),
                 PROMPT_LEN + 1),
                ("chatglm3-6b", (glm.num_heads, glm.num_kv_heads, glm.head_dim),
                 17),
                ("zamba2-7b", (zam.num_heads, zam.num_kv_heads, zam.head_dim),
                 PROMPT_LEN + 1),
                ("phi3.5-moe-42b-a6.6b", (phi.num_heads, phi.num_kv_heads,
                                          phi.head_dim), PROMPT_LEN + 1)):
            shape = (B, S_cache, h, kv, dh)
            err, args = decode_case(*shape, valid, dtype)
            tol = ATTN_TOL[dtype_name]
            print(f"[check] decode_attention {label} {shape} valid_len {valid} "
                  f"{dtype_name}: max|err| {err:.3e} (tol {tol})", flush=True)
            check(err < tol, f"decode_attention {shape}@{valid}: {err}")
            if dtype_name == "bfloat16" and valid == PROMPT_LEN + 1:
                inputs[f"decode_attention/{label}"] = args
                if label == "chatglm3-6b":
                    results["decode_attention"] = {"max_abs_err": err}
        # every width a norm of the main paths has, gated (the Mamba2 norm,
        # y * silu(z) normalized) and not; d = 77 takes the scalar kernel
        for rows in (B * S, B):
            for dim in (glm.d_model, zam.d_model, zam.ssm_d_inner, mam.d_model,
                        mam.ssm_d_inner, sl3.d_model, dsk.d_model,
                        dsk.kv_lora_rank, 77):
                for gated in (False, True):
                    err, share, args = norm_case(rows, dim, dtype, gated)
                    label = "gated " if gated else ""
                    print(f"[check] {label}fused_rmsnorm ({rows}, {dim}) "
                          f"{dtype_name}: max|err| {err:.3e}, {share:.2f} of "
                          f"the bound (tol {NORM_TOL[dtype_name]}"
                          f"{', or 2^-7 of |want|' if label and dtype_name == 'bfloat16' else ''})",
                          flush=True)
                    check(share < 1, f"{label}fused_rmsnorm ({rows},{dim}) "
                          f"{dtype_name}: {err}")
                    if dtype_name == "bfloat16":
                        inputs[f"fused_rmsnorm/{label}{rows}x{dim}"] = args
                        if rows == B * S and dim == glm.d_model and not gated:
                            results["fused_rmsnorm"] = {"max_abs_err": err}
        for label, shape, chunk in ssd_shapes:
            for slow in (False, True):
                err, abs_err, args, note, plain_err = ssd_case(
                    shape, chunk, dtype, slow)
                tol = SSD_TOL[dtype_name]
                print(f"[check] ssd {label} {shape} chunk {chunk} "
                      f"{'slow' if slow else 'fast'} decay {dtype_name}: "
                      f"max|err|/max|want| {err:.3e} of y and the final state "
                      f"vs ssd_naive (tol {tol}), max|err| of y vs "
                      f"{'ssd_naive' if dtype_name == 'float32' else 'ssd_chunked'}"
                      f" {abs_err:.3e}{note}", flush=True)
                check(err < tol, f"ssd {shape} {dtype_name}: {err}")
                check(plain_err is None or plain_err < SSD_TC_TOL,
                      f"ssd {shape} bf16 vs ssd_chunked_tc: {plain_err}")
                if dtype_name == "bfloat16" and slow:
                    inputs[f"ssd/{label}"] = args
                    if label.startswith("zamba2"):
                        results["ssd"] = {"max_abs_err": abs_err}
        err, _, _, note, plain_err = ssd_case((2, 100, 4, 2, 16, 32), 32,
                                              dtype, True)
        print(f"[check] ssd (2, 100, 4, 2, 16, 32) chunk 32 vs ssd_naive "
              f"{dtype_name}: {err:.3e} (tol {SSD_TOL[dtype_name]}){note}",
              flush=True)
        check(err < SSD_TOL[dtype_name], f"ssd vs naive {dtype_name}: {err}")
        check(plain_err is None or plain_err < SSD_TC_TOL,
              f"ssd (2, 100, 4, 2, 16, 32) bf16 vs ssd_chunked_tc: {plain_err}")

    lap("phase 3 (each kernel against its plain version)")
    # ------------------------------------------------------- 4. kernel times
    timer = Timer(torch)
    valid = PROMPT_LEN + 1
    # flash and decode attention at both attention shapes of the main paths;
    # chatglm3-6b's go into the summary line, zamba2-7b's beside them
    for arch, c in (("chatglm3-6b", glm), ("zamba2-7b", zam)):
        H, KV, hd = c.num_heads, c.num_kv_heads, c.head_dim
        q, k, v, scale = inputs[f"flash_attention/{arch}"]
        pairs = B * H * S * (S + 1) // 2                  # causal (q, k) pairs
        nbytes = 2 * (q.numel() * 2 + k.numel() + v.numel())  # q, o, k, v
        flash = dict(
            ms=timer(lambda: fa_ops.flash_attention(q, k, v, scale=scale)),
            plain_ms=timer(lambda: fa_ref.attention_ref(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                scale=scale), iters=5),
            library_ms=timer(lambda: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=True, scale=scale, enable_gqa=True)),
            flops=4 * hd * pairs, bytes=nbytes, dtype="bfloat16")

        q, k, v, vl, scale = inputs[f"decode_attention/{arch}"]
        mask = (torch.arange(S_cache, device=dev) < vl)[None, None, None, :]
        kernel = lambda: da_ops.decode_attention(q, k, v, vl, scale=scale)
        sdpa = lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, scale=scale, enable_gqa=True)
        decode = dict(
            ms=timer(kernel, 50),
            plain_ms=timer(lambda: da_ref.decode_attention_ref(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), vl,
                scale=scale)),
            library_ms=timer(sdpa, 50),
            # the split and combine kernels' device time, without the gap
            # between their launches that the events include
            device_ms=device_ms_per_call(torch, kernel),
            library_device_ms=device_ms_per_call(torch, sdpa),
            flops=4 * B * H * hd * valid,
            bytes=2 * (2 * B * valid * KV * hd + 2 * B * H * hd) + 4,
            dtype="bfloat16")
        n_split, rows = da_ops.split_plan(
            B, KV, S_cache, torch.cuda.get_device_properties(dev)
            .multi_processor_count)
        blocks = B * KV * n_split * -(-(H // KV) // 16)
        print(f"[time] decode_attention {arch}: {n_split} splits of {rows} "
              f"rows, {blocks} blocks; device time per call {decode['device_ms']:.5f}"
              f" ms (profiler, split + combine), SDPA {decode['library_device_ms']:.5f}"
              f" ms  [{card}]", flush=True)
        if arch == "chatglm3-6b":
            check(blocks >= torch.cuda.get_device_properties(dev)
                  .multi_processor_count,
                  f"the decode grid has {blocks} blocks at {arch}'s shape")
            results["flash_attention"].update(flash)
            results["decode_attention"].update(decode)
        else:
            for name, r in (("flash_attention", flash),
                            ("decode_attention", decode)):
                add_bound(r)
                results[name]["zamba2_7b_shape"] = r
                print(f"[time] {name} at {arch}'s shape: kernel {r['ms']:.4f} "
                      f"ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}; "
                      f"{r['bound_ms'] / r['ms']:.1%} of it), plain "
                      f"{r['plain_ms']:.4f} ms, SDPA {r['library_ms']:.4f} ms"
                      f"  [{card}]", flush=True)

    # flash attention at deepseek-v2-lite-16b's MLA prefill shape: q/k 192
    # wide, v and the output 128, 16 heads over 16 KV heads; beside SDPA on
    # the same 128-wide V
    q, k, v, scale = inputs["flash_attention/deepseek-v2-lite-16b"]
    pairs = B * q.shape[2] * S * (S + 1) // 2
    mla = dict(
        ms=timer(lambda: fa_ops.flash_attention(q, k, v, scale=scale)),
        plain_ms=timer(lambda: fa_ref.attention_ref(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            scale=scale), iters=5),
        library_ms=timer(lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, scale=scale)),
        # Q K^T over 192 and P V over 128 for each causal (q, k) pair; q, k,
        # v read and o written once
        flops=2 * (q.shape[3] + v.shape[3]) * pairs,
        bytes=2 * (q.numel() + k.numel() + v.numel() + q.numel()
                   // q.shape[3] * v.shape[3]),
        dtype="bfloat16")
    add_bound(mla)
    results["flash_attention"]["deepseek_v2_lite_16b_mla_shape"] = mla
    print(f"[time] flash_attention at deepseek-v2-lite-16b's MLA prefill shape "
          f"{tuple(q.shape)} q/k, {tuple(v.shape)} v: kernel {mla['ms']:.4f} "
          f"ms, bound {mla['bound_ms']:.4f} ms ({mla['bound_by']}; "
          f"{mla['bytes'] / 1e6:.1f} MB -> "
          f"{mla['bytes'] / PEAK_BYTES_PER_S * 1e3:.4f} ms by bytes, "
          f"{mla['flops'] / 1e9:.1f} GFLOP -> "
          f"{mla['flops'] / PEAK_FLOPS['bfloat16'] * 1e3:.4f} ms by "
          f"operations; {mla['bound_ms'] / mla['ms']:.1%} of it), plain "
          f"{mla['plain_ms']:.4f} ms, SDPA {mla['library_ms']:.4f} ms  "
          f"[{card}]", flush=True)

    # RMSNorm. Rows of a prefill by CUDA events; a decode step's rows (8 x d)
    # take less device time than the host's launch of them, so events would
    # time the host: the profiler's device time reads those, here and in
    # phase 6. The gated norm (the Mamba2 block's) is timed beside the three
    # eager calls it replaces (F.silu, the product, F.rms_norm).
    eps = glm.norm_eps
    d = glm.d_model
    norm = results["fused_rmsnorm"]
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count

    def norm_fns(key):
        x, w, gate = inputs[f"fused_rmsnorm/{key}"]
        dim, n = x.shape[-1], x.numel()
        w1 = (1.0 + w.float()).to(x.dtype)
        if gate is None:                    # one PyTorch call computes it
            lib = lambda: F.rms_norm(x, (dim,), weight=w1, eps=eps)
        else:
            lib = lambda: F.rms_norm(x * F.silu(gate), (dim,), weight=w1,
                                     eps=eps)
        return dict(
            kernel=lambda: rn_ops.rmsnorm(x, w, eps=eps, gate=gate),
            plain=lambda: rn_ref.rmsnorm_ref(x, w, eps=eps, gate=gate),
            lib=lib,
            # x (and the gate) read once, out written once, w; the square,
            # sum and two scalings an element, and silu's four and the
            # product with a gate (f32 arithmetic)
            flops=(4 if gate is None else 9) * n,
            bytes=x.element_size() * ((2 if gate is None else 3) * n + dim),
            dtype="float32", plan=rn_ops.plan(x.shape[0], dim,
                                              16 // x.element_size(), True,
                                              n_sm, gate is not None))

    for key, name, label in (
            (f"{B * S}x{d}", None, "chatglm3-6b prefill"),
            (f"gated {B * S}x{zam.ssm_d_inner}", "gated_zamba2_7b_prefill",
             "zamba2-7b Mamba2 norm, prefill"),
            (f"gated {B * S}x{mam.ssm_d_inner}", "gated_mamba2_130m_prefill",
             "mamba2-130m Mamba2 norm, prefill")):
        f = norm_fns(key)
        r = dict(ms=timer(f["kernel"], 50), plain_ms=timer(f["plain"], 20),
                 flops=f["flops"], bytes=f["bytes"], dtype=f["dtype"])
        other = timer(f["lib"], 50)
        add_bound(r)
        yard = "F.rms_norm" if name is None else "eager silu + mul + F.rms_norm"
        print(f"[time] {key} bf16 fused_rmsnorm ({label}; plan "
              f"{f['plan']}): "
              f"kernel {r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}, {r['bytes'] / 1e6:.1f} MB; "
              f"{r['bound_ms'] / r['ms']:.1%} of it), plain {r['plain_ms']:.4f}"
              f" ms, {yard} {other:.4f} ms  [{card}]", flush=True)
        if name is None:
            norm.update(r, library_ms=other)
        else:
            # the gated rows' persistent grid against a block per row block
            x, w, gate = inputs[f"fused_rmsnorm/{key}"]
            threads, rpb, _ = f["plan"]
            out = torch.empty_like(x)
            fwd = rn_ops._load()
            one_pass = lambda: fwd(
                x.data_ptr(), gate.data_ptr(), w.data_ptr(), out.data_ptr(), 1,
                x.shape[0], x.shape[1], x.shape[1], x.shape[1], eps, threads,
                rpb, -(-x.shape[0] // rpb),
                torch.cuda.current_stream().cuda_stream, x.get_device())
            r["one_block_a_row_block_ms"] = timer(one_pass, 50)
            print(f"[time] {key} bf16 fused_rmsnorm with a block per row "
                  f"block instead of the persistent grid: "
                  f"{r['one_block_a_row_block_ms']:.4f} ms  [{card}]",
                  flush=True)
            r["eager_ms"] = other
            norm[name] = r
    gz = norm["gated_zamba2_7b_prefill"]
    for target, met in (
            (f"{B * S} x {d} at most 0.0504 ms and at least 80% of its bound",
             norm["ms"] <= 0.0504 and norm["bound_ms"] >= 0.8 * norm["ms"]),
            (f"gated {B * S} x {zam.ssm_d_inner} faster than the three eager "
             f"calls and at least 70% of its bound",
             gz["ms"] < gz["eager_ms"] and gz["bound_ms"] >= 0.7 * gz["ms"])):
        print(f"[time] fused_rmsnorm target, {target}: "
              f"{'met' if met else 'missed'}", flush=True)

    for key, name, yard in (
            (f"{B}x{d}", "decode_8x4096", "F.rms_norm"),
            (f"gated {B}x{zam.ssm_d_inner}", "gated_decode_8x7168",
             "eager silu + mul + F.rms_norm")):
        f = norm_fns(key)
        r = dict(device_ms=device_ms_per_call(torch, f["kernel"]),
                 plain_device_ms=device_ms_per_call(torch, f["plain"]),
                 yardstick_device_ms=device_ms_per_call(torch, f["lib"]),
                 bound_ms=f["bytes"] / PEAK_BYTES_PER_S * 1e3, bound_by="bytes")
        norm[name] = r
        print(f"[time] {key} bf16 fused_rmsnorm (plan "
              f"{f['plan']}): "
              f"{r['device_ms']:.5f} ms of device time per call (profiler, 50 "
              f"calls); plain {r['plain_device_ms']:.5f} ms, {yard} "
              f"{r['yardstick_device_ms']:.5f} ms; bound {r['bound_ms']:.6f} ms"
              f" (bytes)  [{card}]", flush=True)
    met = norm["decode_8x4096"]["device_ms"] <= 0.00152
    print(f"[time] fused_rmsnorm target, {B} x {d} device time per call at "
          f"most 0.00152 ms (the Triton kernel's before): "
          f"{'met' if met else 'missed'}", flush=True)

    # the zamba2-7b shape goes into the summary; mamba2-130m's (N 128) beside
    # it, each with its own bound
    for label, _, _ in ssd_shapes[:2]:
        x, dt, A, Bm, Cm, chunk = inputs[f"ssd/{label}"]
        flops, nbytes = ssd_work(*x.shape[:3], Bm.shape[2], x.shape[3],
                                 Bm.shape[3], chunk, x.element_size())
        r = dict(
            ms=timer(lambda: ssd_ops.ssd(x, dt, A, Bm, Cm, chunk=chunk,
                                         use_pallas=True)),
            plain_ms=timer(lambda: ssd_ref.ssd_chunked(x, dt, A, Bm, Cm,
                                                       chunk=chunk), iters=5),
            library_ms=None,            # no PyTorch call computes the scan
            flops=flops, bytes=nbytes, dtype="bfloat16")
        add_bound(r)
        print(f"[time] ssd {label} {tuple(x.shape)} N {Bm.shape[3]}: kernel "
              f"{r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}; {r['bound_ms'] / r['ms']:.1%} of it; "
              f"{flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB), plain "
              f"ssd_chunked {r['plain_ms']:.4f} ms, "
              f"{x.shape[0] * x.shape[2]} blocks  [{card}]", flush=True)
        if label.startswith("zamba2"):
            results["ssd"].update(r)
        else:
            results["ssd"]["mamba2_130m_shape"] = r

    # The training path's shapes (stablelm-3b, bf16): flash attention's
    # forward beside its backward kernel (flash_backward_times); RMSNorm's
    # forward beside its backward, which is its autograd.Function's (the
    # plain version recomputed from the saved inputs, and its vjp), the
    # plain vjp alone, and the library call's forward and backward.
    q, k, v, scale = inputs["flash_attention/stablelm-3b"]
    results["flash_attention"]["train_shape_hd80"] = flash_backward_times(
        torch, F, timer, q, k, v, scale, card)
    xt, wt, _ = inputs[f"fused_rmsnorm/{B * S}x{sl3.d_model}"]
    n, dim = xt.numel(), xt.shape[-1]
    leaves = [a.detach().requires_grad_() for a in (xt, wt)]
    y = rn_ops.rmsnorm(*leaves, eps=eps)
    check(y.grad_fn is not None and "Backward" in y.grad_fn.name(),
          f"fused_rmsnorm under grad returned {y.grad_fn} (no "
          f"autograd.Function)")
    dy = randn(*y.shape, dtype=y.dtype)
    y_p = rn_ref.rmsnorm_ref(*leaves, eps=eps)
    y_l = F.rms_norm(leaves[0], (dim,), weight=1.0 + leaves[1], eps=eps)
    got = torch.autograd.grad(y, leaves, dy, retain_graph=True)
    want = torch.autograd.grad(y_p, leaves, dy, retain_graph=True)
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          "fused_rmsnorm backward is not the plain version's vjp")
    r = dict(
        ms=timer(lambda: rn_ops.rmsnorm(xt, wt, eps=eps), 50),
        bwd_ms=timer(lambda: torch.autograd.grad(y, leaves, dy,
                                                 retain_graph=True), 10),
        plain_ms=timer(lambda: rn_ref.rmsnorm_ref(xt, wt, eps=eps), 10),
        vjp_ms=timer(lambda: torch.autograd.grad(y_p, leaves, dy,
                                                 retain_graph=True), 10),
        library_ms=timer(lambda: F.rms_norm(xt, (dim,), weight=1.0 + wt,
                                            eps=eps), 50),
        library_bwd_ms=timer(lambda: torch.autograd.grad(
            y_l, leaves, dy, retain_graph=True), 20),
        # x read, out written (and x, dy read, dx written, w and dw)
        flops=4 * n, bytes=2 * (2 * n + dim), dtype="bfloat16")
    add_bound(r)
    bwd = dict(flops=8 * n, bytes=2 * (3 * n + 2 * dim), dtype="bfloat16")
    add_bound(bwd)
    r.update(bwd_bound_ms=bwd["bound_ms"], bwd_bound_by=bwd["bound_by"],
             vjp_share=r["vjp_ms"] / r["bwd_ms"])
    results["fused_rmsnorm"][f"train_shape_{B * S}x{dim}"] = r
    del y, y_p, y_l, leaves, got, want
    print(f"[time] fused_rmsnorm at stablelm-3b's training shape "
          f"{tuple(xt.shape)} bf16: forward kernel {r['ms']:.4f} ms "
          f"(bound {r['bound_ms']:.4f}, {r['bound_by']}; "
          f"{r['bound_ms'] / r['ms']:.1%} of it); backward (the plain "
          f"version recomputed + its vjp) {r['bwd_ms']:.4f} ms (bound "
          f"{r['bwd_bound_ms']:.4f}, {r['bwd_bound_by']}; "
          f"{r['bwd_bound_ms'] / r['bwd_ms']:.1%} of it), of which the "
          f"plain vjp alone {r['vjp_ms']:.4f} ms ({r['vjp_share']:.1%}); "
          f"plain forward {r['plain_ms']:.4f} ms; library forward "
          f"{r['library_ms']:.4f} ms, backward {r['library_bwd_ms']:.4f} "
          f"ms  [{card}]", flush=True)

    # host time to issue one call at the decode step's shapes: at batch 8 a
    # decode step is a chain of small launches, so this bounds its speed.
    # Beside each, this script's reading before the RMSNorm kernel was CUDA
    # C++ (H100 80GB HBM3, 700 W), where it had one.
    qd, kd, vd, vld, sd = inputs["decode_attention/chatglm3-6b"]
    x8, w8, _ = inputs[f"fused_rmsnorm/{B}x{d}"]
    y8, wg8, z8 = inputs[f"fused_rmsnorm/gated {B}x{zam.ssm_d_inner}"]
    w8_1 = (1.0 + w8.float()).to(x8.dtype)
    wg8_1 = (1.0 + wg8.float()).to(y8.dtype)
    di = zam.ssm_d_inner
    host = {}
    for label, fn, before in (
            ("decode_attention wrapper",
             lambda: da_ops.decode_attention(qd, kd, vd, vld, scale=sd),
             "78.8 us, 64.1 us on the first slice"),
            (f"fused_rmsnorm wrapper ({B} x {d})",
             lambda: rn_ops.rmsnorm(x8, w8, eps=eps), "59.4 us, Triton"),
            (f"fused_rmsnorm launch alone, without the wrapper's device, "
             f"gate and grad checks ({B} x {d})",
             lambda: rn_ops._launch(x8, w8, None, eps=eps), "not measured"),
            (f"gated fused_rmsnorm wrapper ({B} x {di})",
             lambda: rn_ops.rmsnorm(y8, wg8, eps=eps, gate=z8),
             "none: the eager silu and product ran, then the norm"),
            (f"eager F.silu + mul + F.rms_norm ({B} x {di})",
             lambda: F.rms_norm(y8 * F.silu(z8), (di,), weight=wg8_1, eps=eps),
             "not measured"),
            (f"F.rms_norm ({B} x {d})",
             lambda: F.rms_norm(x8, (d,), weight=w8_1, eps=eps), "23.4 us"),
            (f"torch add ({B} x {d})", lambda: x8 + x8, "13.6 us")):
        fn()
        torch.cuda.synchronize()
        rounds = []
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(200):
                fn()
            rounds.append((time.perf_counter() - t0) / 200 * 1e6)
            torch.cuda.synchronize()
        host[label] = statistics.median(rounds)
        print(f"[host] {label}: {host[label]:.1f} us of host time per call "
              f"(median of 5 x 200 calls; before: {before})", flush=True)
    ratio = (host[f"fused_rmsnorm wrapper ({B} x {d})"]
             / host[f"F.rms_norm ({B} x {d})"])
    print(f"[host] target, the RMSNorm wrapper's host time per call at most "
          f"F.rms_norm's: {'met' if ratio <= 1 else 'missed'} ({ratio:.2f}x)",
          flush=True)
    norm["host_us_per_call"] = {k: v for k, v in host.items()
                                if "rms" in k}

    for name, r in results.items():
        add_bound(r)
        lib = ("none" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms")
        print(f"[time] {name}: kernel {r['ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}; {r['bound_ms'] / r['ms']:.1%}"
              f" of it), plain {r['plain_ms']:.4f} ms, library {lib}  "
              f"[{card}]", flush=True)
    del inputs, q, k, v, x, w, gate, out, x8, w8, y8, wg8, z8, qd, kd, vd, dt, \
        A, Bm, Cm
    torch.cuda.empty_cache()

    lap("phase 4 (kernel times)")
    # ------------------------------------------------ 5. and 6. main paths
    launches, served = {}, {}
    for arch in PATHS:
        launches[arch], served[arch] = serve_and_hold(torch, cfgs[arch],
                                                      ops_of, card, dev)
        torch.cuda.empty_cache()

    lap("phases 5 and 6 (serving, profiles)")
    # ------------------------------------------------------------ 7. training
    trained = {arch: train_and_hold(torch, get_config(arch), ops_of, card,
                                    dev)
               for arch in TRAIN_PATHS}
    train_launches = {arch: trained[arch][0] for arch in TRAIN_PATHS}
    torch.cuda.empty_cache()
    for arch, depth in PARITY_DEPTH.items():
        grad_parity(torch, arch, depth, ops_of, card, dev)
        torch.cuda.empty_cache()
    checkpoint_round_trip(torch, get_config("mamba2-130m"), card, dev)

    lap("phase 7 (training)")
    # ---------------------------------------------------- 8. training driver
    driver_launches = {
        "stablelm-3b": drive_stablelm(torch, ops_of, trained["stablelm-3b"][1],
                                      card),
        "mamba2-130m": drive_mamba(torch, ops_of, card, dev)}
    torch.cuda.empty_cache()

    lap("phase 8 (the training driver)")
    # ------------------------------------------------- 9. dry-run vs the card
    measured_s = {("stablelm-3b", "train"): trained["stablelm-3b"][1],
                  ("mamba2-130m", "train"): trained["mamba2-130m"][1],
                  ("chatglm3-6b", "prefill"): served["chatglm3-6b"]["prefill_s"],
                  ("chatglm3-6b", "decode"):
                      served["chatglm3-6b"]["decode_ms"] / 1e3}
    for arch, step_kind, seq, batch in DRYRUN_CELLS:
        dryrun_vs_card(torch, arch, step_kind, seq, batch,
                       measured_s[(arch, step_kind)], card)
        torch.cuda.empty_cache()

    lap("phase 9 (the dry-run against the card)")
    # ------------------------------------------------- 10. the runtime
    runtime_launches, readings = runtime_on_card(
        torch, ops_of, card, dev, get_config("stablelm-3b"),
        get_config("mamba2-130m"), trained["stablelm-3b"][1])
    torch.cuda.empty_cache()

    lap("phase 10 (the runtime)")
    # ----------------------------- 11. campaign, chaos and observability
    runtime_launches.update(watched_runtime_on_card(
        torch, ops_of, card, dev, get_config("stablelm-3b"), readings))
    torch.cuda.empty_cache()

    lap("phase 11 (campaign, chaos, observability)")
    # ------------------------------ 12. tensor parallelism and ZeRO-1
    tp_launches, split_entry = tensor_parallel_on_card(torch, card)
    torch.cuda.empty_cache()

    lap("phase 12 (tensor-parallel training)")
    # ------------------------------- 13. tensor-parallel serving
    tps_launches, split_entry["decode_shape"] = tp_serving_on_card(torch,
                                                                   card)
    torch.cuda.empty_cache()

    lap("phase 13 (tensor-parallel serving)")
    # ----------------------------- 14. flux partitions over the local cards
    flux_launches = flux_partitions_on_card(torch, ops_of, card)
    torch.cuda.empty_cache()

    lap("phase 14 (flux partitions)")
    # ------------------ 15. padded heads and the sequence-parallel decode
    seq_launches, lse_entry = seq_parallel_on_card(torch, card)
    results["decode_attention"]["lse_block"] = lse_entry
    torch.cuda.empty_cache()

    lap("phase 15 (padded heads, sequence-parallel decode)")
    # ------------- 16. flux tasks over partitions of several local cards
    group_launches = flux_ranks_on_card(torch, card)
    torch.cuda.empty_cache()

    lap("phase 16 (flux tasks on rank groups)")
    # ----------------------------------------------------------------- result
    print(f"[device] phases 1-16 ran in {time.perf_counter() - started:.1f} "
          f"s", flush=True)
    print(f"[device] {card}")
    summary = []
    for name, route, source, replaces in (
            ("flash_attention", "cuda",
             "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention/flash_attention.py:26"),
            ("decode_attention", "cuda",
             "src/repro_torch/kernels/decode_attention/csrc/decode_attention.cu",
             "src/repro/kernels/decode_attention/decode_attention.py:23"),
            ("fused_rmsnorm", "cuda",
             "src/repro_torch/kernels/fused_rmsnorm/csrc/fused_rmsnorm.cu",
             "src/repro/kernels/fused_rmsnorm/fused_rmsnorm.py:13"),
            ("ssd", "cuda", "src/repro_torch/kernels/ssd/csrc/ssd.cu",
             "src/repro/kernels/ssd/ssd.py:29")):
        r = results[name]
        by_path = {arch: launches[arch][name] for arch in PATHS}
        by_part = {part: n[name] for part, n in runtime_launches.items()}
        by_tp = {case: [n.get(name, 0) for n in ranks]
                 for case, ranks in tp_launches.items()}
        by_tps = {case: [n.get(name, 0) for n in ranks]
                  for case, ranks in tps_launches.items()}
        by_flux = {part: {str(c): n for c, n in cards[name].items()}
                   for part, cards in flux_launches.items()}
        by_seq = {case: [n.get(name, 0) for n in ranks]
                  for case, ranks in seq_launches.items()}
        by_group = {case: [n.get(name, 0) for n in ranks]
                    for case, ranks in group_launches.items()}
        summary.append({"name": name, "route": route, "source": source,
                        "replaces": replaces,
                        "launches": (sum(by_path.values())
                                     + sum(by_part.values())
                                     + sum(map(sum, by_tp.values()))
                                     + sum(map(sum, by_tps.values()))
                                     + sum(sum(c.values())
                                           for c in by_flux.values())
                                     + sum(map(sum, by_seq.values()))
                                     + sum(map(sum, by_group.values()))),
                        "launches_per_flux_part_by_card": by_flux,
                        "launches_per_phase15_rank": by_seq,
                        "launches_per_phase16_rank": by_group,
                        "launches_by_path": by_path,
                        "launches_by_runtime_part": by_part,
                        "launches_per_tp_rank_step": by_tp,
                        "launches_per_tp_serve_rank": by_tps,
                        "launches_per_train_step": {
                            arch: train_launches[arch][name]
                            for arch in TRAIN_PATHS},
                        "launches_per_driver_step": {
                            arch: driver_launches[arch][name]
                            for arch in TRAIN_PATHS},
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"],
                        **{shape: ({key: val for key, val in sub.items()
                                    if key not in ("flops", "bytes", "dtype")}
                                   if isinstance(sub, dict) else sub)
                           for shape, sub in r.items() if shape not in (
                               "flops", "bytes", "dtype", "max_abs_err", "ms",
                               "plain_ms", "bound_ms", "bound_by",
                               "library_ms")}})
    # the RMSNorm kernel's split-row mode, launched by phases 12 and 13
    by_tp = {case: [n["fused_rmsnorm_split"] for n in ranks]
             for case, ranks in tp_launches.items()}
    by_tps = {case: [n["fused_rmsnorm_split"] for n in ranks]
              for case, ranks in tps_launches.items()}
    by_seq = {case: [n["fused_rmsnorm_split"] for n in ranks]
              for case, ranks in seq_launches.items()}
    by_group = {case: [n["fused_rmsnorm_split"] for n in ranks]
                for case, ranks in group_launches.items()}
    summary.append({"name": "fused_rmsnorm_split", "route": "cuda",
                    "source": "src/repro_torch/kernels/fused_rmsnorm/csrc/"
                              "fused_rmsnorm.cu",
                    "replaces": "src/repro/kernels/fused_rmsnorm/"
                                "fused_rmsnorm.py:13",
                    "launches": (sum(map(sum, by_tp.values()))
                                 + sum(map(sum, by_tps.values()))
                                 + sum(map(sum, by_seq.values()))
                                 + sum(map(sum, by_group.values()))),
                    "launches_per_tp_rank_step": by_tp,
                    "launches_per_tp_serve_rank": by_tps,
                    "launches_per_phase15_rank": by_seq,
                    "launches_per_phase16_rank": by_group,
                    **{k: v for k, v in split_entry.items()
                       if k not in ("bytes",)}})
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))


def dryrun_vs_card(torch, arch, kind, seq, batch, measured_s, card):
    """Phase 9 for one cell: the dry-run's step on fake tensors on the CPU,
    then the same step (the plain path) on the card under the same dispatch
    mode. Their matmul FLOPs must be equal; the kernel path's time measured
    in phase 5 or 7 must not be below the least time the card could take
    for the step (its FLOPs over the bf16 peak or its arguments read and
    outputs written once over the HBM rate, the larger; the roofline's step
    time, whose memory term sums every unfused op of the plain path, is
    printed beside it); and the dry-run's arguments plus temporaries are
    held against max_memory_allocated of the plain path's step."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch import roofline as RL
    from repro_torch.launch.mesh import abstract_mesh

    shape = ShapeConfig(f"{kind}_{batch}x{seq}", seq, batch, kind)
    cell, _ = dryrun.lower_cell(arch, shape.name, False, shape=shape,
                                mesh=abstract_mesh(data=1, model=1))
    t0 = time.perf_counter()
    fake = cell.run()
    fake_s = time.perf_counter() - t0
    terms = RL.derive(arch, shape, cell.cfg, "one_card", 1,
                      {"flops": fake.flops, "bytes accessed": fake.bytes},
                      fake.collective_bytes())
    floor_ms, floor_by = RL.kernel_bound(
        fake.flops, fake.argument_bytes + fake.output_bytes, "bfloat16")

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    real = cell.run(device="cuda", fake=False)
    torch.cuda.synchronize()
    real_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    predicted = fake.argument_bytes + fake.peak_bytes
    ratio = peak / predicted
    label = f"{arch} {kind} {batch} x {seq}"
    print(f"[dryrun] {label}: fake step {fake_s:.1f} s on the CPU, "
          f"{fake.n_ops} ops; plain path on the card {real_s:.1f} s (its "
          f"inputs made included), {real.n_ops} ops; matmul FLOPs fake "
          f"{fake.matmul_flops}, card {real.matmul_flops}; all FLOPs "
          f"{fake.flops:.6e}, unfused bytes {fake.bytes:.6e}  [{card}]",
          flush=True)
    check(fake.matmul_flops == real.matmul_flops,
          f"{label}: matmul FLOPs of the fake step {fake.matmul_flops} != the "
          f"card's {real.matmul_flops}")
    print(f"[dryrun] {label}: roofline compute {terms.compute_s * 1e3:.3f} ms,"
          f" memory (unfused) {terms.memory_s * 1e3:.3f} ms -> step "
          f"{terms.step_time_s * 1e3:.3f} ms ({terms.bottleneck}); floor "
          f"{floor_ms:.3f} ms ({floor_by}; arguments read and outputs written "
          f"once); kernel path measured {measured_s * 1e3:.3f} ms: the floor "
          f"is {floor_ms / (measured_s * 1e3):.1%} of it, the roofline step "
          f"{terms.step_time_s / measured_s:.1%}  [{card}]", flush=True)
    check(measured_s * 1e3 >= floor_ms,
          f"{label}: measured {measured_s * 1e3:.3f} ms is below the floor "
          f"{floor_ms:.3f} ms: a count is wrong")
    print(f"[dryrun] {label}: peak memory, dry-run arguments "
          f"{fake.argument_bytes / 1e9:.3f} GB + temporaries "
          f"{fake.peak_bytes / 1e9:.3f} GB = {predicted / 1e9:.3f} GB; the "
          f"card's plain step max_memory_allocated {peak / 1e9:.3f} GB; ratio "
          f"{ratio:.4f} (band {MEM_RATIO_BAND})  [{card}]", flush=True)
    check(MEM_RATIO_BAND[0] <= ratio <= MEM_RATIO_BAND[1],
          f"{label}: memory ratio {ratio:.4f} outside {MEM_RATIO_BAND}")


def serve_and_hold(torch, cfg, ops_of, card, dev):
    """Phase 5 for one configuration (and phase 6 where it is profiled):
    serve it at full width with the launch counts read around the call, hold
    it teacher-forced against the plain path, free its weights. Returns the
    launch counts and the kernel path's prefill seconds and decode ms a
    step."""
    from repro_torch import tree as T
    from repro_torch.distributed.serve_step import kernel_launches
    from repro_torch.launch.serve import serve_batch, teacher_forced
    from repro_torch.models import model as M

    arch = cfg.name
    B, S = N_REQUESTS, PROMPT_LEN
    moe = cfg.family == "moe"
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=SEED, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in T.leaves(params))
    print(f"[main] {arch}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{n_params / 1e9:.3f} B params in bf16, random init in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    check((cfg.num_layers, cfg.d_model) == FULL_WIDTH[arch],
          f"{arch} is not at full width")

    torch.cuda.reset_peak_memory_stats()
    for ops in ops_of.values():
        ops.launches = 0
    res = serve_batch(cfg, n_requests=N_REQUESTS, prompt_len=PROMPT_LEN,
                      max_new_tokens=NEW_TOKENS, seed=SEED, params=params,
                      quiet=True, device=dev)
    launches = {name: ops.launches for name, ops in ops_of.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = kernel_launches(cfg, NEW_TOKENS)
    print(f"[main] {arch} serve_batch: {N_REQUESTS} x {PROMPT_LEN} prompt "
          f"tokens, {NEW_TOKENS} new tokens each, {res['wall_s']:.3f} s, "
          f"{res['tokens_per_s']:.1f} new tokens/s, peak memory "
          f"{peak_gb:.2f} GB; launches {launches}  [{card}]", flush=True)
    check(launches == want, f"{arch} launch counts {launches} != {want}")
    if moe:
        # every decode step reads all experts' weights (the reference's
        # dense capacity buffers): the step's floor by bytes
        expert_bytes = sum(params["layers"]["moe"][w].numel()
                           * params["layers"]["moe"][w].element_size()
                           for w in ("w_in", "w_gate", "w_out"))
        print(f"[main] {arch} decode step floor: the routed experts' "
              f"{expert_bytes / 1e9:.2f} GB read each step -> "
              f"{expert_bytes / PEAK_BYTES_PER_S * 1e3:.2f} ms at "
              f"{PEAK_BYTES_PER_S / 1e12:.2f} TB/s  [{card}]", flush=True)
    tokens = res["tokens"]
    check(tuple(tokens.shape) == (N_REQUESTS, PROMPT_LEN + NEW_TOKENS),
          f"{arch} output shape {tuple(tokens.shape)}")

    # The kernel path against the plain path, both teacher-forced on the
    # kernel path's own tokens, so every one of the 32 steps (prefill and 31
    # decode steps) is compared on the same inputs. f32 is the decisive
    # check: the kernels take f32, so the two paths differ only by the order
    # of sums. In bf16 both paths round at other places; there the kernel
    # path must stay as close to the f32 plain path as the bf16 plain path is.
    # The MoE paths take their times and the replay at full depth and their
    # comparisons at MOE_HOLD_DEPTH layers, with the router's decisions of
    # the two f32 paths recorded.
    plain_cfg = dataclasses.replace(cfg, use_pallas=False)
    prefill_s, decode_ms, logits = {}, {}, {}
    for label, c in (("kernels", cfg), ("plain", plain_cfg)):
        prefill_s[label], decode_ms[label], logits[label], _ = teacher_forced(
            params, c, tokens, S)
    V = cfg.vocab_size

    def rel(a, b):                    # per step: max|a - b| / max|b|
        a, b = a[..., :V], b[..., :V]
        return ((a - b).abs().amax(dim=(1, 2)) / b.abs().amax(dim=(1, 2)))

    def agree(a, b):
        return (a[..., :V].argmax(-1) == b[..., :V].argmax(-1)).float().mean()

    replay = (logits["kernels"][..., :V].argmax(-1).t()
              == tokens[:, S:].to(torch.int64)).float().mean().item()
    for label in ("kernels", "plain"):
        print(f"[main] {arch} {label} path: prefill {prefill_s[label]:.4f} s "
              f"({B * S / prefill_s[label]:.0f} prompt tokens/s), decode "
              f"{decode_ms[label]:.3f} ms/step ({B * 1e3 / decode_ms[label]:.1f} "
              f"tokens/s at batch {B})  [{card}]", flush=True)
    if moe:
        full16 = rel(logits["kernels"], logits["plain"])
        print(f"[main] {arch} at all {cfg.num_layers} layers, bf16 kernels vs "
              f"bf16 plain: max|diff|/max|logit| {full16.max().item():.3e} "
              f"(prefill {full16[0].item():.3e}), argmax agrees in "
              f"{agree(logits['kernels'], logits['plain']).item():.1%}",
              flush=True)
        if arch in PROFILED:
            profile_steps(torch, cfg, params, tokens, prefill_s["kernels"],
                          decode_ms["kernels"], card, dev)
        params, cfg = first_layers(params, cfg, MOE_HOLD_DEPTH)
        plain_cfg = dataclasses.replace(cfg, use_pallas=False)
        torch.cuda.empty_cache()
        for label, c in (("kernels", cfg), ("plain", plain_cfg)):
            _, _, logits[label], _ = teacher_forced(params, c, tokens, S)
    params32 = T.tree_map(lambda t: t.float(), params)
    routes = {}
    for label, c in (("kernels", cfg), ("plain", plain_cfg)):
        c32 = dataclasses.replace(c, dtype="float32")
        with recorded_routes() as routes[label]:
            _, _, logits[label + " f32"], _ = teacher_forced(
                params32, c32, tokens, S)
    del params32
    torch.cuda.empty_cache()
    for label, lg in logits.items():
        check(bool(torch.isfinite(lg).all()), f"{arch} {label} logits not finite")

    tol = F32_LOGIT_TOL
    truth = logits["plain f32"]
    # per (step, row): max|diff| / max|logit| of the step
    err32_rows = ((logits["kernels f32"] - truth)[..., :V].abs().amax(dim=2)
                  / truth[..., :V].abs().amax(dim=(1, 2))[:, None])
    flips, decisions, clean = routing_flips(
        torch, routes["kernels"], routes["plain"], cfg, B, NEW_TOKENS, dev)
    err32 = torch.where(clean, err32_rows, 0.0).amax(dim=1)
    control = rel(logits["kernels"], truth)
    err16_k, err16_p = control, rel(logits["plain"], truth)
    err16 = rel(logits["kernels"], logits["plain"])
    where = (f" ({cfg.num_layers} layers at full width)" if moe else "")
    print(f"[main] {arch} teacher-forced logits{where} over {NEW_TOKENS} steps "
          f"(prefill + {NEW_TOKENS - 1} decode steps), max|diff|/max|logit| "
          f"per step, max over steps:", flush=True)
    if moe:
        print(f"[main]   routing, f32 kernels vs f32 plain: {flips} of "
              f"{decisions} (token, layer) decisions flipped; positions (step, row) "
              f"whose routing agreed throughout: {int(clean.sum())} of "
              f"{clean.numel()} (required share {MIN_CLEAN_SHARE}); f32 "
              f"max over all positions {err32_rows.max().item():.3e}",
              flush=True)
    print(f"[main]   f32 kernels vs f32 plain: {err32.max().item():.3e} "
          f"(prefill {err32[0].item():.3e}, decode steps "
          f"{err32[1:].min().item():.3e}-{err32[1:].max().item():.3e}; "
          f"tol {tol}); argmax agrees in "
          f"{agree(logits['kernels f32'], truth).item():.1%}", flush=True)
    print(f"[main]   bf16 control, bf16 kernels vs f32 plain: "
          f"{control.max().item():.3e} (min over steps "
          f"{control.min().item():.3e}; must exceed {tol})", flush=True)
    print(f"[main]   bf16 vs f32 plain: kernel path {err16_k.max().item():.3e},"
          f" plain path {err16_p.max().item():.3e} (ratio "
          f"{(err16_k.max() / err16_p.max()).item():.3f}, tol "
          f"{BF16_ERR_RATIO}); bf16 kernels vs bf16 plain "
          f"{err16.max().item():.3e} (prefill {err16[0].item():.3e}), argmax "
          f"agrees in {agree(logits['kernels'], logits['plain']).item():.1%}",
          flush=True)
    print(f"[main]   the kernel path's replay reproduces serve_batch's greedy "
          f"tokens in {replay:.1%} of {N_REQUESTS * NEW_TOKENS}", flush=True)
    check(clean.float().mean().item() >= MIN_CLEAN_SHARE,
          f"{arch} routing flipped in too many rows: {flips} decisions, "
          f"{clean.tolist()}")
    check(err32.max().item() < tol,
          f"{arch} f32 kernel path logits differ: {err32.tolist()}")
    check(control.min().item() > tol,
          f"{arch} the f32 tolerance does not tell bf16 apart: "
          f"{control.tolist()}")
    check((err16_k.max() / err16_p.max()).item() < BF16_ERR_RATIO,
          f"{arch} bf16 kernel path further from f32 than the plain path: "
          f"{err16_k.tolist()} vs {err16_p.tolist()}")
    check(replay == 1.0, f"{arch} replay of the kernel path gives other "
          f"tokens ({replay:.1%})")
    del logits, truth
    if arch in PROFILED and not moe:
        profile_steps(torch, cfg, params, tokens, prefill_s["kernels"],
                      decode_ms["kernels"], card, dev)
    del params
    return launches, {"prefill_s": prefill_s["kernels"],
                      "decode_ms": decode_ms["kernels"]}


def first_layers(params, cfg, depth):
    """The model cut to its first ``depth`` layers (the MoE family's leading
    dense layers first): the stacked leaves' slices copied, so the full
    tree's can be freed; the rest shared. Returns (params, cfg)."""
    from repro_torch import tree as T
    fd = cfg.first_dense_layers
    cut = dict(params)
    cut["layers"] = T.tree_map(lambda t: t[:depth - fd].clone(),
                               params["layers"])
    return cut, dataclasses.replace(cfg, num_layers=depth)


@contextlib.contextmanager
def recorded_routes():
    """Within: every MoE layer's routing decisions, (top-k experts, kept)
    each (groups, tokens, K), appended to the yielded list in call order."""
    from repro_torch.models import moe
    record, assign = [], moe._assign

    def recording(top_i, E, C):
        pos, keep = assign(top_i, E, C)
        record.append((top_i, keep))
        return pos, keep
    moe._assign = recording
    try:
        yield record
    finally:
        moe._assign = assign


def routing_flips(torch, got, want, cfg, B, steps, dev):
    """Routing decisions that differ between two teacher-forced runs
    (``launch.serve.teacher_forced``: a warm-up prefill, the prefill,
    steps - 1 decode steps), as recorded by ``recorded_routes``. A (token,
    layer) decision is its top-k experts in order and whether each was
    kept. Returns (the count
    of differing decisions, the count of decisions, clean (steps, B) bool):
    the logits of step t in row b are clean where no decision of row b
    differed in the prefill or in decode steps 1..t. A path without routing
    is clean throughout."""
    clean = torch.ones((steps, B), dtype=torch.bool, device=dev)
    if not got and not want:
        return 0, 0, clean
    n = cfg.num_layers - cfg.first_dense_layers          # MoE layers a call
    check(len(got) == len(want) == n * (steps + 1),
          f"{cfg.name}: {len(got)} and {len(want)} routing records, not "
          f"{n * (steps + 1)}")
    flips = decisions = 0
    dirty = torch.zeros(B, dtype=torch.bool, device=dev)
    for t in range(steps):
        for c in range(n * (t + 1), n * (t + 2)):        # after the warm-up
            (ia, ka), (ib, kb) = got[c], want[c]
            differ = ((ia != ib) | (ka != kb)).any(dim=-1)   # (G, tokens)
            # prefill: a group per row; decode: one group of the batch rows
            dirty |= differ.any(dim=1) if t == 0 else differ[0]
            flips += int(differ.sum())
            decisions += differ.numel()
        clean[t] = ~dirty
    return flips, decisions, clean


def profile_steps(torch, cfg, params, tokens, prefill_s, decode_ms, card, dev):
    """Phase 6: device time by kernel over one prefill and one decode step
    of the kernel path, the device's idle share of each (against the same
    call timed without the profiler), the decode step's host side (the ops
    that take its host time, and the time to issue it with every wait on the
    device forbidden), and the main path's kernels' device time per
    launch."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.distributed.serve_step import (make_decode_step,
                                                    make_prefill_step,
                                                    pad_cache, sample)
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.fused_rmsnorm import ops as rn_ops
    from repro_torch.launch.serve import _positions

    arch = cfg.name
    B, S = N_REQUESTS, PROMPT_LEN
    # the (flops, bytes) each launch of the profiled call needs, from its
    # arguments: the bound of the per-launch readings below
    work = {}

    @contextlib.contextmanager
    def recorded(where):
        norm, dec = rn_ops._launch, da_ops.decode_attention
        norms, decs = work.setdefault((where, "norm"), []), work.setdefault(
            (where, "decode"), [])

        def norm_rec(x, w, gate, *, eps):
            n, item = x.numel(), x.element_size()
            norms.append((4 * n, (2 + (gate is not None)) * n * item
                          + w.numel() * item))
            return norm(x, w, gate, eps=eps)

        def dec_rec(q, k_cache, v_cache, valid_len, *, scale):
            b, _, h, hd = q.shape
            kv = k_cache.shape[2]
            valid = S + 1                  # the step after the prompt
            decs.append((4 * b * h * valid * hd,
                         (2 * q.numel() + 2 * b * valid * kv * hd)
                         * q.element_size()))
            return dec(q, k_cache, v_cache, valid_len, scale=scale)

        rn_ops._launch, da_ops.decode_attention = norm_rec, dec_rec
        try:
            yield
        finally:
            rn_ops._launch, da_ops.decode_attention = norm, dec

    def bound_of(where, kind, n_profiled):
        """The per-launch mean of the least time the card could take for
        the recorded launches (roofline terms), what bounds it, and the
        launch count when the profile holds another (the profiler has
        missed a kernel of a long window: zamba2-7b's prefill ran 189
        norms, its profile held 188)."""
        ws = work[(where, kind)]
        ms, by = zip(*(kernel_bound(f, b, "bfloat16") for f, b in ws))
        seen = ("" if len(ws) == n_profiled
                else f", over {len(ws)} launches ({n_profiled} profiled)")
        return sum(ms) / len(ms), max(set(by), key=by.count) + seen

    def breakdown(label, fn, step_ms, host=False):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof, \
                recorded(label.split()[1]):
            fn()
            torch.cuda.synchronize()
        rows = sorted(device_rows(prof), key=lambda r: -r[1])
        busy_ms = sum(r[1] for r in rows)
        print(f"[profile] {arch} {label}: device busy {busy_ms:.3f} ms of "
              f"{step_ms:.3f} ms timed without the profiler "
              f"({1 - busy_ms / step_ms:.1%} idle)  [{card}]", flush=True)
        for key, ms, n in rows[:8]:
            print(f"[profile]   {ms:9.3f} ms {n:5d}x  {key[:80]}")
        if host:
            ops = [e for e in prof.key_averages()
                   if e.self_cpu_time_total > 0 and e.key.startswith("aten::")]
            ops.sort(key=lambda e: -e.self_cpu_time_total)
            counts = {e.key: e.count for e in ops}
            print(f"[profile] {arch} {label}, host: {sum(e.count for e in ops)} "
                  f"aten op calls (before: "
                  f"{ATEN_CALLS_BEFORE.get(arch, 'not measured')}; of them "
                  f"aten::silu {counts.get('aten::silu', 0)}, aten::mul "
                  f"{counts.get('aten::mul', 0)}, aten::view "
                  f"{counts.get('aten::view', 0)}), "
                  f"{sum(e.self_cpu_time_total for e in ops) / 1e3:.3f}"
                  f" ms of self host time under the profiler; the most:")
            for e in ops[:8]:
                print(f"[profile]   {e.self_cpu_time_total / 1e3:9.3f} ms "
                      f"{e.count:5d}x  {e.key}")
        return rows

    batch = {"tokens": tokens[:, :S].contiguous(),
             "positions": _positions(cfg, B, S, device=dev)}
    prefill = make_prefill_step(cfg)
    rows = {"prefill": breakdown("one prefill (kernel path)",
                                 lambda: prefill(params, batch),
                                 prefill_s * 1e3)}
    lg, cache = prefill(params, batch)
    cache = pad_cache(cache, cfg, S + NEW_TOKENS)
    step = make_decode_step(cfg)
    db = {"tokens": sample(lg, None, 0.0, cfg.vocab_size),
          "positions": _positions(cfg, B, 1, start=S, device=dev)}
    rows["decode step"] = breakdown("one decode step (kernel path)",
                                    lambda: step(params, db, cache), decode_ms,
                                    host=True)
    # any call that waits on the device raises in this debug mode
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    t0 = time.perf_counter()
    step(params, db, cache)
    issue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print(f"[profile] {arch} one decode step issued in {issue_ms:.3f} ms of "
          f"host time without waiting on the device (of {decode_ms:.3f} ms "
          f"per step)  [{card}]", flush=True)
    # kernel times on the main path, from the device's own clock: the decode
    # rows' RMSNorm has no other true time (see phase 4)
    # (decode attention is two kernels, split and combine, per launch)
    for where, key, what, kernels in (
            ("prefill", "flash_fwd", "flash_attention", 1),
            ("prefill", "ssd_fwd", "ssd", 1),
            ("decode step", "decode_fwd",
             f"decode_attention (B {B}, valid {S + 1})", 2)):
        hits = [(ms, n) for k, ms, n in rows[where] if key in k]
        if not hits:
            continue                   # a path without this kernel
        check(len(hits) == kernels and len({n for _, n in hits}) == 1,
              f"not {kernels} {key} row(s) of one count in the {arch} {where} "
              f"profile: {hits}")
        ms, n = sum(ms for ms, _ in hits), hits[0][1]
        bound = ""
        if what.startswith("decode_attention"):
            b_ms, by = bound_of("decode", "decode", n)
            bound = (f"; bound {b_ms:.5f} ms ({by}), "
                     f"{b_ms / (ms / n):.1%} of it")
        print(f"[time] {arch} {what} bf16 in the {where}: {ms / n:.5f} ms per "
              f"launch (profiler device time, {n} launches){bound}  "
              f"[{card}]", flush=True)
    # RMSNorm: one row per instantiation the step ran (gated or not); a step
    # runs 2 per block and a final one
    for where, n_rows in (("prefill", B * S), ("decode step", B)):
        hits = [(k, ms, n) for k, ms, n in rows[where] if "rmsnorm_" in k]
        check(hits, f"no RMSNorm kernel in the {arch} {where} profile")
        for k, ms, n in hits:
            inst = re.search(r"rmsnorm_\w+<[^>]*>", k)
            print(f"[time] {arch} fused_rmsnorm ({n_rows} rows) bf16 in the "
                  f"{where}, {inst.group(0) if inst else k[:60]}: "
                  f"{ms / n:.5f} ms per launch (profiler device time, {n} "
                  f"launches)  [{card}]", flush=True)
        # every width of the step's norms (model, MLA's kv_norm, the gated
        # Mamba2 norm) against the bound of the same launches
        ms = sum(ms for _, ms, _ in hits)
        n = sum(n for _, _, n in hits)
        b_ms, by = bound_of(where.split()[0], "norm", n)
        print(f"[time] {arch} fused_rmsnorm bf16 in the {where}, all "
              f"{n} launches: {ms / n:.5f} ms per launch (profiler device "
              f"time); bound {b_ms:.5f} ms per launch ({by}), "
              f"{b_ms / (ms / n):.1%} of it  [{card}]", flush=True)
    del cache


def train_batch(torch, cfg, dev, B=TRAIN_BATCH, S=TRAIN_SEQ):
    """One fixed batch of B x S random tokens from a seeded generator on
    the card, labelled with the next token."""
    from repro_torch.launch.serve import _positions
    gen = torch.Generator(device=dev).manual_seed(SEED)
    tokens = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen,
                           device=dev, dtype=torch.int32)
    return {"tokens": tokens[:, :-1].contiguous(),
            "labels": tokens[:, 1:].contiguous(),
            "positions": _positions(cfg, B, S, device=dev)}


def train_and_hold(torch, cfg, ops_of, card, dev):
    """Phase 7 for one configuration at full width and depth: TRAIN_STEPS
    AdamW steps through make_train_step on one fixed batch, each step's
    launch counts read around it; then one more step taken as its two parts
    (forward and backward, then the update), with every leaf's gradient
    checked. Returns the launch counts of one step and the median step
    time in seconds."""
    from repro_torch import tree as T
    from repro_torch.distributed.train_step import (flash_backwards,
                                                    kernel_launches,
                                                    make_grad_fn,
                                                    make_train_step)
    from repro_torch.models import model as M
    from repro_torch.optim import adamw

    arch = cfg.name
    B, S = TRAIN_BATCH, TRAIN_SEQ
    check((cfg.num_layers, cfg.d_model) == TRAIN_WIDTH[arch]
          and cfg.remat == "full" and cfg.use_pallas and cfg.dtype == "bfloat16",
          f"{arch} is not at full width and depth, bf16, remat full, kernels")
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=SEED, device=dev)
    batch = train_batch(torch, cfg, dev)
    opt_cfg = adamw.OptimizerConfig(warmup_steps=1, total_steps=10)
    opt = adamw.init(params)
    step = make_train_step(cfg, opt_cfg)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in T.leaves(params))
    print(f"[train] {arch}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{n_params / 1e9:.3f} B params in bf16 and f32 moments, random "
          f"init in {time.perf_counter() - t0:.1f} s; batch {B} x {S} tokens, "
          f"remat {cfg.remat!r}", flush=True)
    want = kernel_launches(cfg)
    fa_ops = ops_of["flash_attention"]
    want_bwd = flash_backwards(cfg)
    torch.cuda.reset_peak_memory_stats()
    losses, step_s = [], []
    for i in range(TRAIN_STEPS):
        for ops in ops_of.values():
            ops.launches = 0
        fa_ops.backward_launches = fa_ops.plain_backward_calls = 0
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        launches = {name: ops.launches for name, ops in ops_of.items()}
        backwards = {"backward_launches": fa_ops.backward_launches,
                     "plain_backward_calls": fa_ops.plain_backward_calls}
        losses.append(m["loss"].item())
        print(f"[train] {arch} step {i + 1}: loss {losses[-1]:.6f}, grad_norm "
              f"{m['grad_norm'].item():.4f}, lr {m['lr'].item():.3e}, "
              f"{step_s[-1]:.4f} s; launches {launches}; flash backwards "
              f"{backwards}", flush=True)
        check(math.isfinite(losses[-1]), f"{arch} step {i + 1} loss not finite")
        check(launches == want, f"{arch} train step launches {launches} != "
              f"{want}")
        check(backwards == want_bwd, f"{arch} train step flash backwards "
              f"{backwards} != {want_bwd}")
        step_launches = launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(losses[-1] < losses[0], f"{arch} loss did not fall on one batch: "
          f"{losses}")

    # one more step in its two parts, each ended by a synchronize
    grad_fn = make_grad_fn(cfg)
    for ops in ops_of.values():
        ops.launches = 0
    t0 = time.perf_counter()
    grads, _ = grad_fn(params, batch)
    torch.cuda.synchronize()
    fwd_bwd_s = time.perf_counter() - t0
    launches = {name: ops.launches for name, ops in ops_of.items()}
    check(launches == want, f"{arch} forward+backward launches {launches}")
    bad = [path for path, g in T.flatten(grads)
           if not (bool(torch.isfinite(g).all()) and bool((g != 0).any()))]
    check(not bad, f"{arch} gradients not finite or all zero: {bad}")
    t0 = time.perf_counter()
    adamw.update(opt_cfg, opt, grads, params)
    torch.cuda.synchronize()
    update_s = time.perf_counter() - t0
    del grads
    profile_train_step(torch, arch, grad_fn, opt_cfg, params, opt, batch,
                       (fwd_bwd_s + update_s) * 1e3, card)

    med = statistics.median(step_s[1:])
    tokens = B * S
    # parameters in matrix products: all but an untied input embedding table,
    # which is a lookup; attention's own products are not counted
    n_mm = n_params - (0 if cfg.tie_embeddings
                       else params["embed"]["table"].numel())
    peak = PEAK_FLOPS["bfloat16"]
    print(f"[train] {arch}: step {med:.4f} s (median of steps 2-{TRAIN_STEPS}"
          f"), {tokens / med:.0f} tokens/s; one more step apart: forward + "
          f"backward {fwd_bwd_s:.4f} s, AdamW update {update_s:.4f} s; peak "
          f"memory {peak_gb:.2f} GB (max_memory_allocated over the "
          f"{TRAIN_STEPS} steps); model FLOP share 6NT/(step x 989 TFLOP/s) "
          f"{6 * n_mm * tokens / med / peak:.1%}, with the recompute's 2NT "
          f"{8 * n_mm * tokens / med / peak:.1%} (N = {n_mm / 1e9:.3f} B "
          f"params in products, T = {tokens}); every leaf's gradient finite "
          f"and nonzero; launches per step {step_launches}  [{card}]",
          flush=True)
    del params, opt
    return step_launches, med, losses


def profile_train_step(torch, arch, grad_fn, opt_cfg, params, opt, batch,
                       step_ms, card):
    """Phase 7: device time by kernel over one more train step (forward,
    backward and update), and the device's idle share against the step
    timed without the profiler. Only the device's activity is recorded
    (``device_rows`` reads nothing else): a step's host ops number tens of
    thousands, and with them recorded mamba2-130m's profile took 27 s."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.optim import adamw
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        grads, _ = grad_fn(params, batch)
        adamw.update(opt_cfg, opt, grads, params)
        del grads
        torch.cuda.synchronize()
    rows = sorted(device_rows(prof), key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    mine = {key: sum(ms for k, ms, _ in rows if key in k)
            for key in ("flash_fwd", "flash_bwd", "rmsnorm_", "ssd_fwd")}

    def kind(k):
        low = k.lower()
        if "gemm" in low or "nvjet" in low:
            # f32 operands: a plain vjp's products (no TF32)
            f32 = "f32f32_f32f32" in low or "sgemm" in low
            return "f32 GEMM" if f32 else "GEMM"
        if "elementwise" in low or "copy" in low:
            return "elementwise and copies"
        return "reductions" if "reduce" in low else "other"
    kinds = {}
    for k, ms, _ in rows:
        kinds[kind(k)] = kinds.get(kind(k), 0.0) + ms
    print(f"[profile] {arch} one train step: device busy {busy_ms:.3f} ms of "
          f"{step_ms:.3f} ms timed without the profiler "
          f"({1 - busy_ms / step_ms:.1%} idle); the port's kernels: "
          + ", ".join(f"{k} {ms:.3f} ms" for k, ms in mine.items())
          + "; by kind (kernel names): "
          + ", ".join(f"{k} {ms:.3f} ms" for k, ms in sorted(
              kinds.items(), key=lambda kv: -kv[1]))
          + f"  [{card}]", flush=True)
    for key, ms, n in rows[:12]:
        print(f"[profile]   {ms:9.3f} ms {n:5d}x  {key[:80]}")


def grad_parity(torch, arch, depth, ops_of, card, dev):
    """Phase 7: the kernel path's f32 gradients against the plain path's,
    from one set of weights and one batch, per leaf max|diff| / max|grad|,
    and the loss's relative difference."""
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.distributed.train_step import (kernel_launches,
                                                    make_grad_fn)
    from repro_torch.models import model as M

    cfg = get_config(arch, dtype="float32", num_layers=depth)
    params = M.init_params(cfg, seed=SEED, device=dev)
    batch = train_batch(torch, cfg, dev)
    for ops in ops_of.values():
        ops.launches = 0
    gk, mk = make_grad_fn(cfg)(params, batch)
    torch.cuda.synchronize()
    launches = {name: ops.launches for name, ops in ops_of.items()}
    check(launches == kernel_launches(cfg),
          f"{arch} f32 kernel path launches {launches}")
    gp, mp = make_grad_fn(dataclasses.replace(cfg, use_pallas=False))(
        params, batch)
    torch.cuda.synchronize()
    check(launches == {name: ops.launches for name, ops in ops_of.items()},
          f"{arch} the plain path launched a kernel")
    loss_rel = abs(mk["loss"].item() - mp["loss"].item()) / abs(
        mp["loss"].item())
    rels = {path: rel_err(g, w) for (path, g), w in zip(T.flatten(gk),
                                                        T.leaves(gp))}
    worst = max(rels, key=rels.get)
    print(f"[parity] {arch} f32, {depth} layers at full width, batch "
          f"{TRAIN_BATCH} x {TRAIN_SEQ}: kernel path vs plain path, loss "
          f"{mk['loss'].item():.7f} vs {mp['loss'].item():.7f} (rel "
          f"{loss_rel:.3e}, tol {GRAD_LOSS_TOL}); gradients max|diff|/max|grad|"
          f" per leaf: max {rels[worst]:.3e} ({worst}), median "
          f"{statistics.median(rels.values()):.3e} over {len(rels)} leaves "
          f"(tol {GRAD_LEAF_TOL})  [{card}]", flush=True)
    check(loss_rel < GRAD_LOSS_TOL, f"{arch} f32 loss differs: {loss_rel}")
    check(rels[worst] < GRAD_LEAF_TOL, f"{arch} f32 gradients differ: {rels}")
    del params, gk, gp


def checkpoint_round_trip(torch, cfg, card, dev):
    """Phase 7: two steps, a save (the async thread), a restore into a fresh
    tree of other weights, and a third step from both, compared bit for
    bit."""
    from repro_torch import tree as T
    from repro_torch.checkpoint.checkpoint import CheckpointManager
    from repro_torch.distributed.train_step import make_train_step
    from repro_torch.models import model as M
    from repro_torch.optim import adamw

    params = M.init_params(cfg, seed=SEED, device=dev)
    batch = train_batch(torch, cfg, dev)
    step = make_train_step(cfg, adamw.OptimizerConfig(warmup_steps=1,
                                                      total_steps=10))
    opt = adamw.init(params)
    for _ in range(2):
        params, opt, _ = step(params, opt, batch)
    directory = os.path.join(ROOT, "build", "chip_smoke_checkpoint")
    shutil.rmtree(directory, ignore_errors=True)
    mgr = CheckpointManager(directory, async_save=True)
    t0 = time.perf_counter()
    mgr.save(2, {"params": params, "opt": opt})
    call_s = time.perf_counter() - t0
    mgr.wait()
    save_s = time.perf_counter() - t0
    fresh = {"params": M.init_params(cfg, seed=SEED + 1, device=dev)}
    fresh["opt"] = adamw.init(fresh["params"])
    t0 = time.perf_counter()
    back = mgr.restore(template=fresh)["tree"]
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    nbytes = sum(os.path.getsize(os.path.join(directory, "step_00000002", f))
                 for f in os.listdir(os.path.join(directory, "step_00000002")))
    a = step(params, opt, batch)
    b = step(back["params"], back["opt"], batch)
    pairs = list(zip(T.leaves((a[0], a[1])), T.leaves((b[0], b[1]))))
    same = sum(torch.equal(x, y) for x, y in pairs)
    print(f"[ckpt] {cfg.name}: saved after step 2 ({nbytes / 1e6:.1f} MB; the "
          f"save call returned in {call_s:.3f} s, the thread wrote it in "
          f"{save_s:.3f} s), restored into a fresh tree in {restore_s:.3f} s;"
          f" step 3 from both: loss {a[2]['loss'].item():.7f} and "
          f"{b[2]['loss'].item():.7f}, {same} of {len(pairs)} leaves of the "
          f"parameters and optimizer state equal bit for bit  [{card}]",
          flush=True)
    check(same == len(pairs) and a[2]["loss"].item() == b[2]["loss"].item(),
          f"{cfg.name} step 3 after the restore differs")
    shutil.rmtree(directory)
    del params, opt, back, fresh, a, b


@contextlib.contextmanager
def counted_steps(train_mod, ops_of, record):
    """Inside, each train step that ``train_mod.train`` makes has its kernel
    launches counted from 0 and appended to ``record`` with its batch."""
    real = train_mod.make_train_step

    def make(*args, **kw):
        step = real(*args, **kw)

        def counted(params, opt, batch):
            for ops in ops_of.values():
                ops.launches = 0
            out = step(params, opt, batch)
            record.append(({n: ops.launches for n, ops in ops_of.items()},
                           batch))
            return out
        return counted

    train_mod.make_train_step = make
    try:
        yield
    finally:
        train_mod.make_train_step = real


def driver_run(torch, train_mod, cfg, ops_of, **kw):
    """``train_mod.train(cfg, **kw)`` on the card with each step's launches
    checked against ``kernel_launches(cfg)`` and every loss finite. Returns
    train's dict, the launches counted in its first step (as in every other)
    and the batches the steps got."""
    from repro_torch.distributed.train_step import kernel_launches
    record = []
    with counted_steps(train_mod, ops_of, record):
        out = train_mod.train(cfg, seed=SEED, log_every=1, device="cuda", **kw)
    want = kernel_launches(cfg)
    check(len(record) == len(out["losses"]) > 0,
          f"{cfg.name}: {len(record)} steps counted, {len(out['losses'])} run")
    for i, (launches, _) in enumerate(record):
        check(launches == want, f"{cfg.name} driver step {i}: launches "
              f"{launches} != {want}")
    check(all(math.isfinite(x) for x in out["losses"]),
          f"{cfg.name} driver losses not finite: {out['losses']}")
    return out, record[0][0], [b for _, b in record]


def drive_stablelm(torch, ops_of, direct_step_s, card):
    """Phase 8 (a): stablelm-3b at full width and depth through ``train()``,
    TRAIN_STEPS steps of TRAIN_BATCH x TRAIN_SEQ tokens from the stream,
    beside phase 7's direct ``make_train_step`` step."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train as train_mod
    from repro_torch.optim import adamw
    cfg = get_config("stablelm-3b")
    check((cfg.num_layers, cfg.d_model) == TRAIN_WIDTH[cfg.name]
          and cfg.remat == "full" and cfg.dtype == "bfloat16",
          "stablelm-3b is not at full width and depth, bf16, remat full")
    torch.cuda.reset_peak_memory_stats()
    out, launches, _ = driver_run(
        torch, train_mod, cfg, ops_of, steps=TRAIN_STEPS,
        global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
        opt_cfg=adamw.OptimizerConfig(warmup_steps=1, total_steps=10))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    med = statistics.median(out["step_s"][1:])
    print(f"[driver] stablelm-3b through train(): step {med:.4f} s (median "
          f"of steps 2-{TRAIN_STEPS}: batch from the stream, copy, step, "
          f"loss read), {TRAIN_BATCH * TRAIN_SEQ / med:.0f} tokens/s; phase "
          f"7's direct make_train_step step {direct_step_s:.4f} s in this run"
          f" (driver/direct {med / direct_step_s:.4f}); first step "
          f"{out['step_s'][0]:.4f} s; losses "
          f"{[round(x, 4) for x in out['losses']]}; peak memory "
          f"{peak_gb:.2f} GB; launches per step {launches}  [{card}]",
          flush=True)
    del out
    return launches


def timed_manager(torch, log):
    """A ``CheckpointManager`` class whose save calls, write threads and
    restores append (what, step, seconds) to ``log``."""
    from repro_torch.checkpoint.checkpoint import CheckpointManager

    class Timed(CheckpointManager):
        def save(self, step, state, extra_meta=None):
            t0 = time.perf_counter()
            super().save(step, state, extra_meta)
            log.append(("save call", step, time.perf_counter() - t0))

        def _write(self, step, host, extra_meta):
            t0 = time.perf_counter()
            super()._write(step, host, extra_meta)
            log.append(("write", step, time.perf_counter() - t0))

        def restore(self, step=None, template=None):
            t0 = time.perf_counter()
            out = super().restore(step, template)
            torch.cuda.synchronize()
            log.append(("restore", out["step"], time.perf_counter() - t0))
            return out
    return Timed


def drive_mamba(torch, ops_of, card, dev):
    """Phase 8 (b) and (c): mamba2-130m at full size at examples/train_lm.py's
    shape: an uninterrupted run, a run cut with checkpoints and its resume
    (bit for bit), then int8 gradient compression on one rank."""
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, make_loader
    from repro_torch.distributed.compression import make_local_grad_fn
    from repro_torch.distributed.train_step import make_grad_fn
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    cfg = get_config("mamba2-130m")
    check((cfg.num_layers, cfg.d_model) == TRAIN_WIDTH[cfg.name],
          "mamba2-130m is not at full size")
    B, S = DRIVER_LM_BATCH, DRIVER_LM_SEQ
    opt_cfg = adamw.OptimizerConfig(warmup_steps=2, total_steps=DRIVER_STEPS)
    run = dict(global_batch=B, seq_len=S, opt_cfg=opt_cfg)
    full, launches, _ = driver_run(torch, train_mod, cfg, ops_of,
                                   steps=DRIVER_STEPS, **run)
    losses = full["losses"]
    check(statistics.mean(losses[-3:]) < losses[0],
          f"mamba2-130m driver loss did not fall: {losses}")
    plain_med = statistics.median(full["step_s"][1:])
    del full

    directory = os.path.join(ROOT, "build", "chip_smoke_driver")
    shutil.rmtree(directory, ignore_errors=True)
    log = []
    real_manager = train_mod.CheckpointManager
    train_mod.CheckpointManager = timed_manager(torch, log)
    try:
        cut, _, _ = driver_run(torch, train_mod, cfg, ops_of, steps=DRIVER_CUT,
                               ckpt_dir=directory, ckpt_every=DRIVER_EVERY,
                               **run)
        step_dir = os.path.join(directory, f"step_{DRIVER_CUT:08d}")
        nbytes = sum(os.path.getsize(os.path.join(step_dir, f))
                     for f in os.listdir(step_dir))
        with open(os.path.join(step_dir, "manifest.json")) as f:
            cursor = json.load(f)["meta"]["data"]
        rest, _, batches = driver_run(torch, train_mod, cfg, ops_of,
                                      steps=DRIVER_STEPS, ckpt_dir=directory,
                                      resume=True, **run)
    finally:
        train_mod.CheckpointManager = real_manager
    n_params = sum(t.numel() for t in T.leaves(rest["params"]))
    del rest["params"], rest["opt_state"]
    shutil.rmtree(directory)
    want_first = make_loader(cfg, DataConfig(seq_len=S, global_batch=B,
                                             seed=SEED))._batch_at(DRIVER_CUT)
    first_ok = bool(torch.equal(batches[0]["tokens"].cpu(), torch.from_numpy(
        want_first["tokens"])))
    resumed = cut["losses"] + rest["losses"]
    same = sum(a == b for a, b in zip(resumed, losses))
    after_save = cut["step_s"][DRIVER_EVERY]
    others = statistics.median(cut["step_s"][1:DRIVER_EVERY]
                               + cut["step_s"][DRIVER_EVERY + 1:])
    print(f"[driver] mamba2-130m through train(), batch {B} x {S}: "
          f"{DRIVER_STEPS} steps uninterrupted, step {plain_med:.4f} s "
          f"(median of steps 2-{DRIVER_STEPS}), {B * S / plain_med:.0f} "
          f"tokens/s; losses {[round(x, 4) for x in losses]}; then "
          f"{DRIVER_CUT} steps with a checkpoint every {DRIVER_EVERY} and a "
          f"resume to {DRIVER_STEPS}: started at step "
          f"{DRIVER_STEPS - len(rest['losses'])}, "
          f"cursor {cursor}, first batch the stream's step {DRIVER_CUT}: "
          f"{first_ok}; {same} of {DRIVER_STEPS} losses equal bit for bit "
          f"to the uninterrupted run's  [{card}]", flush=True)
    print(f"[driver] mamba2-130m checkpoints ({n_params / 1e6:.1f} M bf16 "
          f"params and two f32 moments): {nbytes / 1e9:.3f} GB on disk a "
          f"step; " + ", ".join(f"{w} at {st} {sec:.3f} s" for w, st, sec
                                in log)
          + f"; the step after the async save at step {DRIVER_EVERY} took "
          f"{after_save:.4f} s against {others:.4f} s for the run's other "
          f"steps (median of steps 2-{DRIVER_CUT} without it)  [{card}]",
          flush=True)
    check(len(rest["losses"]) == DRIVER_STEPS - DRIVER_CUT
          and cursor == {"step": DRIVER_CUT, "seed": SEED} and first_ok,
          f"the resume did not start at step {DRIVER_CUT} with the cursor "
          f"there: {len(rest['losses'])} steps, cursor {cursor}, first batch "
          f"{first_ok}")
    check(same == DRIVER_STEPS, f"resumed losses {resumed} differ from the "
          f"uninterrupted run's {losses}")

    # (c) int8 gradient compression on one rank: the n == 1 branch
    params = M.init_params(cfg, seed=SEED, device=dev)
    nb = make_loader(cfg, DataConfig(seq_len=S, global_batch=B,
                                     seed=SEED))._batch_at(0)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in nb.items()}
    plain, _ = make_grad_fn(cfg)(params, batch)
    mesh = make_host_mesh(device=dev)
    comp, _ = make_local_grad_fn(make_grad_fn(cfg), mesh, ("data",), {},
                                 compress=True)(params, batch)
    worst, worst_path = 0.0, ""
    for (path, g), c in zip(T.flatten(plain), T.leaves(comp)):
        scale = g.float().abs().max().item() / 127
        ratio = max_err(c, g) / scale if scale else max_err(c, g)
        if ratio > worst:
            worst, worst_path = ratio, path
    del params, plain, comp, batch
    check(worst <= 1.0, f"int8 gradients beyond |g|/127: {worst_path} at "
          f"{worst:.3f} steps")
    comp_run, comp_launches, _ = driver_run(
        torch, train_mod, cfg, ops_of, steps=5, compress_grads=True, **run)
    comp_med = statistics.median(comp_run["step_s"][1:])
    print(f"[driver] mamba2-130m int8 gradients on one rank: every leaf "
          f"within |g|_inf/127 of the uncompressed gradient (largest "
          f"{worst:.3f} of it, {worst_path}); train(compress_grads=True): "
          f"losses {[round(x, 4) for x in comp_run['losses']]}, step "
          f"{comp_med:.4f} s (median of steps 2-5) against {plain_med:.4f} "
          f"s uncompressed; launches per step {comp_launches}  [{card}]",
          flush=True)
    del comp_run
    return launches


def _reset(ops_of):
    for ops in ops_of.values():
        ops.launches = 0


def _counts(ops_of):
    return {name: ops.launches for name, ops in ops_of.items()}


def _times(tasks, a="SCHEDULING", b="DONE"):
    """Seconds from state a to state b of each task, from its timestamps."""
    return [t.timestamps[b] - t.timestamps[a] for t in tasks]


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def runtime_on_card(torch, ops_of, card, dev, cfg, mamba, phase7_step_s):
    """Phase 10: the port's runtime drives the kernels on the card. Returns
    each part's launch counts by kernel, and the readings phase 11 sets its
    limits and comparisons from."""
    launches, readings = {}, {}
    launches["campaign"], params, readings["campaign"] = campaign_on_card(
        torch, ops_of, card, dev, cfg, phase7_step_s)
    svc_params, svc_cfg = first_layers(params, cfg, SERVICE_DEPTH)
    launches["service"], readings["service"] = service_on_card(
        torch, ops_of, card, dev, svc_cfg, svc_params)
    del params, svc_params
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    launches["restart"] = restart_on_card(torch, ops_of, card, dev, mamba)
    launches["throughput"] = throughput_on_card(torch, ops_of, card, dev, cfg)
    return launches, readings


def campaign_on_card(torch, ops_of, card, dev, cfg, phase7_step_s):
    """Phase 10 (a): launch/hybrid_campaign.py on the card with ``cfg`` as
    the surrogate; the numpy side against a CPU run of the twin at the
    example's model size; the losses against the same steps called
    directly from the same weights; the launches against the tasks'."""
    from repro_torch import tree as T
    from repro_torch.distributed import serve_step, train_step
    from repro_torch.launch import hybrid_campaign as HC
    from repro_torch.models import model as M
    from repro_torch.optim import adamw

    shape = dict(iterations=CAMPAIGN_ITERS, docking_batch=CAMPAIGN_DOCK,
                 train_steps=CAMPAIGN_STEPS, seq_len=CAMPAIGN_SEQ)
    t0 = time.perf_counter()
    cpu = HC.run_campaign(device="cpu", quiet=True, **shape)
    cpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=SEED, device=dev)
    init = T.tree_map(torch.clone, params)
    _sync(torch, dev)
    print(f"[runtime] campaign surrogate {cfg.name}: {cfg.num_layers} "
          f"layers, d_model {cfg.d_model}, {cfg.dtype}, remat {cfg.remat!r};"
          f" random init and a copy in {time.perf_counter() - t0:.1f} s; the "
          f"twin on the CPU at the example's size (d_model 96, 2 layers) "
          f"took {cpu_s:.1f} s", flush=True)
    _reset(ops_of)
    t0 = time.perf_counter()
    out = HC.run_campaign(cfg, params=params, device=dev, **shape)
    _sync(torch, dev)
    wall_s = time.perf_counter() - t0
    launches = _counts(ops_of)
    del params

    tasks = [t for ts in out["tasks"].values() for t in ts]
    check(len(tasks) == CAMPAIGN_ITERS * (CAMPAIGN_DOCK + 2)
          and all(t.state.value == "DONE" for t in tasks),
          f"campaign tasks not all DONE: "
          f"{[(t.uid, t.state.value, t.error) for t in tasks]}")
    check({t.backend for t in out["tasks"]["sst_train"]} == {"flux"}
          and {t.backend for t in out["tasks"]["docking"]
               + out["tasks"]["inference"]} == {"dragon"},
          "campaign tasks on the wrong backends")
    check(all(m is not None and m.size == 1 for m in out["meshes"]),
          f"the train tasks did not get the one-card mesh: {out['meshes']}")
    losses = out["losses"]
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"campaign losses not finite and falling: {losses}")
    # the numpy side (the SST tokens are taken modulo each model's vocab)
    for key in ("scores", "selections"):
        check(all(np.array_equal(a, b) for a, b in zip(out[key], cpu[key]))
              and len(out[key]) == len(cpu[key]) == CAMPAIGN_ITERS,
              f"campaign {key} on the card differ from the CPU twin's")
    tl = train_step.kernel_launches(cfg)
    fl = serve_step.kernel_launches(cfg, 1)          # one full forward
    want = {k: CAMPAIGN_ITERS * (CAMPAIGN_STEPS * tl[k] + fl[k]) for k in tl}
    check(launches == want, f"campaign launches {launches} != {want}")

    # the same steps, called directly from the same weights
    opt = adamw.init(init)
    step = train_step.make_train_step(cfg, adamw.OptimizerConfig(
        total_steps=64, warmup_steps=2))
    direct, direct_s = [], []
    for toks in out["tokens"]:
        batch = HC.sst_batch(toks, dev)
        for _ in range(CAMPAIGN_STEPS):
            t0 = time.perf_counter()
            init, opt, m = step(init, opt, batch)
            loss = float(m["loss"])
            _sync(torch, dev)
            direct_s.append(time.perf_counter() - t0)
        direct.append(loss)
    del init, opt, batch
    bitwise = direct == losses
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, direct))
    check(bitwise or rel <= CAMPAIGN_LOSS_RTOL,
          f"campaign losses {losses} != direct {direct} (rel {rel:.3e})")

    for name in ("docking", "sst_train", "inference"):
        print(f"[runtime] campaign stage {name}: wall "
              f"{[round(x, 4) for x in out['stage_s'][name]]} s a round",
              flush=True)
    trains = out["tasks"]["sst_train"]
    run_s = _times(trains, "RUNNING", "DONE")
    inside = [sum(x) for x in out["step_s"]]
    dispatch = _times(trains, "SCHEDULING", "RUNNING")
    for i in range(CAMPAIGN_ITERS):
        print(f"[runtime] campaign round {i}: sst_train RUNNING->DONE "
              f"{run_s[i]:.4f} s in the trace, its {CAMPAIGN_STEPS} steps "
              f"{inside[i]:.4f} s inside the callable (synchronised): the "
              f"runtime's cost {run_s[i] - inside[i]:.4f} s; dispatch "
              f"SCHEDULING->RUNNING {dispatch[i] * 1e3:.3f} ms  [{card}]",
              flush=True)
    steps = [x for s in out["step_s"] for x in s[1:]]
    med = statistics.median(steps)
    print(f"[runtime] campaign: {len(tasks)} tasks DONE in {wall_s:.2f} s "
          f"(rounds {out['wall_s']:.2f} s); losses {losses}; direct "
          f"{direct}: {'equal in every bit' if bitwise else f'rel {rel:.3e}'}"
          f"; step {med:.4f} s in the task (median of the rounds' steps 2-"
          f"{CAMPAIGN_STEPS}), {statistics.median(direct_s[1:]):.4f} s "
          f"called directly, phase 7's {phase7_step_s:.4f} s; scores and "
          f"selections equal to the CPU twin's; launches {launches}  "
          f"[{card}]", flush=True)
    readings = {"losses": losses, "scores": out["scores"],
                "selections": out["selections"],
                "inference": out["inference"], "step_s": med,
                "sst_run_s": max(run_s)}
    return launches, out.pop("params"), readings


def _serve(torch, ops_of, cfg, handler, prompts, replicas):
    """``prompts`` through a service of ``replicas`` replicas on dragon, the
    launch counts set to 0 just before. Returns the results in request
    order, the request log, the launches, the replica tasks, the requests
    each replica served and the wall seconds."""
    from repro_torch.core.pilot import PilotDescription
    from repro_torch.runtime import PilotManager, Session, TaskManager

    with Session(mode="real") as session:
        pilot = PilotManager(session).submit_pilots(PilotDescription(
            nodes=1, backends={"dragon": {"workers": replicas + 2}}))
        tmgr = TaskManager(session)
        tmgr.add_pilots(pilot)
        _reset(ops_of)
        t0 = time.perf_counter()
        svc = tmgr.start_service(handler=handler, replicas=replicas,
                                 backend="dragon")
        rids = svc.submit_requests(prompts)
        check(svc.wait_requests(timeout=TASK_TIMEOUT_S),
              "service requests did not finish")
        wall_s = time.perf_counter() - t0
        svc.stop()
        check(tmgr.wait_tasks(timeout=TASK_TIMEOUT_S),
              "service replicas did not stop")
        launches = _counts(ops_of)
        tasks = [tmgr.tasks[d.uid] for d in svc.descriptions()]
        log = {k: np.asarray(v) for k, v in svc.request_log().items()}
        return ([svc.results[r] for r in rids], log, launches, tasks,
                sorted(svc.served_per_replica().values()), wall_s)


def service_on_card(torch, ops_of, card, dev, cfg, params):
    """Phase 10 (b): an LM service of SERVICE_REPLICAS replicas on dragon
    sharing ``params``, each request one PROMPT_LEN prompt and NEW_TOKENS
    greedy tokens through launch/serve.py's generate; the tokens against
    generate called directly; the replicas STOPPED; exact launches. Then
    the same requests through one replica, and generate called one request
    after another, for the rate each gives."""
    from repro_torch.distributed import serve_step
    from repro_torch.launch.serve import generate

    gen = torch.Generator(device=dev).manual_seed(SEED)
    prompts = [torch.randint(0, cfg.vocab_size, (1, PROMPT_LEN),
                             generator=gen, device=dev, dtype=torch.int32)
               for _ in range(SERVICE_REQUESTS)]

    cpu_s = []          # CPU seconds of the thread that ran each request

    def handler(prompt):
        t0 = time.thread_time()
        out = generate(params, cfg, prompt,
                       max_new_tokens=NEW_TOKENS)[:, PROMPT_LEN:].cpu()
        cpu_s.append(time.thread_time() - t0)
        return out

    t0 = time.perf_counter()
    direct = [handler(p) for p in prompts]
    direct_s = time.perf_counter() - t0
    cpu = {"direct": statistics.median(cpu_s)}
    per_launch = serve_step.kernel_launches(cfg, NEW_TOKENS)
    want = {k: SERVICE_REQUESTS * v for k, v in per_launch.items()}
    rates, main, lat_of, served_of = {}, None, {}, {}
    for replicas in (SERVICE_REPLICAS, 1):
        cpu_s.clear()
        results, log, launches, tasks, served, wall_s = _serve(
            torch, ops_of, cfg, handler, prompts, replicas)
        check(all(t.state.value == "STOPPED" and t.backend == "dragon"
                  for t in tasks),
              f"replicas not STOPPED on dragon: "
              f"{[(t.uid, t.state.value, t.error) for t in tasks]}")
        check(bool((log["ok"] == 1).all()) and len(results) == len(prompts),
              f"service requests not all answered: ok {log['ok'].tolist()}")
        check(launches == want, f"service launches {launches} != {want}")
        same = sum(bool(torch.equal(a, b)) for a, b in zip(results, direct))
        check(same == len(prompts), f"service tokens differ from direct "
              f"generate in {len(prompts) - same} of {len(prompts)}")
        lat = log["end"] - log["submit"]
        lat_of[replicas] = lat
        served_of[replicas] = float(np.median(log["end"] - log["start"]))
        span = log["end"].max() - log["submit"].min()
        rates[replicas] = len(prompts) / span
        cpu[replicas] = statistics.median(cpu_s)
        ready = _times(tasks, "PROVISIONING", "READY")
        print(f"[runtime] service: {replicas} replica(s) of {cfg.name} on "
              f"dragon, {len(prompts)} requests of {PROMPT_LEN} prompt "
              f"tokens and {NEW_TOKENS} greedy new tokens: "
              f"{rates[replicas]:.3f} requests/s "
              f"({len(prompts) * NEW_TOKENS / span:.1f} new tokens/s) over "
              f"{span:.3f} s from the request log, wall {wall_s:.3f} s; "
              f"latency median {np.median(lat):.4f} s, p99 "
              f"{np.percentile(lat, 99):.4f} s; CPU time of the replica's "
              f"thread per request {cpu[replicas]:.4f} s (median); served "
              f"per replica {served};"
              f" PROVISIONING->READY {[round(x * 1e3, 3) for x in ready]} "
              f"ms; tokens equal to direct generate in {same}/"
              f"{len(prompts)}; replicas STOPPED; launches {launches}  "
              f"[{card}]", flush=True)
        main = main or launches
    print(f"[runtime] service rates: {SERVICE_REPLICAS} replicas "
          f"{rates[SERVICE_REPLICAS]:.3f}, 1 replica {rates[1]:.3f}, generate "
          f"called one request after another {len(prompts) / direct_s:.3f} "
          f"requests/s; CPU seconds of the serving thread per request "
          f"(median) {cpu[SERVICE_REPLICAS]:.4f}, {cpu[1]:.4f} and "
          f"{cpu['direct']:.4f}  [{card}]", flush=True)
    readings = {"served_s": served_of[1],
                "p99_s": float(np.percentile(lat_of[SERVICE_REPLICAS], 99))}
    return main, readings


def restart_on_card(torch, ops_of, card, dev, cfg):
    """Phase 10 (c): a flux task trains ``cfg`` (mamba2-130m) at
    DRIVER_LM_BATCH x DRIVER_LM_SEQ, saves through the manager the runtime
    injects every RESTART_EVERY steps, crashes once after RESTART_CRASH, and
    is resumed by the runtime to RESTART_STEPS; its final parameters against
    an uninterrupted run, bit for bit."""
    from repro_torch import tree as T
    from repro_torch.core.pilot import PilotDescription
    from repro_torch.core.task import TaskDescription
    from repro_torch.distributed.train_step import (kernel_launches,
                                                    make_train_step)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.serve import _positions
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.runtime import PilotManager, Session, TaskManager

    B, S = DRIVER_LM_BATCH, DRIVER_LM_SEQ
    gen = torch.Generator(device=dev).manual_seed(SEED)
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen,
                         device=dev, dtype=torch.int32)
    batch = {"tokens": toks[:, :-1].contiguous(),
             "labels": toks[:, 1:].contiguous(),
             "positions": _positions(cfg, B, S, device=dev)}
    step = make_train_step(cfg, adamw.OptimizerConfig(warmup_steps=1,
                                                      total_steps=10))
    attempts = []

    def trainer(n_steps, checkpoint=None, resume_from=None, mesh=None):
        attempts.append(resume_from)
        params = M.init_params(cfg, seed=SEED, device=dev)
        opt = adamw.init(params)
        start = 0
        if resume_from is not None:
            tree = checkpoint.restore(resume_from, template={
                "params": params, "opt": opt})["tree"]
            params, opt, start = tree["params"], tree["opt"], resume_from
        for s in range(start + 1, n_steps + 1):
            params, opt, _ = step(params, opt, batch)
            if checkpoint is not None and s % RESTART_EVERY == 0:
                checkpoint.save(s, {"params": params, "opt": opt})
            if (checkpoint is not None and resume_from is None
                    and s == RESTART_CRASH):
                raise RuntimeError(f"a crash after step {s}")
        _sync(torch, dev)
        return params

    ckpt = os.path.join(ROOT, "build", "chip_smoke_runtime_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    with Session(mode="real") as session:
        pilot = PilotManager(session).submit_pilots(PilotDescription(
            nodes=1, backends={"flux": {"partitions": 1,
                                        "mesh": make_host_mesh(device=dev)}}))
        tmgr = TaskManager(session)
        tmgr.add_pilots(pilot)
        _reset(ops_of)
        t0 = time.perf_counter()
        task = tmgr.submit_tasks(TaskDescription(
            kind="executable", coupling="tight", fn=trainer,
            args=(RESTART_STEPS,), max_retries=1, checkpoint_dir=ckpt))
        check(tmgr.wait_tasks(timeout=TASK_TIMEOUT_S),
              "the restart task did not finish")
        wall_s = time.perf_counter() - t0
        launches = _counts(ops_of)
        resumes = session.profiler.by_name("task:resume")
        retries = session.profiler.by_name("agent:retry")
    check(task.state.value == "DONE" and task.backend == "flux",
          f"restart task {task.state.value} on {task.backend}: {task.error}")
    check(attempts == [None, RESTART_CRASH],
          f"restart attempts resumed from {attempts}")
    check(len(resumes) == 1 and resumes[0].data["progress"] == RESTART_CRASH,
          f"task:resume events {[e.data for e in resumes]}")
    want = {k: RESTART_STEPS * v for k, v in kernel_launches(cfg).items()}
    check(launches == want, f"restart launches {launches} != {want}")
    t0 = time.perf_counter()
    ref = trainer(RESTART_STEPS)
    ref_s = time.perf_counter() - t0
    diff = [key for (key, a), (_, b) in zip(T.flatten(task.result),
                                             T.flatten(ref))
            if not torch.equal(a, b)]
    check(not diff, f"resumed parameters differ from the uninterrupted run's "
          f"in {len(diff)} leaves: {diff[:5]}")
    print(f"[runtime] restart: {cfg.name} at {B} x {S} on flux, a "
          f"checkpoint every {RESTART_EVERY} steps, a crash after step "
          f"{RESTART_CRASH} ({len(retries)} agent:retry), one task:resume "
          f"with progress {resumes[0].data['progress']}, DONE at step "
          f"{RESTART_STEPS} in {wall_s:.3f} s (the uninterrupted run "
          f"{ref_s:.3f} s); parameters equal to the uninterrupted run's in "
          f"every bit; launches {launches}  [{card}]", flush=True)
    del task, ref
    shutil.rmtree(ckpt, ignore_errors=True)
    return launches


def _noop_rate(tmgr, backend, n):
    """n no-op function tasks through ``backend``: tasks/s from the trace
    (first submission to last DONE), and the tasks."""
    from repro_torch.core.task import TaskDescription
    tasks = tmgr.submit_tasks([TaskDescription(kind="function", fn=_noop,
                                               args=(i,), backend=backend)
                               for i in range(n)])
    check(tmgr.wait_tasks(tasks, timeout=TASK_TIMEOUT_S),
          f"{n} no-op tasks on {backend} did not finish")
    check(all(t.state.value == "DONE" and t.backend == backend
              for t in tasks) and [t.result for t in tasks] == list(range(n)),
          f"no-op tasks on {backend} not all DONE there")
    t_first = min(t.timestamps["SCHEDULING"] for t in tasks)
    t_last = max(t.timestamps["DONE"] for t in tasks)
    return n / (t_last - t_first)


def throughput_on_card(torch, ops_of, card, dev, cfg):
    """Phase 10 (d): THROUGHPUT_TASKS no-op function tasks through dragon
    and through funcpool (worker processes forked after CUDA is up), each
    alone and beside a flux task training ``cfg`` on the card. A task that
    asks for the card in a forked funcpool worker fails with CUDA's error."""
    from repro_torch.core.pilot import PilotDescription
    from repro_torch.core.task import TaskDescription
    from repro_torch.distributed.train_step import (kernel_launches,
                                                    make_train_step)
    from repro_torch.launch.hybrid_campaign import sst_batch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.runtime import PilotManager, Session, TaskManager

    check(torch.cuda.is_initialized() or dev.type != "cuda",
          "CUDA is not initialised before the funcpool workers fork")
    pools = {"dragon": {"workers": THROUGHPUT_WORKERS},
             "funcpool": {"workers": THROUGHPUT_WORKERS}}
    rates = {}
    for backend in ("dragon", "funcpool"):
        with Session(mode="real") as session:
            pilot = PilotManager(session).submit_pilots(PilotDescription(
                nodes=1, backends={backend: pools[backend]}))
            tmgr = TaskManager(session)
            tmgr.add_pilots(pilot)
            rates[(backend, "alone")] = _noop_rate(tmgr, backend,
                                                   THROUGHPUT_TASKS)
            if backend == "funcpool":
                t0 = time.perf_counter()
                bad = tmgr.submit_tasks(TaskDescription(
                    kind="function", fn=_touch_cuda, backend="funcpool"))
                check(tmgr.wait_tasks([bad], timeout=60),
                      "a CUDA payload on funcpool did not end within 60 s")
                fail_s = time.perf_counter() - t0
                check(bad.state.value == "FAILED"
                      and "CUDA" in (bad.error or ""),
                      f"a CUDA payload on funcpool ended {bad.state.value}: "
                      f"{bad.error}")
                print(f"[runtime] funcpool (start method "
                      f"{pilot.agent.backends['funcpool']._ctx.get_start_method()}"
                      f", workers forked after CUDA was set up): a payload "
                      f"that asks for the card ended FAILED in {fail_s:.3f} "
                      f"s: {bad.error[:160]!r}", flush=True)

    params = M.init_params(cfg, seed=SEED, device=dev)
    step = make_train_step(cfg, adamw.OptimizerConfig(warmup_steps=1,
                                                      total_steps=10))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    toks = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ),
                         generator=gen, device=dev, dtype=torch.int32)
    batch = sst_batch(toks.cpu().numpy(), dev)
    first, stop = threading.Event(), threading.Event()

    def trainer(mesh=None):
        opt, n, times = adamw.init(params), 0, []
        while n < 1 or not stop.is_set():
            t0 = time.perf_counter()
            _, opt, m = step(params, opt, batch)
            if not math.isfinite(float(m["loss"])):
                raise RuntimeError(f"step {n}: loss {float(m['loss'])}")
            _sync(torch, dev)
            times.append(time.perf_counter() - t0)
            n += 1
            first.set()
        return times

    with Session(mode="real") as session:
        pilot = PilotManager(session).submit_pilots(PilotDescription(
            nodes=1, backends={"flux": {"partitions": 1,
                                        "mesh": make_host_mesh(device=dev)},
                               **pools}))
        tmgr = TaskManager(session)
        tmgr.add_pilots(pilot)
        _reset(ops_of)
        train = tmgr.submit_tasks(TaskDescription(
            kind="executable", coupling="tight", fn=trainer))
        check(first.wait(timeout=TASK_TIMEOUT_S),
              "the training task took no step")
        for backend in ("dragon", "funcpool"):
            rates[(backend, "beside training")] = _noop_rate(
                tmgr, backend, THROUGHPUT_TASKS)
        stop.set()
        check(tmgr.wait_tasks([train], timeout=TASK_TIMEOUT_S),
              "the training task did not stop")
        launches = _counts(ops_of)
    check(train.state.value == "DONE" and train.backend == "flux",
          f"training task {train.state.value}: {train.error}")
    times = train.result
    want = {k: len(times) * v for k, v in kernel_launches(cfg).items()}
    check(launches == want, f"throughput phase launches {launches} != {want}")
    print(f"[runtime] function-task throughput, {THROUGHPUT_TASKS} no-op "
          f"tasks, {THROUGHPUT_WORKERS} workers, tasks/s from the trace "
          f"(first submission to last DONE): "
          + ", ".join(f"{b} {w} {r:.1f}" for (b, w), r in rates.items())
          + f"; the flux task trained {cfg.name} for {len(times)} steps "
          f"meanwhile (step median {statistics.median(times):.4f} s, "
          f"max {max(times):.4f} s); launches {launches}  [{card}]",
          flush=True)
    del params
    return launches


def hybrid_stages(cfg, params, dev, iterations, docking_batch, train_steps,
                  seq_len):
    """launch/hybrid_campaign.py's campaign as Stages of a Campaign: per
    round ``docking.{it}`` (a function task per candidate), then
    ``sst_train.{it}`` (one tight executable task), then ``inference.{it}``
    (a function task); the next round's docking depends on the previous
    inference. The payloads are the twin's own (``make_payloads``) and the
    draws its own, from ``default_rng(0)`` in the loop's order: each
    stage's ``make_tasks`` draws the round's SST tokens (``sst_train``) or
    makes the selection and the fresh candidates (``inference``, reading
    ``ctx.results`` of the round's docking). ``make_tasks`` runs under the
    engine lock, so it only draws numpy and builds descriptions. Returns
    the stages and a record that fills in as they run: per round the SST
    ``tokens``, the docking ``scores`` and the ``selections``; the train
    tasks' ``step_s`` and ``meshes``; and ``state``, whose ``params`` the
    train tasks update."""
    from repro_torch.core.campaign import Stage
    from repro_torch.core.task import TaskDescription
    from repro_torch.launch import hybrid_campaign as HC
    from repro_torch.optim import adamw

    state = {"params": params, "opt": adamw.init(params)}
    rec = {"tokens": [], "scores": [], "selections": [], "step_s": [],
           "meshes": [], "state": state}
    docking, train_task, inference = HC.make_payloads(
        cfg, state, HC.make_step(cfg), dev, train_steps, rec["step_s"],
        rec["meshes"])
    rng = np.random.default_rng(0)
    cand = {"now": rng.standard_normal((docking_batch, 8))}

    def mk_docking(ctx):
        return [TaskDescription(kind="function", fn=docking, args=(m,))
                for m in cand["now"]]

    def mk_train(ctx):
        toks = HC.sst_tokens(cand["now"], rng, seq_len, cfg.vocab_size)
        rec["tokens"].append(toks)
        return [TaskDescription(kind="executable", coupling="tight",
                                fn=train_task, args=(toks,))]

    def mk_inference(ctx, it):
        scores = np.asarray([t.result
                             for t in ctx.results(f"docking.{it}")])
        pick, cand["now"] = HC.select(cand["now"], scores, rng)
        rec["scores"].append(scores)
        rec["selections"].append(pick)
        return [TaskDescription(kind="function", fn=inference,
                                args=(scores,))]

    stages = []
    for it in range(iterations):
        stages += [
            Stage(f"docking.{it}", mk_docking,
                  depends_on=[f"inference.{it - 1}"] if it else []),
            Stage(f"sst_train.{it}", mk_train,
                  depends_on=[f"docking.{it}"]),
            Stage(f"inference.{it}",
                  lambda ctx, it=it: mk_inference(ctx, it),
                  depends_on=[f"sst_train.{it}"])]
    return stages, rec


def assert_streamed_equals_posthoc(w, tasks, cores, prof, what):
    """tests/test_streaming.py's golden check: the watcher's streamed
    throughput, in-flight and occupancy series equal to the post-hoc
    reconstruction, bit for bit, and its breakdown to 1e-9 (sums) and
    exactly (counts, order statistics)."""
    from repro_torch.observability import (PHASES, inflight,
                                           lifecycle_breakdown, occupancy,
                                           throughput)

    for name, got, want in (
            ("throughput", w.throughput.series(),
             throughput(prof, tasks, dt=w.dt)),
            ("inflight", w.inflight.series(), inflight(tasks, dt=w.dt)),
            ("occupancy", w.occupancy_series(),
             occupancy(tasks, cores, dt=w.dt))):
        check(np.array_equal(got.t, want.t) and np.array_equal(got.v, want.v),
              f"{what}: streamed {name} differs from the post-hoc one")
    st = w.breakdown.stats(exact_quantiles=True)
    post = lifecycle_breakdown(tasks, prof).total.as_dict()
    close = lambda a, b: abs(a - b) <= 1e-9 * abs(b) + 1e-12  # noqa: E731
    check(st["n"] == post["n"] and close(st["span_sum"], post["span_sum"]),
          f"{what}: streamed breakdown n/span {st['n']}/{st['span_sum']} "
          f"!= post-hoc {post['n']}/{post['span_sum']}")
    for p in PHASES:
        sp, pp = st["phases"][p], post["phases"][p]
        check(sp["n"] == pp["n"] and close(sp["sum"], pp["sum"])
              and (sp["p50"], sp["p99"], sp["max"])
              == (pp["p50"], pp["p99"], pp["max"]),
              f"{what}: streamed phase {p} {sp} != post-hoc {pp}")


def assert_telescopes(bd, tasks, cores, what):
    """tests/test_observability.py's check: each task's lifecycle stamps in
    order, the phase sums tiling submit -> done in every group, and the
    breakdown's count equal to compute_metrics' (real mode)."""
    from repro_torch.core.analytics import compute_metrics
    from repro_torch.observability import PHASES

    order = ("SCHEDULING", "QUEUED", "LAUNCHING", "RUNNING", "DONE")
    for t in tasks:
        ts = [t.timestamps[s] for s in order]
        check(ts == sorted(ts), f"{what}: {t.uid} stamps out of order {ts}")
    for g in [bd.total, *bd.groups.values()]:
        s = sum(g.phases[p].sum for p in PHASES)
        check(abs(s - g.span_sum) <= 1e-9 * abs(g.span_sum) + 1e-12,
              f"{what}: phases sum {s} != span {g.span_sum}")
    m = compute_metrics(tasks, cores, mode="real")
    check(bd.n_tasks == m.n_done == len(tasks),
          f"{what}: breakdown of {bd.n_tasks} tasks, {m.n_done} done")


def watched_runtime_on_card(torch, ops_of, card, dev, cfg, readings):
    """Phase 11: the port's Campaign, analytics, chaos and observability
    layers over the card's tasks. Returns each part's launch counts."""
    launches = {}
    launches["watched_campaign"], params = watched_campaign_on_card(
        torch, ops_of, card, dev, cfg, readings["campaign"])
    params, svc_cfg = first_layers(params, cfg, SERVICE_DEPTH)
    launches["service_under_chaos"] = chaos_service_on_card(
        torch, ops_of, card, dev, svc_cfg, params, readings["service"])
    del params
    impeccable_on_sim_engine()
    return launches


def impeccable_on_sim_engine():
    """The survey's IMPECCABLE campaign (``run_impeccable``, its defaults:
    3 iterations, seed 0) on the port's SimEngine at 256 and 1,024 nodes:
    virtual seconds of a simulated cluster, no card involved."""
    from repro_torch.core.analytics import compute_metrics
    from repro_torch.core.impeccable import run_impeccable

    for nodes in (256, 1024):
        row = []
        for backend in ("srun", "flux", "flux+dragon"):
            agent, camp = run_impeccable(backend, nodes)
            check(camp.complete, f"IMPECCABLE on {backend} did not finish")
            m = compute_metrics(camp.all_tasks(), agent.total_cores)
            row.append(f"{backend} makespan {m.makespan:.3f} s, utilization "
                       f"{m.utilization:.4f}")
        print(f"[sim] IMPECCABLE at {nodes} nodes ({len(camp.all_tasks())} "
              f"tasks; SimEngine virtual seconds, not a card reading): "
              + "; ".join(row), flush=True)


def watched_campaign_on_card(torch, ops_of, card, dev, cfg, before):
    """Phase 11 (a): phase 10 (a)'s campaign through
    ``TaskManager.run_campaign`` from the same weights and draws, watched.
    ``before`` holds phase 10 (a)'s readings."""
    from repro_torch.core.analytics import compute_metrics
    from repro_torch.core.pilot import PilotDescription
    from repro_torch.distributed import serve_step, train_step
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as M
    from repro_torch.observability import (RunReport, StallRule,
                                           export_chrome_trace,
                                           lifecycle_breakdown)
    from repro_torch.runtime import PilotManager, Session, TaskManager

    params = M.init_params(cfg, seed=SEED, device=dev)
    stages, rec = hybrid_stages(cfg, params, dev, CAMPAIGN_ITERS,
                                CAMPAIGN_DOCK, CAMPAIGN_STEPS, CAMPAIGN_SEQ)
    del params
    # no completion lands while a train task runs (phase 10 (a)'s longest
    # read before["sst_run_s"]): the window leaves it STALL_FACTOR of room
    window = STALL_FACTOR * before["sst_run_s"]
    with Session(mode="real") as session:
        pilot = PilotManager(session).submit_pilots(PilotDescription(
            nodes=1, backends={"dragon": {"workers": 4},
                               "flux": {"partitions": 1,
                                        "mesh": make_host_mesh(device=dev)}}))
        tmgr = TaskManager(session)
        tmgr.add_pilots(pilot)
        _reset(ops_of)
        t0 = time.perf_counter()
        watcher = tmgr.watch(interval=WATCH_INTERVAL_S,
                             rules=[StallRule(window=window)])
        camp = tmgr.run_campaign(stages, name="hybrid",
                                 timeout=TASK_TIMEOUT_S)
        _sync(torch, dev)
        wall_s = time.perf_counter() - t0
        watcher.finalize()
        launches = _counts(ops_of)
        agent, prof = pilot.agent, session.profiler
        tasks = camp.all_tasks()
        workers = sum(ex.workers for ex in agent.backends.values())
        check(camp.complete, "the campaign did not complete")
        check(watcher.n_rows_folded == prof.n_rows,
              f"the watcher folded {watcher.n_rows_folded} of "
              f"{prof.n_rows} trace rows")
        assert_streamed_equals_posthoc(watcher, tasks, agent.total_cores,
                                       prof, "campaign")
        bd = lifecycle_breakdown(tasks, prof, by="backend")
        m = compute_metrics(tasks, workers, mode="real")
        trace_path = os.path.join(ROOT, "build", "chip_smoke_campaign.trace"
                                  ".json")
        os.makedirs(os.path.dirname(trace_path), exist_ok=True)
        summary = export_chrome_trace(trace_path, tasks, prof,
                                      total_cores=workers, dt=0.25)
        report = RunReport.collect(tasks, workers, profiler=prof,
                                   mode="real")
    state = rec.pop("state")
    params = state.pop("params")
    state.clear()

    for name, ts in camp.stage_tasks.items():
        check(ts and all(t.state.value == "DONE" for t in ts),
              f"stage {name}: {[(t.uid, t.state.value, t.error) for t in ts]}")
        want = ("flux" if name.startswith("sst_train") else "dragon")
        check({t.backend for t in ts} == {want},
              f"stage {name} ran on {sorted({t.backend for t in ts})}")
    check(len(tasks) == CAMPAIGN_ITERS * (CAMPAIGN_DOCK + 2),
          f"{len(tasks)} campaign tasks")
    losses = [camp.stage_tasks[f"sst_train.{i}"][0].result
              for i in range(CAMPAIGN_ITERS)]
    check(losses == before["losses"],
          f"staged losses {losses} != phase 10 (a)'s {before['losses']}")
    for key in ("scores", "selections"):
        check(len(rec[key]) == CAMPAIGN_ITERS and all(
            np.array_equal(a, b) for a, b in zip(rec[key], before[key])),
            f"staged {key} differ from phase 10 (a)'s")
    same_inf = all(np.array_equal(
        camp.stage_tasks[f"inference.{i}"][0].result, before["inference"][i])
        for i in range(CAMPAIGN_ITERS))
    assert_telescopes(bd, tasks, workers, "campaign")
    check(not watcher.monitor.alerts,
          f"alerts in the campaign: {watcher.monitor.alerts}")
    tl = train_step.kernel_launches(cfg)
    fl = serve_step.kernel_launches(cfg, 1)          # one full forward
    want = {k: CAMPAIGN_ITERS * (CAMPAIGN_STEPS * tl[k] + fl[k]) for k in tl}
    check(launches == want, f"watched campaign launches {launches} != {want}")

    with open(trace_path) as fh:
        doc = json.load(fh)
    slices = [e["name"] for e in doc["traceEvents"] if e["ph"] == "X"]
    attempts = sum(1 + t.retries for t in tasks)
    check(sorted(slices) == sorted(t.uid for t in tasks)
          and len(slices) == attempts == summary["n_slices"]
          and summary["n_slices_dropped"] == 0,
          f"Chrome trace: {len(slices)} slices for {attempts} attempts")
    payload = report.to_json()
    check(json.loads(json.dumps(payload)) == payload
          and payload["metrics"]["n_done"] == len(tasks)
          and "lifecycle breakdown" in report.render(),
          "the RunReport did not round-trip")

    steps = [x for s in rec["step_s"] for x in s[1:]]
    print(f"[runtime] watched campaign: {len(camp.stage_tasks)} stages, "
          f"{len(tasks)} tasks DONE through run_campaign in {wall_s:.2f} s; "
          f"losses {losses} equal in every bit to phase 10 (a)'s; scores "
          f"and selections equal; inference outputs "
          f"{'equal' if same_inf else 'differ'}; step in the watched task "
          f"{statistics.median(steps):.4f} s (median of the rounds' steps "
          f"2-{CAMPAIGN_STEPS}), unwatched (phase 10 (a)) "
          f"{before['step_s']:.4f} s; launches {launches}  [{card}]",
          flush=True)
    print(f"[runtime] watched campaign metrics (compute_metrics, real, "
          f"{workers} workers): makespan {m.makespan:.4f} s, utilization "
          f"{m.utilization:.4f}, throughput {m.throughput_avg:.4f} tasks/s, "
          f"peak concurrency {m.concurrency_peak}; watcher: "
          f"{watcher.n_ticks} ticks every {WATCH_INTERVAL_S} s, "
          f"{watcher.fold_wall_s * 1e3:.3f} ms folding {watcher.n_rows_folded}"
          f" rows, stall window {window:.3f} s, no alert; streamed == "
          f"post-hoc; Chrome trace {len(slices)} slices "
          f"({os.path.relpath(trace_path, ROOT)}); RunReport round-trips  "
          f"[{card}]", flush=True)
    for b, g in sorted(bd.groups.items()):
        print(f"[runtime] lifecycle {b} ({g.n} tasks): " + ", ".join(
            f"{p} p50 {g.phases[p].p50 * 1e3:.3f} / p99 "
            f"{g.phases[p].p99 * 1e3:.3f} ms" for p in g.phases), flush=True)
    return launches, params


def chaos_service_on_card(torch, ops_of, card, dev, cfg, params, before):
    """Phase 11 (b): CHAOS_REPLICAS LM replicas on dragon with a
    RestartPolicy, CHAOS_REQUESTS requests, a node fault on dragon while
    they are served; watched. ``before`` holds phase 10 (b)'s readings."""
    from repro_torch.core.analytics import fault_metrics, service_metrics
    from repro_torch.core.pilot import PilotDescription
    from repro_torch.distributed import serve_step
    from repro_torch.faults import ChaosController, FaultEvent, FaultPlan
    from repro_torch.launch.serve import generate
    from repro_torch.observability import ServiceLatencyRule
    from repro_torch.runtime import PilotManager, Session, TaskManager
    from repro_torch.sched import CampaignScheduler
    from repro_torch.services import RestartPolicy

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    prompts = [torch.randint(0, cfg.vocab_size, (1, PROMPT_LEN),
                             generator=gen, device=dev, dtype=torch.int32)
               for _ in range(CHAOS_REQUESTS)]
    calls, lock = {"started": 0, "finished": 0}, threading.Lock()

    def answer(prompt):
        return generate(params, cfg, prompt,
                        max_new_tokens=NEW_TOKENS)[:, PROMPT_LEN:].cpu()

    def handler(prompt):
        with lock:
            calls["started"] += 1
        try:
            return answer(prompt)
        finally:
            with lock:
                calls["finished"] += 1

    direct = [answer(p) for p in prompts]
    # the fault lands FAULT_AT of one request's service time (phase 10 (b),
    # one replica) after the requests go in: both replicas are serving
    fault_t = FAULT_AT * before["served_s"]
    with Session(mode="real") as session:
        pilot = PilotManager(session).submit_pilots(PilotDescription(
            nodes=1, backends={"dragon": {"workers": CHAOS_REPLICAS + 2}}))
        sched = CampaignScheduler(policy="fifo")
        tmgr = TaskManager(session, scheduler=sched)
        tmgr.add_pilots(pilot)
        _reset(ops_of)
        t0 = time.perf_counter()
        svc = tmgr.start_service(
            handler=handler, replicas=CHAOS_REPLICAS, backend="dragon",
            restart=RestartPolicy(max_restarts=2, backoff=0.1))
        watcher = tmgr.watch(
            interval=WATCH_INTERVAL_S, services=[svc],
            rules=[ServiceLatencyRule(svc, slo_p99=before["p99_s"],
                                      min_requests=1)])
        check(svc.wait_ready(timeout=TASK_TIMEOUT_S),
              "the replicas did not get READY")
        chaos = ChaosController(sched, FaultPlan(
            [FaultEvent(fault_t, "node", backend="dragon")]), seed=SEED)
        rids = svc.submit_requests(prompts)
        chaos.arm()
        check(svc.wait_requests(timeout=TASK_TIMEOUT_S),
              "the requests did not finish")
        svc.stop()
        check(tmgr.wait_tasks(timeout=TASK_TIMEOUT_S),
              "the replicas did not stop")
        # a killed replica's thread cannot be stopped: it finishes the
        # generate it was running (and answers its request) before the
        # launches are read
        deadline = time.perf_counter() + TASK_TIMEOUT_S
        while calls["finished"] < calls["started"]:
            check(time.perf_counter() < deadline,
                  "a replica's generate did not return")
            time.sleep(0.01)
        wall_s = time.perf_counter() - t0
        watcher.finalize()
        launches = _counts(ops_of)
        stats = chaos.stats()
        fm = fault_metrics(session.profiler)
        sm = service_metrics(svc)
        log = {k: np.asarray(v) for k, v in svc.request_log().items()}
        replicas = [pilot.agent.tasks[d.uid] for d in svc.all_descriptions()]
        fail_t = [e.time for e in session.profiler.by_name("chaos:node_fail")]
        alerts = [a.as_dict() for a in watcher.monitor.alerts]

    check(stats["node_failures"] == 1 and stats["tasks_killed"] >= 1,
          f"the node fault killed nothing: {stats}")
    check(sm.n_completed == CHAOS_REQUESTS and sm.n_failed == 0
          and sm.n_restarts >= 1,
          f"service metrics {sm.as_dict()}")
    check(len(rids) == CHAOS_REQUESTS and bool((log["ok"] == 1).all())
          and bool((log["end"] >= 0.0).all()),
          f"a request was lost: ok {log['ok'].tolist()}")
    same = sum(bool(torch.equal(svc.results[r], d))
               for r, d in zip(rids, direct))
    check(same == CHAOS_REQUESTS, f"tokens differ from direct generate in "
          f"{CHAOS_REQUESTS - same} of {CHAOS_REQUESTS}")
    killed = [t for t in replicas if t.state.value == "FAILED"]
    check(len(killed) == stats["tasks_killed"]
          and all("node failure" in (t.error or "") for t in killed)
          and all(t.state.value == "STOPPED" for t in replicas
                  if t not in killed)
          and all(t.backend == "dragon" for t in replicas),
          f"replicas: {[(t.uid, t.state.value, t.error) for t in replicas]}")
    per = serve_step.kernel_launches(cfg, NEW_TOKENS)
    want = {k: calls["started"] * v for k, v in per.items()}
    check(launches == want, f"launches {launches} != {want} "
          f"({calls['started']} generate calls)")

    t_fail = fail_t[0]
    ready = [t.timestamps["READY"] - t_fail for t in replicas
             if t.description.restarted_from and "READY" in t.timestamps]
    after = log["end"][log["end"] > t_fail] - t_fail
    lat = log["end"] - log["submit"]
    print(f"[runtime] service under chaos: {CHAOS_REPLICAS} replicas of "
          f"{cfg.name} on dragon, {CHAOS_REQUESTS} requests of {PROMPT_LEN} "
          f"+ {NEW_TOKENS} tokens, a node fault at +{fault_t:.3f} s "
          f"(chaos {stats}); {sm.n_completed} answered, none lost, tokens "
          f"equal to direct generate; {sm.n_restarts} restart(s), "
          f"{calls['started']} generate calls; replicas "
          f"{[t.state.value for t in replicas]}; wall {wall_s:.3f} s; "
          f"latency median {np.median(lat):.4f} s, p99 "
          f"{np.percentile(lat, 99):.4f} s; launches {launches}  [{card}]",
          flush=True)
    print(f"[runtime] recovery: replacement READY "
          f"{[round(x, 4) for x in ready]} s after the fault, first answer "
          f"after it {after.min():.4f} s, last {after.max():.4f} s; "
          f"fault_metrics {fm.as_dict()}; alerts {alerts} (p99 limit "
          f"{before['p99_s']:.3f} s); watcher "
          f"{watcher.n_ticks} ticks  [{card}]", flush=True)
    return launches


# ------------------------------------------------------------------ phase 12
def _card_rank(rank, world, port, jobs, results):
    """A spawned rank on card 0, joined to the others over gloo, running
    each (fn, args) it is handed, fn(rank, world, *args), until it is
    handed None."""
    import traceback
    try:
        import torch
        import torch.distributed as dist
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dist.init_process_group("gloo", world_size=world, rank=rank,
                                init_method=f"tcp://localhost:{port}")
        try:
            for fn, args in iter(jobs.get, None):
                results.put((rank, True, fn(rank, world, *args)))
        finally:
            dist.destroy_process_group()
    except Exception:                                    # noqa: BLE001
        results.put((rank, False, traceback.format_exc()))


# world -> (processes, each rank's job queue, the results queue): the ranks
# spawned on card 0 stay up from one call of on_card_ranks to the next of
# the same world (phases 12, 13 and 15 each run cases on 2 and on 4 ranks;
# a spawn takes 10-30 s to reach the card) until close_rank_pools
_POOLS = {}


def _spawn_pool(world):
    import multiprocessing as mp
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    ctx = mp.get_context("spawn")
    jobs = [ctx.Queue() for _ in range(world)]
    results = ctx.Queue()
    # daemonic: a failed check's exit takes them down with this process
    procs = [ctx.Process(target=_card_rank, daemon=True,
                         args=(rank, world, port, jobs[rank], results))
             for rank in range(world)]
    for p in procs:
        p.start()
    _POOLS[world] = procs, jobs, results
    return _POOLS[world]


def close_rank_pools(worlds=None, timeout=60.0):
    """Stop the ranks of the pools of ``worlds`` (every pool by default):
    each rank handed None, joined, killed if it has not exited within
    ``timeout``."""
    for world in [w for w in _POOLS if worlds is None or w in worlds]:
        procs, jobs, _ = _POOLS.pop(world)
        for q in jobs:
            q.put(None)
        deadline = time.monotonic() + timeout
        for p in procs:
            p.join(timeout=max(0.1, deadline - time.monotonic()))
            if p.is_alive():
                p.kill()
                p.join()


def on_card_ranks(fn, world, *args, timeout=TP_TIMEOUT_S):
    """[fn(rank, world, *args) for each rank], run by ``world`` processes
    on card 0 (spawned, this process has CUDA up: no fork; kept for the
    next call of the same world). A rank that fails, or a deadline passed,
    stops every rank of the pool and fails the run."""
    import queue
    procs, jobs, results = _POOLS.get(world) or _spawn_pool(world)
    for q in jobs:
        q.put((fn, args))
    deadline = time.monotonic() + timeout
    out, errors = {}, []
    while len(out) + len(errors) < world:
        try:
            rank, ok, payload = results.get(timeout=1.0)
        except queue.Empty:
            dead = [r for r, p in enumerate(procs)
                    if not p.is_alive() and r not in out]
            if dead or time.monotonic() > deadline:
                missing = sorted(set(range(world)) - set(out))
                errors.append(f"ranks {missing} gave nothing (exited "
                              f"{dead}; deadline {timeout} s)")
                break
            continue
        if ok:
            out[rank] = payload
        else:
            errors.append(f"rank {rank}:\n{payload}")
            deadline = min(deadline, time.monotonic() + 10)
    if errors:
        _POOLS.pop(world)
        for p in procs:
            p.kill()
            p.join()
    check(not errors, f"{fn.__name__} on {world} ranks: " + "\n".join(errors))
    return [out[r] for r in range(world)]


def _gather0(t, spec, mesh):
    """The whole tensor from every rank's block ``t`` under ``spec``
    (``sharding.local_slices``' blocks) on rank 0, None elsewhere: a
    collective, as ``sharding.gather_leaf`` is, for ranks that share one
    card. Rank 0 copies each other block out of its rank's memory through a
    CUDA IPC handle passed over the group, where ``gather_leaf`` would send
    the whole to every rank through host memory (most of a phase 12 (a)
    case's time). A block that several ranks hold (replicated over an
    axis) comes from the first of them, as rank 0's own gather takes it."""
    import torch
    import torch.distributed as dist
    from torch.multiprocessing.reductions import reduce_tensor
    from repro_torch.distributed import sharding as SH
    t = t.detach().contiguous()
    shape = tuple(n * mesh.axes_size(SH._axes_of(spec[d] if d < len(spec)
                                                 else None))
                  for d, n in enumerate(t.shape))
    rank, world = dist.get_rank(), dist.get_world_size()
    blocks = [None] * world
    dist.all_gather_object(blocks, [(s.start, s.stop) for s in
                                    SH.local_slices(spec, shape, mesh)])
    first = {}
    for r, b in enumerate(blocks):
        first.setdefault(tuple(b), r)
    shares = first[tuple(blocks[rank])] == rank and rank != 0
    handles = [None] * world
    dist.all_gather_object(handles, reduce_tensor(t) if shares else None)
    whole = None
    if rank == 0:
        whole = t.new_empty(shape)
        for b, r in first.items():
            sl = tuple(slice(*ab) for ab in b)
            whole[sl].copy_(t if r == 0 else handles[r][0](*handles[r][1]))
        torch.cuda.synchronize()
    dist.barrier()                  # each block lives until rank 0 copied it
    return whole


def _rank_ops():
    """The kernel wrappers of this process, by kernel name."""
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.fused_rmsnorm import ops as rn_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    return {"flash_attention": fa_ops, "decode_attention": da_ops,
            "fused_rmsnorm": rn_ops, "ssd": ssd_ops}


def tp_parity_rank(rank, world, cases):
    """Phase 12 (a) on one rank: ``tp_parity_case`` for each (arch,
    mesh_shape) of ``cases`` in turn, in one call of the ranks (each spawn
    takes seconds to reach the card), the card's cache emptied between
    them; each case's seconds on this rank added to its reading."""
    import torch
    out = []
    for arch, mesh_shape in cases:
        t0 = time.perf_counter()
        r = tp_parity_case(rank, world, arch, tuple(mesh_shape))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.ipc_collect()      # the blocks rank 0 copied
        out.append({**r, "case_s": time.perf_counter() - t0})
    return out


def tp_parity_case(rank, world, arch, mesh_shape):
    """One case of phase 12 (a) on one rank: the tensor-parallel step in
    its two parts (gradients, then the sharded AdamW update), its launches
    counted. Rank 0 first takes the one-rank kernel-path gradients on the
    whole weights; then every gathered leaf (a collective) is compared on
    rank 0 and dropped on the others (the ranks share one card): the
    gradients against the one-rank ones, the updated leaves and moments
    against the one-rank AdamW update on the gathered gradients."""
    import torch
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed import train_step as TS
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    ops_of = _rank_ops()
    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(arch, dtype="float32",
                     num_layers=TP_DEPTH_OF.get(arch, TP_DEPTH))
    mesh = make_mesh(mesh_shape, ("data", "model"), device=dev)
    rows = TP_BATCH_OF.get(arch, TP_BATCH)
    batch = train_batch(torch, cfg, dev, rows)
    opt_cfg = adamw.OptimizerConfig(warmup_steps=1, total_steps=10)
    step = TS.make_train_step(cfg, opt_cfg, mesh=mesh,
                              dp_axes=SH.batch_axes(mesh, cfg, rows))
    layout = step.layout
    whole = M.init_params(cfg, seed=SEED, device=dev)
    local = layout.shard_params(whole)
    if rank:
        del whole
    else:
        want, ref = TS.make_grad_fn(cfg)(whole, batch)
        want = dict(T.flatten(want))
    state = adamw.init(local, layout)
    for ops in ops_of.values():
        ops.launches = 0
    ops_of["fused_rmsnorm"].split_launches = 0
    grads, m = step.grad_fn(local, batch)
    local, state, _ = adamw.update(opt_cfg, state, grads, local, layout)
    mine = {"launches": {name: ops.launches for name, ops in ops_of.items()},
            "split_launches": ops_of["fused_rmsnorm"].split_launches,
            "loss": m["loss"].item(),
            "n_local": sum(t.numel() for t in T.leaves(local)),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    grad_rel, gathered = {}, []
    for path, g in T.flatten(grads):
        g = _gather0(g, layout.specs[path], mesh)
        if not rank:
            grad_rel[path] = rel_err(g, want.pop(path))
            gathered.append(g)
    del grads
    upd_rel = {}
    if not rank:                    # the one-rank AdamW on those gradients
        one = adamw.init(whole)
        adamw.update(opt_cfg, one, T.unflatten(whole, gathered), whole)
        del gathered
        ones = {"": dict(T.flatten(whole)), ".mu/": dict(T.flatten(one.mu)),
                ".nu/": dict(T.flatten(one.nu))}
    for prefix, tree, specs in (("", local, layout.specs),
                                (".mu/", state.mu, layout.moment_specs),
                                (".nu/", state.nu, layout.moment_specs)):
        for path, t in T.flatten(tree):
            t = _gather0(t, specs[path], mesh)
            if not rank:
                upd_rel[prefix + path] = rel_err(t, ones[prefix][path])
    if rank:
        return mine
    return {**mine, "ref_loss": ref["loss"].item(), "grad_rel": grad_rel,
            "upd_rel": upd_rel}


def tp_bf16_rank(rank, world, cases, steps, seed):
    """Phase 12 (b) on one rank: ``tp_bf16_case`` for each (arch,
    mesh_shape, depth) of ``cases`` in turn, in one call of the ranks,
    each case's seconds on this rank added to its reading."""
    import torch
    out = []
    for arch, mesh_shape, depth in cases:
        t0 = time.perf_counter()
        r = tp_bf16_case(rank, world, arch, tuple(mesh_shape), steps, depth,
                         seed)
        torch.cuda.empty_cache()
        out.append({**r, "case_s": time.perf_counter() - t0})
    return out


def tp_bf16_case(rank, world, arch, mesh_shape, steps, depth, seed):
    """One case of phase 12 (b) on one rank: ``steps`` tensor-parallel
    steps of the bf16 model at full width (``depth`` layers, or all; the
    weights of ``seed``) on phase 7's batch, each one's time, launches and the seconds spent in the
    collectives (each timed between two device synchronizations), and the
    rank's peak memory over the steps."""
    import torch
    import torch.distributed as dist
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.distributed import train_step as TS
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    ops_of = _rank_ops()
    dev = torch.device("cuda")
    cfg = get_config(arch, **({"num_layers": depth} if depth else {}))
    mesh = make_mesh(mesh_shape, ("data", "model"), device=dev)
    batch = train_batch(torch, cfg, dev)
    step = TS.make_train_step(cfg, adamw.OptimizerConfig(warmup_steps=1,
                                                         total_steps=10),
                              mesh=mesh,
                              dp_axes=SH.batch_axes(mesh, cfg, TRAIN_BATCH))
    params = step.layout.shard_params(M.init_params(cfg, seed=seed,
                                                    device=dev))
    opt = adamw.init(params, step.layout)
    spent = [0.0]

    def timed(fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            spent[0] += time.perf_counter() - t
            return out
        return run
    real = (dist.all_reduce, TP._all_gather)
    dist.all_reduce, TP._all_gather = timed(real[0]), timed(real[1])
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses, step_s, coll_s, launches = [], [], [], []
    split = []
    for _ in range(steps):
        for ops in ops_of.values():
            ops.launches = 0
        ops_of["fused_rmsnorm"].split_launches = 0
        spent[0] = 0.0
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        losses.append(m["loss"].item())
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        coll_s.append(spent[0])
        launches.append({name: ops.launches for name, ops in ops_of.items()})
        split.append(ops_of["fused_rmsnorm"].split_launches)
    dist.all_reduce, TP._all_gather = real
    return {"losses": losses, "step_s": step_s, "coll_s": coll_s,
            "launches": launches, "split_launches": split,
            "n_local": sum(t.numel() for t in T.leaves(params)),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def split_norm_on_card(torch, card, timer):
    """Phase 12's kernel check: the RMSNorm kernel's split-row mode at
    zamba2-7b's gated norm on two model ranks (8 x 1,024 rows, 3,584 of
    the 7,168 columns a rank), the row sums of both column blocks added
    and each block scaled: each pass against its plain version, f32 and
    bf16, and the two blocks against the unsplit plain norm of the whole
    row. Then, in bf16, the device time of the two passes of one rank
    beside their plain versions and the bound: the bytes of both passes
    (the row read by each, the sums written and read, the output written)
    over the card's rate. Returns the summary's entry."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.fused_rmsnorm import ops as rn_ops
    from repro_torch.kernels.fused_rmsnorm import ref as rn_ref
    cfg = get_config("zamba2-7b")
    rows, full, eps = TRAIN_BATCH * TRAIN_SEQ, cfg.ssm_d_inner, cfg.norm_eps
    d = full // 2
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    out = {}
    for dtype, tol in (("float32", NORM_TOL["float32"]),
                       ("bfloat16", NORM_TOL["bfloat16"])):
        dt = getattr(torch, dtype)
        x, gate = (torch.randn((rows, full), generator=gen, device="cuda")
                   .to(dt) for _ in range(2))
        w = (torch.randn(full, generator=gen, device="cuda") * 0.1).to(dt)
        blocks = [(x[:, k * d:(k + 1) * d].contiguous(),
                   gate[:, k * d:(k + 1) * d].contiguous(),
                   w[k * d:(k + 1) * d].contiguous()) for k in range(2)]
        n0 = rn_ops.split_launches
        sums = [rn_ops.row_sumsq(xk, gk) for xk, gk, _ in blocks]
        ss_err = max(rel_err(s_, rn_ref.row_sumsq_ref(xk, gk))
                     for s_, (xk, gk, _) in zip(sums, blocks))
        total = sums[0] + sums[1]
        got = [rn_ops.rmsnorm(xk, wk, eps=eps, gate=gk, row_ss=total,
                              width=full) for xk, gk, wk in blocks]
        torch.cuda.synchronize()
        check(rn_ops.split_launches - n0 == 4, "the split RMSNorm launched "
              f"{rn_ops.split_launches - n0} times, not 4")
        plain = [rn_ref.rmsnorm_ref(xk, wk, eps=eps, gate=gk, row_ss=total,
                                    width=full) for xk, gk, wk in blocks]
        want = rn_ref.rmsnorm_ref(x, w, eps=eps, gate=gate)
        whole = torch.cat(got, dim=-1)
        # the gated bf16 outputs reach 8 and more: one bf16 step of |want|
        bound = torch.full_like(want, tol, dtype=torch.float32)
        if dtype == "bfloat16":
            bound = torch.maximum(bound, want.float().abs() * 2.0 ** -7)
        scale_err = max(((a.float() - b.float()).abs()
                         / bound[:, k * d:(k + 1) * d]).max().item()
                        for k, (a, b) in enumerate(zip(got, plain)))
        whole_err = ((whole.float() - want.float()).abs() / bound).max().item()
        out[dtype] = {"sumsq_rel_err": ss_err, "scale_err_of_bound": scale_err,
                      "whole_err_of_bound": whole_err,
                      "max_abs_err": max(max_err(a, b)
                                         for a, b in zip(got, plain))}
        print(f"[tp] split RMSNorm {dtype}, zamba2-7b's gated norm, {rows} "
              f"rows over 2 ranks of {d} columns: row sums vs plain max "
              f"rel {ss_err:.3e} (tol 1e-5); scaling vs plain "
              f"{scale_err:.3f} of the bound, both blocks vs the unsplit "
              f"norm {whole_err:.3f} of the bound (tol {tol}, bf16 also one "
              f"bf16 step)", flush=True)
        check(ss_err < 1e-5 and scale_err < 1 and whole_err < 1,
              f"split RMSNorm {dtype} disagrees with its plain version: "
              f"{out[dtype]}")
    # device times of one rank's two passes, bf16
    xk, gk, wk = blocks[0]
    n = xk.numel()
    t_sum = timer(lambda: rn_ops.row_sumsq(xk, gk), 50)
    t_scale = timer(lambda: rn_ops.rmsnorm(xk, wk, eps=eps, gate=gk,
                                           row_ss=total, width=full), 50)
    plain_ms = timer(lambda: rn_ref.rmsnorm_ref(
        xk, wk, eps=eps, gate=gk, row_ss=rn_ref.row_sumsq_ref(xk, gk),
        width=full), 20)
    sum_bytes = 2 * 2 * n + 4 * rows               # x, gate; the sums
    scale_bytes = 3 * 2 * n + 2 * d + 4 * rows     # x, gate, out; w; sums
    r = {"ms": t_sum + t_scale, "sumsq_ms": t_sum, "scale_ms": t_scale,
         "plain_ms": plain_ms, "library_ms": None,
         "bytes": sum_bytes + scale_bytes,
         "sumsq_bound_ms": sum_bytes / PEAK_BYTES_PER_S * 1e3,
         "scale_bound_ms": scale_bytes / PEAK_BYTES_PER_S * 1e3,
         "bound_ms": (sum_bytes + scale_bytes) / PEAK_BYTES_PER_S * 1e3,
         "bound_by": "bytes", "max_abs_err": out["bfloat16"]["max_abs_err"],
         "checks": out, "shape": [rows, d], "width": full}
    print(f"[time] split RMSNorm bf16 at zamba2-7b's gated norm on one of 2 "
          f"ranks ({rows} x {d} of {full}): row sums {t_sum:.4f} ms (bound "
          f"{r['sumsq_bound_ms']:.4f} ms, {r['sumsq_bound_ms'] / t_sum:.1%}), "
          f"scaling {t_scale:.4f} ms (bound {r['scale_bound_ms']:.4f} ms, "
          f"{r['scale_bound_ms'] / t_scale:.1%}); both {r['ms']:.4f} ms, "
          f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}, "
          f"{r['bytes'] / 1e6:.1f} MB; {r['bound_ms'] / r['ms']:.1%}); plain "
          f"{plain_ms:.4f} ms; no library call computes a split row  "
          f"[{card}]", flush=True)
    return r


def one_rank_bf16(torch, arch, depth, steps, seed=SEED):
    """The one-rank reference of a phase 12 (b) case: ``steps`` steps of
    the same bf16 weights (of ``seed``) on phase 7's batch, in this
    process. Returns the losses, the step times and the peak memory."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import train_step as TS
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    dev = torch.device("cuda")
    cfg = get_config(arch, **({"num_layers": depth} if depth else {}))
    step = TS.make_train_step(cfg, adamw.OptimizerConfig(warmup_steps=1,
                                                         total_steps=10))
    params = M.init_params(cfg, seed=seed, device=dev)
    opt = adamw.init(params)
    batch = train_batch(torch, cfg, dev)
    losses, step_s = [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(steps):
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        losses.append(m["loss"].item())
        step_s.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 1e9
    del params, opt, step
    torch.cuda.empty_cache()
    return losses, step_s, peak


def tensor_parallel_on_card(torch, card):
    """Phase 12 (see the module docstring). Returns each step's kernel
    launches per rank, by case (the split-row RMSNorm's as
    ``fused_rmsnorm_split``), and the split mode's kernel entry."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.train_step import (kernel_launches,
                                                    split_norm_launches)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()              # the ranks share this card
    print(f"[tp] this process holds {torch.cuda.memory_allocated() / 1e9:.2f}"
          f" GB of the card as phase 12 starts", flush=True)
    timer = Timer(torch)
    split_entry = split_norm_on_card(torch, card, timer)
    del timer
    torch.cuda.empty_cache()
    launches = {}
    world = 4                     # every case of (a): one call of its ranks
    t0 = time.perf_counter()
    runs = on_card_ranks(tp_parity_rank, world, TP_CASES)
    print(f"[tp] (a) {len(TP_CASES)} cases on {world} ranks in one call "
          f"took {time.perf_counter() - t0:.1f} s  [{card}]", flush=True)
    for i, (arch, shape) in enumerate(TP_CASES):
        check(shape[0] * shape[1] == world, f"{arch} {shape} is not on "
              f"{world} ranks")
        out = [ranks[i] for ranks in runs]
        depth = TP_DEPTH_OF.get(arch, TP_DEPTH)
        rows = TP_BATCH_OF.get(arch, TP_BATCH)
        case_s = out[0]["case_s"]
        r0 = out[0]
        cfg = get_config(arch, dtype="float32", num_layers=depth)
        want = kernel_launches(cfg, model_ranks=shape[1])
        want_split = split_norm_launches(cfg, shape[1])
        loss_rel = abs(r0["loss"] - r0["ref_loss"]) / abs(r0["ref_loss"])
        g_worst = max(r0["grad_rel"], key=r0["grad_rel"].get)
        u_worst = max(r0["upd_rel"], key=r0["upd_rel"].get)
        print(f"[tp] {arch} f32, {depth} layers at full width, (data, "
              f"model) {shape} on {world} ranks sharing the card over gloo, "
              f"batch {rows} x {TRAIN_SEQ}: loss {r0['loss']:.7f} vs "
              f"one rank {r0['ref_loss']:.7f} (rel {loss_rel:.3e}, tol "
              f"{GRAD_LOSS_TOL}); gathered gradients vs the one-rank kernel "
              f"path, max|diff|/max|grad| per leaf: max "
              f"{r0['grad_rel'][g_worst]:.3e} ({g_worst}) over "
              f"{len(r0['grad_rel'])} leaves; updated leaves and moments vs "
              f"the one-rank AdamW on those gradients: max "
              f"{r0['upd_rel'][u_worst]:.3e} ({u_worst}) (tol "
              f"{GRAD_LEAF_TOL}); per rank: parameters "
              f"{[r['n_local'] for r in out]}, peak "
              f"{[round(r['peak_gb'], 2) for r in out]} GB; launches "
              f"{out[0]['launches']}, of which split-row RMSNorm "
              f"{out[0]['split_launches']}; the case took {case_s:.1f} s  "
              f"[{card}]", flush=True)
        check(all(r["loss"] == r0["loss"] for r in out),
              f"{arch} {shape}: the ranks' losses differ")
        check(loss_rel < GRAD_LOSS_TOL, f"{arch} {shape} loss differs: "
              f"{loss_rel}")
        check(r0["grad_rel"][g_worst] < GRAD_LEAF_TOL,
              f"{arch} {shape} gradients differ: {r0['grad_rel']}")
        check(r0["upd_rel"][u_worst] < GRAD_LEAF_TOL,
              f"{arch} {shape} updated leaves differ: {r0['upd_rel']}")
        for rank, r in enumerate(out):
            check(r["launches"] == want and r["split_launches"] == want_split,
                  f"{arch} {shape} rank {rank} launches {r['launches']} "
                  f"(split {r['split_launches']}) != {want} (split "
                  f"{want_split})")
        launches[f"{arch} {shape[0]}x{shape[1]}"] = [
            {**r["launches"], "fused_rmsnorm_split": r["split_launches"]}
            for r in out]

    launches.update(tp_bf16_on_card(torch, card)[0])
    return launches, split_entry


def tp_bf16_on_card(torch, card, seed=SEED, hold=True):
    """Phase 12 (b), the weights of ``seed``: each case of ``TP_BF16`` on
    2 ranks against a one-rank run of the same weights, the gaps held within
    TP_FIRST_LOSS_GAP and TP_LOSS_GAP where ``hold``. Returns each case's launches per rank and
    its relative loss gaps by step."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.train_step import (kernel_launches,
                                                    split_norm_launches)
    launches, gaps_of = {}, {}
    tokens = TRAIN_BATCH * TRAIN_SEQ
    refs = {}
    for arch, shape, depth in TP_BF16:
        t0 = time.perf_counter()
        ref_losses, ref_s, ref_peak = one_rank_bf16(torch, arch, depth,
                                                    TP_STEPS, seed)
        print(f"[tp] {arch} bf16 at {depth} layers on one rank "
              f"(seed {seed}): losses "
              f"{[round(x, 6) for x in ref_losses]}, step "
              f"{[round(x, 4) for x in ref_s]} s, peak {ref_peak:.2f} "
              f"GB (this process's, the earlier phases' tensors "
              f"included); took {time.perf_counter() - t0:.1f} s  "
              f"[{card}]", flush=True)
        refs[arch] = ref_losses, "the one-rank run's"
    world = 2                     # every case of (b): one call of its ranks
    t0 = time.perf_counter()
    runs = on_card_ranks(tp_bf16_rank, world, TP_BF16, TP_STEPS, seed)
    print(f"[tp] (b) {len(TP_BF16)} cases on {world} ranks in one call "
          f"took {time.perf_counter() - t0:.1f} s  [{card}]", flush=True)
    for i, (arch, shape, depth) in enumerate(TP_BF16):
        check(shape[0] * shape[1] == world, f"{arch} {shape} is not on "
              f"{world} ranks")
        out = [ranks[i] for ranks in runs]
        ref_losses, against = refs[arch]
        case_s = out[0]["case_s"]
        cfg = get_config(arch, **({"num_layers": depth} if depth else {}))
        want = kernel_launches(cfg, model_ranks=shape[1])
        want_split = split_norm_launches(cfg, shape[1])
        losses = out[0]["losses"]
        gaps = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
        med = statistics.median(out[0]["step_s"][1:])
        gaps_of[arch] = gaps
        print(f"[tp] {arch} bf16 at full width, {cfg.num_layers} layers, "
              f"seed {seed}, "
              f"(data, model) {shape} on {world} ranks sharing the card over "
              f"gloo, {TP_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} tokens "
              f"(phase 7's batch): losses {[round(x, 6) for x in losses]}, "
              f"{against} {[round(x, 6) for x in ref_losses[:TP_STEPS]]}, "
              f"relative gaps {[f'{g:.3e}' for g in gaps]} (tol "
              f"{TP_FIRST_LOSS_GAP[arch]} at step 1, {TP_LOSS_GAP[arch]} "
              f"after)  [{card}]", flush=True)
        print(f"[tp] {arch} {shape} per step, gloo through host memory on "
              f"one card (not NCCL): step "
              f"{[round(x, 4) for x in out[0]['step_s']]} s (median of steps "
              f"2-{TP_STEPS} {med:.4f} s, {tokens / med:.0f} tokens/s), "
              f"seconds in collectives by rank "
              f"{[[round(x, 4) for x in r['coll_s']] for r in out]}; "
              f"parameters {[r['n_local'] for r in out]} and peak memory "
              f"{[round(r['peak_gb'], 2) for r in out]} GB by rank; launches "
              f"per step {out[0]['launches'][0]}, of which split-row RMSNorm "
              f"{out[0]['split_launches'][0]}; the case took {case_s:.1f} s  "
              f"[{card}]", flush=True)
        for rank, r in enumerate(out):
            check(r["losses"] == losses, f"{arch} rank {rank} losses "
                  f"{r['losses']} != rank 0's {losses}")
            for i, got in enumerate(r["launches"]):
                check(got == want and r["split_launches"][i] == want_split,
                      f"{arch} bf16 rank {rank} step {i} launches {got} "
                      f"(split {r['split_launches'][i]}) != {want} (split "
                      f"{want_split})")
        check(all(math.isfinite(x) for x in losses)
              and losses[-1] < losses[0],
              f"{arch} bf16 tensor-parallel losses not finite and falling: "
              f"{losses}")
        check(not hold or (gaps[0] <= TP_FIRST_LOSS_GAP[arch]
                           and max(gaps) <= TP_LOSS_GAP[arch]),
              f"{arch} bf16 tensor-parallel losses {losses} more than "
              f"{TP_FIRST_LOSS_GAP[arch]} at step 1 or {TP_LOSS_GAP[arch]} "
              f"from {against} {ref_losses}")
        launches[f"{arch} bf16 {shape[0]}x{shape[1]}"] = [
            {**r["launches"][0], "fused_rmsnorm_split": r["split_launches"][0]}
            for r in out]
    return launches, gaps_of



# ------------------------------------------------------------------ phase 13
def _cache_gaps(torch, blocks, layout, want, rank):
    """Each leaf of this rank's cache ``blocks`` gathered whole (a
    collective) and, on rank 0, its max|diff| relative to the leaf's
    largest value of ``want`` (the one-rank cache): {path: gap}."""
    from repro_torch import tree as T
    from repro_torch.distributed import sharding as SH
    gaps = {}
    for path, t in T.flatten(blocks):
        g = SH.gather_leaf(t.contiguous(), layout.cache_specs[path],
                           layout.mesh)
        if not rank:
            w = want[path]
            gaps[path] = (max_err(g, w) / (w.float().abs().max().item()
                                           + 1e-30))
    return gaps


def _reset_all(ops_of):
    """Every launch count of the wrappers set to 0, the split-row
    RMSNorm's too."""
    _reset(ops_of)
    ops_of["fused_rmsnorm"].split_launches = 0


def _counts_all(ops_of):
    return {**_counts(ops_of),
            "fused_rmsnorm_split": ops_of["fused_rmsnorm"].split_launches}


def tps_parity_rank(rank, world, cases):
    """Phase 13 (a) on one rank: ``tps_parity_case`` for each (arch,
    mesh_shape) of ``cases`` in one call, the card's cache emptied between
    them, each case's seconds on this rank added to its reading."""
    import torch
    out = []
    for arch, mesh_shape in cases:
        t0 = time.perf_counter()
        r = tps_parity_case(rank, world, arch, tuple(mesh_shape))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        out.append({**r, "case_s": time.perf_counter() - t0})
    return out


def tps_parity_case(rank, world, arch, mesh_shape):
    """One case of phase 13 (a) on one rank (see the constants). Every rank
    draws only its blocks of the seed's f32 weights
    (``ParamLayout.init_params``); rank 0 also draws them whole, runs the
    one-rank kernel-path ``generate``, and its teacher-forced steps before
    the ranks' own, recording the MoE routing of both."""
    import torch
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import generate, teacher_forced
    from repro_torch.models import model as M
    ops_of = _rank_ops()
    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(arch, dtype="float32",
                     num_layers=TP_DEPTH_OF.get(arch, TP_DEPTH))
    mesh = make_mesh(mesh_shape, ("data", "model"), device=dev)
    B, S, new = TPS_REQUESTS, TPS_PROMPT, TPS_NEW
    layout = TP.serve_layout(cfg, mesh, B)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                            device=dev, dtype=torch.int32)
    local = layout.init_params(SEED, dev)
    ref = {}
    if not rank:                  # the one-rank kernel path, same weights
        whole = M.init_params(cfg, seed=SEED, device=dev)
        ref["tokens"] = generate(whole, cfg, prompts, max_new_tokens=new)
    _reset_all(ops_of)
    tokens = generate(local, cfg, prompts, max_new_tokens=new, mesh=mesh)
    torch.cuda.synchronize()
    mine = {"launches": _counts_all(ops_of), "tokens": tokens.cpu(),
            "n_local": sum(t.numel() for t in T.leaves(local))}
    routes = {}
    if not rank:
        firsts = {}
        with recorded_routes() as routes["one"]:
            _, _, ref["logits"], final = teacher_forced(
                whole, cfg, tokens, S, on_prefill=lambda c: firsts.update(
                    {p: t.clone() for p, t in T.flatten(c)}))
        ref["prefill_cache"], ref["final_cache"] = firsts, dict(
            T.flatten(final))
        del whole, final
    gaps = {}
    with (recorded_routes() if not rank else contextlib.nullcontext(
            [])) as routes["tp"]:
        _, _, logits, final = teacher_forced(
            local, cfg, tokens, S, layout=layout, on_prefill=lambda c: gaps.update(prefill=_cache_gaps(
                torch, c, layout, ref.get("prefill_cache"), rank)))
    gaps["final"] = _cache_gaps(torch, final, layout, ref.get("final_cache"),
                                rank)
    mine["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if rank:
        return mine
    V = cfg.vocab_size
    want = ref["logits"][..., :V]
    err_rows = ((logits[..., :V] - want).abs().amax(dim=2)
                / want.abs().amax(dim=(1, 2))[:, None])       # (steps, B)
    flips, decisions, clean = routing_flips(
        torch, routes["tp"], routes["one"], cfg, B, new, dev)
    err = torch.where(clean, err_rows, 0.0).amax(dim=1)
    rows_clean = clean.all(dim=0)                                  # (B,)
    same = (tokens == ref["tokens"]).all(dim=1)
    return {**mine, "err": err.tolist(), "err_all": err_rows.max().item(),
            "flips": flips, "decisions": decisions,
            "clean_share": clean.float().mean().item(),
            "tokens_equal_clean": bool(same[rows_clean].all()),
            "rows_equal": int(same.sum()), "rows_clean": int(rows_clean.sum()),
            "cache_gaps": gaps}


def tps_bf16_rank(rank, world, cases, seed):
    """Phase 13 (b) on one rank: for each (arch, forced tokens) of
    ``cases``, the bf16 model at full size on a (1, world) mesh, this
    rank's blocks drawn from ``seed``, teacher-forced on the tokens (a
    one-rank run's): the prefill s, decode ms a step and launches of a
    first pass, the seconds in collectives of a second with no warm-up
    (each timed between two synchronizations), the rank's peak memory;
    rank 0 the logits of the first pass (on the host)."""
    import torch
    import torch.distributed as dist
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import teacher_forced
    ops_of = _rank_ops()
    dev = torch.device("cuda")
    out = []
    for arch, tokens in cases:
        t_case = time.perf_counter()
        cfg = get_config(arch, num_layers=TPS_BF16_DEPTH[arch])
        mesh = make_mesh((1, world), ("data", "model"), device=dev)
        layout = TP.serve_layout(cfg, mesh, tokens.shape[0])
        params = layout.init_params(seed, dev)
        tokens = tokens.to(dev)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        prefill_s, decode_ms, logits, _ = teacher_forced(
            params, cfg, tokens, PROMPT_LEN, layout=layout, on_warm=lambda: _reset_all(ops_of))
        launches = _counts_all(ops_of)
        spent = {"now": 0.0, "prefill": 0.0}

        def timed(fn):
            def run(*args, **kw):
                torch.cuda.synchronize()
                t = time.perf_counter()
                r = fn(*args, **kw)
                torch.cuda.synchronize()
                spent["now"] += time.perf_counter() - t
                return r
            return run
        real = (dist.all_reduce, TP._all_gather)
        dist.all_reduce, TP._all_gather = timed(real[0]), timed(real[1])
        try:
            teacher_forced(
                params, cfg, tokens, PROMPT_LEN, layout=layout, warm=False, on_warm=lambda: spent.update(now=0.0),
                on_prefill=lambda c: spent.update(prefill=spent["now"]))
        finally:
            dist.all_reduce, TP._all_gather = real
        peak = torch.cuda.max_memory_allocated() / 1e9
        r = {"prefill_s": prefill_s, "decode_ms": decode_ms,
             "launches": launches, "peak_gb": peak,
             "n_local": sum(t.numel() for t in T.leaves(params)),
             "coll_prefill_s": spent["prefill"],
             "coll_decode_ms": (spent["now"] - spent["prefill"]) * 1e3
             / (tokens.shape[1] - PROMPT_LEN - 1)}
        if not rank:
            r["logits"] = logits.cpu()
        del params, logits
        torch.cuda.empty_cache()
        out.append({**r, "case_s": time.perf_counter() - t_case})
    return out


def split_norm_decode_on_card(torch, card, tries=3):
    """Phase 13's kernel reading: the RMSNorm kernel's split-row mode at a
    decode step's shape (zamba2-7b's gated norm on two model ranks, 8 rows
    x 3,584 of the 7,168 columns a rank), bf16: each pass against its plain
    version, then each pass's device time (``kernel_ms_per_launch``: a
    launch this small is shorter than its host time, so CUDA events around
    single calls would time the host) beside the bound of its bytes."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.fused_rmsnorm import ops as rn_ops
    from repro_torch.kernels.fused_rmsnorm import ref as rn_ref
    cfg = get_config("zamba2-7b")
    rows, full, eps = N_REQUESTS, cfg.ssm_d_inner, cfg.norm_eps
    d = full // 2
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x, gate = (torch.randn((rows, full), generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(2))
    w = (torch.randn(full, generator=gen, device="cuda") * 0.1).to(
        torch.bfloat16)
    xk, gk, wk = x[:, :d].contiguous(), gate[:, :d].contiguous(), w[:d]
    total = (rn_ref.row_sumsq_ref(xk, gk)
             + rn_ref.row_sumsq_ref(x[:, d:].contiguous(),
                                    gate[:, d:].contiguous()))
    ss_err = rel_err(rn_ops.row_sumsq(xk, gk), rn_ref.row_sumsq_ref(xk, gk))
    got = rn_ops.rmsnorm(xk, wk, eps=eps, gate=gk, row_ss=total, width=full)
    want = rn_ref.rmsnorm_ref(xk, wk, eps=eps, gate=gk, row_ss=total,
                              width=full)
    bound = torch.maximum(torch.full_like(want, NORM_TOL["bfloat16"],
                                          dtype=torch.float32),
                          want.float().abs() * 2.0 ** -7)
    scale_err = ((got.float() - want.float()).abs() / bound).max().item()
    check(ss_err < 1e-5 and scale_err < 1, f"split RMSNorm at the decode "
          f"shape disagrees with its plain version: {ss_err}, {scale_err}")
    t_sum, by_sum = kernel_ms_per_launch(
        torch, lambda: rn_ops.row_sumsq(xk, gk), "rmsnorm_", tries=tries)
    t_scale, by_scale = kernel_ms_per_launch(
        torch, lambda: rn_ops.rmsnorm(xk, wk, eps=eps, gate=gk, row_ss=total,
                                      width=full), "rmsnorm_", tries=tries)
    n = xk.numel()
    sum_bytes = 2 * 2 * n + 4 * rows
    scale_bytes = 3 * 2 * n + 2 * d + 4 * rows
    r = {"shape": [rows, d], "width": full, "sumsq_ms": t_sum,
         "scale_ms": t_scale, "ms": t_sum + t_scale,
         "sumsq_bound_ms": sum_bytes / PEAK_BYTES_PER_S * 1e3,
         "scale_bound_ms": scale_bytes / PEAK_BYTES_PER_S * 1e3,
         "bound_ms": (sum_bytes + scale_bytes) / PEAK_BYTES_PER_S * 1e3,
         "bound_by": "bytes", "sumsq_rel_err": ss_err,
         "scale_err_of_bound": scale_err, "timed_by": [by_sum, by_scale]}
    print(f"[tps] split RMSNorm bf16 at a decode step's shape (zamba2-7b's "
          f"gated norm on one of 2 ranks, {rows} x {d} of {full}): row sums "
          f"vs plain rel {ss_err:.3e}, scaling {scale_err:.3f} of the "
          f"bound; device time a launch: row sums {t_sum * 1e3:.3f} us "
          f"({by_sum}; bound {r['sumsq_bound_ms'] * 1e3:.3f} us), scaling "
          f"{t_scale * 1e3:.3f} us ({by_scale}; bound "
          f"{r['scale_bound_ms'] * 1e3:.3f} us), both {r['ms'] * 1e3:.3f} "
          f"us, bound {r['bound_ms'] * 1e3:.3f} us ({r['bound_by']}, "
          f"{r['bound_ms'] / r['ms']:.1%})  [{card}]", flush=True)
    return r


def tp_serving_on_card(torch, card):
    """Phase 13 (see the module docstring and the constants). Returns the
    launches of each rank by case, the split-row RMSNorm's as
    ``fused_rmsnorm_split``, and the split mode's decode-shape reading."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.serve_step import kernel_launches
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    norm = split_norm_decode_on_card(torch, card)
    launches = {}
    world = 4
    t0 = time.perf_counter()
    runs = on_card_ranks(tps_parity_rank, world, TPS_CASES)
    print(f"[tps] (a) {len(TPS_CASES)} cases on {world} ranks in one call "
          f"took {time.perf_counter() - t0:.1f} s  [{card}]", flush=True)
    for i, (arch, shape) in enumerate(TPS_CASES):
        check(shape[0] * shape[1] == world, f"{arch} {shape} is not on "
              f"{world} ranks")
        out = [ranks[i] for ranks in runs]
        r0 = out[0]
        depth = TP_DEPTH_OF.get(arch, TP_DEPTH)
        cfg = get_config(arch, dtype="float32", num_layers=depth)
        want = kernel_launches(cfg, TPS_NEW, tp=shape[1])
        gaps = {k: max(v.values()) for k, v in r0["cache_gaps"].items()}
        print(f"[tps] {arch} f32, {depth} layers at full width, (data, "
              f"model) {shape} on {world} ranks sharing the card over gloo, "
              f"{TPS_REQUESTS} x {TPS_PROMPT} + {TPS_NEW}: greedy tokens "
              f"equal the one-rank generate's in {r0['rows_equal']} of "
              f"{TPS_REQUESTS} rows ({r0['rows_clean']} with routing equal "
              f"throughout); teacher-forced logits max|diff|/max|logit| per "
              f"step max {max(r0['err']):.3e} (tol {F32_LOGIT_TOL}; over "
              f"every row {r0['err_all']:.3e}); routing {r0['flips']} of "
              f"{r0['decisions']} decisions flipped; cache blocks vs the "
              f"one-rank cache, max per leaf: after prefill "
              f"{gaps['prefill']:.3e}, after the last step "
              f"{gaps['final']:.3e} (tol {CACHE_TOL}); per rank: parameters "
              f"{[r['n_local'] for r in out]}, peak "
              f"{[round(r['peak_gb'], 2) for r in out]} GB; launches "
              f"{r0['launches']}; the case took {r0['case_s']:.1f} s  "
              f"[{card}]", flush=True)
        check(all(torch.equal(r["tokens"], r0["tokens"]) for r in out),
              f"{arch} {shape}: the ranks' tokens differ")
        check(r0["tokens_equal_clean"] and r0["clean_share"]
              >= MIN_CLEAN_SHARE, f"{arch} {shape}: tokens differ from one "
              f"rank's ({r0['rows_equal']} rows equal, clean share "
              f"{r0['clean_share']})")
        check(max(r0["err"]) < F32_LOGIT_TOL, f"{arch} {shape} logits "
              f"differ: {r0['err']}")
        check(max(gaps.values()) < CACHE_TOL, f"{arch} {shape} cache blocks "
              f"differ: {r0['cache_gaps']}")
        for rank, r in enumerate(out):
            check(r["launches"] == want, f"{arch} {shape} rank {rank} "
                  f"launches {r['launches']} != {want}")
        launches[f"{arch} serve {shape[0]}x{shape[1]}"] = [
            r["launches"] for r in out]

    launches.update(tps_bf16_on_card(torch, card)[0])
    print(f"[tps] phase 13 took {time.perf_counter() - t_phase:.1f} s  "
          f"[{card}]", flush=True)
    return launches, norm


def tps_bf16_on_card(torch, card, seed=SEED, hold=True):
    """Phase 13 (b), the weights of ``seed``: the one-rank runs here, then
    the ranks teacher-forced on their tokens, the logits held within
    TPS_BF16_TOL where ``hold``. Returns each case's launches per rank and
    its logits' gap (max|diff|/max|logit|, the worst step)."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.serve_step import kernel_launches
    from repro_torch.launch.serve import generate, teacher_forced
    from repro_torch.models import model as M
    launches, gap_of = {}, {}
    world = 2
    B, S = N_REQUESTS, PROMPT_LEN
    refs, cases = {}, []
    for arch in TPS_BF16:
        t0 = time.perf_counter()
        cfg = get_config(arch, num_layers=TPS_BF16_DEPTH[arch])
        params = M.init_params(cfg, seed=seed, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                                device="cuda", dtype=torch.int32)
        torch.cuda.reset_peak_memory_stats()
        tokens = generate(params, cfg, prompts, max_new_tokens=NEW_TOKENS,
                          generator=gen)
        prefill_s, decode_ms, logits, _ = teacher_forced(params, cfg, tokens,
                                                         S)
        peak = torch.cuda.max_memory_allocated() / 1e9
        refs[arch] = (prefill_s, decode_ms, logits.cpu(), peak)
        cases.append((arch, tokens.cpu()))
        del params, logits
        torch.cuda.empty_cache()
        print(f"[tps] {arch} bf16 at full width, {cfg.num_layers} layers, "
              f"seed {seed}, on one rank "
              f"(this process): "
              f"prefill {prefill_s:.4f} s, decode {decode_ms:.3f} ms/step, "
              f"peak {peak:.2f} GB (the earlier phases' tensors included); "
              f"took {time.perf_counter() - t0:.1f} s  [{card}]", flush=True)
    t0 = time.perf_counter()
    runs = on_card_ranks(tps_bf16_rank, world, cases, seed)
    print(f"[tps] (b) {len(cases)} cases on {world} ranks in one call took "
          f"{time.perf_counter() - t0:.1f} s  [{card}]", flush=True)
    for i, arch in enumerate(TPS_BF16):
        out = [ranks[i] for ranks in runs]
        r0 = out[0]
        cfg = get_config(arch, num_layers=TPS_BF16_DEPTH[arch])
        want = kernel_launches(cfg, NEW_TOKENS, tp=world)
        ref_prefill, ref_decode, ref_logits, ref_peak = refs[arch]
        V = cfg.vocab_size
        a, b = r0["logits"][..., :V], ref_logits[..., :V]
        err = ((a - b).abs().amax(dim=(1, 2)) / b.abs().amax(dim=(1, 2)))
        agree = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
        gap_of[arch] = err.max().item()
        print(f"[tps] {arch} bf16 at full width ({cfg.num_layers} layers, "
              f"seed {seed}), "
              f"(data, model) (1, {world}) on {world} ranks sharing the card "
              f"over gloo, {B} x {S} + {NEW_TOKENS}, teacher-forced on the "
              f"one-rank tokens: logits vs the one-rank run's, "
              f"max|diff|/max|logit| per step max {err.max().item():.3e} "
              f"(prefill {err[0].item():.3e}; tol {TPS_BF16_TOL[arch]}), argmax "
              f"agrees in {agree:.1%}  [{card}]", flush=True)
        print(f"[tps] {arch} (1, {world}) gloo through host memory on one "
              f"card (not NCCL): prefill {r0['prefill_s']:.4f} s (one rank "
              f"{ref_prefill:.4f}), decode {r0['decode_ms']:.3f} ms/step "
              f"(one rank {ref_decode:.3f}), {B * 1e3 / r0['decode_ms']:.1f} "
              f"new tokens/s; seconds in collectives by rank: prefill "
              f"{[round(r['coll_prefill_s'], 4) for r in out]} s, decode "
              f"{[round(r['coll_decode_ms'], 3) for r in out]} ms/step; "
              f"parameters {[r['n_local'] for r in out]} and peak memory "
              f"{[round(r['peak_gb'], 2) for r in out]} GB by rank (one "
              f"rank {ref_peak:.2f}); launches {r0['launches']}; the case "
              f"took {r0['case_s']:.1f} s  [{card}]", flush=True)
        check(bool(torch.isfinite(a).all()), f"{arch} bf16 tp logits not "
              f"finite")
        check(not hold or err.max().item() < TPS_BF16_TOL[arch],
              f"{arch} bf16 tensor-parallel logits differ from one rank's: "
              f"{err.tolist()}")
        for rank, r in enumerate(out):
            check(r["launches"] == want, f"{arch} bf16 rank {rank} launches "
                  f"{r['launches']} != {want}")
        launches[f"{arch} bf16 serve 1x{world}"] = [r["launches"]
                                                   for r in out]
    return launches, gap_of


# ------------------------------------------------------------------ phase 14
def _reset_cards(ops_of):
    for ops in ops_of.values():
        ops.card_launches = {}


def _card_counts(ops_of):
    return {name: dict(sorted(ops.card_launches.items()))
            for name, ops in ops_of.items()}


def flux_kernel_cases(torch, dev):
    """Each kernel's wrapper call at phase 3's main-path shapes, bf16, its
    inputs drawn on ``dev`` from SEED (the same values on every card of one
    model), and the error of an output against its plain version beside
    phase 3's limit: {name: (call, error)}, ``error(got)`` -> (err, tol)."""
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.decode_attention import ref as da_ref
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.fused_rmsnorm import ops as rn_ops
    from repro_torch.kernels.fused_rmsnorm import ref as rn_ref
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd import ref as ssd_ref

    glm, zam = get_config("chatglm3-6b"), get_config("zamba2-7b")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    bf = torch.bfloat16

    def randn(*shape, dtype=bf):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32).to(dtype)

    B, S = N_REQUESTS, PROMPT_LEN
    H, KV, hd = glm.num_heads, glm.num_kv_heads, glm.head_dim
    scale = hd ** -0.5
    q, k, v = randn(B, S, H, hd), randn(B, S, KV, hd), randn(B, S, KV, hd)
    qd = randn(B, 1, H, hd)
    kd, vd = (randn(B, S + NEW_TOKENS, KV, hd) for _ in range(2))
    vl = torch.full((), S + 1, dtype=torch.int32, device=dev)
    x, w = randn(B * S, glm.d_model), randn(glm.d_model) * 0.1
    eps = glm.norm_eps
    zH, zG = zam.ssm_heads, zam.ssm_groups
    xs = randn(B, S, zH, zam.ssm_head_dim)
    dt = F.softplus(randn(B, S, zH, dtype=torch.float32) - 4.0)
    A = -torch.exp(torch.rand(zH, generator=gen, device=dev) * 2.0)
    Bm, Cm = (randn(B, S, zG, zam.ssm_state) for _ in range(2))
    chunk = zam.ssm_chunk

    def ssd_err(got):
        want = ssd_ref.ssd_chunked_tc(xs, dt, A, Bm, Cm, chunk=chunk)
        return (max(rel_err(got[0], want[0]), rel_err(got[1], want[1])),
                SSD_TC_TOL)

    return {
        "flash_attention": (
            lambda: fa_ops.flash_attention(q, k, v, scale=scale),
            lambda got: (max_err(got, fa_ops.plain(q, k, v, scale=scale)),
                         ATTN_TOL["bfloat16"])),
        "decode_attention": (
            lambda: da_ops.decode_attention(qd, kd, vd, vl, scale=scale),
            lambda got: (max_err(got, da_ref.decode_attention_ref(
                qd.transpose(1, 2), kd.transpose(1, 2), vd.transpose(1, 2),
                vl, scale=scale).transpose(1, 2)), ATTN_TOL["bfloat16"])),
        "fused_rmsnorm": (
            lambda: rn_ops.rmsnorm(x, w, eps=eps),
            lambda got: (max_err(got, rn_ref.rmsnorm_ref(x, w, eps=eps)),
                         NORM_TOL["bfloat16"])),
        "ssd": (
            lambda: ssd_ops.ssd(xs, dt, A, Bm, Cm, chunk=chunk,
                                use_pallas=True),
            ssd_err)}


def _run_cases(torch, dev):
    """Each kernel of ``flux_kernel_cases`` on ``dev``, once: {name: (err,
    tol, the output's device, the first output on the host)}, and the
    calling thread's current device after the launches."""
    out = {}
    for name, (call, error) in flux_kernel_cases(torch, dev).items():
        got = call()
        _sync(torch, dev)
        first = got[0] if isinstance(got, tuple) else got
        out[name] = (*error(got), first.device, first.cpu())
        del got, first
    current = torch.cuda.current_device() if dev.type == "cuda" else None
    return out, current


def _submit(rt, descs):
    """Submit ``descs`` to LocalRuntime ``rt`` and wait; fails unless every
    task ended DONE on flux."""
    tasks = rt.submit(descs)
    check(rt.wait(timeout=TASK_TIMEOUT_S), "flux tasks did not finish")
    bad = [(t.uid, t.state.value, t.backend, t.error) for t in tasks
           if t.state.value != "DONE" or t.backend != "flux"]
    check(not bad, f"flux tasks failed: {bad}")
    return tasks


def flux_kernels_on_cards(torch, ops_of, card, rt, devices):
    """Phase 14 (a). Returns each kernel's launches by card."""
    from repro_torch.core.task import TaskDescription

    n_parts = len(rt.partitions)

    def task(mesh=None):
        return mesh.device, _run_cases(torch, mesh.device)

    _reset_cards(ops_of)
    tasks = _submit(rt, [TaskDescription(kind="executable", coupling="tight",
                                         fn=task) for _ in range(n_parts)])
    first = {}
    for t in tasks:
        dev, (res, current) = t.result
        check(dev == devices[t.partition] and current in (None, dev.index),
              f"kernel task of partition {t.partition} ran on {dev} "
              f"(current {current}), not {devices[t.partition]}")
        for name, (err, tol, where, got) in res.items():
            same = first.setdefault(name, got)
            bitwise = torch.equal(got, same)
            print(f"[flux] (a) {name} in the task of partition "
                  f"{t.partition} on {where}: max|err| vs its plain "
                  f"version {err:.3e} (tol {tol}); equal in every bit to "
                  f"partition 0's: {bitwise}  [{card}]", flush=True)
            check(same_device(where, dev) and err < tol,
                  f"{name} on {where} (partition {t.partition}): {err}")
    want = {name: {d.index if d.type == "cuda" else 0: 1
                   for d in devices[:n_parts]} for name in ops_of}
    if len(devices) > 1 and devices[0].type == "cuda":
        last, out = devices[-1], {}

        def from_card_0():
            try:
                torch.cuda.set_device(devices[0])
                out["res"] = _run_cases(torch, last)
            except Exception as e:              # noqa: BLE001 - checked below
                out["error"] = repr(e)

        th = threading.Thread(target=from_card_0)
        th.start()
        th.join(timeout=TASK_TIMEOUT_S)
        check(not th.is_alive() and "error" not in out,
              f"launches onto {last} from a thread on {devices[0]}: "
              f"{out.get('error', 'timed out')}")
        res, current = out["res"]
        check(current == devices[0].index, f"the thread's current device "
              f"moved to {current}")
        for name, (err, tol, where, _) in res.items():
            print(f"[flux] (a) {name} from a thread whose current device is "
                  f"{devices[0]}, onto tensors of {last}: output on {where}, "
                  f"max|err| {err:.3e} (tol {tol}); the thread's current "
                  f"device after it {current}  [{card}]", flush=True)
            check(where == last and err < tol,
                  f"{name} launched from card 0 onto {last}: {err}")
            want[name][last.index] += 1
    got = _card_counts(ops_of)
    print(f"[flux] (a) launches by card {got}", flush=True)
    check(got == want, f"phase 14 (a) launches by card {got} != {want}")
    return got


def _train_body(torch, cfg, seed, dev, mesh=None):
    """FLUX_TRAIN_STEPS steps of ``cfg`` from weights drawn from ``seed``
    on ``dev``; the batch is drawn on ``torch.device("cuda")``, the calling
    thread's current card (on ``dev`` where a placement made it current).
    Returns the losses, the wall interval, the peak memory and where every
    tensor lay."""
    from repro_torch import tree as T
    from repro_torch.distributed.train_step import make_train_step
    from repro_torch.models import model as M
    from repro_torch.optim import adamw

    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=seed, device=dev)
    batch = train_batch(torch, cfg, torch.device("cuda") if cuda else dev)
    step = make_train_step(cfg, adamw.OptimizerConfig(warmup_steps=1,
                                                      total_steps=10),
                           mesh=mesh)
    opt = adamw.init(params)
    losses = []
    for _ in range(FLUX_TRAIN_STEPS):
        params, opt, m = step(params, opt, batch)
        losses.append(m["loss"].item())
    _sync(torch, dev)
    t1 = time.perf_counter()
    where = {t.device for t in (*T.leaves(params), *T.leaves(opt.mu),
                                *batch.values(), m["loss"])}
    peak = torch.cuda.max_memory_allocated(dev) / 1e9 if cuda else 0.0
    current = torch.cuda.current_device() if cuda else None
    del params, opt, batch, m
    return dict(losses=losses, t0=t0, t1=t1, peak_gb=peak, where=where,
                current=current)


def flux_training_on_cards(torch, ops_of, card, rt, devices, cfg):
    """Phase 14 (b). Returns each kernel's launches by card."""
    from repro_torch.core.task import TaskDescription
    from repro_torch.distributed.train_step import kernel_launches

    n_parts = len(rt.partitions)
    n_tasks = max(2, n_parts)
    seeds = [SEED + i for i in range(n_tasks)]
    direct = {}
    for seed in seeds:
        direct[seed] = _train_body(torch, cfg, seed, devices[0])
        if devices[0].type == "cuda":
            torch.cuda.empty_cache()
    # one task alone: the shortest direct run (the first may warm up)
    alone = min(direct.values(), key=lambda r: r["t1"] - r["t0"])
    _reset_cards(ops_of)

    def task(seed, mesh=None):
        return mesh.device, _train_body(torch, cfg, seed, mesh.device, mesh)

    t0 = time.perf_counter()
    tasks = _submit(rt, [TaskDescription(
        kind="executable", coupling="tight", fn=task, args=(seed,))
        for seed in seeds])
    wall = time.perf_counter() - t0
    got = _card_counts(ops_of)
    per_card = {}
    for seed, t in zip(seeds, tasks):
        dev, r = t.result
        want_dev = devices[t.partition]
        per_card[want_dev] = per_card.get(want_dev, 0) + 1
        same = r["losses"] == direct[seed]["losses"]
        gap = max(abs(a - b) / abs(b) for a, b in
                  zip(r["losses"], direct[seed]["losses"]))
        print(f"[flux] (b) {cfg.name} task of seed {seed} on partition "
              f"{t.partition} ({dev}): losses {r['losses']}, directly on "
              f"{devices[0]} {direct[seed]['losses']}, equal in every bit: "
              f"{same} (largest relative gap {gap:.3e}); tensors on "
              f"{sorted(map(str, r['where']))}, current device "
              f"{r['current']}; wall {r['t1'] - r['t0']:.3f} s (alone "
              f"{direct[seed]['t1'] - direct[seed]['t0']:.3f} s); peak "
              f"{r['peak_gb']:.2f} GB  [{card}]", flush=True)
        check(dev == want_dev and all(same_device(w, dev) for w in r["where"])
              and r["current"] in (None, want_dev.index),
              f"train task of seed {seed} placed on {r['where']} (current "
              f"{r['current']}), not on {want_dev}")
        check(all(math.isfinite(x) for x in r["losses"]), f"train task of "
              f"seed {seed}: losses not finite {r['losses']}")
        check(same, f"train task of seed {seed} on {dev}: losses "
              f"{r['losses']} != {direct[seed]['losses']} on {devices[0]} "
              f"(largest relative gap {gap:.3e})")
    starts = [t.result[1]["t0"] for t in tasks]
    ends = [t.result[1]["t1"] for t in tasks]
    overlap = max(starts) < min(ends)
    if n_parts > 1:
        check(overlap, f"the {n_tasks} train tasks on {n_parts} cards did "
              f"not overlap: starts {starts}, ends {ends}")
    step_want = kernel_launches(cfg)
    want = {name: {d.index if d.type == "cuda" else 0:
                   n * FLUX_TRAIN_STEPS * step_want[name]
                   for d, n in per_card.items() if step_want[name]}
            for name in ops_of}
    print(f"[flux] (b) {n_tasks} {cfg.name} train tasks of "
          f"{FLUX_TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} on "
          f"{n_parts} partition(s): wall {wall:.3f} s for all, one alone "
          f"{alone['t1'] - alone['t0']:.3f} s (init and steps, the shortest "
          f"direct run on {devices[0]}); every task started before any ended: {overlap}; "
          f"peak GB by task {[round(t.result[1]['peak_gb'], 2) for t in tasks]}"
          f"; launches by card {got}  [{card}]", flush=True)
    check(got == want, f"phase 14 (b) launches by card {got} != {want}")
    return got


def _serve_body(torch, cfg, params, prompt, dev, mesh=None):
    """generate's NEW_TOKENS greedy tokens after ``prompt`` (moved to the
    calling thread's current card), then the decode steps timed on those
    tokens (``teacher_forced``)."""
    from repro_torch.launch.serve import generate, teacher_forced

    p = prompt.cuda() if dev.type == "cuda" else prompt
    t0 = time.perf_counter()
    out = generate(params, cfg, p, max_new_tokens=NEW_TOKENS, mesh=mesh)
    _sync(torch, dev)
    gen_s = time.perf_counter() - t0
    prefill_s, decode_ms, _, _ = teacher_forced(
        params, cfg, out, PROMPT_LEN, warm=False, keep_logits=False)
    current = torch.cuda.current_device() if dev.type == "cuda" else None
    return dict(tokens=out[:, PROMPT_LEN:].cpu(), where=out.device,
                current=current, gen_s=gen_s, prefill_s=prefill_s,
                decode_ms=decode_ms, t0=t0, t1=time.perf_counter())


def flux_serving_on_cards(torch, ops_of, card, rt, devices, cfg):
    """Phase 14 (c). Returns each kernel's launches by card."""
    from repro_torch.core.task import TaskDescription
    from repro_torch.distributed.serve_step import kernel_launches
    from repro_torch.models import model as M

    n_parts = len(rt.partitions)
    n_tasks = n_parts + 1
    params = {d: M.init_params(cfg, seed=SEED, device=d)
              for d in devices[:n_parts]}
    gen = torch.Generator().manual_seed(SEED)
    prompts = [torch.randint(0, cfg.vocab_size, (1, PROMPT_LEN),
                             generator=gen, dtype=torch.int32)
               for _ in range(n_tasks)]
    direct = [_serve_body(torch, cfg, params[devices[0]],
                          p.to(devices[0]), devices[0]) for p in prompts]

    def task(i, mesh=None):
        return mesh.device, _serve_body(torch, cfg, params[mesh.device],
                                        prompts[i], mesh.device, mesh)

    _reset_cards(ops_of)
    t0 = time.perf_counter()
    tasks = _submit(rt, [TaskDescription(
        kind="executable", coupling="tight", fn=task, args=(i,))
        for i in range(n_tasks)])
    wall = time.perf_counter() - t0
    got = _card_counts(ops_of)
    alone = _submit(rt, [TaskDescription(kind="executable", coupling="tight",
                                         fn=task, args=(0,))])[0].result[1]
    per_card = {}
    for i, t in enumerate(tasks):
        dev, r = t.result
        want_dev = devices[t.partition]
        per_card[want_dev] = per_card.get(want_dev, 0) + 1
        same = torch.equal(r["tokens"], direct[i]["tokens"])
        print(f"[flux] (c) {cfg.name} generate task {i} on partition "
              f"{t.partition} ({r['where']}, current device {r['current']}):"
              f" {PROMPT_LEN} + {NEW_TOKENS} tokens equal to generate "
              f"directly on {devices[0]}: {same}; generate "
              f"{r['gen_s']:.3f} s, prefill {r['prefill_s']:.4f} s, decode "
              f"{r['decode_ms']:.3f} ms a step (directly, alone: "
              f"{direct[i]['decode_ms']:.3f})  [{card}]", flush=True)
        check(dev == want_dev and same_device(r["where"], dev)
              and r["current"] in (None, want_dev.index),
              f"generate task {i} ran on {r['where']} (current "
              f"{r['current']}), not on {want_dev}")
        check(same, f"generate task {i} tokens differ from direct generate")
    # each task: one generate and one teacher-forced pass, as many launches
    per = kernel_launches(cfg, NEW_TOKENS)
    want = {name: {d.index if d.type == "cuda" else 0: 2 * n * per[name]
                   for d, n in per_card.items() if per[name]}
            for name in ops_of}
    dec = [t.result[1]["decode_ms"] for t in tasks]
    print(f"[flux] (c) {n_tasks} generate tasks on {n_parts} partition(s): "
          f"wall {wall:.3f} s for all; decode ms a step by task "
          f"{[round(x, 3) for x in dec]} (median "
          f"{statistics.median(dec):.3f}), one task alone through the "
          f"runtime {alone['decode_ms']:.3f} ms, directly "
          f"{direct[0]['decode_ms']:.3f} ms; launches by card {got}  "
          f"[{card}]", flush=True)
    check(got == want, f"phase 14 (c) launches by card {got} != {want}")
    del params
    return got


def flux_partitions_on_card(torch, ops_of, card, devices=None, cfg=None):
    """Phase 14: Flux partitions over the cards of this process, one task
    a partition at a time (see FLUX_TRAIN_STEPS). ``devices``: the local
    mesh's devices (the cards); ``cfg``: stablelm-3b at full size. Returns
    each part's launches by kernel and card."""
    from repro_torch.configs import get_config
    from repro_torch.core.local import LocalRuntime
    from repro_torch.launch.mesh import make_local_mesh

    t0 = time.perf_counter()
    mesh = make_local_mesh(devices=devices)
    devices = list(mesh.devices.flat)
    cfg = cfg or get_config("stablelm-3b")
    peak = {}
    if devices[0].type == "cuda":
        for d in devices:
            torch.cuda.reset_peak_memory_stats(d)
    rt = LocalRuntime(mesh=mesh, n_partitions=len(devices))
    try:
        check(len(rt.partitions) == len(devices)
              and [p.mesh.device for p in rt.partitions] == devices,
              f"{len(devices)} cards carved into {rt.partitions}")
        print(f"[flux] {len(devices)} card(s) {[str(d) for d in devices]} "
              f"carved into {len(rt.partitions)} partition(s) of "
              f"{rt.partitions[0].mesh.shape}  [{card}]", flush=True)
        launches = {"a": flux_kernels_on_cards(torch, ops_of, card, rt,
                                               devices)}
        launches["b"] = flux_training_on_cards(torch, ops_of, card, rt,
                                               devices, cfg)
        if devices[0].type == "cuda":
            torch.cuda.empty_cache()
        launches["c"] = flux_serving_on_cards(torch, ops_of, card, rt,
                                              devices, cfg)
    finally:
        rt.shutdown()
    if devices[0].type == "cuda":
        peak = {str(d): round(torch.cuda.max_memory_allocated(d) / 1e9, 2)
                for d in devices}
    print(f"[flux] phase 14 took {time.perf_counter() - t0:.1f} s; peak "
          f"memory by card over the phase {peak} GB  [{card}]", flush=True)
    return launches



# ------------------------------------------------------------------ phase 15
def lse_case(torch, dtype, B, H, KV, hd, S, n_blocks, valid):
    """The decode kernel's softmax partial (``return_lse``) on each of
    ``n_blocks`` blocks of one cache against its plain version, and the
    blocks' partials combined against the kernel over the whole cache:
    (o max|err|, lse max|err| where finite, the combine's max|err|, the
    blocks without a valid row)."""
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.decode_attention import ref as da_ref
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    q = torch.randn((B, 1, H, hd), generator=gen, device="cuda").to(dt)
    k, v = (torch.randn((B, S, KV, hd), generator=gen, device="cuda").to(dt)
            for _ in range(2))
    scale = hd ** -0.5
    whole = da_ops.decode_attention(
        q, k, v, torch.tensor([valid], dtype=torch.int32, device="cuda"),
        scale=scale)
    Sb = S // n_blocks
    os_, lses, err_o, err_lse, empty = [], [], 0.0, 0.0, 0
    for r in range(n_blocks):
        kb, vb = k[:, r * Sb:(r + 1) * Sb], v[:, r * Sb:(r + 1) * Sb]
        vl = torch.tensor([min(max(valid - r * Sb, 0), Sb)],
                          dtype=torch.int32, device="cuda")
        o, lse = da_ops.decode_attention(q, kb, vb, vl, scale=scale,
                                         return_lse=True)
        po, pl = da_ref.decode_attention_partial_ref(
            q.transpose(1, 2), kb.transpose(1, 2), vb.transpose(1, 2), vl,
            scale=scale)
        check(o.dtype == torch.float32 and lse.shape == (B, H),
              f"lse mode returned {o.dtype} {tuple(lse.shape)}")
        check(bool((torch.isneginf(lse) == torch.isneginf(pl)).all()),
              f"lse mode's empty blocks differ from the plain version's")
        fin = torch.isfinite(pl)
        empty += int(not fin.any())
        err_o = max(err_o, max_err(o, po.transpose(1, 2)))
        if fin.any():
            err_lse = max(err_lse, max_err(lse[fin], pl[fin]))
        os_.append(o[:, 0])
        lses.append(lse)
    comb = da_ref.combine_partials_ref(torch.stack(os_), torch.stack(lses))
    return err_o, err_lse, max_err(comb, whole[:, 0]), empty


def lse_on_card(torch, card):
    """Phase 15 (a): the decode kernel's softmax partial against its plain
    version, f32 and bf16, on blocks with no valid row, some and all, and
    the blocks' partials combined against the whole-cache kernel (within
    ATTN_TOL); then its time at zamba2-7b's per-rank block beside its
    bound, the plain partial, the mode without lse, and the one library
    call that returns a log-sum-exp (aten's private memory-efficient
    attention). Returns the timed reading."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.decode_attention import ref as da_ref
    zam, qwen = get_config("zamba2-7b"), get_config("qwen2-vl-7b")
    worst = 0.0
    for dtype in ("float32", "bfloat16"):
        for label, shape in (
                ("zamba2-7b", (1, zam.num_heads, zam.num_kv_heads,
                               zam.head_dim, 4096, 4, 2500)),
                ("qwen2-vl-7b, a rank's 8 slots over 1 kv head",
                 (2, 8, 1, qwen.head_dim, 2048, 2, 2048)),
                ("musicgen-medium", (1, 24, 24, 64, 1024, 8, 1))):
            eo, el, ec, empty = lse_case(torch, dtype, *shape)
            tol = ATTN_TOL[dtype]
            print(f"[seq] decode_attention lse mode {label} {shape} "
                  f"{dtype}: o max|err| {eo:.3e}, lse max|err| {el:.3e} "
                  f"(tol {LSE_TOL[dtype]}), {shape[5]} blocks ({empty} "
                  f"without a valid row) combined vs the whole-cache "
                  f"kernel {ec:.3e} (tol {tol})", flush=True)
            check(eo < tol and el < LSE_TOL[dtype] and ec < tol,
                  f"decode_attention lse mode {label} {dtype}: {eo}, {el}, "
                  f"{ec}")
            worst = max(worst, eo)
    B, H, KV, hd, S = 1, zam.num_heads, zam.num_kv_heads, zam.head_dim, \
        LSE_BLOCK
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    q = torch.randn((B, 1, H, hd), generator=gen, device="cuda").to(
        torch.bfloat16)
    k, v = (torch.randn((B, S, KV, hd), generator=gen, device="cuda").to(
        torch.bfloat16) for _ in range(2))
    vl = torch.tensor([S], dtype=torch.int32, device="cuda")
    scale = hd ** -0.5
    timer = Timer(torch)
    r = dict(
        ms=timer(lambda: da_ops.decode_attention(q, k, v, vl, scale=scale,
                                                 return_lse=True), 50),
        without_lse_ms=timer(lambda: da_ops.decode_attention(
            q, k, v, vl, scale=scale), 50),
        plain_ms=timer(lambda: da_ref.decode_attention_partial_ref(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), vl,
            scale=scale), iters=5),
        flops=4 * B * H * S * hd,
        bytes=2 * (2 * B * S * KV * hd + B * H * hd) + 4 * (B * H * hd
                                                           + B * H) + 4,
        dtype="bfloat16", max_abs_err=worst, shape=[B, S, H, KV, hd])
    add_bound(r)
    try:                   # the private aten op returns the log-sum-exp
        lib = torch.ops.aten._scaled_dot_product_efficient_attention
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        r["library_ms"] = timer(lambda: lib(qt, kt, vt, None, True,
                                            scale=scale), 50)
        r["library"] = "aten._scaled_dot_product_efficient_attention"
    except Exception as e:                               # noqa: BLE001
        r["library_ms"], r["library"] = None, f"none ({type(e).__name__})"
    del timer
    print(f"[seq] decode_attention lse mode at zamba2-7b's per-rank block "
          f"(B {B}, {S} positions, {H} heads, hd {hd}, bf16): kernel "
          f"{r['ms']:.4f} ms (without lse {r['without_lse_ms']:.4f}), bound "
          f"{r['bound_ms']:.4f} ms ({r['bound_by']}, "
          f"{r['bound_ms'] / r['ms']:.1%}), plain {r['plain_ms']:.4f} ms, "
          f"library {r['library']} {r['library_ms']} ms  [{card}]",
          flush=True)
    return r


def heads_rank(rank, world, cases):
    """Phase 15 (b) on one rank: ``heads_case`` for each (arch, mesh_shape)
    of ``cases`` in one call, the card's cache emptied between them."""
    import torch
    out = []
    for arch, mesh_shape in cases:
        t0 = time.perf_counter()
        r = heads_case(rank, world, arch, tuple(mesh_shape))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.ipc_collect()      # the blocks rank 0 copied
        out.append({**r, "case_s": time.perf_counter() - t0})
    return out


def _in_turn(torch, rank, world, fn):
    """fn() on each rank in turn (the ranks share one card: a whole leaf
    drawn before it is cut is freed before the next rank draws)."""
    import torch.distributed as dist
    out = None
    for r in range(world):
        if r == rank:
            out = fn()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        dist.barrier()
    return out


def heads_case(rank, world, arch, mesh_shape):
    """One case of phase 15 (b) on one rank: query heads padded to slots
    (``tensor_parallel.head_slots``), f32 at full width and HEADS_DEPTH
    layers. Rank 0 draws the whole weights (the others only their blocks,
    in turn) and takes the one-rank kernel-path gradients, ``generate`` and
    teacher-forced logits. Training: one step in its two parts, every
    gathered gradient (real heads only, as ``ParamLayout.gather_leaf``
    gives them) and updated leaf compared on rank 0 as phase 12 does, then
    the padding entries of this rank's blocks after HEADS_MORE_STEPS more
    steps. Serving: TPS_REQUESTS x TPS_PROMPT + TPS_NEW, the tokens, the
    logits teacher-forced and the cache blocks against one rank's. Each
    part's launches counted."""
    import torch
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.distributed import train_step as TS
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import generate, teacher_forced
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    ops_of = _rank_ops()
    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(arch, dtype="float32", num_layers=HEADS_DEPTH)
    mesh = make_mesh(mesh_shape, ("data", "model"), device=dev)
    rows = HEADS_BATCH
    batch = train_batch(torch, cfg, dev, rows, HEADS_SEQ)
    opt_cfg = adamw.OptimizerConfig(warmup_steps=1, total_steps=10)
    step = TS.make_train_step(cfg, opt_cfg, mesh=mesh,
                              dp_axes=SH.batch_axes(mesh, cfg, rows))
    layout = step.layout
    slots = layout.heads
    mine = {"real_heads": slots.real(mesh.coordinate()["model"])[1]}
    if not rank:
        whole = M.init_params(cfg, seed=SEED, device=dev)
        local = layout.shard_params(whole)
        want, ref_m = TS.make_grad_fn(cfg)(whole, batch)
        want = dict(T.flatten(want))
        mine["ref_loss"] = ref_m["loss"].item()
    local = _in_turn(torch, rank, world, lambda: (
        local if not rank else layout.init_params(SEED, dev)))
    state = adamw.init(local, layout)
    _reset_all(ops_of)
    grads, m = step.grad_fn(local, batch)
    local, state, _ = adamw.update(opt_cfg, state, grads, local, layout)
    mine.update(train_launches=_counts_all(ops_of), loss=m["loss"].item(),
                n_local=sum(t.numel() for t in T.leaves(local)))
    grad_rel, gathered = {}, []
    for path, g in T.flatten(grads):
        w = want.pop(path) if not rank else None
        into = torch.empty_like(w) if not rank else None
        grad_rel[path] = _gathered_rel(layout, path, g, w, rank, into=into)
        gathered.append(into)
        del w
    del grads
    if not rank:               # the one-rank AdamW on those gradients
        adamw.update(opt_cfg, adamw.init(whole),
                     T.unflatten(whole, gathered), whole)
        del gathered
        ones = dict(T.flatten(whole))
        del whole
    upd_rel = {path: _gathered_rel(layout, path, t,
                                   ones[path] if not rank else None, rank)
               for path, t in T.flatten(local)}
    if not rank:
        del ones
    for _ in range(HEADS_MORE_STEPS):
        local, state, _ = step(local, state, batch)
    pad_max, pad_n = 0.0, 0
    for (path, p), mu, nu in zip(T.flatten(local), T.leaves(state.mu),
                                 T.leaves(state.nu)):
        if TP.head_dim_of(path) is None:
            continue
        pad = layout.block(path, torch.ones(layout.shapes[path],
                                            device=dev)) == 0
        blk = layout.moment_block(path)
        mpad = pad if blk is None else pad[blk[1]]
        for t, mask in ((p, pad), (mu, mpad), (nu, mpad)):
            pad_n += int(mask.sum())
            if mask.any():
                pad_max = max(pad_max, t[mask].abs().max().item())
    mine.update(pad_max=pad_max, pad_n=pad_n)
    del state
    torch.cuda.empty_cache()
    # serving: the seed's weights again (the trained ones are not served)
    if not rank:
        whole = M.init_params(cfg, seed=SEED, device=dev)
    local = _in_turn(torch, rank, world, lambda: (
        layout.shard_params(whole) if not rank
        else layout.init_params(SEED, dev)))
    slayout = TP.serve_layout(cfg, mesh, TPS_REQUESTS)
    B, S, new = TPS_REQUESTS, TPS_PROMPT, TPS_NEW
    gen = torch.Generator(device=dev).manual_seed(SEED)
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                            device=dev, dtype=torch.int32)
    ref = {}
    if not rank:
        ref["tokens"] = generate(whole, cfg, prompts, max_new_tokens=new)
    _reset_all(ops_of)
    tokens = generate(local, cfg, prompts, max_new_tokens=new, mesh=mesh)
    torch.cuda.synchronize()
    mine.update(serve_launches=_counts_all(ops_of),
                tokens=tokens.cpu().numpy())
    if not rank:
        firsts = {}
        _, _, ref["logits"], final = teacher_forced(
            whole, cfg, tokens, S, on_prefill=lambda c: firsts.update(
                {p: t.clone() for p, t in T.flatten(c)}))
        ref["prefill_cache"], ref["final_cache"] = firsts, dict(
            T.flatten(final))
        del whole, final
    gaps = {}
    _, _, logits, final = teacher_forced(
        local, cfg, tokens, S, layout=slayout,
        on_prefill=lambda c: gaps.update(prefill=_cache_gaps(
            torch, c, slayout, ref.get("prefill_cache"), rank)))
    gaps["final"] = _cache_gaps(torch, final, slayout,
                                ref.get("final_cache"), rank)
    mine["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if rank:
        return mine
    V = cfg.vocab_size
    want = ref["logits"][..., :V]
    err = ((logits[..., :V] - want).abs().amax(dim=(1, 2))
           / want.abs().amax(dim=(1, 2)))
    return {**mine, "grad_rel": grad_rel, "upd_rel": upd_rel,
            "logit_err": err.tolist(),
            "tokens_equal": bool((tokens == ref["tokens"]).all()),
            "cache_gaps": gaps}


def _gathered_rel(layout, path, t, want, rank, specs=None, into=None):
    """max|diff|/max|value| of a leaf's whole (this rank's block ``t``
    gathered on rank 0 by ``_gather0``, a collective, its real heads alone
    where it has head slots, as ``layout.gather_leaf`` gives it) against
    ``want`` on rank 0 (None elsewhere). On rank 0 the whole is also
    written into ``into`` where given."""
    from repro_torch.distributed import tensor_parallel as TP
    g = _gather0(t, (specs or layout.specs)[path], layout.mesh)
    if rank:
        return None
    if path in layout._padded:
        g = TP.unpad_heads(g, layout._padded[path], layout.heads)
    if into is not None:
        into.copy_(g)
    return max_err(g, want) / (want.float().abs().max().item() + 1e-9)


def heads_on_card(torch, card):
    """Phase 15 (b): each case of HEADS_CASES in a spawn of its ranks
    sharing the card. Returns each case's launches per rank, training and
    serving."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import serve_step, train_step
    from repro_torch.distributed.tensor_parallel import head_slots
    launches = {}
    for arch, shape in HEADS_CASES:
        world = shape[0] * shape[1]
        t0 = time.perf_counter()
        out = [r[0] for r in on_card_ranks(heads_rank, world,
                                           [(arch, shape)])]
        close_rank_pools((world,))      # one case a world: its card back
        print(f"[seq] (b) {arch} on {world} ranks in one call took "
              f"{time.perf_counter() - t0:.1f} s  [{card}]", flush=True)
        r0 = out[0]
        cfg = get_config(arch, dtype="float32", num_layers=HEADS_DEPTH)
        slots = head_slots(cfg, shape[1])
        loss_rel = abs(r0["loss"] - r0["ref_loss"]) / abs(r0["ref_loss"])
        g_worst = max(r0["grad_rel"], key=r0["grad_rel"].get)
        u_worst = max(r0["upd_rel"], key=r0["upd_rel"].get)
        gaps = {k: max(v.values()) for k, v in r0["cache_gaps"].items()}
        print(f"[seq] {arch} f32, {HEADS_DEPTH} layers at full width, "
              f"(data, model) {shape} on {world} ranks sharing the card over "
              f"gloo, {cfg.num_heads} heads in {len(slots.heads)} slots, "
              f"{slots.per_rank} a rank, real heads by rank "
              f"{[r['real_heads'] for r in out]}: training {HEADS_BATCH} x "
              f"{HEADS_SEQ}: loss rel {loss_rel:.3e} (tol {GRAD_LOSS_TOL}), "
              f"gradients max {r0['grad_rel'][g_worst]:.3e} ({g_worst}), "
              f"updated leaves max {r0['upd_rel'][u_worst]:.3e} "
              f"({u_worst}) (tol {GRAD_LEAF_TOL}); padding entries after "
              f"{1 + HEADS_MORE_STEPS} steps: max |value| "
              f"{max(r['pad_max'] for r in out)} over "
              f"{sum(r['pad_n'] for r in out)} entries; serving "
              f"{TPS_REQUESTS} x {TPS_PROMPT} + {TPS_NEW}: tokens equal "
              f"{r0['tokens_equal']}, logits max|diff|/max|logit| per step "
              f"max {max(r0['logit_err']):.3e} (tol {F32_LOGIT_TOL}), cache "
              f"blocks after prefill {gaps['prefill']:.3e}, after the last "
              f"step {gaps['final']:.3e} (tol {CACHE_TOL}); peak "
              f"{max(r['peak_gb'] for r in out):.2f} GB a rank at most; the "
              f"case took {r0['case_s']:.1f} s  [{card}]", flush=True)
        check(all(r["loss"] == r0["loss"] for r in out),
              f"{arch} {shape}: the ranks' losses differ")
        check(loss_rel < GRAD_LOSS_TOL, f"{arch} {shape} loss: {loss_rel}")
        check(r0["grad_rel"][g_worst] < GRAD_LEAF_TOL,
              f"{arch} {shape} gradients differ: {r0['grad_rel']}")
        check(r0["upd_rel"][u_worst] < GRAD_LEAF_TOL,
              f"{arch} {shape} updated leaves differ: {r0['upd_rel']}")
        check(all(r["pad_max"] == 0.0 for r in out)
              and sum(r["pad_n"] for r in out) > 0,
              f"{arch} {shape}: padding entries moved")
        check(all(np.array_equal(r["tokens"], r0["tokens"]) for r in out)
              and r0["tokens_equal"], f"{arch} {shape}: tokens differ")
        check(max(r0["logit_err"]) < F32_LOGIT_TOL,
              f"{arch} {shape} logits differ: {r0['logit_err']}")
        check(max(gaps.values()) < CACHE_TOL, f"{arch} {shape} cache "
              f"blocks differ: {r0['cache_gaps']}")
        for rank, r in enumerate(out):
            m = rank % shape[1]
            tw = train_step.kernel_launches(cfg, shape[1], rank=m)
            sw = serve_step.kernel_launches(cfg, TPS_NEW, tp=shape[1],
                                            rank=m)
            got_t = {k: v for k, v in r["train_launches"].items()
                     if k in tw}
            check(got_t == tw and r["serve_launches"] == sw,
                  f"{arch} {shape} rank {rank} launches "
                  f"{r['train_launches']}, {r['serve_launches']} != {tw}, "
                  f"{sw}")
        check(any(not r["real_heads"] for r in out)
              == (arch == "musicgen-medium"),
              f"{arch} {shape}: ranks of padding alone "
              f"{[r['real_heads'] for r in out]}")
        launches[f"{arch} train {shape[0]}x{shape[1]}"] = [
            r["train_launches"] for r in out]
        launches[f"{arch} serve {shape[0]}x{shape[1]}"] = [
            r["serve_launches"] for r in out]
    return launches


def seq_rank(rank, world, cases):
    """Phase 15 (c) on one rank: ``seq_case`` for each case of ``cases``
    in one call, the card's cache emptied between them; then, on two
    ranks, the data group's combine timed."""
    import torch
    out = []
    for case in cases:
        t0 = time.perf_counter()
        r = seq_case(rank, world, *case)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        out.append({**r, "case_s": time.perf_counter() - t0})
    if world == 2:
        out.append(combine_timing(torch, rank, world))
    return out


def combine_timing(torch, rank, world, n=50):
    """The data group's combine of zamba2-7b's decode partial (B 1, 32
    heads, hd 112, f32) over two ranks sharing the card over gloo: ms a
    call of ``combine_partials`` and of each of its two all-reduces,
    each call between two synchronizations (median of n)."""
    import torch.distributed as dist
    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((world, 1), ("data", "model"), device="cuda")
    sp = TP.SeqPar(mesh.group(("data",)), world, mesh.coordinate()["data"],
                   0)
    o = torch.randn((1, 1, 32, 112), device="cuda")
    lse = torch.randn((1, 32), device="cuda")

    def med(fn):
        ts = []
        for _ in range(n):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t) * 1e3)
        return statistics.median(ts)
    cat = torch.randn(32 * 112 + 32, device="cuda")
    return {"combine_ms": med(lambda: TP.combine_partials(o, lse, sp)),
            "max_ms": med(lambda: dist.all_reduce(
                lse.clone(), op=dist.ReduceOp.MAX, group=sp.group)),
            "sum_ms": med(lambda: dist.all_reduce(cat, group=sp.group))}


def seq_case(rank, world, arch, mesh_shape, dtype, depth, capacity,
             prompt_len, new, tokens=None, seed=SEED):
    """One case of phase 15 (c) on one rank: batch 1 served
    sequence-parallel on a (data, model) mesh of ``mesh_shape``, the
    cache's ``capacity`` positions over ``data``, this rank's blocks of the
    weights of ``seed`` drawn. f32 (``tokens`` None): rank 0 also draws them
    whole and runs the one-rank kernel-path ``generate`` of ``new`` tokens
    after a random prompt of ``prompt_len`` and its teacher-forced logits
    and caches; the ranks' ``generate`` (tokens, launches), then their
    teacher-forced logits and cache blocks (gathered and compared on rank
    0). bf16 (``tokens``, a one-rank run's): teacher-forced on them, the
    prefill s, decode ms a step, launches, the seconds in collectives of a
    second pass, the peak memory; rank 0 the logits."""
    import torch
    import torch.distributed as dist
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.distributed.serve_step import pad_cache
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import generate, teacher_forced
    from repro_torch.models import model as M
    ops_of = _rank_ops()
    dev = torch.device("cuda")
    kw = {"num_layers": depth} if depth else {}
    cfg = get_config(arch, dtype=dtype, **kw)
    mesh = make_mesh(mesh_shape, ("data", "model"), device=dev)
    layout = TP.serve_layout(cfg, mesh, 1)
    check(layout.seq_parallel, f"{arch} {mesh_shape}: not sequence-parallel")
    sp = layout.seq_par(capacity)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    local = _in_turn(torch, rank, world,
                     lambda: layout.init_params(seed, dev))
    mine = {"n_local": sum(t.numel() for t in T.leaves(local)),
            "seq_rows": sp.rows}
    if tokens is not None:                            # bf16 at full size
        tokens = torch.from_numpy(tokens).to(dev)
        prefill_s, decode_ms, logits, final = teacher_forced(
            local, cfg, tokens, prompt_len, layout=layout, max_len=capacity,
            on_warm=lambda: _reset_all(ops_of))
        mine["launches"] = _counts_all(ops_of)
        del final                   # the second pass holds its own cache
        torch.cuda.empty_cache()
        spent = {"now": 0.0, "prefill": 0.0}

        def timed(fn):
            def run(*args, **kw):
                torch.cuda.synchronize()
                t = time.perf_counter()
                r = fn(*args, **kw)
                torch.cuda.synchronize()
                spent["now"] += time.perf_counter() - t
                return r
            return run
        real = (dist.all_reduce, TP._all_gather)
        dist.all_reduce, TP._all_gather = timed(real[0]), timed(real[1])
        try:
            teacher_forced(local, cfg, tokens, prompt_len, layout=layout,
                           max_len=capacity, warm=False, keep_logits=False,
                           on_warm=lambda: spent.update(now=0.0),
                           on_prefill=lambda c: spent.update(
                               prefill=spent["now"]))
        finally:
            dist.all_reduce, TP._all_gather = real
        mine.update(prefill_s=prefill_s, decode_ms=decode_ms,
                    peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                    coll_prefill_s=spent["prefill"],
                    coll_decode_ms=(spent["now"] - spent["prefill"]) * 1e3
                    / (tokens.shape[1] - prompt_len - 1))
        if not rank:
            mine["logits"] = logits.cpu().numpy()
        return mine
    gen = torch.Generator(device=dev).manual_seed(SEED)
    prompts = torch.randint(0, cfg.vocab_size, (1, prompt_len),
                            generator=gen, device=dev, dtype=torch.int32)
    ref = {}
    if not rank:
        whole = M.init_params(cfg, seed=seed, device=dev)
        ref["tokens"] = generate(whole, cfg, prompts, max_new_tokens=new,
                                 max_len=capacity)
    _reset_all(ops_of)
    out = generate(local, cfg, prompts, max_new_tokens=new, mesh=mesh,
                   max_len=capacity)
    torch.cuda.synchronize()
    mine.update(launches=_counts_all(ops_of), tokens=out.cpu().numpy())
    if not rank:
        firsts = {}
        # the prefill's cache grown to the capacity, as the ranks' blocks
        _, _, ref["logits"], final = teacher_forced(
            whole, cfg, out, prompt_len, max_len=capacity,
            on_prefill=lambda c: firsts.update(
                {p: t.clone() for p, t in T.flatten(pad_cache(c, cfg,
                                                              capacity))}))
        ref["prefill_cache"], ref["final_cache"] = firsts, dict(
            T.flatten(final))
        del whole, final
    gaps = {}
    _, _, logits, final = teacher_forced(
        local, cfg, out, prompt_len, layout=layout, max_len=capacity,
        on_prefill=lambda c: gaps.update(prefill=_cache_gaps(
            torch, c, layout, ref.get("prefill_cache"), rank)))
    gaps["final"] = _cache_gaps(torch, final, layout, ref.get("final_cache"),
                                rank)
    mine["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if rank:
        return mine
    V = cfg.vocab_size
    want = ref["logits"][..., :V]
    err = ((logits[..., :V] - want).abs().amax(dim=(1, 2))
           / want.abs().amax(dim=(1, 2)))
    return {**mine, "logit_err": err.tolist(), "cache_gaps": gaps,
            "tokens_equal": bool((out == ref["tokens"]).all())}


def seq_bf16_reference(torch, card, seed=SEED):
    """Phase 15 (c) 3.'s one-rank run in this process: zamba2-7b bf16 at
    full size, the weights of ``seed``, one prompt of SEQ_BF16_PROMPT
    tokens from the script's seed, SEQ_BF16_NEW greedy tokens, then
    teacher-forced on them with a cache of SEQ_BF16_CAPACITY. Returns
    (tokens, prefill s, decode ms, logits on the host, peak GB)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate, teacher_forced
    from repro_torch.models import model as M
    t0 = time.perf_counter()
    cfg = get_config("zamba2-7b")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = M.init_params(cfg, seed=seed, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    prompts = torch.randint(0, cfg.vocab_size, (1, SEQ_BF16_PROMPT),
                            generator=gen, device="cuda", dtype=torch.int32)
    tokens = generate(params, cfg, prompts, max_new_tokens=SEQ_BF16_NEW,
                      max_len=SEQ_BF16_CAPACITY)
    prefill_s, decode_ms, logits, _ = teacher_forced(
        params, cfg, tokens, SEQ_BF16_PROMPT, max_len=SEQ_BF16_CAPACITY)
    peak = torch.cuda.max_memory_allocated() / 1e9
    logits = logits.cpu().numpy()
    del params
    torch.cuda.empty_cache()
    print(f"[seq] zamba2-7b bf16 at full size, seed {seed}, one rank (this "
          f"process), 1 x {SEQ_BF16_PROMPT} + {SEQ_BF16_NEW}, cache "
          f"{SEQ_BF16_CAPACITY}: prefill {prefill_s:.4f} s, decode "
          f"{decode_ms:.3f} ms/step, peak {peak:.2f} GB (the earlier "
          f"phases' tensors included); took {time.perf_counter() - t0:.1f} "
          f"s  [{card}]", flush=True)
    return tokens.cpu().numpy(), prefill_s, decode_ms, logits, peak


def seq_bf16_gap(ref, r0, V):
    """max|diff|/max|logit| of each step of the ranks' logits against the
    one-rank run's, over the ``V`` real rows of the vocabulary, and the
    argmax agreement (numpy)."""
    a, b = r0["logits"][..., :V], ref[3][..., :V]
    err = np.abs(a - b).max(axis=(1, 2)) / np.abs(b).max(axis=(1, 2))
    return err, float((a.argmax(-1) == b.argmax(-1)).mean())


def seq_bf16_gap_of_seed(torch, card, seed):
    """Phase 15 (c) 3. alone for the weights of ``seed``, not held to
    SEQ_BF16_TOL: the gap of each step's logits (``seq_bf16_gap``)."""
    from repro_torch.configs import get_config
    ref = seq_bf16_reference(torch, card, seed)
    case = ("zamba2-7b", (2, 1), "bfloat16", None, SEQ_BF16_CAPACITY,
            SEQ_BF16_PROMPT, SEQ_BF16_NEW, ref[0], seed)
    r0 = on_card_ranks(seq_rank, 2, [case])[0][0]
    err, agree = seq_bf16_gap(ref, r0, get_config("zamba2-7b").vocab_size)
    print(f"[seq] zamba2-7b bf16 at full size, seed {seed}, (2, 1): logits "
          f"gap per step {[f'{x:.3e}' for x in err.tolist()]}, argmax "
          f"agrees in {agree:.1%}; prefill {r0['prefill_s']:.4f} s, decode "
          f"{r0['decode_ms']:.3f} ms/step  [{card}]", flush=True)
    return err.max().item()


def seq_on_card(torch, card):
    """Phase 15 (c): SEQ_F32_CASES and the bf16 case, one call a mesh
    size. Returns each case's launches per rank and the combine's
    timing."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.serve_step import kernel_launches
    ref = seq_bf16_reference(torch, card)
    launches, timing = {}, None
    for world in (2, 4):
        cases = [(arch, shape, "float32", SEQ_DEPTH_OF.get(arch),
                  SEQ_CAPACITY, SEQ_PROMPT, SEQ_NEW)
                 for arch, shape in SEQ_F32_CASES
                 if shape[0] * shape[1] == world]
        if world == 2:
            cases.append(("zamba2-7b", (2, 1), "bfloat16", None,
                          SEQ_BF16_CAPACITY, SEQ_BF16_PROMPT, SEQ_BF16_NEW,
                          ref[0]))
        t0 = time.perf_counter()
        runs = on_card_ranks(seq_rank, world, cases)
        print(f"[seq] (c) {len(cases)} cases on {world} ranks in one call "
              f"took {time.perf_counter() - t0:.1f} s  [{card}]",
              flush=True)
        for i, case in enumerate(cases):
            arch, shape, dtype, depth, capacity, prompt_len, new = case[:7]
            out = [ranks[i] for ranks in runs]
            r0 = out[0]
            cfg = get_config(arch, dtype=dtype,
                             **({"num_layers": depth} if depth else {}))
            what = (f"{arch} {dtype}, {cfg.num_layers} layers at full width, "
                    f"(data, model) {shape} on {world} ranks sharing the "
                    f"card over gloo, 1 x {prompt_len} + {new}, a cache of "
                    f"{capacity} positions in blocks of {r0['seq_rows']}")
            for rank, r in enumerate(out):
                want = kernel_launches(cfg, new, tp=shape[1],
                                       rank=rank % shape[1])
                check(r["launches"] == want, f"{what}: rank {rank} "
                      f"launches {r['launches']} != {want}")
            key = f"{arch} {'bf16 ' if dtype == 'bfloat16' else ''}serve " \
                  f"{shape[0]}x{shape[1]} seq"
            launches[key] = [r["launches"] for r in out]
            if dtype == "bfloat16":
                err, agree = seq_bf16_gap(ref, r0, cfg.vocab_size)
                print(f"[seq] {what}: logits vs the one-rank run's, "
                      f"max|diff|/max|logit| per step max "
                      f"{err.max().item():.3e} (prefill {err[0].item():.3e};"
                      f" tol {SEQ_BF16_TOL}), argmax agrees in {agree:.1%}; "
                      f"prefill {r0['prefill_s']:.4f} s (one rank "
                      f"{ref[1]:.4f}), decode {r0['decode_ms']:.3f} ms/step "
                      f"(one rank {ref[2]:.3f}); seconds in collectives by "
                      f"rank: prefill "
                      f"{[round(r['coll_prefill_s'], 4) for r in out]} s, "
                      f"decode {[round(r['coll_decode_ms'], 3) for r in out]}"
                      f" ms/step; peak memory by rank "
                      f"{[round(r['peak_gb'], 2) for r in out]} GB (one rank"
                      f" {ref[4]:.2f}); launches {r0['launches']}; the case "
                      f"took {r0['case_s']:.1f} s  [{card}]", flush=True)
                check(bool(np.isfinite(r0["logits"]).all()),
                      f"{what}: logits not finite")
                check(err.max().item() < SEQ_BF16_TOL,
                      f"{what}: logits differ from one rank's: "
                      f"{err.tolist()}")
                continue
            gaps = {k: max(v.values()) for k, v in r0["cache_gaps"].items()}
            print(f"[seq] {what}: tokens equal the one-rank generate's "
                  f"{r0['tokens_equal']}; teacher-forced logits "
                  f"max|diff|/max|logit| per step max "
                  f"{max(r0['logit_err']):.3e} (tol {SEQ_F32_TOL}); cache "
                  f"blocks vs the one-rank cache after prefill "
                  f"{gaps['prefill']:.3e}, after the last step "
                  f"{gaps['final']:.3e} (tol {CACHE_TOL}); parameters by "
                  f"rank {[r['n_local'] for r in out]}, peak "
                  f"{[round(r['peak_gb'], 2) for r in out]} GB; launches "
                  f"{r0['launches']}; the case took {r0['case_s']:.1f} s  "
                  f"[{card}]", flush=True)
            check(all(np.array_equal(r["tokens"], r0["tokens"])
                      for r in out) and r0["tokens_equal"],
                  f"{what}: tokens differ")
            check(max(r0["logit_err"]) < SEQ_F32_TOL,
                  f"{what}: logits differ: {r0['logit_err']}")
            check(max(gaps.values()) < CACHE_TOL,
                  f"{what}: cache blocks differ: {r0['cache_gaps']}")
        if world == 2:
            timing = {k: [r[-1][k] for r in runs]
                      for k in runs[0][-1]}
            print(f"[seq] the data group's combine over 2 ranks sharing the "
                  f"card (gloo through host memory), zamba2-7b's partial "
                  f"(1 x 32 heads x 112, f32), ms a call by rank: combine "
                  f"{[round(x, 4) for x in timing['combine_ms']]}, its "
                  f"all-reduce MAX {[round(x, 4) for x in timing['max_ms']]}"
                  f", its all-reduce SUM "
                  f"{[round(x, 4) for x in timing['sum_ms']]}  [{card}]",
                  flush=True)
    return launches, timing


def seq_parallel_on_card(torch, card):
    """Phase 15 (see the module docstring and the constants). Returns the
    launches per rank by case and the decode kernel's lse-mode reading
    (with the combine's timing)."""
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    lse = lse_on_card(torch, card)
    torch.cuda.empty_cache()
    launches = heads_on_card(torch, card)
    torch.cuda.empty_cache()
    seq_launches, lse["combine"] = seq_on_card(torch, card)
    close_rank_pools()              # phase 16's ranks are the runtime's
    launches.update(seq_launches)
    print(f"[seq] phase 15 took {time.perf_counter() - t0:.1f} s  [{card}]",
          flush=True)
    return launches, lse


# ------------------------------------------------------------------ phase 16
def flux_rank_train(arch, mesh=None):
    """Phase 16 (a) and (b), a flux task's body on each rank of its group:
    phase 12 (a)'s case (``tp_parity_case``) over the group's mesh; rank
    0's reading comes back."""
    import torch.distributed as dist
    return tp_parity_case(dist.get_rank(), dist.get_world_size(), arch,
                          tuple(mesh.shape.values()))


def flux_rank_generate(arch, mesh=None):
    """Phase 16 (c) on each rank: the rank's blocks of the seed's f32
    weights at TP_DEPTH layers, phase 13 (a)'s prompts, ``generate`` over
    the group's mesh; rank 0's tokens come back (onto the partition's
    first card)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.launch.serve import generate
    dev = torch.device("cuda")
    cfg = get_config(arch, dtype="float32", num_layers=TP_DEPTH)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    prompts = torch.randint(0, cfg.vocab_size, (TPS_REQUESTS, TPS_PROMPT),
                            generator=gen, device=dev, dtype=torch.int32)
    local = TP.serve_layout(cfg, mesh, TPS_REQUESTS).init_params(SEED, dev)
    tokens = generate(local, cfg, prompts, max_new_tokens=TPS_NEW,
                      mesh=mesh)
    return {"tokens": tokens}


def flux_rank_fail(gb, mesh=None):
    """Phase 16 (d) on each rank: take ``gb`` of the card, then rank 1
    raises while rank 0 waits for it in a collective."""
    import torch
    import torch.distributed as dist
    held = torch.ones(int(gb * 1e9) // 4, device="cuda")
    torch.cuda.synchronize()
    if dist.get_rank() == 1:
        raise RuntimeError(f"rank 1 fails on purpose, holding "
                           f"{held.numel() * 4 / 1e9:.1f} GB of its card")
    dist.all_reduce(torch.ones(1, device="cuda"))
    return held.numel()


def _group_launches(group):
    """Each rank's launches by kernel (the split-row RMSNorm's among them
    as ``fused_rmsnorm_split``), from the group's reports."""
    return [{**r["launches"], "fused_rmsnorm_split": r["split_launches"]}
            for r in group["ranks"]]


def _check_group(group, want_shape, card0, what):
    """Every rank of ``group`` on card 0 (its device, its current card)
    over gloo, as many as the partition's shape holds."""
    n = math.prod(want_shape)
    check(group["backend"] == "gloo" and group["devices"] == [str(card0)] * n
          and len(group["ranks"]) == n
          and all(r["device"] == str(card0) and r["current"] == card0.index
                  for r in group["ranks"]),
          f"{what}: group {group['backend']} on {group['devices']}, ranks "
          f"{[(r.get('device'), r.get('current')) for r in group['ranks']]}")


def _hold_train(torch, task, group, shape, card0, card, what):
    """Phase 16 (a)/(b): one train task's reading held as phase 12 (a)
    holds its case, and each rank's launches exact."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.train_step import (kernel_launches,
                                                    split_norm_launches)
    arch = "stablelm-3b"
    cfg = get_config(arch, dtype="float32", num_layers=TP_DEPTH)
    r0 = task.result
    _check_group(group, shape, card0, what)
    want = kernel_launches(cfg, model_ranks=shape[1])
    want_split = split_norm_launches(cfg, shape[1])
    loss_rel = abs(r0["loss"] - r0["ref_loss"]) / abs(r0["ref_loss"])
    g_worst = max(r0["grad_rel"], key=r0["grad_rel"].get)
    u_worst = max(r0["upd_rel"], key=r0["upd_rel"].get)
    body = [r["t1"] - r["t0"] for r in group["ranks"]]
    print(f"[ranks] {what}: {arch} f32, {TP_DEPTH} layers at full width, "
          f"a flux task on a {shape} partition, a rank group over gloo on "
          f"{group['devices']}: loss {r0['loss']:.7f} vs one rank "
          f"{r0['ref_loss']:.7f} (rel {loss_rel:.3e}, tol {GRAD_LOSS_TOL}); "
          f"gathered gradients max|diff|/max|grad| "
          f"{r0['grad_rel'][g_worst]:.3e} ({g_worst}), updated leaves and "
          f"moments "
          f"{r0['upd_rel'][u_worst]:.3e} ({u_worst}) (tol {GRAD_LEAF_TOL}); "
          f"spawn {group['spawn_s']:.2f} s, the group {group['wall_s']:.2f} "
          f"s, the body in the ranks {[round(b, 2) for b in body]} s (rank "
          f"0's one-rank reference and comparisons included); peak "
          f"{[round(r['peak_gb'], 2) for r in group['ranks']]} GB by rank; "
          f"launches by rank {_group_launches(group)}, by card "
          f"{[r['card_launches'] for r in group['ranks']]}  [{card}]",
          flush=True)
    check(loss_rel < GRAD_LOSS_TOL, f"{what}: loss differs: {loss_rel}")
    check(r0["grad_rel"][g_worst] < GRAD_LEAF_TOL,
          f"{what}: gradients differ: {r0['grad_rel']}")
    check(r0["upd_rel"][u_worst] < GRAD_LEAF_TOL,
          f"{what}: updated leaves differ: {r0['upd_rel']}")
    for rank, r in enumerate(group["ranks"]):
        # rank 0's one-rank reference pass launched as many before the body
        # set the counts to 0; its launches by card keep them
        by_card = {name: ({card0.index: n * (2 if rank == 0 else 1)}
                          if n else {}) for name, n in want.items()}
        check(r["launches"] == want and r["split_launches"] == want_split
              and r["card_launches"] == by_card,
              f"{what} rank {rank} launches {r['launches']} (split "
              f"{r['split_launches']}, by card {r['card_launches']}) != "
              f"{want} (split {want_split}, by card {by_card})")


def _free_after(torch, card0, free0):
    """The card's free bytes, read until they are back within
    FLUX_MEM_SLACK of ``free0`` or FLUX_MEM_WAIT_S has passed."""
    deadline = time.monotonic() + FLUX_MEM_WAIT_S
    while True:
        free = torch.cuda.mem_get_info(card0)[0]
        if free >= free0 - FLUX_MEM_SLACK or time.monotonic() > deadline:
            return free
        time.sleep(0.25)


def flux_ranks_on_card(torch, card):
    """Phase 16 (see the module docstring and the constants). Returns each
    task's launches per rank, by case."""
    from repro_torch.configs import get_config
    from repro_torch.core.local import LocalRuntime
    from repro_torch.core.task import TaskDescription
    from repro_torch.distributed.serve_step import kernel_launches
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.serve import generate
    from repro_torch.models import model as M
    t_phase = time.perf_counter()
    card0 = torch.device("cuda", 0)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    launches = {}

    # (c)'s one-rank reference in this process, the ranks' weights whole
    gcfg = get_config("chatglm3-6b", dtype="float32", num_layers=TP_DEPTH)
    whole = M.init_params(gcfg, seed=SEED, device=card0)
    gen = torch.Generator(device=card0).manual_seed(SEED)
    prompts = torch.randint(0, gcfg.vocab_size, (TPS_REQUESTS, TPS_PROMPT),
                            generator=gen, device=card0, dtype=torch.int32)
    t0 = time.perf_counter()
    ref_tokens = generate(whole, gcfg, prompts, max_new_tokens=TPS_NEW)
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    del whole
    torch.cuda.empty_cache()

    def desc(fn, *args):
        return TaskDescription(kind="executable", coupling="tight", fn=fn,
                               args=args, walltime=FLUX_RANK_WALLTIME_S)

    # (d) alone on a (2, 1) partition, its card's free memory read around it
    rt_b = LocalRuntime(mesh=make_local_mesh(1, devices=[card0] * 2),
                        n_partitions=1)
    rt_a = None
    try:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        free0 = torch.cuda.mem_get_info(card0)[0]
        bad, = rt_b.submit([desc(flux_rank_fail, FLUX_FAIL_GB)])
        check(rt_b.wait(timeout=TASK_TIMEOUT_S), "(d) the task did not end")
        failed_at = time.perf_counter()
        bg = rt_b.agent.backends["flux"].rank_groups[bad.uid]
        free = _free_after(torch, card0, free0)
        back_s = time.perf_counter() - failed_at
        alive = [pid for pid in bg["pids"] if _pid_alive(pid)]
        print(f"[ranks] (d) a rank that raises after taking {FLUX_FAIL_GB} "
              f"GB of the card: task {bad.state.value}, error "
              f"{(bad.error or '').splitlines()[0]!r} ... "
              f"{(bad.error or '').strip().splitlines()[-1]!r}; ranks "
              f"alive after it {alive}; the card's free memory "
              f"{free0 / 2**30:.2f} GiB before the group, "
              f"{free / 2**30:.2f} GiB {back_s:.2f} s after the task "
              f"failed (slack {FLUX_MEM_SLACK >> 20} MiB); spawn "
              f"{bg['spawn_s']:.2f} s, the group {bg['wall_s']:.2f} s  "
              f"[{card}]", flush=True)
        check(bad.state.value == "FAILED" and "rank 1 of 2 on cuda:0"
              in bad.error and "fails on purpose" in bad.error,
              f"(d) task {bad.state.value}: {bad.error}")
        check(not alive, f"(d) ranks {alive} outlived the task")
        check(free >= free0 - FLUX_MEM_SLACK, f"(d) the card's free "
              f"memory {free} did not come back to {free0}")

        # (a) and (c) on three (1, 2) partitions, and (b) as the (2, 1)
        # partition's next task, all at once
        rt_a = LocalRuntime(mesh=make_local_mesh(2, devices=[card0] * 6),
                            n_partitions=3)
        shapes = [tuple(p.mesh.shape.values()) for p in rt_a.partitions]
        check(shapes == [(1, 2)] * 3, f"[cuda:0] * 6 carved into {shapes}")
        t0 = time.perf_counter()
        tasks = rt_a.submit([desc(flux_rank_train, "stablelm-3b"),
                             desc(flux_rank_train, "stablelm-3b"),
                             desc(flux_rank_generate, "chatglm3-6b")])
        nxt, = rt_b.submit([desc(flux_rank_train, "stablelm-3b")])
        check(rt_a.wait(timeout=TASK_TIMEOUT_S)
              and rt_b.wait(timeout=TASK_TIMEOUT_S),
              "phase 16's tasks did not finish")
        wall = time.perf_counter() - t0
        bad_tasks = [(t.uid, t.state.value, t.error) for t in (*tasks, nxt)
                     if t.state.value != "DONE" or t.backend != "flux"]
        check(not bad_tasks, f"flux tasks failed: {bad_tasks}")
        check(nxt.partition == bad.partition, "(b) ran on another partition")
        groups = [rt_a.agent.backends["flux"].rank_groups[t.uid]
                  for t in tasks]
        ng = rt_b.agent.backends["flux"].rank_groups[nxt.uid]
    finally:
        rt_b.shutdown()
        if rt_a is not None:
            rt_a.shutdown()
    for i in range(2):
        _hold_train(torch, tasks[i], groups[i], (1, 2), card0, card,
                    f"(a) task {i}")
        launches[f"stablelm-3b train 1x2 task {i}"] = _group_launches(
            groups[i])
    spans = [(r["t0"], r["t1"]) for g in groups[:2] for r in g["ranks"]]
    overlap = max(a for a, _ in spans) < min(b for _, b in spans)
    check(overlap, f"(a) the two train tasks' ranks did not run at once: "
          f"{spans}")
    got, g = tasks[2].result, groups[2]
    _check_group(g, (1, 2), card0, "(c)")
    want = kernel_launches(gcfg, TPS_NEW, tp=2)
    same = bool(torch.equal(got["tokens"], ref_tokens))
    print(f"[ranks] (c) chatglm3-6b f32, {TP_DEPTH} layers at full width, "
          f"generate as a flux task on a (1, 2) partition, a rank group over "
          f"gloo on {g['devices']}, {TPS_REQUESTS} x {TPS_PROMPT} + "
          f"{TPS_NEW}: tokens on {got['tokens'].device} equal to one-rank "
          f"generate in this process: {same}; spawn {g['spawn_s']:.2f} s, "
          f"the group {g['wall_s']:.2f} s, the body in the ranks "
          f"{[round(r['t1'] - r['t0'], 2) for r in g['ranks']]} s (one-rank "
          f"generate {ref_s:.2f} s); peak "
          f"{[round(r['peak_gb'], 2) for r in g['ranks']]} GB by rank; "
          f"launches by rank {_group_launches(g)}  [{card}]", flush=True)
    check(same and got["tokens"].device == card0,
          f"(c) tokens on {got['tokens'].device} differ from one-rank "
          f"generate's")
    for rank, r in enumerate(_group_launches(g)):
        by_card = {name: {card0.index: want[name]} if want[name] else {}
                   for name in g["ranks"][rank]["card_launches"]}
        check(r == want and g["ranks"][rank]["card_launches"] == by_card,
              f"(c) rank {rank} launches {r} (by card "
              f"{g['ranks'][rank]['card_launches']}) != {want}")
    launches["chatglm3-6b generate 1x2"] = _group_launches(g)
    _hold_train(torch, nxt, ng, (2, 1), card0, card,
                "(b) the (2, 1) partition's next task")
    launches["stablelm-3b train 2x1"] = _group_launches(ng)
    print(f"[ranks] (a), (b) and (c): four tasks of 2 ranks at once on card "
          f"0, wall {wall:.2f} s through the runtime; the (a) ranks' bodies "
          f"overlap: {overlap}  [{card}]", flush=True)
    print(f"[ranks] phase 16 took {time.perf_counter() - t_phase:.1f} s  "
          f"[{card}]", flush=True)
    return launches


def _pid_alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


if __name__ == "__main__":
    main()
