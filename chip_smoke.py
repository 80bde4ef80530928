#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA H100.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one CUDA
card, ``nvcc`` (``/usr/local/cuda``) and Triton, and fails without them.

Phases, each printing its lines; any failed check exits non-zero:
  1. device: the card's name, count and power limit;
  2. build: every CUDA kernel from the checkout's sources (one nvcc per
     source, in parallel), with ptxas' registers and spills;
  3. kernel vs plain: each kernel's wrapper on CUDA tensors at the main
     path's shapes against its plain PyTorch version, tolerance stated;
  4. kernel times (CUDA events, L2 flushed before each launch) beside the
     least time the card could take, the plain version and a library call;
  5. main path: ``serve_batch`` on full-width chatglm3-6b (28 layers,
     d_model 4096, random bf16 weights from a seed): 8 requests of 1,024
     prompt tokens, 32 greedy new tokens, with the kernels' launch counts
     read around it; then the kernel and plain paths teacher-forced on the
     kernel path's tokens, the logits of every step compared in f32 and in
     bf16; prefill and decode times;
  6. where the time of one prefill and one decode step goes
     (torch.profiler), and the per-launch device time of the kernels there.
The line before the last is the ``{"kernels": [...]}`` summary; the last is
``{"ok": true, "device": {...}}``.
"""
import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM peaks (NVIDIA data sheet, dense): the bound of each kernel
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
SPIN_CYCLES = 400_000       # ~0.2 ms at 1.98 GHz: above any wrapper's host time

ARCH = "chatglm3-6b"
N_REQUESTS, PROMPT_LEN, NEW_TOKENS, SEED = 8, 1024, 32, 0
# bf16 kernel-vs-plain tolerances as in the JAX package's kernel tests;
# f32 differs only by the order of sums
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
NORM_TOL = {"float32": 2e-5, "bfloat16": 0.05}
# Kernel path vs plain path at full width, teacher-forced, per step:
# max|diff|/max|logit|. In f32 the paths differ by the order of sums only:
# the card read at most 1.3e-5 over the 32 steps, and the bf16 control (the
# bf16 kernel path against the same f32 plain path) at least 3.2e-2, which
# the script requires to fail this limit. In bf16 the kernel path's distance
# to the f32 plain path, over the bf16 plain path's, read 1.03.
F32_LOGIT_TOL = 1e-4
BF16_ERR_RATIO = 1.5


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


def main():
    import torch
    import torch.nn.functional as F

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
    from repro_torch.distributed.serve_step import (make_decode_step,
                                                    make_prefill_step,
                                                    pad_cache, sample)
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.decode_attention import ref as da_ref
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.fused_rmsnorm import ops as rn_ops
    from repro_torch.kernels.fused_rmsnorm import ref as rn_ref
    from repro_torch.launch.serve import _positions, serve_batch
    from repro_torch.models import model as M

    # ------------------------------------------------------------- 2. build
    t0 = time.perf_counter()
    logs = _build.build_all()
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

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32).to(dtype)

    cfg = get_config(ARCH)
    B, S, H, KV, hd = (N_REQUESTS, PROMPT_LEN, cfg.num_heads,
                       cfg.num_kv_heads, cfg.head_dim)
    S_cache = PROMPT_LEN + NEW_TOKENS
    d = cfg.d_model
    results = {}

    # --------------------------------------------------- 3. kernel vs plain
    def flash_case(b, s, h, kv, dh, dtype):
        q, k, v = (randn(b, s, h, dh, dtype=dtype), randn(b, s, kv, dh, dtype=dtype),
                   randn(b, s, kv, dh, dtype=dtype))
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

    def norm_case(rows, dim, dtype):
        x, w = randn(rows, dim, dtype=dtype), randn(dim, dtype=dtype) * 0.1
        got = rn_ops.rmsnorm(x, w, eps=cfg.norm_eps)
        torch.cuda.synchronize()
        return max_err(got, rn_ref.rmsnorm_ref(x, w, eps=cfg.norm_eps)), (x, w)

    inputs = {}
    for dtype_name, dtype in (("bfloat16", torch.bfloat16),
                              ("float32", torch.float32)):
        for label, shape in (("chatglm3-6b prefill", (B, S, H, KV, hd)),
                             ("stablelm-3b hd80 ragged", (2, 200, 32, 32, 80))):
            err, args = flash_case(*shape, dtype)
            tol = ATTN_TOL[dtype_name]
            print(f"[check] flash_attention {label} {shape} {dtype_name}: "
                  f"max|err| {err:.3e} (tol {tol})", flush=True)
            check(err < tol, f"flash_attention {shape} {dtype_name}: {err}")
            if dtype_name == "bfloat16" and label.startswith("chatglm"):
                results["flash_attention"] = {"max_abs_err": err}
                inputs["flash_attention"] = args
        for valid in (PROMPT_LEN + 1, 17):
            shape = (B, S_cache, H, KV, hd)
            err, args = decode_case(*shape, valid, dtype)
            tol = ATTN_TOL[dtype_name]
            print(f"[check] decode_attention {shape} valid_len {valid} "
                  f"{dtype_name}: max|err| {err:.3e} (tol {tol})", flush=True)
            check(err < tol, f"decode_attention {shape}@{valid}: {err}")
            if dtype_name == "bfloat16" and valid == PROMPT_LEN + 1:
                results["decode_attention"] = {"max_abs_err": err}
                inputs["decode_attention"] = args
        for rows in (B * S, B):
            err, args = norm_case(rows, d, dtype)
            tol = NORM_TOL[dtype_name]
            print(f"[check] fused_rmsnorm ({rows}, {d}) {dtype_name}: max|err| "
                  f"{err:.3e} (tol {tol})", flush=True)
            check(err < tol, f"fused_rmsnorm ({rows},{d}) {dtype_name}: {err}")
            if dtype_name == "bfloat16":
                inputs[f"fused_rmsnorm/{rows}"] = args
                if rows == B * S:
                    results["fused_rmsnorm"] = {"max_abs_err": err}

    # ------------------------------------------------------- 4. kernel times
    timer = Timer(torch)
    q, k, v, scale = inputs["flash_attention"]
    pairs = B * H * S * (S + 1) // 2                     # causal (q, k) pairs
    flops = 4 * hd * pairs
    nbytes = 2 * (q.numel() * 2 + k.numel() + v.numel())  # q, o, k, v in bf16
    results["flash_attention"].update(
        ms=timer(lambda: fa_ops.flash_attention(q, k, v, scale=scale)),
        plain_ms=timer(lambda: fa_ref.attention_ref(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), scale=scale),
            iters=5),
        library_ms=timer(lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, scale=scale, enable_gqa=True)),
        flops=flops, bytes=nbytes, dtype="bfloat16")

    q, k, v, vl, scale = inputs["decode_attention"]
    valid = PROMPT_LEN + 1
    mask = (torch.arange(S_cache, device=dev) < vl)[None, None, None, :]
    results["decode_attention"].update(
        ms=timer(lambda: da_ops.decode_attention(q, k, v, vl, scale=scale), 50),
        plain_ms=timer(lambda: da_ref.decode_attention_ref(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), vl,
            scale=scale)),
        library_ms=timer(lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, scale=scale, enable_gqa=True), 50),
        flops=4 * B * H * hd * valid,
        bytes=2 * (2 * B * valid * KV * hd + 2 * B * H * hd) + 4,
        dtype="bfloat16")

    # the prefill rows here; the decode rows' (8 x 4,096) kernel time is
    # shorter than the host's launch of it, so events would time the host:
    # phase 6 reads it from the decode step's profile instead
    x, w = inputs[f"fused_rmsnorm/{B * S}"]
    w1 = (1.0 + w.float()).to(x.dtype)
    results["fused_rmsnorm"].update(
        ms=timer(lambda: rn_ops.rmsnorm(x, w, eps=cfg.norm_eps), 50),
        plain_ms=timer(lambda: rn_ref.rmsnorm_ref(x, w, eps=cfg.norm_eps), 50),
        library_ms=timer(lambda: F.rms_norm(x, (d,), weight=w1,
                                            eps=cfg.norm_eps), 50),
        flops=4 * B * S * d, bytes=2 * (2 * B * S * d + d), dtype="float32")

    # host time to issue one call at the decode step's shapes: at batch 8 a
    # decode step is a chain of small launches, so this bounds its speed
    x8, w8 = inputs[f"fused_rmsnorm/{B}"]
    w8_1 = (1.0 + w8.float()).to(x8.dtype)
    qd, kd, vd, vld, sd = inputs["decode_attention"]
    for label, fn in (
            ("fused_rmsnorm wrapper (8 rows)",
             lambda: rn_ops.rmsnorm(x8, w8, eps=cfg.norm_eps)),
            ("decode_attention wrapper",
             lambda: da_ops.decode_attention(qd, kd, vd, vld, scale=sd)),
            ("F.rms_norm (8 rows)",
             lambda: F.rms_norm(x8, (d,), weight=w8_1, eps=cfg.norm_eps)),
            ("torch add (8 rows)", lambda: x8 + x8)):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            fn()
        host_us = (time.perf_counter() - t0) / 200 * 1e6
        torch.cuda.synchronize()
        print(f"[host] {label}: {host_us:.1f} us of host time per call",
              flush=True)

    for name, r in results.items():
        t_bytes = r["bytes"] / PEAK_BYTES_PER_S * 1e3
        t_ops = r["flops"] / PEAK_FLOPS[r["dtype"]] * 1e3
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        print(f"[time] {name}: kernel {r['ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}; {r['bound_ms'] / r['ms']:.1%}"
              f" of it), plain {r['plain_ms']:.4f} ms, library "
              f"{r['library_ms']:.4f} ms  [{card}]", flush=True)
    del inputs, q, k, v, x, w, w1

    # ------------------------------------------------------------ 5. main path
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=SEED, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"[main] {ARCH}: {cfg.num_layers} layers, d_model {d}, "
          f"{n_params / 1e9:.3f} B params in bf16, random init in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    check(cfg.num_layers == 28 and d == 4096, "chatglm3-6b is not at full width")

    torch.cuda.reset_peak_memory_stats()
    for ops in (fa_ops, da_ops, rn_ops):
        ops.launches = 0
    res = serve_batch(cfg, n_requests=N_REQUESTS, prompt_len=PROMPT_LEN,
                      max_new_tokens=NEW_TOKENS, seed=SEED, params=params,
                      quiet=True, device=dev)
    launches = {"flash_attention": fa_ops.launches,
                "decode_attention": da_ops.launches,
                "fused_rmsnorm": rn_ops.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    L = cfg.num_layers
    want = {"flash_attention": L, "decode_attention": L * (NEW_TOKENS - 1),
            "fused_rmsnorm": (2 * L + 1) * NEW_TOKENS}
    print(f"[main] serve_batch: {N_REQUESTS} x {PROMPT_LEN} prompt tokens, "
          f"{NEW_TOKENS} new tokens each, {res['wall_s']:.3f} s, "
          f"{res['tokens_per_s']:.1f} new tokens/s, peak memory "
          f"{peak_gb:.2f} GB; launches {launches}  [{card}]", flush=True)
    check(launches == want, f"launch counts {launches} != {want}")
    for name in results:
        results[name]["launches"] = launches[name]
    tokens = res["tokens"]
    check(tuple(tokens.shape) == (N_REQUESTS, PROMPT_LEN + NEW_TOKENS),
          f"output shape {tuple(tokens.shape)}")

    # The kernel path against the plain path, both teacher-forced on the
    # kernel path's own tokens, so every one of the 32 steps (prefill and 31
    # decode steps) is compared on the same inputs. f32 is the decisive
    # check: the kernels take f32, so the two paths differ only by the order
    # of sums. In bf16 both paths round at other places; there the kernel
    # path must stay as close to the f32 plain path as the bf16 plain path is.
    plain_cfg = dataclasses.replace(cfg, use_pallas=False)
    prefill_s, decode_ms, logits = {}, {}, {}
    runs = (("kernels", cfg, params), ("plain", plain_cfg, params))
    for label, c, p in runs:
        prefill_s[label], decode_ms[label], logits[label] = teacher_forced(
            torch, c, p, tokens, S, S_cache, dev)
    params32 = _tree_map(lambda t: t.float(), params)
    for label, c in (("kernels", cfg), ("plain", plain_cfg)):
        c32 = dataclasses.replace(c, dtype="float32")
        _, _, logits[label + " f32"] = teacher_forced(
            torch, c32, params32, tokens, S, S_cache, dev)
    del params32
    torch.cuda.empty_cache()
    V = cfg.vocab_size
    for label, lg in logits.items():
        check(bool(torch.isfinite(lg).all()), f"{label} logits not finite")

    def rel(a, b):                    # per step: max|a - b| / max|b|
        a, b = a[..., :V], b[..., :V]
        return ((a - b).abs().amax(dim=(1, 2)) / b.abs().amax(dim=(1, 2)))

    def agree(a, b):
        return (a[..., :V].argmax(-1) == b[..., :V].argmax(-1)).float().mean()

    truth = logits["plain f32"]
    err32 = rel(logits["kernels f32"], truth)
    control = rel(logits["kernels"], truth)
    err16_k, err16_p = control, rel(logits["plain"], truth)
    err16 = rel(logits["kernels"], logits["plain"])
    replay = (logits["kernels"][..., :V].argmax(-1).t()
              == tokens[:, S:].to(torch.int64)).float().mean().item()
    print(f"[main] teacher-forced logits over {NEW_TOKENS} steps (prefill + "
          f"{NEW_TOKENS - 1} decode steps), max|diff|/max|logit| per step, "
          f"max over steps:", flush=True)
    print(f"[main]   f32 kernels vs f32 plain: {err32.max().item():.3e} "
          f"(prefill {err32[0].item():.3e}, decode steps "
          f"{err32[1:].min().item():.3e}-{err32[1:].max().item():.3e}; "
          f"tol {F32_LOGIT_TOL}); argmax agrees in "
          f"{agree(logits['kernels f32'], truth).item():.1%}", flush=True)
    print(f"[main]   bf16 control, bf16 kernels vs f32 plain: "
          f"{control.max().item():.3e} (min over steps "
          f"{control.min().item():.3e}; must exceed {F32_LOGIT_TOL})",
          flush=True)
    print(f"[main]   bf16 vs f32 plain: kernel path {err16_k.max().item():.3e},"
          f" plain path {err16_p.max().item():.3e} (ratio "
          f"{(err16_k.max() / err16_p.max()).item():.3f}, tol "
          f"{BF16_ERR_RATIO}); bf16 kernels vs bf16 plain "
          f"{err16.max().item():.3e} (prefill {err16[0].item():.3e}), argmax "
          f"agrees in {agree(logits['kernels'], logits['plain']).item():.1%}",
          flush=True)
    print(f"[main]   the kernel path's replay reproduces serve_batch's greedy "
          f"tokens in {replay:.1%} of {N_REQUESTS * NEW_TOKENS}", flush=True)
    for label in ("kernels", "plain"):
        print(f"[main] {label} path: prefill {prefill_s[label]:.4f} s "
              f"({B * S / prefill_s[label]:.0f} prompt tokens/s), decode "
              f"{decode_ms[label]:.3f} ms/step ({B * 1e3 / decode_ms[label]:.1f} "
              f"tokens/s at batch {B})  [{card}]", flush=True)
    check(err32.max().item() < F32_LOGIT_TOL,
          f"f32 kernel path logits differ: {err32.tolist()}")
    check(control.min().item() > F32_LOGIT_TOL,
          f"the f32 tolerance does not tell bf16 apart: {control.tolist()}")
    check((err16_k.max() / err16_p.max()).item() < BF16_ERR_RATIO,
          f"bf16 kernel path further from f32 than the plain path: "
          f"{err16_k.tolist()} vs {err16_p.tolist()}")
    check(replay == 1.0, f"replay of the kernel path gives other tokens "
          f"({replay:.1%})")
    del logits, truth

    # ------------------------------------ 6. where a step's device time goes
    from torch.profiler import ProfilerActivity, profile

    def breakdown(label, fn, step_ms):
        """Device time by kernel over one call of fn, and the device's idle
        share of the same call timed without the profiler (step_ms)."""
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        # device-side events only (kernels, copies): CPU ops would count twice
        rows = [(e.key, e.self_device_time_total / 1e3, e.count)
                for e in prof.key_averages()
                if str(getattr(e, "device_type", "")).endswith("CUDA")
                and e.self_device_time_total > 0]
        rows.sort(key=lambda r: -r[1])
        busy_ms = sum(r[1] for r in rows)
        print(f"[profile] {label}: device busy {busy_ms:.3f} ms of "
              f"{step_ms:.3f} ms timed without the profiler "
              f"({1 - busy_ms / step_ms:.1%} idle)  [{card}]", flush=True)
        for key, ms, n in rows[:8]:
            print(f"[profile]   {ms:9.3f} ms {n:5d}x  {key[:80]}")
        return rows

    batch = {"tokens": tokens[:, :S].contiguous(),
             "positions": _positions(cfg, B, S, device=dev)}
    prefill = make_prefill_step(cfg)
    rows = {"prefill": breakdown("one prefill (kernel path)",
                                 lambda: prefill(params, batch),
                                 prefill_s["kernels"] * 1e3)}
    lg, cache = prefill(params, batch)
    cache = pad_cache(cache, cfg, S_cache)
    step = make_decode_step(cfg)
    db = {"tokens": sample(lg, None, 0.0, cfg.vocab_size),
          "positions": _positions(cfg, B, 1, start=S, device=dev)}
    rows["decode step"] = breakdown("one decode step (kernel path)",
                                    lambda: step(params, db, cache),
                                    decode_ms["kernels"])
    # kernel times on the main path, from the device's own clock: the decode
    # rows' RMSNorm has no other true time (see phase 4)
    for where, key, what, nbytes in (
            ("prefill", "rmsnorm_kernel", f"fused_rmsnorm ({B * S}, {d})",
             results["fused_rmsnorm"]["bytes"]),
            ("decode step", "rmsnorm_kernel", f"fused_rmsnorm ({B}, {d})",
             2 * (2 * B * d + d)),
            ("decode step", "decode_fwd",
             f"decode_attention (B {B}, valid {S + 1})",
             results["decode_attention"]["bytes"])):
        hits = [(ms, n) for k, ms, n in rows[where] if key in k]
        check(len(hits) == 1, f"no single {key} row in the {where} profile")
        ms, n = hits[0]
        print(f"[time] {what} bf16 in the {where}: {ms / n:.5f} ms per "
              f"launch (profiler device time, {n} launches), bound "
              f"{nbytes / PEAK_BYTES_PER_S * 1e3:.5f} ms (bytes)  [{card}]",
              flush=True)

    # ----------------------------------------------------------------- result
    print(f"[device] {card}")
    summary = []
    for name, route, source, replaces in (
            ("flash_attention", "cuda",
             "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention/flash_attention.py:26"),
            ("decode_attention", "cuda",
             "src/repro_torch/kernels/decode_attention/csrc/decode_attention.cu",
             "src/repro/kernels/decode_attention/decode_attention.py:23"),
            ("fused_rmsnorm", "triton",
             "src/repro_torch/kernels/fused_rmsnorm/fused_rmsnorm.py",
             "src/repro/kernels/fused_rmsnorm/fused_rmsnorm.py:13")):
        r = results[name]
        summary.append({"name": name, "route": route, "source": source,
                        "replaces": replaces, "launches": r["launches"],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))


def teacher_forced(torch, c, params, tokens, S, S_cache, dev):
    """Prefill on tokens[:, :S], then decode feeding tokens[:, S + t] at step
    t, as generate does with its own samples. Returns the prefill's seconds
    (after one warm-up call), the decode loop's ms per step, and the logits of
    every step as (steps, B, padded vocab) f32."""
    from repro_torch.distributed.serve_step import (make_decode_step,
                                                    make_prefill_step,
                                                    pad_cache)
    from repro_torch.launch.serve import _positions
    B, steps = tokens.shape[0], tokens.shape[1] - S
    batch = {"tokens": tokens[:, :S].contiguous(),
             "positions": _positions(c, B, S, device=dev)}
    prefill, decode = make_prefill_step(c), make_decode_step(c)
    prefill(params, batch)                               # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lg, cache = prefill(params, batch)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    out = torch.empty((steps, B, lg.shape[-1]), dtype=torch.float32, device=dev)
    out[0] = lg[:, 0]
    cache = pad_cache(cache, c, S_cache)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(steps - 1):
        db = {"tokens": tokens[:, S + t:S + t + 1],
              "positions": _positions(c, B, 1, start=S + t, device=dev)}
        lg, cache = decode(params, db, cache)
        out[t + 1] = lg[:, 0]
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / (steps - 1)
    return prefill_s, decode_ms, out


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    main()
