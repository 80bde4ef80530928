"""Host time a call of each kernel wrapper at a decode step's shapes, for
the checkout named on the command line (its ``src/repro_torch``, its
kernels built into its own ``build/kernels``), as ``chip_smoke.py`` phase 4
reads it: the median of 5 rounds of 200 calls, the card synchronized
between rounds. Decode attention at chatglm3-6b's decode step (B 8, cache
1,056, valid 1,025, 32 heads over 2, hd 128), RMSNorm 8 x 4,096 and gated
8 x 7,168, and flash attention and the SSD scan at small shapes whose
device time stays below their host time. Compare two checkouts within one
call, in the order A, B, B, A:

  python scripts/wrapper_host_time.py CHECKOUT
"""
import os
import statistics
import sys
import time

import torch

CHECKOUT = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else ".")
sys.path.insert(0, os.path.join(CHECKOUT, "src"))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.decode_attention import ops as da_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.fused_rmsnorm import ops as rn_ops  # noqa: E402
from repro_torch.kernels.ssd import ops as ssd_ops  # noqa: E402


def host_us(fn, rounds=5, calls=200):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(times)


def main():
    _build.build_all()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16

    def randn(*shape, dtype=bf):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32).to(dtype)

    q, k, v = randn(8, 1, 32, 128), randn(8, 1056, 2, 128), \
        randn(8, 1056, 2, 128)
    vl = torch.full((), 1025, dtype=torch.int32, device=dev)
    x, w = randn(8, 4096), randn(4096) * 0.1
    y, wg, z = randn(8, 7168), randn(7168) * 0.1, randn(8, 7168)
    fq, fk, fv = randn(1, 128, 32, 128), randn(1, 128, 2, 128), \
        randn(1, 128, 2, 128)
    sx = randn(1, 128, 8, 64)
    sdt = torch.nn.functional.softplus(randn(1, 128, 8, dtype=torch.float32))
    sA = -torch.ones(8, device=dev)
    sB, sC = randn(1, 128, 1, 64), randn(1, 128, 1, 64)
    with torch.no_grad():
        for label, fn in (
                ("decode_attention wrapper (8 x 1,056 cache)",
                 lambda: da_ops.decode_attention(q, k, v, vl, scale=0.088)),
                ("fused_rmsnorm wrapper (8 x 4,096)",
                 lambda: rn_ops.rmsnorm(x, w, eps=1e-5)),
                ("gated fused_rmsnorm wrapper (8 x 7,168)",
                 lambda: rn_ops.rmsnorm(y, wg, eps=1e-5, gate=z)),
                ("flash_attention wrapper (1 x 128, 32 heads)",
                 lambda: fa_ops.flash_attention(fq, fk, fv, scale=0.088)),
                ("ssd wrapper (1 x 128, 8 heads)",
                 lambda: ssd_ops.ssd(sx, sdt, sA, sB, sC, chunk=128,
                                     use_pallas=True))):
            print(f"[host] {CHECKOUT}: {label}: {host_us(fn):.2f} us of host "
                  f"time a call (median of 5 x 200)", flush=True)


if __name__ == "__main__":
    main()
