"""Roofline terms of the port, in NVIDIA H100 terms: the counterpart of the
JAX package's ``repro/launch/roofline.py`` (whose TPU constants do not carry
over).

Peaks, from NVIDIA's H100 SXM5 80 GB data sheet (dense, no sparsity, at the
card's full 700 W power limit; a card set below it runs slower):
    989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s fp32 outside them;
    3.35 TB/s of HBM3;
    NVLink 4: 450 GB/s per card per direction (900 GB/s both ways), for a
    mesh axis whose ranks stay inside one 8-card node;
    InfiniBand NDR: 400 Gb/s = 50 GB/s per card, for an axis that spans
    nodes.
Ranks are laid out row-major over the mesh (the last axis the fastest), 8
to a node. An axis stays inside a node when its size times the sizes of
the axes after it is at most 8. So on the production meshes every axis
spans nodes and gets the InfiniBand term: on 16 x 16 (32 nodes of 8) the
16-wide ``model`` axis spans two nodes and ``data`` strides across 16; on
2 x 16 x 16 ``pod`` spans the two halves as well.

The dry-run's step is the per-device program, so its FLOPs and bytes are
per device:
    compute    = flops_dev / peak
    memory     = bytes_dev / hbm_bw
    collective = collective_bytes_dev / link_bw
collective_bytes sums the result bytes of every collective the step runs
(the ring-traffic approximation of the JAX package).

The kernel bounds of ``chip_smoke.py`` use the same terms: the least time
the card could take for a kernel's work is its bytes over the HBM rate or
its operations over the peak rate of their type, whichever is larger.
"""
from __future__ import annotations

import math
from dataclasses import asdict, dataclass
from typing import Dict, Optional, Sequence, Tuple

from repro_torch.configs.base import ModelConfig, ShapeConfig

PEAK_FLOPS = 989e12                      # bf16 FLOP/s per card (data sheet)
PEAK_FLOPS_BY_DTYPE = {"bfloat16": PEAK_FLOPS, "float32": 67e12}
HBM_BW = 3.35e12                         # B/s per card (data sheet)
NVLINK_BW = 450e9                        # B/s per card per direction
IB_BW = 50e9                             # B/s per card (NDR, 400 Gb/s)
CARDS_PER_NODE = 8


def link_bandwidth(mesh_shape: Dict[str, int], axes: Sequence[str]) -> float:
    """The link rate of a collective over ``axes`` of a mesh (axis name ->
    size, in axis order): NVLink when every group of those axes stays in
    one node, InfiniBand otherwise (see the module docstring)."""
    names = list(mesh_shape)
    live = [a for a in axes if mesh_shape[a] > 1]
    if not live:
        return NVLINK_BW
    slowest = min(names.index(a) for a in live)
    span = math.prod(mesh_shape[a] for a in names[slowest:])
    return NVLINK_BW if span <= CARDS_PER_NODE else IB_BW


def kernel_bound(flops: float, nbytes: float, dtype: str
                 ) -> Tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time the card could take
    for a kernel's work, its bytes over the HBM rate or its operations over
    the peak rate of their type, whichever is larger."""
    t_bytes = nbytes / HBM_BW * 1e3
    t_ops = flops / PEAK_FLOPS_BY_DTYPE[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def add_bound(r: Dict) -> None:
    """Set ``bound_ms`` and ``bound_by`` of a kernel record holding its
    ``flops``, ``bytes`` and ``dtype``."""
    r["bound_ms"], r["bound_by"] = kernel_bound(r["flops"], r["bytes"],
                                                r["dtype"])


def ssd_work(B, S, H, G, P, N, chunk, itemsize):
    """Operations and bytes one SSD scan needs: the causal (C B^T) and
    (att x) products over the rows each chunk holds, the carried state's
    product and update; x read and y written once, dt, A, B/C and the final
    f32 state."""
    L = min(chunk, S)
    flops = 0
    for t0 in range(0, S, L):
        n = min(L, S - t0)
        flops += n * (n + 1) * (N + P) + 4 * n * P * N
    flops *= B * H
    nbytes = (2 * B * S * H * P * itemsize + 4 * B * S * H + 4 * H
              + 2 * B * S * G * N * itemsize + 4 * B * H * P * N)
    return flops, nbytes


@dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    n_devices: int
    flops_dev: float
    bytes_dev: float
    collective_bytes_dev: float
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float
    useful_ratio: float                 # MODEL_FLOPS / (step flops global)
    step_time_s: float                  # max of the three terms
    hw_frac: float                      # roofline fraction achieved (model
                                        # flops / (step_time * cards * peak))
    peak_bytes_dev: Optional[float] = None

    def to_dict(self):
        return asdict(self)


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Useful flops per step: 6*N_active*D for train, 2*N_active*D forward
    (+ attention-cache term for decode)."""
    D = shape.global_batch * shape.seq_len
    N = cfg.num_active_params()
    if shape.kind == "train":
        return 6.0 * N * D
    if shape.kind == "prefill":
        attn = 0.0
        if cfg.num_heads:
            qk_dim = ((cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
                      if cfg.use_mla else cfg.head_dim)
            n_attn = (cfg.num_layers if cfg.family != "hybrid"
                      else cfg.num_layers // max(1, cfg.attn_every))
            # causal: S^2/2 per pair of matmuls (QK^T, AV)
            attn = (2.0 * 2.0 * cfg.num_heads * qk_dim
                    * shape.seq_len ** 2 / 2 * shape.global_batch * n_attn)
        return 2.0 * N * D + attn
    # decode: one token per sequence + attention against the cache
    toks = shape.global_batch
    attn = 0.0
    if cfg.num_heads:
        qk_dim = ((cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
                  if cfg.use_mla else cfg.head_dim)
        n_attn = (cfg.num_layers if cfg.family != "hybrid"
                  else cfg.num_layers // max(1, cfg.attn_every))
        attn = 2.0 * 2.0 * cfg.num_heads * qk_dim * shape.seq_len * toks * n_attn
    ssm = 0.0
    if cfg.ssm_state:
        # state update + readout: 2 * H*P*N madds each
        ssm = (2.0 * 2.0 * cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state
               * toks * cfg.num_layers)
    return 2.0 * N * toks + attn + ssm


def derive(arch: str, shape_cfg: ShapeConfig, cfg: ModelConfig, mesh_name: str,
           n_devices: int, cost: Dict[str, float], coll: Dict[str, int],
           peak_bytes_dev: Optional[float] = None,
           link_bw: float = IB_BW) -> RooflineTerms:
    """The three terms of one cell from its per-device costs; ``link_bw``
    is the rate of the links its collectives cross (``link_bandwidth``)."""
    flops_dev = float(cost.get("flops", 0.0))
    bytes_dev = float(cost.get("bytes accessed", 0.0))
    coll_dev = float(coll.get("total", 0))
    compute_s = flops_dev / PEAK_FLOPS
    memory_s = bytes_dev / HBM_BW
    collective_s = coll_dev / link_bw
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    mf = model_flops(cfg, shape_cfg)
    step_global = flops_dev * n_devices
    step = max(compute_s, memory_s, collective_s)
    return RooflineTerms(
        arch=arch, shape=shape_cfg.name, mesh=mesh_name, n_devices=n_devices,
        flops_dev=flops_dev, bytes_dev=bytes_dev,
        collective_bytes_dev=coll_dev,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        bottleneck=bottleneck, model_flops=mf,
        useful_ratio=(mf / step_global if step_global else 0.0),
        step_time_s=step,
        hw_frac=(mf / (step * n_devices * PEAK_FLOPS) if step else 0.0),
        peak_bytes_dev=peak_bytes_dev)
