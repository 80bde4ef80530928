"""Affine-in-depth cost model of the dry-run, the port's copy of the JAX
package's ``repro/launch/costmodel.py``.

Layer stacks are structurally homogeneous, so every cost is affine in the
stack depth: cost(L) = fixed + L * per_layer. JAX needs the fit because
XLA's ``cost_analysis()`` ignores ``while``-loop trip counts of a scanned
module. The port has no scan (its layers are a Python loop), so its dry-run
counts the full depth directly; the fit gives the per-layer and fixed split
of a profile (``opprof.profile_cell``) and a check that the full-depth count
is what two probe depths predict.

Hybrid (zamba2) is affine in the number of (6 ssm + shared-attn) groups; the
3-layer ssm tail is counted as 0.5 group, which over-counts it by half a
shared block (the JAX package's documented approximation).
"""
from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.configs.base import ModelConfig


def probe_depths(cfg: ModelConfig) -> Tuple[Dict, Dict, float, float, float]:
    """Returns (overrides_a, overrides_b, n_a, n_b, n_target) where n_* count
    the varied stack units (layers or hybrid groups)."""
    if cfg.family == "hybrid":
        ae = cfg.attn_every
        g = cfg.num_layers // ae
        tail = cfg.num_layers - g * ae
        n_target = g + tail / ae
        return ({"num_layers": ae, "scan_layers": False},
                {"num_layers": 2 * ae, "scan_layers": False},
                1.0, 2.0, n_target)
    fd = cfg.first_dense_layers
    la, lb = fd + 2, fd + 4
    n_target = cfg.num_layers - fd
    return ({"num_layers": la, "scan_layers": False},
            {"num_layers": lb, "scan_layers": False},
            2.0, 4.0, float(n_target))


def extrapolate(cost_a: Dict[str, float], cost_b: Dict[str, float],
                n_a: float, n_b: float, n_target: float) -> Dict[str, float]:
    """Per-key affine extrapolation (keys missing in either side are kept)."""
    out = {}
    keys = set(cost_a) | set(cost_b)
    for k in keys:
        ca = float(cost_a.get(k, 0.0) or 0.0)
        cb = float(cost_b.get(k, 0.0) or 0.0)
        slope = (cb - ca) / (n_b - n_a)
        out[k] = max(0.0, ca + (n_target - n_a) * slope)
    return out
