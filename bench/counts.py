"""The benchmark's yardstick arithmetic: the card's peaks, the model FLOPs
of a step, and the operations and bytes of a kernel launch, all computed
from shapes. Frozen copies of what the port's ``launch/roofline.py`` holds
(``PEAK_FLOPS``, ``HBM_BW``, ``kernel_bound``), kept here so that a change
to the program cannot move the yardstick. What a model's step counts is its
reference module's (``matmul_params``, ``attention_fwd_flops``).

Peaks are NVIDIA's H100 SXM5 80 GB data sheet figures, dense, at the full
700 W power limit: 989 TFLOP/s in bf16 on the tensor cores and 3.35 TB/s
of HBM3. A card set below 700 W runs slower; the harness prints the
card's power limit beside every share of these peaks.
"""
from __future__ import annotations

from typing import Dict, Tuple

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BW = 3.35e12
ITEMSIZE = {"bfloat16": 2, "float32": 4}


def causal_pairs(seq: int) -> int:
    """(query, key) pairs a causal mask keeps in a sequence of ``seq``."""
    return seq * (seq + 1) // 2


def forward_flops(ref, m: Dict, batch: int, seq: int) -> float:
    """Model FLOPs of one forward of ``batch`` sequences of ``seq``: 2 N T
    with N the parameters in products, and the attention term, each as the
    configuration's reference module ``ref`` counts its model."""
    return 2.0 * ref.matmul_params(m) * batch * seq + \
        ref.attention_fwd_flops(m, batch, seq)


def train_flops(ref, m: Dict, batch: int, seq: int) -> float:
    """Model FLOPs of one training step: 6 N T and three times the
    attention forward term. Recomputation is not counted."""
    return 6.0 * ref.matmul_params(m) * batch * seq + \
        3.0 * ref.attention_fwd_flops(m, batch, seq)


def flash_fwd_work(batch: int, seq: int, heads: int, kv_heads: int,
                   head_dim: int, dtype: str = "bfloat16"
                   ) -> Tuple[float, float]:
    """(operations, bytes) one causal flash-attention forward launch needs:
    the two products over the causal pairs; q, k and v read once and the
    output written once."""
    flops = 4.0 * batch * heads * head_dim * causal_pairs(seq)
    nbytes = (2 * heads + 2 * kv_heads) * batch * seq * head_dim * ITEMSIZE[
        dtype]
    return flops, float(nbytes)


def bound_s(flops: float, nbytes: float, dtype: str = "bfloat16") -> float:
    """The least time the card could take for this work: its bytes over
    the HBM rate or its operations over the peak rate, the larger."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BW)
