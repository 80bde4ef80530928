"""zamba2-7b — Mamba2 backbone + weight-shared attention blocks. [arXiv:2411.15242]

81 Mamba2 layers (d_model=3584, ssm_state=64, head_dim=64 -> 112 SSD heads)
with ONE weight-shared attention+MLP block (32H MHA, d_ff=14336) applied every
6 SSM layers: 13 groups and a tail of 3 SSM layers. Simplification vs. the
released model, as in the JAX package: one shared block, not two alternating
ones, and no per-invocation LoRA or concatenated embedding input.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_chunk=256,
    ssm_groups=1,
    attn_every=6,
    rope_theta=10000.0,
)
