"""phi3.5-moe-42b-a6.6b — 16 experts, top-2. [hf:microsoft/Phi-3.5-MoE-instruct]

32L, d_model=4096, 32H (GQA kv=8), expert d_ff=6400, vocab=32064.
Every layer is MoE (sparse MLP), no shared experts.

All 32 layers take 83.8 GB in bf16, more than one 80 GB card holds: the
card's main path serves it with ``num_layers=16`` (about 42 GB), every
width as published.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=6400,
    d_ff_expert=6400,
    vocab_size=32064,
    num_experts=16,
    top_k=2,
    num_shared_experts=0,
    rope_theta=10000.0,
)
