"""chatglm3-6b — partial ("2d") RoPE, extreme GQA. [arXiv:2406.12793; hf]

28L, d_model=4096, 32H (GQA kv=2), d_ff=13696, vocab=65024,
rotary applied to half of head_dim (rotary_pct=0.5).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    num_layers=28,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab_size=65024,
    rope_kind="partial",
    rotary_pct=0.5,
    rope_theta=10000.0,
)
