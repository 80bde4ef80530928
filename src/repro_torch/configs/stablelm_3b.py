"""stablelm-3b — dense, partial rotary. [hf:stabilityai/stablelm-2-1_6b family]

32L, d_model=2560, 32H (kv=32, MHA), head_dim=80, d_ff=6912, vocab=50304,
rotary_pct=0.25 (StableLM-family convention).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b",
    family="dense",
    num_layers=32,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=6912,
    vocab_size=50304,
    rope_kind="partial",
    rotary_pct=0.25,
    rope_theta=10000.0,
)
