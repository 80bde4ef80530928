"""qwen2-vl-7b — M-RoPE, dynamic-resolution VLM backbone. [arXiv:2409.12191; hf]

28L, d_model=3584, 28H (GQA kv=4), head_dim=128, d_ff=18944, vocab=152064.
M-RoPE sections (t, h, w) = (16, 24, 24) over the 64 half-dim frequencies.
Vision frontend is a STUB: input_specs() provides patch embeddings plus the
3-stream M-RoPE position ids.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    rope_kind="mrope",
    mrope_sections=(16, 24, 24),
    rope_theta=1000000.0,
    qkv_bias=True,
    input_mode="embeddings",
)
