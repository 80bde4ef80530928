"""musicgen-medium — decoder-only over EnCodec tokens. [arXiv:2306.05284; hf]

48L, d_model=1536, 24H (kv=24), d_ff=6144 (plain GELU MLP, not gated),
vocab=2048 (EnCodec codebook). Sinusoidal positions; the EnCodec frontend is a
STUB: input_specs() provides precomputed frame embeddings (B, S, d_model).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    act="gelu",
    gated_mlp=False,
    rope_kind="none",
    pos_embed="sinusoidal",
    input_mode="embeddings",
)
