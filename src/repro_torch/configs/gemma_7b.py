"""gemma-7b — GeGLU, wide heads. [arXiv:2403.08295]

28L, d_model=3072, 16H (kv=16), head_dim=256 (q-dim 4096 != d_model),
d_ff=24576 (GeGLU), vocab=256000, tied embeddings, (1+w)-RMSNorm,
embeddings scaled by sqrt(d_model).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    num_layers=28,
    d_model=3072,
    num_heads=16,
    num_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256000,
    act="gelu",
    gemma_norm=True,
    tie_embeddings=True,
    rope_theta=10000.0,
    norm_eps=1e-6,
)
