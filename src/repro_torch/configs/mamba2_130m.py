"""mamba2-130m — SSD (state-space duality) LM. [arXiv:2405.21060]

24L, d_model=768, attention-free, vocab=50280, ssm_state=128,
head_dim=64, expand=2 -> d_inner=1536, 24 SSD heads.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    vocab_size=50280,
    d_ff=0,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_chunk=256,
    ssm_groups=1,
    tie_embeddings=True,
    rope_kind="none",
    pos_embed="none",
)
