"""deepseek-v2-lite-16b — MLA + fine-grained MoE. [arXiv:2405.04434; hf]

27L, d_model=2048, 16H, MLA kv_lora=512 (qk_nope=128, qk_rope=64, v=128),
64 routed experts top-6 + 2 shared, expert d_ff=1408, first layer dense
(d_ff=10944), vocab=102400.

Note: the assignment line says "2 shared+160 routed"; 160 routed is the
DeepSeek-V2 *236B* config — V2-Lite (16B, as assigned) has 64 routed experts
[hf:deepseek-ai/DeepSeek-V2-Lite]. We follow the primary "MoE 64e top-6" spec.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=0,                  # MLA defines per-head dims below
    d_ff=10944,                  # dense (first) layer FFN
    d_ff_expert=1408,
    vocab_size=102400,
    num_experts=64,
    top_k=6,
    num_shared_experts=2,
    first_dense_layers=1,
    use_mla=True,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    rope_theta=10000.0,
)
