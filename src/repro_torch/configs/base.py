"""Model configuration dataclass of the PyTorch port.

The port keeps its own copy of the JAX package's ``ModelConfig`` so that it
imports nothing of ``repro``. Every field, property and ``reduced()`` is the
same, with one deliberate difference: ``use_pallas`` defaults to ``True`` and
means "route the hot ops through the hand-written Hopper kernels"
(flash attention in prefill, decode attention in every decode step, the
SSD scan in every Mamba2 prefill, RMSNorm everywhere). The kernels' wrappers
run their plain PyTorch version for CPU tensors, so the flag only changes
what runs on a CUDA device. ``use_pallas=False`` selects the plain attention
path (``attn_weights_core``), the plain ``ssd_chunked`` and the plain norm,
exactly as it selects XLA in the JAX package.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class ModelConfig:
    # --- identity -----------------------------------------------------------
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    # --- trunk dimensions ----------------------------------------------------
    num_layers: int
    d_model: int
    vocab_size: int
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    # --- activations / norms --------------------------------------------------
    act: str = "silu"                # silu | gelu  (gated: SwiGLU / GeGLU)
    gated_mlp: bool = True           # False: plain 2-matrix MLP (musicgen)
    qkv_bias: bool = False           # qwen2-vl uses QKV biases
    norm_eps: float = 1e-5
    gemma_norm: bool = False         # RMSNorm scale = (1 + w); embed *= sqrt(d)
    pos_embed: str = "rope"          # rope | sinusoidal | none
    # --- positional encoding --------------------------------------------------
    rope_kind: str = "full"          # full | partial | mrope | none
    rope_theta: float = 10000.0
    rotary_pct: float = 1.0          # partial RoPE fraction of head_dim
    mrope_sections: Tuple[int, ...] = ()   # qwen2-vl (t, h, w) half-dim sections
    # --- MoE -------------------------------------------------------------------
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    first_dense_layers: int = 0      # deepseek: leading dense layers
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    moe_dispatch_constraint: bool = False   # force (G:data, E:model) layout
    # --- MLA (deepseek) ---------------------------------------------------------
    use_mla: bool = False
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # --- SSM (mamba2 / zamba2) ---------------------------------------------------
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 256
    ssm_groups: int = 1
    ssd_precision: str = "highest"   # "mixed": bf16 SSD matmuls (perf knob)
    # --- hybrid (zamba2) ----------------------------------------------------------
    attn_every: int = 0              # shared attn+mlp block applied every N ssm layers
    # --- frontend -------------------------------------------------------------------
    input_mode: str = "tokens"       # tokens | embeddings (audio / vlm stubs)
    # --- numerics / impl ---------------------------------------------------------------
    dtype: str = "bfloat16"
    tie_embeddings: bool = False
    vocab_pad_multiple: int = 256
    use_pallas: bool = True          # GPU: route hot ops through the Hopper kernels
    vocab_tp: bool = True            # shard embed/unembed over model axis
    remat: str = "full"              # none | full | dots  (activation ckpt policy)
    scan_layers: bool = True

    # ------------------------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def d_head_total(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim if self.ssm_head_dim else 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic archs run the long_500k cell (SSM + hybrids)."""
        return self.family in ("ssm", "hybrid")

    def num_params(self) -> int:
        """Analytic parameter count (true vocab, not padded)."""
        d, v = self.d_model, self.vocab_size
        n = v * d                                   # embed
        if not self.tie_embeddings:
            n += v * d                              # unembed
        per_attn = 0
        if self.num_heads:
            if self.use_mla:
                qk_dim = self.qk_nope_head_dim + self.qk_rope_head_dim
                per_attn = (d * self.num_heads * qk_dim            # W_q
                            + d * (self.kv_lora_rank + self.qk_rope_head_dim)
                            + self.kv_lora_rank * self.num_heads
                            * (self.qk_nope_head_dim + self.v_head_dim)
                            + self.num_heads * self.v_head_dim * d)
            else:
                per_attn = (d * self.num_heads * self.head_dim
                            + 2 * d * self.num_kv_heads * self.head_dim
                            + self.num_heads * self.head_dim * d)
        def mlp(ff: int) -> int:
            return (3 if self.gated_mlp else 2) * d * ff   # gated adds w_gate
        per_moe = 0
        if self.num_experts:
            per_moe = (self.num_experts * mlp(self.d_ff_expert)
                       + self.num_shared_experts * mlp(self.d_ff_expert)
                       + d * self.num_experts)      # router
        per_ssm = 0
        if self.ssm_state:
            di, ns, g = self.ssm_d_inner, self.ssm_state, self.ssm_groups
            conv_dim = di + 2 * g * ns
            per_ssm = (d * (2 * di + 2 * g * ns + self.ssm_heads)  # in_proj
                       + conv_dim * self.ssm_conv                  # conv1d
                       + 3 * self.ssm_heads                        # A, D, dt_bias
                       + di                                        # gated norm
                       + di * d)                                   # out_proj
        if self.family == "ssm":
            n += self.num_layers * (per_ssm + d)    # + input norm
        elif self.family == "hybrid":
            n += self.num_layers * (per_ssm + d)
            n_shared = 1
            n += n_shared * (per_attn + mlp(self.d_ff) + 2 * d)
        elif self.family == "moe":
            dense_l = self.first_dense_layers
            n += dense_l * (per_attn + mlp(self.d_ff) + 2 * d)
            n += (self.num_layers - dense_l) * (per_attn + per_moe + 2 * d)
        else:
            n += self.num_layers * (per_attn + mlp(self.d_ff) + 2 * d)
        n += d                                      # final norm
        return n

    def num_active_params(self) -> int:
        """Active-per-token params (MoE: only routed top_k + shared)."""
        if not self.num_experts:
            return self.num_params()
        full = self.num_params()
        d = self.d_model
        moe_layers = self.num_layers - self.first_dense_layers
        inactive = (self.num_experts - self.top_k) * 3 * d * self.d_ff_expert
        return full - moe_layers * inactive

    def reduced(self, **overrides) -> "ModelConfig":
        """A tiny same-family variant for CPU smoke tests."""
        base = dict(
            num_layers=2 if self.attn_every == 0 else max(2, self.attn_every),
            d_model=64,
            vocab_size=256,
            vocab_pad_multiple=32,
        )
        if self.num_heads:
            base.update(num_heads=4, num_kv_heads=min(4, max(1, self.num_kv_heads)),
                        head_dim=16)
        if self.d_ff:
            base.update(d_ff=128)
        if self.use_mla:
            base.update(kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
                        v_head_dim=16, num_heads=4, num_kv_heads=4, head_dim=0)
        if self.num_experts:
            base.update(num_experts=4, top_k=2, d_ff_expert=64,
                        num_shared_experts=min(1, self.num_shared_experts),
                        first_dense_layers=min(1, self.first_dense_layers))
        if self.ssm_state:
            base.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=32)
        if self.mrope_sections:
            base.update(mrope_sections=(2, 3, 3))
        if self.attn_every:
            base.update(num_layers=4, attn_every=2)
        base.update(overrides)
        return dataclasses.replace(self, **base)


@dataclass(frozen=True)
class ShapeConfig:
    """An assigned input-shape cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


SHAPES = {
    "train_4k":    ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k":  ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k":   ShapeConfig("long_500k", 524288, 1, "decode"),
}


def cell_is_runnable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Spec rules: long_500k only for sub-quadratic archs."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, ("skip: long_500k requires sub-quadratic attention; "
                       f"{cfg.name} is pure full-attention ({cfg.family})")
    return True, ""
