"""The decoder-LM trunk of the port: the dense code path.

  * dense / audio / vlm : [norm -> attn, norm -> mlp] x L over stacked params

The MoE, SSM and hybrid families join with their slices; until then
``init_params``, ``init_cache``, ``forward`` and ``decode`` raise
``NotImplementedError`` for them.

Layers are stacked (leading L dim) as in the JAX package, so weights cross
the bridge unchanged. JAX's ``lax.scan`` becomes a Python loop over
leading-dim slices (views, no copies). ``cfg.remat`` and ``cfg.scan_layers``
are read and ignored: this serving slice keeps no activations for a backward
pass, and training will bring ``torch.utils.checkpoint`` for ``remat``.

Modes: ``forward(..., mode='train')`` full logits; ``mode='prefill'`` last-token
logits + filled caches; ``decode(...)`` single-token step against caches,
which writes the caches in place.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import layers as L

Params = Dict[str, Any]

_DENSE_FAMILIES = ("dense", "audio", "vlm")
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _require_dense(cfg: ModelConfig) -> None:
    if cfg.family not in _DENSE_FAMILIES or cfg.use_mla:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet (the port "
            f"runs the dense/audio/vlm path)")


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def _layer(tree, i: int):
    """Slice i of every stacked leaf (views)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


# ================================================================ block: dense
def init_dense_block(gen, cfg: ModelConfig, dtype, device, lead=()):
    return {"norm1": L.init_rmsnorm(cfg.d_model, dtype, device, lead),
            "norm2": L.init_rmsnorm(cfg.d_model, dtype, device, lead),
            "attn": attn.init_gqa(gen, cfg, dtype, device, lead),
            "mlp": L.init_mlp(gen, cfg, cfg.d_ff, dtype, device, lead)}


def dense_block_full(p, x, cfg: ModelConfig, positions, *, return_kv: bool):
    h = L.rmsnorm(p["norm1"], x, cfg.norm_eps, cfg.use_pallas)
    h, kv = attn.gqa_full(p["attn"], h, cfg, positions, return_kv=return_kv)
    x = x + h
    h = L.rmsnorm(p["norm2"], x, cfg.norm_eps, cfg.use_pallas)
    return x + L.mlp(p["mlp"], h, cfg), kv


def dense_block_decode(p, x, cfg: ModelConfig, positions, cache, index):
    h = L.rmsnorm(p["norm1"], x, cfg.norm_eps, cfg.use_pallas)
    h, ck, cv = attn.gqa_decode(p["attn"], h, cfg, positions,
                                cache["k"], cache["v"], index)
    x = x + h
    h = L.rmsnorm(p["norm2"], x, cfg.norm_eps, cfg.use_pallas)
    return x + L.mlp(p["mlp"], h, cfg), {"k": ck, "v": cv}


# ====================================================================== params
def init_params(cfg: ModelConfig, *, seed: int = 0, device="cuda") -> Params:
    """Random weights with the JAX package's distributions, drawn from one
    ``torch.Generator`` seeded with ``seed`` and created on ``device``.
    (The bits differ from JAX's: tests carry JAX's weights over the bridge.)"""
    _require_dense(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dtype = torch_dtype(cfg)
    params: Params = {
        "embed": L.init_embedding(gen, cfg.padded_vocab, cfg.d_model, dtype,
                                  dev),
        "final_norm": L.init_rmsnorm(cfg.d_model, dtype, dev),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = L.init_linear(gen, cfg.d_model, cfg.padded_vocab,
                                          dtype, dev)
    params["layers"] = init_dense_block(gen, cfg, dtype, dev,
                                        lead=(cfg.num_layers,))
    return params


# ======================================================================= cache
def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device="cuda") -> Dict[str, Any]:
    """Preallocated decoding caches (stacked over layers), plus ``index``
    (a 0-dim int32 tensor on the device, as in JAX)."""
    _require_dense(cfg)
    dev = resolve_device(device)
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    dtype = torch_dtype(cfg)
    return {"index": torch.zeros((), dtype=torch.int32, device=dev),
            "layers": {"k": torch.zeros(shape, dtype=dtype, device=dev),
                       "v": torch.zeros(shape, dtype=dtype, device=dev)}}


# ===================================================================== forward
def _inputs_to_h(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]):
    if cfg.input_mode == "embeddings" and "embeds" in batch:
        x = batch["embeds"].to(torch_dtype(cfg))
    else:
        x = L.embed(params["embed"], batch["tokens"], cfg)
    if cfg.pos_embed == "sinusoidal":
        x = x + L.sinusoidal_pos_embed(batch["positions"], cfg.d_model, x.dtype)
    return x


def _logits(params, cfg: ModelConfig, x):
    if cfg.tie_embeddings:
        return L.unembed(params["embed"], x, cfg)
    return L.unembed(params["unembed"], x, cfg)


def forward(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            *, mode: str = "train"
            ) -> Tuple[torch.Tensor, torch.Tensor, Optional[Dict[str, Any]]]:
    """Full-sequence forward.

    mode='train':   returns (logits (B,S,V), aux_loss, None)
    mode='prefill': returns (last-token logits (B,1,V), aux_loss, cache)
    """
    if mode not in ("train", "prefill"):
        raise ValueError(f"mode must be 'train' or 'prefill', got {mode!r}")
    _require_dense(cfg)
    prefill = mode == "prefill"
    positions = batch["positions"]
    x = _inputs_to_h(params, cfg, batch)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    caches: Dict[str, Any] = {}

    ks, vs = [], []
    for i in range(cfg.num_layers):
        x, kv = dense_block_full(_layer(params["layers"], i), x, cfg, positions,
                                 return_kv=prefill)
        if prefill:
            ks.append(kv[0])
            vs.append(kv[1])
    if prefill:
        caches["layers"] = _kv_dict(cfg, (torch.stack(ks), torch.stack(vs)))

    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps, cfg.use_pallas)
    if prefill:
        x = x[:, -1:, :]
        caches["index"] = torch.full((), positions.shape[-1],
                                     dtype=torch.int32, device=x.device)
    logits = _logits(params, cfg, x)
    return logits, aux_total, (caches if prefill else None)


def _kv_dict(cfg, kvs):
    return {"k": kvs[0], "v": kvs[1]}


# ====================================================================== decode
def decode(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
           cache: Dict[str, Any]) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step. batch: tokens (B,1) or embeds (B,1,d) + positions.

    Writes the new K/V rows into ``cache``'s tensors in place and returns
    (logits (B,1,V), new_cache), where new_cache shares those tensors and
    carries ``index + 1``. Nothing here waits on the device."""
    _require_dense(cfg)
    index = cache["index"]
    positions = batch["positions"]
    x = _inputs_to_h(params, cfg, batch)
    new_cache: Dict[str, Any] = {"index": index + 1}
    layer_caches = cache["layers"]
    for i in range(cfg.num_layers):
        x, _ = dense_block_decode(_layer(params["layers"], i), x, cfg,
                                  positions, _layer(layer_caches, i), index)
    new_cache["layers"] = layer_caches
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps, cfg.use_pallas)
    return _logits(params, cfg, x), new_cache
