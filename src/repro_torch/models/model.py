"""The decoder-LM trunk of the port, covering all ten architectures of the
JAX package: four families of layer stack.

  * dense / audio / vlm : [norm -> attn, norm -> mlp] x L over stacked params
  * moe                 : optional leading dense layers (``dense_layers``),
                          then [norm -> attn, norm -> moe] x L; attention is
                          GQA or DeepSeek's MLA (``cfg.use_mla``)
  * ssm (mamba2)        : [norm -> mamba2] x L
  * hybrid (zamba2)     : groups of ``attn_every`` mamba2 layers, each group
                          followed by ONE weight-shared attention+MLP block,
                          then the tail of leftover mamba2 layers

Layers are stacked (leading L dim; the hybrid's groups carry two leading
dims, (n_groups, attn_every)) as in the JAX package, so weights cross the
bridge unchanged. JAX's ``lax.scan`` becomes a Python loop over leading-dim
slices (views, no copies); ``cfg.scan_layers`` is read and ignored. The
forward takes the slices from ``torch.unbind``, whose backward stacks the
layers' gradients into the stacked leaf in one tensor (indexing would add a
full-size zero gradient per layer); ``decode`` indexes.

``cfg.remat`` is JAX's activation-checkpoint policy (``model._remat`` there),
applied to each layer body (the dense block, each Mamba2 block) and only
where a backward will run; the hybrid's shared block runs without it, as in
the reference:

  * ``"none"``: the plain loop; every activation is kept.
  * ``"full"``: ``jax.checkpoint`` -> ``torch.utils.checkpoint.checkpoint(
    ..., use_reentrant=False)``: a layer keeps only its input and reruns its
    forward in the backward pass (so its kernels launch twice a step).
  * ``"dots"``: ``jax.checkpoint_policies.dots_saveable`` -> selective
    activation checkpointing (``create_selective_checkpoint_contexts``)
    that saves the outputs of the matrix products (``aten.mm``,
    ``aten.addmm``, ``aten.bmm``, ``aten.matmul``) and recomputes the rest,
    the kernels included.

The serving path runs none of this: without a parameter that requires grad
the loop and its ops are the plain ones.

Tensor parallelism (the ``tp`` of ``forward`` in both modes and of
``decode``): under tp16 (the dense, MoE and hybrid stacks, the hybrid's
shared block too) each layer's weights are this rank's blocks, and the
layer's collectives (``distributed/tensor_parallel.py``) run inside its
remat region, so a recompute reruns its forward all-reduces, in the same
order on every rank. Under dp_all (the ssm family) the stack runs whole on
this rank's rows and only the vocabulary is split over the group. A
prefill returns, and a decode step writes, this rank's block of the caches
(``sharding.cache_pspec``; ``init_cache(..., mesh=)`` allocates one), and
the logits are this rank's vocab columns where ``cfg.vocab_tp``
(``tensor_parallel.gather_vocab`` makes them whole).

Sequence-parallel serving (the ``sp`` of a prefill and of ``decode``,
``tensor_parallel.SeqPar``): every rank runs the prefill of the whole
prompt and keeps its block of each layer's K/V, positions [r * rows, (r +
1) * rows) of the cache, zero past the prompt; a decode step attends over
the block and combines the partials over the data group
(``attention.gqa_decode``). A split prefill is not implemented.

Modes: ``forward(..., mode='train')`` full logits; ``mode='prefill'`` last-token
logits + filled caches; ``decode(...)`` single-token step against caches,
which writes the caches in place.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import tree as T
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm

Params = Dict[str, Any]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def _layer(tree, i):
    """Slice i of every stacked leaf (views); i is an int, or a tuple
    (group, layer) for the hybrid's two leading dims."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _unbind(tree) -> List[Any]:
    """Every slice of the stacked leaves along dim 0, through ``unbind``."""
    if isinstance(tree, dict):
        parts = {k: _unbind(v) for k, v in tree.items()}
        n = len(next(iter(parts.values())))
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    return list(torch.unbind(tree))


def _needs_grad(params) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad
                                           for t in T.leaves(params))


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
         torch.ops.aten.bmm.default, torch.ops.aten.matmul.default)


def _remat(cfg: ModelConfig, fn, grad: bool):
    """``fn`` under ``cfg.remat``'s checkpoint policy where a backward will
    run (see the module docstring), else ``fn`` itself."""
    if cfg.remat not in ("none", "full", "dots"):
        raise ValueError(f"remat must be 'none', 'full' or 'dots', not "
                         f"{cfg.remat!r}")
    if not grad or cfg.remat == "none":
        return fn
    if cfg.remat == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    return functools.partial(
        checkpoint, fn, use_reentrant=False,
        context_fn=functools.partial(create_selective_checkpoint_contexts,
                                     list(_DOTS)))


def _stack(trees):
    """Per-layer dicts of tensors -> one dict of tensors stacked on a new
    leading dim."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _first_dense(cfg: ModelConfig) -> int:
    """The MoE family's leading dense layers (``dense_layers``), else 0."""
    return cfg.first_dense_layers if cfg.family == "moe" else 0


def _hybrid_layout(cfg: ModelConfig) -> Tuple[int, int]:
    """(#full groups of ``attn_every`` ssm layers, #tail ssm layers)."""
    g = cfg.num_layers // cfg.attn_every
    return g, cfg.num_layers - g * cfg.attn_every


# ================================================================ block: dense
def init_dense_block(gen, cfg: ModelConfig, dtype, device, lead=(), *,
                     use_moe: bool = False):
    p = {"norm1": L.init_rmsnorm(cfg.d_model, dtype, device, lead),
         "norm2": L.init_rmsnorm(cfg.d_model, dtype, device, lead)}
    p["attn"] = (attn.init_mla(gen, cfg, dtype, device, lead) if cfg.use_mla
                 else attn.init_gqa(gen, cfg, dtype, device, lead))
    if use_moe:
        p["moe"] = moe_lib.init_moe(gen, cfg, dtype, device, lead)
    else:
        p["mlp"] = L.init_mlp(gen, cfg, cfg.d_ff, dtype, device, lead)
    return p


def dense_block_full(p, x, cfg: ModelConfig, positions, *, return_kv: bool,
                     tp=None):
    """Returns (out, kv or None, the MoE aux loss or None). With ``tp``
    (``tensor_parallel.TP``) the block runs tensor-parallel on this rank's
    weights; its input and output are whole on every rank."""
    h = L.rmsnorm(p["norm1"], x, cfg.norm_eps, cfg.use_pallas)
    if cfg.use_mla:
        h, kv = attn.mla_full(p["attn"], h, cfg, positions,
                              return_kv=return_kv, tp=tp)
    else:
        h, kv = attn.gqa_full(p["attn"], h, cfg, positions,
                              return_kv=return_kv, tp=tp)
    x = x + h
    h = L.rmsnorm(p["norm2"], x, cfg.norm_eps, cfg.use_pallas)
    if "moe" in p:
        h, aux = moe_lib.moe_apply(p["moe"], h, cfg, tp)
    else:
        h, aux = L.mlp(p["mlp"], h, cfg, tp), None
    return x + h, kv, aux


def dense_block_decode(p, x, cfg: ModelConfig, positions, cache, index,
                       tp=None, sp=None):
    h = L.rmsnorm(p["norm1"], x, cfg.norm_eps, cfg.use_pallas)
    if cfg.use_mla:
        h, c1, c2 = attn.mla_decode(p["attn"], h, cfg, positions,
                                    cache["c_kv"], cache["k_rope"], index, tp)
        new_cache = {"c_kv": c1, "k_rope": c2}
    else:
        h, ck, cv = attn.gqa_decode(p["attn"], h, cfg, positions,
                                    cache["k"], cache["v"], index, tp, sp)
        new_cache = {"k": ck, "v": cv}
    x = x + h
    h = L.rmsnorm(p["norm2"], x, cfg.norm_eps, cfg.use_pallas)
    if "moe" in p:
        h, _ = moe_lib.moe_apply(p["moe"], h, cfg, tp)
    else:
        h = L.mlp(p["mlp"], h, cfg, tp)
    return x + h, new_cache


def _dense_stack_full(stacked, x, aux, cfg: ModelConfig, positions,
                      prefill: bool, grad: bool, tp=None, sp=None):
    """The attention blocks of a stack in order: (x, aux plus the blocks'
    MoE aux losses, their prefill caches stacked or None; with ``sp`` each
    layer's block of the sequence, ``_seq_block``)."""
    block = _remat(cfg, dense_block_full, grad)
    kvs = []
    for lp in _unbind(stacked):
        x, kv, a = block(lp, x, cfg, positions, return_kv=prefill, tp=tp)
        if a is not None:
            aux = aux + a
        kvs.append(kv if kv is None or sp is None
                   else tuple(_seq_block(t, sp) for t in kv))
    if not prefill:
        return x, aux, None
    return x, aux, _kv_dict(cfg, [torch.stack(t) for t in zip(*kvs)])


# ================================================================== block: ssm
def init_ssm_block(gen, cfg: ModelConfig, dtype, device, lead=()):
    return {"norm1": L.init_rmsnorm(cfg.d_model, dtype, device, lead),
            "ssm": ssm.init_mamba2(gen, cfg, dtype, device, lead)}


def ssm_block_full(p, x, cfg: ModelConfig, *, return_cache: bool, tp=None):
    """Returns (out, cache or None); with ``tp`` the Mamba2 layer runs
    tensor-parallel on this rank's weights (``ssm.mamba2_full``)."""
    h = L.rmsnorm(p["norm1"], x, cfg.norm_eps, cfg.use_pallas)
    h, cache = ssm.mamba2_full(p["ssm"], h, cfg, return_cache=return_cache,
                               tp=tp)
    return x + h, cache


def ssm_block_decode(p, x, cfg: ModelConfig, cache, tp=None):
    h = L.rmsnorm(p["norm1"], x, cfg.norm_eps, cfg.use_pallas)
    h, cache = ssm.mamba2_decode(p["ssm"], h, cfg, cache, tp)
    return x + h, cache


def _ssm_stack_full(stacked, x, cfg: ModelConfig, prefill: bool, grad: bool,
                    tp=None):
    """The mamba2 blocks of a stack in order; their prefill caches stacked
    (or None)."""
    block = _remat(cfg, ssm_block_full, grad)
    caches = []
    for lp in _unbind(stacked):
        x, c = block(lp, x, cfg, return_cache=prefill, tp=tp)
        caches.append(c)
    return x, (_stack(caches) if prefill else None)


# ====================================================================== params
def init_params(cfg: ModelConfig, *, seed: int = 0, device="cuda") -> Params:
    """Random weights with the JAX package's distributions, drawn from one
    ``torch.Generator`` seeded with ``seed`` and created on ``device``.
    (The bits differ from JAX's: tests carry JAX's weights over the bridge.)
    On the ``meta`` device it allocates nothing and gives the shapes and
    dtypes alone (``launch.specs.params_struct``)."""
    dev = resolve_device(device)
    gen = torch.Generator(device="cpu" if dev.type == "meta" else dev
                          ).manual_seed(seed)
    dtype = torch_dtype(cfg)
    params: Params = {
        "embed": L.init_embedding(gen, cfg.padded_vocab, cfg.d_model, dtype,
                                  dev),
        "final_norm": L.init_rmsnorm(cfg.d_model, dtype, dev),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = L.init_linear(gen, cfg.d_model, cfg.padded_vocab,
                                          dtype, dev)
    if cfg.family == "ssm":
        params["layers"] = init_ssm_block(gen, cfg, dtype, dev,
                                          lead=(cfg.num_layers,))
    elif cfg.family == "hybrid":
        n_groups, tail = _hybrid_layout(cfg)
        params["ssm_groups"] = init_ssm_block(
            gen, cfg, dtype, dev, lead=(n_groups, cfg.attn_every))
        if tail:
            params["ssm_tail"] = init_ssm_block(gen, cfg, dtype, dev,
                                                lead=(tail,))
        params["shared_attn"] = init_dense_block(gen, cfg, dtype, dev)
    elif cfg.family == "moe":
        fd = _first_dense(cfg)
        if fd:
            params["dense_layers"] = init_dense_block(gen, cfg, dtype, dev,
                                                      lead=(fd,))
        params["layers"] = init_dense_block(gen, cfg, dtype, dev,
                                            lead=(cfg.num_layers - fd,),
                                            use_moe=True)
    else:
        params["layers"] = init_dense_block(gen, cfg, dtype, dev,
                                            lead=(cfg.num_layers,))
    return params


# ======================================================================= cache
def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device="cuda", mesh=None) -> Dict[str, Any]:
    """Preallocated decoding caches (stacked over layers), plus ``index``
    (a 0-dim int32 tensor on the device, as in JAX). Mamba2 layers keep
    their last K-1 conv inputs and an f32 state; attention keeps K/V, MLA
    its latent ``c_kv`` and ``k_rope``. With a ``mesh`` each leaf is a
    rank's block of it by ``sharding.cache_pspec(cfg, mesh, batch)`` (the
    global ``batch``): its shape alone, so an abstract mesh will do."""
    if mesh is not None:
        from repro_torch.distributed import sharding as SH
        specs = SH.cache_pspec(cfg, mesh, batch)
        whole = init_cache(cfg, batch, max_len, device="meta")
        return T.unflatten(whole, [
            torch.zeros(SH.block_shape(specs[p], tuple(t.shape), mesh),
                        dtype=t.dtype, device=resolve_device(device))
            for p, t in T.flatten(whole)])
    dev = resolve_device(device)
    dtype = torch_dtype(cfg)

    def zeros(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    def gqa_cache(n_layers):
        if cfg.use_mla:
            return {"c_kv": zeros((n_layers, batch, max_len,
                                   cfg.kv_lora_rank)),
                    "k_rope": zeros((n_layers, batch, max_len,
                                     cfg.qk_rope_head_dim))}
        shape = (n_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
        return {"k": zeros(shape), "v": zeros(shape)}

    def ssm_cache(lead):
        K, di, GN = cfg.ssm_conv, cfg.ssm_d_inner, cfg.ssm_groups * cfg.ssm_state
        return {"conv_x": zeros((*lead, batch, K - 1, di)),
                "conv_B": zeros((*lead, batch, K - 1, GN)),
                "conv_C": zeros((*lead, batch, K - 1, GN)),
                "state": zeros((*lead, batch, cfg.ssm_heads, cfg.ssm_head_dim,
                                cfg.ssm_state), torch.float32)}

    cache: Dict[str, Any] = {"index": torch.zeros((), dtype=torch.int32,
                                                  device=dev)}
    if cfg.family == "ssm":
        cache["layers"] = ssm_cache((cfg.num_layers,))
    elif cfg.family == "hybrid":
        n_groups, tail = _hybrid_layout(cfg)
        cache["ssm_groups"] = ssm_cache((n_groups, cfg.attn_every))
        if tail:
            cache["ssm_tail"] = ssm_cache((tail,))
        cache["attn"] = gqa_cache(n_groups)
    elif _first_dense(cfg):
        cache["dense_layers"] = gqa_cache(_first_dense(cfg))
        cache["layers"] = gqa_cache(cfg.num_layers - _first_dense(cfg))
    else:
        cache["layers"] = gqa_cache(cfg.num_layers)
    return cache


# ===================================================================== forward
def _inputs_to_h(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
                 vocab_tp=None):
    if cfg.input_mode == "embeddings" and "embeds" in batch:
        x = batch["embeds"].to(torch_dtype(cfg))
    else:
        x = L.embed(params["embed"], batch["tokens"], cfg, vocab_tp)
    if cfg.pos_embed == "sinusoidal":
        x = x + L.sinusoidal_pos_embed(batch["positions"], cfg.d_model, x.dtype)
    return x


def _logits(params, cfg: ModelConfig, x, vocab_tp=None):
    if cfg.tie_embeddings:
        return L.unembed(params["embed"], x, cfg, vocab_tp)
    return L.unembed(params["unembed"], x, cfg, vocab_tp)


def vocab_group(cfg: ModelConfig, tp):
    """The model group the vocabulary is split over: ``tp`` where the
    config splits it (``vocab_tp``), else None (the table whole on every
    rank)."""
    return tp if cfg.vocab_tp else None


def _seq_block(t: torch.Tensor, sp) -> torch.Tensor:
    """This rank's block of positions of a layer's prefill K or V (B, S,
    ...): rows [r * sp.rows, (r + 1) * sp.rows) of the cache, those past
    the prompt zero. Cut as each layer makes it, so the whole prompt's K/V
    of one layer at a time is on the rank."""
    lo = min(sp.rank * sp.rows, t.shape[1])
    part = t[:, lo:min(lo + sp.rows, t.shape[1])]
    pad = [0, 0] * (t.ndim - 2) + [0, sp.rows - part.shape[1]]
    return torch.nn.functional.pad(part, pad)


def forward(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            *, mode: str = "train", tp=None, sp=None
            ) -> Tuple[torch.Tensor, torch.Tensor, Optional[Dict[str, Any]]]:
    """Full-sequence forward.

    mode='train':   returns (logits (B,S,V), aux_loss, None)
    mode='prefill': returns (last-token logits (B,1,V), aux_loss, cache)

    ``tp`` (``tensor_parallel.TP``): ``params`` are this rank's blocks
    under the specs of ``distributed/sharding.py``. Under tp16 the stacks
    run tensor-parallel; under dp_all (the ssm family) only the vocabulary
    is split, over ranks that hold other rows of the batch where
    ``tp.split_rows`` (whose logits are then those of the group's rows).
    The logits are this rank's vocab columns where ``cfg.vocab_tp`` (else
    whole), and a prefill's caches this rank's blocks by
    ``sharding.cache_pspec``; with ``sp`` (``tensor_parallel.SeqPar``, a
    prefill) its K/V are this rank's block of the cache's sequence, of
    ``sp.rows`` positions.
    """
    if mode not in ("train", "prefill"):
        raise ValueError(f"mode must be 'train' or 'prefill', got {mode!r}")
    prefill = mode == "prefill"
    grad = _needs_grad(params)
    positions = batch["positions"]
    vtp = vocab_group(cfg, tp)
    x = _inputs_to_h(params, cfg, batch, vtp)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    caches: Dict[str, Any] = {}

    if cfg.family == "ssm":               # dp_all: the stack runs whole
        x, caches["layers"] = _ssm_stack_full(params["layers"], x, cfg,
                                              prefill, grad)
    elif cfg.family == "hybrid":
        tail = _hybrid_layout(cfg)[1]
        shared = params["shared_attn"]
        ssm_caches, ks, vs = [], [], []
        for grp in _unbind(params["ssm_groups"]):
            x, c = _ssm_stack_full(grp, x, cfg, prefill, grad, tp)
            x, kv, _ = dense_block_full(shared, x, cfg, positions,
                                        return_kv=prefill, tp=tp)
            if prefill:
                ssm_caches.append(c)
                if sp is not None:
                    kv = tuple(_seq_block(t, sp) for t in kv)
                ks.append(kv[0])
                vs.append(kv[1])
        if tail:
            x, tail_c = _ssm_stack_full(params["ssm_tail"], x, cfg, prefill,
                                        grad, tp)
        if prefill:
            caches["ssm_groups"] = _stack(ssm_caches)
            if tail:
                caches["ssm_tail"] = tail_c
            caches["attn"] = {"k": torch.stack(ks), "v": torch.stack(vs)}
    else:                                   # dense / moe / audio / vlm
        if _first_dense(cfg):
            x, aux_total, caches["dense_layers"] = _dense_stack_full(
                params["dense_layers"], x, aux_total, cfg, positions, prefill,
                grad, tp, sp)
        x, aux_total, caches["layers"] = _dense_stack_full(
            params["layers"], x, aux_total, cfg, positions, prefill, grad, tp,
            sp)

    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps, cfg.use_pallas)
    if prefill:
        x = x[:, -1:, :]
        caches["index"] = torch.full((), positions.shape[-1],
                                     dtype=torch.int32, device=x.device)
    logits = _logits(params, cfg, x, vtp)
    return logits, aux_total, (caches if prefill else None)


def _kv_dict(cfg, kvs):
    if cfg.use_mla:
        return {"c_kv": kvs[0], "k_rope": kvs[1]}
    return {"k": kvs[0], "v": kvs[1]}


# ====================================================================== decode
def decode(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
           cache: Dict[str, Any], tp=None, sp=None
           ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step. batch: tokens (B,1) or embeds (B,1,d) + positions.

    Writes the new K/V rows, conv windows and SSM states into ``cache``'s
    tensors in place and returns (logits (B,1,V), new_cache), where new_cache
    shares those tensors and carries ``index + 1``. Nothing here waits on the
    device. With ``tp`` the parameters and caches are this rank's blocks and
    the logits its vocab columns, as in ``forward``; the collectives run in
    one order on every rank, ``index`` staying on the device. With ``sp``
    the attention caches are this rank's block of the sequence (see the
    module docstring)."""
    index = cache["index"]
    positions = batch["positions"]
    vtp = vocab_group(cfg, tp)
    x = _inputs_to_h(params, cfg, batch, vtp)
    new_cache: Dict[str, Any] = {**cache, "index": index + 1}
    if cfg.family == "ssm":               # dp_all: the stack runs whole
        for i in range(cfg.num_layers):
            x, _ = ssm_block_decode(_layer(params["layers"], i), x, cfg,
                                    _layer(cache["layers"], i))
    elif cfg.family == "hybrid":
        n_groups, tail = _hybrid_layout(cfg)
        shared = params["shared_attn"]
        for g in range(n_groups):
            for i in range(cfg.attn_every):
                x, _ = ssm_block_decode(_layer(params["ssm_groups"], (g, i)),
                                        x, cfg,
                                        _layer(cache["ssm_groups"], (g, i)),
                                        tp)
            x, _ = dense_block_decode(shared, x, cfg, positions,
                                      _layer(cache["attn"], g), index, tp,
                                      sp)
        for i in range(tail):
            x, _ = ssm_block_decode(_layer(params["ssm_tail"], i), x, cfg,
                                    _layer(cache["ssm_tail"], i), tp)
    else:
        fd = _first_dense(cfg)
        for stack, n in (("dense_layers", fd), ("layers", cfg.num_layers - fd)):
            for i in range(n):
                x, _ = dense_block_decode(_layer(params[stack], i), x, cfg,
                                          positions, _layer(cache[stack], i),
                                          index, tp, sp)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps, cfg.use_pallas)
    return _logits(params, cfg, x, vtp), new_cache
