"""Sharding policies of the port: param/opt-state/cache/batch specs per
architecture family, the rules of the JAX package's
``repro/distributed/sharding.py``.

Two policies:
  * ``tp16``  — Megatron-style tensor parallelism over the ``model`` axis
                (attn heads / ffn hidden / vocab / experts), data parallelism
                over ``data`` (and ``pod``), ZeRO-1 optimizer-state sharding.
  * ``dp_all`` — for small attention-free models (mamba2-130m): pure data
                parallelism over the flattened (data, model) axes; only the
                vocab matmuls stay tensor-parallel.

A spec is the twin of JAX's ``PartitionSpec``: a tuple with, per tensor
dim, a mesh-axis name, a tuple of names, or None; an entry of one axis is
written as the name and an entry of none as None, as ``PartitionSpec``
normalises them. Trees of specs are flat dicts ``{path: spec}`` in the leaf
order of ``repro_torch.tree.flatten``, whose paths are JAX's (``.mu/...``
for an ``OptState`` field). Rules are path-based: a leaf's spec is decided
by its name/rank, with leading layer-stack dims padded with None.
``kv_heads < TP`` triggers the replicated-KV rule.

The port executes them: ``batch_axes`` gives each rank's rows of the batch;
under either policy a rank holds the ``local_slices`` block of every
parameter (``shard_tree``; ``gather_tree`` is the inverse) and of every
AdamW moment (``zero1_spec``). Under tp16 the model runs tensor-parallel
over ``model``, under dp_all only the vocabulary is split there
(``distributed/tensor_parallel.py``). ``placements`` gives a spec's DTensor
placements, against which the tests hold ``local_slices``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch import tree as T
from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import Mesh

MODEL_AXIS = "model"
DATA_AXIS = "data"
POD_AXIS = "pod"

Spec = Tuple


def policy_for(cfg: ModelConfig) -> str:
    return "dp_all" if cfg.family == "ssm" else "tp16"


def batch_axes(mesh: Mesh, cfg: ModelConfig,
               global_batch: Optional[int] = None) -> Tuple[str, ...]:
    """Mesh axes the global batch is sharded over. If ``global_batch`` is
    given, axes are dropped (right to left) until the batch divides evenly."""
    multi_pod = POD_AXIS in mesh.axis_names
    if policy_for(cfg) == "dp_all":
        # flatten DP over data+model; pod (if present) becomes a replica axis
        axes: Tuple[str, ...] = (DATA_AXIS, MODEL_AXIS)
    else:
        axes = (POD_AXIS, DATA_AXIS) if multi_pod else (DATA_AXIS,)
    if global_batch is not None:
        while axes and global_batch % mesh.axes_size(axes):
            axes = axes[:-1]
    return axes


def _entry(axes: Tuple[str, ...]):
    """A spec entry for ``axes``, normalised as ``PartitionSpec`` does."""
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else tuple(axes)


def _tp(cfg: ModelConfig) -> Optional[str]:
    return MODEL_AXIS if policy_for(cfg) == "tp16" else None


def _kv_shardable(cfg: ModelConfig, tp_size: int) -> bool:
    # argument shardings demand exact divisibility; otherwise replicate KV
    # (the standard replicated-KV rule)
    return (cfg.num_kv_heads >= tp_size
            and cfg.num_kv_heads % tp_size == 0)


def _pad(ndim: int, tail: Tuple) -> Spec:
    return (None,) * (ndim - len(tail)) + tuple(tail)


# ------------------------------------------------------------------ param rules
def param_spec(cfg: ModelConfig, mesh: Mesh, path: str, ndim: int) -> Spec:
    """Sharding spec for a parameter leaf, identified by its tree path."""
    tp = _tp(cfg)
    tp_size = mesh.shape.get(MODEL_AXIS, 1)
    kv_tp = tp if (tp and _kv_shardable(cfg, tp_size)) else None

    def pad(tail: Tuple) -> Spec:
        return _pad(ndim, tail)

    parts = path.split("/")
    name = parts[-1]
    parent = parts[-2] if len(parts) > 1 else ""
    # linear layers are dicts {w, b}: the rule owner is the enclosing name
    owner = parent if name in ("w", "b") else name
    is_bias = name == "b"

    # ---- embeddings / head --------------------------------------------------
    if name == "table":                                   # (V, d)
        return pad((MODEL_AXIS, None) if cfg.vocab_tp else (None, None))
    if owner == "unembed":                                # (d, V)
        return pad((None, MODEL_AXIS) if cfg.vocab_tp else (None, None))

    # ---- norms / scalars -----------------------------------------------------
    if name == "scale":
        if parent == "norm" and cfg.ssm_state:            # ssm gated norm (di,)
            return pad((tp,))
        return pad((None,))
    if name in ("A_log", "D", "dt_bias"):                 # (H,): tiny
        return pad((None,))

    # ---- attention (column-parallel QKV, row-parallel O; replicated-KV rule)
    if owner == "wq":
        return pad((tp,)) if is_bias else pad((None, tp))
    if owner in ("wk", "wv"):
        return pad((kv_tp,)) if is_bias else pad((None, kv_tp))
    if owner == "wo":
        return pad((None,)) if is_bias else pad((tp, None))
    if owner in ("w_dkv", "w_krope"):                     # MLA latents: small
        return pad((None, None))
    if owner in ("w_uk", "w_uv"):                         # (r, H*dim)
        return pad((None, tp))

    # ---- MoE ----------------------------------------------------------------
    if owner == "router" or parent == "router":
        return pad((None, None))
    if parent == "moe" and name in ("w_in", "w_gate", "w_out"):
        # expert-stacked raw arrays (E, d, ff)/(E, ff, d): expert parallelism
        return pad((tp, None, None))

    # ---- dense/shared-expert MLP --------------------------------------------
    if owner in ("w_in", "w_gate"):                       # (d, ff)
        return pad((None, tp))
    if owner == "w_out":                                  # (ff, d)
        return pad((tp, None))

    # ---- SSM ----------------------------------------------------------------
    if owner in ("wz", "wx"):                             # (d, di)
        return pad((None, tp))
    if owner in ("wB", "wC", "wdt"):                      # small projections
        return pad((None, None))
    if name == "conv_x":                                  # (K, di)
        return pad((None, tp))
    if name in ("conv_B", "conv_C"):
        return pad((None, None))
    # the SSM out-projection is named w_out and hits the row-parallel MLP
    # rule above ((di, d) sharded on di)
    return (None,) * ndim


def params_pspec(cfg: ModelConfig, mesh: Mesh, params) -> Dict[str, Spec]:
    """{path: spec} for every leaf of ``params`` (tensors, meta tensors or
    anything with ``ndim``)."""
    return {path: param_spec(cfg, mesh, path, leaf.ndim)
            for path, leaf in T.flatten(params)}


# ------------------------------------------------------------------- ZeRO-1
def zero1_spec(spec: Spec, shape: Tuple[int, ...], mesh: Mesh) -> Spec:
    """Extend a param spec with optimizer-state sharding over the data axis
    (ZeRO-1): shard the first free dim divisible by |data|."""
    dp = mesh.shape.get(DATA_AXIS, 1)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    for i, (ax, dim) in enumerate(zip(entries, shape)):
        if ax is None and dim % dp == 0 and dim >= dp:
            entries[i] = DATA_AXIS
            return tuple(entries)
    return tuple(entries)


def opt_state_pspec(cfg: ModelConfig, mesh: Mesh, opt_state
                    ) -> Dict[str, Spec]:
    """{path: spec} for an ``OptState`` (or any tree): each leaf's param
    rule, then ZeRO-1 over ``data``."""
    return {path: zero1_spec(param_spec(cfg, mesh, path, leaf.ndim),
                             tuple(leaf.shape), mesh)
            for path, leaf in T.flatten(opt_state)}


# ---------------------------------------------------------------- batch / cache
def batch_pspec(cfg: ModelConfig, mesh: Mesh,
                global_batch: Optional[int] = None) -> Dict[str, Spec]:
    """Specs for a training/prefill batch dict."""
    b = _entry(batch_axes(mesh, cfg, global_batch))
    out = {"tokens": (b, None), "labels": (b, None), "positions": (b, None)}
    if cfg.rope_kind == "mrope":
        out["positions"] = (None, b, None)
    if cfg.input_mode == "embeddings":
        out["embeds"] = (b, None, None)
    return out


def cache_pspec(cfg: ModelConfig, mesh: Mesh, batch_size: int
                ) -> Dict[str, Spec]:
    """Specs for the decode cache (see model.init_cache), {path: spec}.

    Batch shards over the (divisibility-reduced) DP axes; when the batch
    can't shard at all (long-context batch=1 cell), the KV *sequence* shards
    over ``data`` instead (sequence-parallel decode) and heads over model.
    """
    from repro_torch.models.model import init_cache
    tp = _tp(cfg)
    tp_size = mesh.shape.get(MODEL_AXIS, 1)
    kv_tp = tp if (tp and _kv_shardable(cfg, tp_size)) else None
    axes = batch_axes(mesh, cfg, batch_size)
    seq_parallel = not axes
    bax = _entry(axes)
    sax = DATA_AXIS if seq_parallel else None

    def spec_for(path: str, ndim: int) -> Spec:
        name = path.split("/")[-1]
        if name == "index":
            return ()
        if name in ("k", "v", "c_kv", "k_rope"):
            # MLA's latent (L,B,Smax,r) / (L,B,Smax,rope_d) is tiny: its last
            # dim stays whole
            s = ((None, bax, sax, None) if cfg.use_mla
                 else (None, bax, sax, kv_tp, None))
            return _pad(ndim, s)
        if name == "state":        # (L,B,H,P,N)
            return _pad(ndim, (bax, tp, None, None))
        if name.startswith("conv_"):   # (L,B,K-1,C)
            return _pad(ndim, (bax, None, tp if name == "conv_x" else None))
        return (None,) * ndim

    # shapes alone: the cache on the meta device allocates nothing
    template = init_cache(cfg, batch_size, 8, device="meta")
    return {path: spec_for(path, leaf.ndim)
            for path, leaf in T.flatten(template)}


# ------------------------------------------------------- specs on real ranks
def _axes_of(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def local_slices(spec: Spec, shape: Tuple[int, ...], mesh: Mesh
                 ) -> Tuple[slice, ...]:
    """The block of a tensor of ``shape`` that this rank holds under
    ``spec``: dim d split evenly over the axes of spec[d], in their order
    (row-major, as JAX lays out the shards of an entry naming several
    axes)."""
    out = []
    for d, n in enumerate(shape):
        axes = _axes_of(spec[d] if d < len(spec) else None)
        k = mesh.axes_size(axes)
        if n % k:
            raise ValueError(f"dim {d} of {tuple(shape)} does not divide "
                             f"over {axes} ({k})")
        i, m = mesh.axes_index(axes), n // k
        out.append(slice(i * m, (i + 1) * m))
    return tuple(out)


def block_shape(spec: Spec, shape: Tuple[int, ...], mesh: Mesh
                ) -> Tuple[int, ...]:
    """The shape of a rank's block of a tensor of ``shape`` under ``spec``
    (``local_slices``' block), on any mesh, an abstract one too."""
    out = []
    for d, n in enumerate(shape):
        k = mesh.axes_size(_axes_of(spec[d] if d < len(spec) else None))
        if n % k:
            raise ValueError(f"dim {d} of {tuple(shape)} does not divide "
                             f"over {k}")
        out.append(n // k)
    return tuple(out)


def placements(spec: Spec, mesh: Mesh):
    """DTensor placements of ``spec`` on ``mesh.device_mesh``: per mesh axis
    ``Shard(d)`` where spec[d] names it, else ``Replicate()``. A dim split
    over several axes gets ``Shard(d)`` on each, which DTensor splits in
    mesh-axis order: the blocks of ``local_slices`` when the spec names
    the axes in that order."""
    from torch.distributed.tensor import Replicate, Shard
    where = {a: d for d, entry in enumerate(spec) for a in _axes_of(entry)}
    return tuple(Shard(where[a]) if a in where else Replicate()
                 for a in mesh.axis_names)


def shard_tree(tree, specs: Dict[str, Spec], mesh: Mesh):
    """This rank's block of every leaf of ``tree`` under ``specs`` ({path:
    spec}, ``flatten``'s paths), each a contiguous tensor of its own, a
    whole leaf too: an update of the blocks in place leaves ``tree`` as it
    was, and ``tree`` can be freed."""
    def block(path, leaf):
        sl = local_slices(specs[path], tuple(leaf.shape), mesh)
        return leaf[sl].clone(memory_format=torch.contiguous_format)
    return T.unflatten(tree, [block(p, t) for p, t in T.flatten(tree)])


def gather_leaf(leaf: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """The whole tensor from every rank's ``local_slices`` block under
    ``spec``, on every rank (collective): gathered over the axes each dim
    of the spec names."""
    from repro_torch.distributed.tensor_parallel import all_gather_dim
    for d, entry in enumerate(spec):
        axes = _axes_of(entry)
        n = mesh.axes_size(axes)
        if n > 1:
            leaf = all_gather_dim(leaf, d, mesh.group(axes), n)
    return leaf


def gather_tree(tree, specs: Dict[str, Spec], mesh: Mesh):
    """The inverse of ``shard_tree``, collective: every leaf whole on every
    rank (``gather_leaf``)."""
    return T.unflatten(tree, [gather_leaf(t, specs[p], mesh)
                              for p, t in T.flatten(tree)])
