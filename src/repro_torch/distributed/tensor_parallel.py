"""Tensor parallelism over a mesh's ``model`` axis and the ZeRO-1 layout of a
train step: what GSPMD derives for the JAX package from the specs of
``distributed/sharding.py``, written out as Megatron-LM does it.

The pieces:
  * ``TP``: the model group of a ``Mesh`` (its size, this rank's index,
    whether its ranks hold different rows of the batch),
    ``model_group(mesh)`` (None when the axis has one rank);
  * the two collectives it runs (``all_reduce``, ``all_gather_dim``), which
    gloo and NCCL both implement, gloo on CUDA tensors too;
  * Megatron's two autograd collectives: ``copy_to_tp`` (identity forward,
    all-reduce of the gradient backward), where a replicated activation
    enters a computation split over the ranks, and ``reduce_from_tp``
    (all-reduce forward, identity backward), after a row-parallel product;
    and ``sum_over_tp`` (all-reduce both ways), for a sum that every rank
    reads for its own part (the gated norm's row sum of squares);
  * ``row_parallel``, ``split_rmsnorm`` (an RMSNorm of rows whose columns
    are split over the ranks), ``vocab_embed`` (a masked lookup into this
    rank's rows of the table), ``vocab_parallel_ce`` (the cross entropy of
    logits split over the vocabulary) and ``local_kv`` (the replicated-KV
    rule, also the rule of a Mamba2 layer's B/C groups);
  * ``TrainLayout``: every leaf's block on this rank, the parameters by
    their specs and the AdamW moments by ``zero1_spec``; ``ServeLayout``:
    the parameters' blocks, each decode cache leaf's block by
    ``cache_pspec`` and the serving batch's rows; ``gather_vocab``, the
    logits over the whole vocabulary from every rank's columns, which
    ``serve_step.sample`` reads unchanged on every rank.

Serving runs the same split as training, without gradients: the prefill
fills, and each decode step writes, this rank's block of the cache (K/V
of its kv heads, or whole under the replicated-KV rule, where the decode
kernel reads only its query heads' kv heads through a view; MLA's latents
whole; a Mamba2 layer's state and ``conv_x`` window of its heads, its
``conv_B``/``conv_C`` whole).

Which tensors are split under tp16: column-parallel products (QKV, MLP in,
MLA's per-head up-projections, each rank's experts, a Mamba2 layer's z and
x projections and its conv over x: its heads) produce this rank's part;
row-parallel ones (attention out, MLP out, the experts' partial sums,
Mamba2's out-projection) produce a partial sum that ``reduce_from_tp``
completes. Everything else (the residual stream, norms, the router, MLA's
latents, K/V under the replicated-KV rule, Mamba2's B, C and dt and its
per-head leaves) is computed whole on every rank, and every leaf used that
way gets the whole gradient on every rank: a replicated tensor that a split
computation reads goes through ``copy_to_tp`` first.

Under dp_all (mamba2-130m) only the vocabulary is split over ``model``, and
the ranks of a model group hold different rows of the batch
(``TP.split_rows``): the embedding gathers the group's tokens, looks them
up in this rank's rows of the table and sums the rows back to their ranks
(``scatter_rows``); the logits are those of the group's gathered hidden
rows (``gather_rows``) over this rank's vocabulary, and the loss is the
group's mean. Each rank's gradient of a leaf whole on every rank is then
its rows' part of the group loss's, summed over the group by the gradient
mean (``compression.make_local_grad_fn``).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch import tree as T
from repro_torch.device import same_device
from repro_torch.distributed import sharding as SH
from repro_torch.kernels.fused_rmsnorm import ops as rn_ops
from repro_torch.kernels.fused_rmsnorm import ref as rn_ref


@dataclass(frozen=True)
class TP:
    """The ranks of one model group: ``group`` (a process group), ``size``
    and this rank's ``rank`` in it. ``split_rows``: the ranks hold
    different rows of the batch (dp_all), which the vocabulary ops gather
    (see the module docstring)."""
    group: Any
    size: int
    rank: int
    split_rows: bool = False


def model_group(mesh) -> Optional[TP]:
    """The model group of ``mesh``, or None when its ``model`` axis has one
    rank (or there is no mesh)."""
    if mesh is None or mesh.shape.get(SH.MODEL_AXIS, 1) == 1:
        return None
    return TP(mesh.group((SH.MODEL_AXIS,)), mesh.shape[SH.MODEL_AXIS],
              mesh.coordinate()[SH.MODEL_AXIS])


# ------------------------------------------------------------- collectives
# all_gather into one tensor: ``all_gather_single`` where torch has it (the
# older name is deprecated there)
_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """All-reduce ``x`` (contiguous) over ``group`` in place; returns it.
    gloo takes CUDA tensors too (ranks that share one card), staging them
    through host memory itself."""
    dist.all_reduce(x, op=op, group=group)
    return x


def all_gather_dim(x: torch.Tensor, dim: int, group, n: int,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The ``n`` ranks' blocks of ``x`` (each of x's shape) concatenated
    along ``dim`` in group-rank order; written into ``out`` when given."""
    x = x.contiguous()
    shape = list(x.shape)
    if out is not None and dim == 0 and out.is_contiguous():
        _all_gather(out, x, group=group)          # in place, no copy
        return out
    buf = x.new_empty((n * shape[0], *shape[1:]))
    _all_gather(buf, x, group=group)
    full = buf.view(n, *shape).movedim(0, dim).reshape(
        *shape[:dim], n * shape[dim], *shape[dim + 1:])
    return full if out is None else out.copy_(full)


# ------------------------------------------------ autograd collectives
class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.tp.group), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return all_reduce(x.contiguous().clone(), tp.group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumOverTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return all_reduce(x.contiguous().clone(), tp.group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.tp.group), None


def _own_rows(x: torch.Tensor, tp: TP) -> torch.Tensor:
    """This rank's block of dim 0 of x (n blocks, in rank order)."""
    m = x.shape[0] // tp.size
    return x[tp.rank * m:(tp.rank + 1) * m]


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return all_gather_dim(x, 0, tp.group, tp.size)

    @staticmethod
    def backward(ctx, g):
        # the sum over the ranks of their gradients of this rank's rows: a
        # reduce-scatter, run as an all-reduce and this rank's rows, as the
        # ZeRO-1 mean is (ROADMAP.md, item 12e)
        g = all_reduce(g.contiguous().clone(), ctx.tp.group)
        return _own_rows(g, ctx.tp).contiguous(), None


class _ScatterRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        x = all_reduce(x.contiguous().clone(), tp.group)
        return _own_rows(x, tp).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather_dim(g, 0, ctx.tp.group, ctx.tp.size), None


def copy_to_tp(x: torch.Tensor, tp: TP) -> torch.Tensor:
    """Identity forward; backward, the gradient summed over the model
    group. For a replicated tensor that a split computation reads."""
    return _CopyToTP.apply(x, tp)


def reduce_from_tp(x: torch.Tensor, tp: TP) -> torch.Tensor:
    """The sum of every rank's ``x`` forward; identity backward. For the
    partial sums of a row-parallel product."""
    return _ReduceFromTP.apply(x, tp)


def sum_over_tp(x: torch.Tensor, tp: TP) -> torch.Tensor:
    """The sum of every rank's ``x`` forward, and of every rank's gradient
    backward: for a sum every rank reads for its own part of a split
    computation, so that the gradient of a rank's term is the sum of what
    each rank's reading gives it."""
    return _SumOverTP.apply(x, tp)


def gather_rows(x: torch.Tensor, tp: TP) -> torch.Tensor:
    """Every rank's ``x`` concatenated along dim 0 in rank order; backward,
    each rank's block of the gradient summed over the ranks."""
    return _GatherRows.apply(x, tp)


def scatter_rows(x: torch.Tensor, tp: TP) -> torch.Tensor:
    """This rank's block of dim 0 of the sum of every rank's ``x`` (n
    blocks); backward, the gradients of every rank's block gathered."""
    return _ScatterRows.apply(x, tp)


def split_rmsnorm(p, y: torch.Tensor, gate, eps: float, use_pallas: bool,
                  tp: TP) -> torch.Tensor:
    """``layers.rmsnorm(p, y, eps, gate=gate)`` of rows whose columns are
    split over the model group: ``y``, ``gate`` and ``p["scale"]`` are this
    rank's columns. Each row's sum of squares (of ``y * silu(gate)`` where
    gated, rounded as the fused kernel rounds it) on this rank's columns,
    summed over the ranks (``sum_over_tp``), then this rank's columns
    scaled by the mean over the full width: with ``use_pallas`` the two
    passes of the RMSNorm kernel's split mode, else their plain versions."""
    w = p["scale"]
    width = y.shape[-1] * tp.size
    if use_pallas:
        ss = sum_over_tp(rn_ops.row_sumsq(y, gate), tp)
        return rn_ops.rmsnorm(y, w, eps=eps, gate=gate, row_ss=ss,
                              width=width)
    ss = sum_over_tp(rn_ref.row_sumsq_ref(y, gate), tp)
    return rn_ref.rmsnorm_ref(y, w, eps=eps, gate=gate, row_ss=ss,
                              width=width)


def local_heads(t: torch.Tensor, dim: int, n: int, tp: TP) -> torch.Tensor:
    """This rank's ``n`` heads (``rank * n`` on) along ``dim`` of a tensor
    whole on every rank, after ``copy_to_tp`` (the gradient of each head
    whole on the rank that reads it, zero on the others, summed)."""
    return copy_to_tp(t, tp).narrow(dim, tp.rank * n, n)


def row_parallel(p, h: torch.Tensor, tp: TP) -> torch.Tensor:
    """A linear layer ``{w[, b]}`` whose input dim is split over the model
    group: this rank's ``h @ w`` summed over the ranks, then the bias
    (whole on every rank, added once)."""
    y = reduce_from_tp(h @ p["w"], tp)
    return y + p["b"] if "b" in p else y


# ------------------------------------------------------ vocab-parallel ops
def _local_ids(ids: torch.Tensor, n: int, tp: TP):
    """(ids local to this rank's ``n`` rows, 0 where another rank owns
    them; the mask of those this rank owns)."""
    local = ids.long() - tp.rank * n
    mine = (local >= 0) & (local < n)
    return torch.where(mine, local, 0), mine


def vocab_embed(table: torch.Tensor, tokens: torch.Tensor, tp: TP
                ) -> torch.Tensor:
    """``F.embedding(tokens, full table)`` from this rank's rows of the
    table: a masked lookup, summed over the model group (one rank adds the
    row, the others zeros). Where the group's ranks hold different rows of
    the batch (``tp.split_rows``) the lookup is of the group's tokens,
    gathered, and each rank keeps the sum of its own rows
    (``scatter_rows``)."""
    if tp.split_rows:
        tokens = all_gather_dim(tokens, 0, tp.group, tp.size)
    local, mine = _local_ids(tokens, table.shape[0], tp)
    x = torch.nn.functional.embedding(local, table)
    x = x.masked_fill(~mine[..., None], 0)
    return scatter_rows(x, tp) if tp.split_rows else reduce_from_tp(x, tp)


def vocab_parallel_ce(logits: torch.Tensor, labels: torch.Tensor, tp: TP
                      ) -> torch.Tensor:
    """Per-token ``logsumexp(logits) - logits[label]`` from this rank's
    vocab columns of the logits, as ``train_step.make_loss_fn`` computes
    it on the whole vocabulary: the gold logit gathered in the logits'
    dtype by the rank that owns the label, then f32; the logsumexp in f32
    from a max (a stop-gradient shift) and a sum of exponentials, each
    reduced over the model group."""
    local, mine = _local_ids(labels, logits.shape[-1], tp)
    gold = torch.gather(logits, -1, local[..., None])[..., 0].float()
    gold = reduce_from_tp(torch.where(mine, gold, 0.0), tp)
    l32 = logits.float()
    with torch.no_grad():
        m = all_reduce(l32.amax(dim=-1), tp.group, op=dist.ReduceOp.MAX)
    s = reduce_from_tp(torch.sum(torch.exp(l32 - m[..., None]), dim=-1), tp)
    return torch.log(s) + m - gold


def local_kv(k: torch.Tensor, v: torch.Tensor, n_heads: int, groups: int,
             tp: TP) -> Tuple[torch.Tensor, torch.Tensor]:
    """The replicated-KV rule: K/V (B, S, KV, hd) whole on every rank; this
    rank's ``n_heads`` query heads (``rank * n_heads`` on) read kv heads
    ``h // groups`` (groups = H / KV). Returns views of exactly the kv heads
    they read, after ``copy_to_tp`` (each kv head's gradient is summed over
    the ranks whose heads read it), so the kernel's ``h // G`` on local
    indices finds them."""
    if n_heads % groups and groups % n_heads:
        raise ValueError(f"{n_heads} query heads a rank over groups of "
                         f"{groups}: a rank's heads straddle kv heads")
    first = tp.rank * n_heads // groups
    n_kv = max(1, n_heads // groups)
    k, v = copy_to_tp(k, tp), copy_to_tp(v, tp)
    return k[:, :, first:first + n_kv], v[:, :, first:first + n_kv]


# ----------------------------------------------------------- layouts
class ParamLayout:
    """How the ranks of ``mesh`` hold a model's parameters: each leaf's
    block by its spec (``sharding.params_pspec``: under tp16 split over
    ``model``, under dp_all only the vocabulary; replicated over ``data``),
    and this rank's model group (``tp``)."""

    def __init__(self, cfg, mesh):
        from repro_torch.models.model import init_params   # models imports us
        struct = init_params(cfg, device="meta")
        self.cfg = cfg
        self.mesh = mesh
        self.tp = model_group(mesh)
        self.specs = SH.params_pspec(cfg, mesh, struct)
        self.shapes = {p: tuple(t.shape) for p, t in T.flatten(struct)}
        self._split = {p for p, spec in self.specs.items()
                       if self.tp is not None
                       and any(SH.MODEL_AXIS in SH._axes_of(e) for e in spec)}

    def split_over_model(self, path: str) -> bool:
        """Whether ranks of the model group hold other parts of the leaf."""
        return path in self._split

    def shard_params(self, params):
        """This rank's block of every leaf of a whole parameter tree."""
        return SH.shard_tree(params, self.specs, self.mesh)

    def gather_params(self, params):
        """The whole tree from every rank's blocks (collective)."""
        return SH.gather_tree(params, self.specs, self.mesh)

    def init_params(self, seed: int = 0, device="cuda"):
        """``shard_params(model.init_params(cfg, seed=seed, device=device))``,
        the same values, without the whole tree: each leaf that
        ``layers.truncated_normal_init`` draws (every weight matrix) is cut
        to this rank's block as it is drawn, so the peak is the largest
        leaf whole beside the blocks (a model that one card does not hold,
        phi3.5-moe at 32 layers, starts on four)."""
        from repro_torch.models import layers as L
        from repro_torch.models import model as M
        drawn = []
        with L.drawn_leaves(lambda t: drawn.append(t) or t):
            struct = M.init_params(self.cfg, seed=seed, device="meta")
        where = {id(t): p for p, t in T.flatten(struct)}
        paths = iter([where.get(id(t)) for t in drawn])

        def block(t):
            path = next(paths)
            return t if path is None else self._block(path, t)
        with L.drawn_leaves(block):
            params = M.init_params(self.cfg, seed=seed, device=device)
        # the leaves drawn otherwise (zeros, the Mamba2 per-head draws) are
        # whole yet; a block of a whole leaf is itself
        return T.unflatten(params, [
            self._block(p, t) if tuple(t.shape) == self.shapes[p] else t
            for p, t in T.flatten(params)])

    def _block(self, path, t):
        sl = SH.local_slices(self.specs[path], tuple(t.shape), self.mesh)
        return t[sl].clone(memory_format=torch.contiguous_format)


class TrainLayout(ParamLayout):
    """How the ranks of ``mesh`` hold a model's train state: the parameter
    blocks of ``ParamLayout``, each AdamW moment's block by
    ``sharding.zero1_spec`` (ZeRO-1: also split over ``data`` where a free
    dim divides)."""

    def __init__(self, cfg, mesh):
        super().__init__(cfg, mesh)
        self.moment_specs = {p: SH.zero1_spec(s, self.shapes[p], mesh)
                             for p, s in self.specs.items()}
        self.data_size = mesh.shape.get(SH.DATA_AXIS, 1)
        self.data_group = mesh.group((SH.DATA_AXIS,))
        self._blocks = {p: self._moment_block(p) for p in self.specs}

    def moment_block(self, path: str
                     ) -> Optional[Tuple[int, Tuple[slice, ...]]]:
        """(dim, slices): the block of this rank's parameter block that its
        moments cover, split along ``dim`` over ``data``; None when they
        cover it whole."""
        return self._blocks[path]

    def _moment_block(self, path):
        spec = self.moment_specs[path]
        if self.data_size == 1 or SH.DATA_AXIS not in spec:
            return None
        dim = spec.index(SH.DATA_AXIS)
        local = [sl.stop - sl.start for sl in SH.local_slices(
            self.specs[path], self.shapes[path], self.mesh)]
        only_data = tuple(SH.DATA_AXIS if i == dim else None
                          for i in range(len(local)))
        return dim, SH.local_slices(only_data, tuple(local), self.mesh)

    def gather_moments(self, tree):
        return SH.gather_tree(tree, self.moment_specs, self.mesh)


class ServeLayout(ParamLayout):
    """How the ranks of ``mesh`` serve a batch of ``batch`` requests: the
    parameter blocks of ``ParamLayout`` (no moments), each decode cache
    leaf's block by ``sharding.cache_pspec``, the batch's rows over
    ``batch_axes(mesh, cfg, batch)`` (``rows`` a rank), and the model
    group ``tp`` the prefill and decode steps run over: under dp_all with
    ``split_rows`` where that serving batch splits over ``model`` too (on
    the production mesh B = 32 and 128 drop ``model``, so a group's ranks
    hold the same rows)."""

    def __init__(self, cfg, mesh, batch: int):
        super().__init__(cfg, mesh)
        self.batch_axes = SH.batch_axes(mesh, cfg, batch)
        if not self.batch_axes and mesh.shape.get(SH.DATA_AXIS, 1) > 1:
            raise NotImplementedError(
                f"a batch of {batch} does not divide over the data axis: "
                f"sequence-parallel decode (the cache's sequence over "
                f"'data') is not executed (ROADMAP item 12h)")
        self.rows = batch // mesh.axes_size(self.batch_axes)
        self.cache_specs = SH.cache_pspec(cfg, mesh, batch)
        self.tp = step_group(cfg, self, self.batch_axes)

    def my_rows(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows (dim 0) of a tensor of the whole batch."""
        i, n = self.mesh.axes_index(self.batch_axes), self.rows
        return t[i * n:(i + 1) * n]

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """The whole batch from every rank's rows (dim 0; collective)."""
        group = self.mesh.group(self.batch_axes)
        if group is None:
            return t
        return all_gather_dim(t, 0, group,
                              self.mesh.axes_size(self.batch_axes))


def gather_vocab(logits: torch.Tensor, tp: Optional[TP]) -> torch.Tensor:
    """The logits over the whole (padded) vocabulary from this rank's
    columns of them, so that ``serve_step.sample`` runs unchanged on every
    rank and draws the same token there: an all-gather of the last axis
    over the model group. Where the group's ranks hold other rows
    (``tp.split_rows``) the logits are the group's rows, and each rank
    keeps its own. None (one rank, or a vocabulary whole on every rank):
    ``logits`` as they are."""
    if tp is None:
        return logits
    full = all_gather_dim(logits, logits.ndim - 1, tp.group, tp.size)
    return _own_rows(full, tp) if tp.split_rows else full


def unsupported(cfg, mesh) -> Optional[str]:
    """Why the port cannot run ``cfg`` tensor-parallel over ``mesh``'s
    ``model`` axis, or None (also for one rank)."""
    n = mesh.shape.get(SH.MODEL_AXIS, 1)
    if n == 1:
        return None
    if cfg.vocab_tp and cfg.padded_vocab % n:
        return (f"{cfg.name}: the vocabulary of {cfg.padded_vocab} rows does "
                f"not divide over {n} model ranks")
    if SH.policy_for(cfg) != "tp16":
        return None
    if cfg.family == "hybrid":
        H, G = cfg.ssm_heads, cfg.ssm_groups
        if H % n:
            return (f"{cfg.name}: {H} SSD heads do not divide over {n} model "
                    f"ranks")
        per_group, mine = H // G, H // n
        if mine % per_group and per_group % mine:
            return (f"{cfg.name}: {mine} SSD heads a rank straddle the "
                    f"{G} B/C groups of {per_group} heads")
    if cfg.num_heads % n:
        return (f"{cfg.name}: {cfg.num_heads} query heads do not divide over "
                f"{n} model ranks (the port splits whole heads)")
    return None


def local_device(mesh):
    """The device of a one-device local mesh (``make_local_mesh``, a Flux
    partition of one card), where a step runs as on one rank; None for any
    other mesh. A local mesh of several devices raises NotImplementedError:
    a step over them runs data- or tensor-parallel in one process, which
    the port does not have (its parallelism runs over ranks; ROADMAP item
    8d)."""
    if mesh is None or getattr(mesh, "devices", None) is None:
        return None
    if mesh.size > 1:
        raise NotImplementedError(
            f"a step over the {mesh.size} local devices of {mesh!r} in one "
            f"process (ROADMAP item 8d): carve one device a partition, or "
            f"run a mesh over ranks (make_host_mesh under a launcher)")
    return mesh.device


def check_local(mesh, t: torch.Tensor, what: str):
    """Raise where ``t`` does not lie on the device of a one-device local
    ``mesh`` (see ``local_device``)."""
    dev = local_device(mesh)
    if dev is not None and not same_device(t.device, dev):
        raise ValueError(f"{what} on {t.device}, not on the device of "
                         f"{mesh!r}, {dev}")


def train_layout(cfg, mesh) -> Optional[TrainLayout]:
    """The ``TrainLayout`` of ``cfg`` on ``mesh`` (either policy) over more
    than one rank; None for one rank and for a one-device local mesh.
    Raises NotImplementedError where ``unsupported`` says why, and for a
    local mesh of several devices (``local_device``)."""
    local_device(mesh)
    if (mesh is None or math.prod(mesh.shape.get(a, 1) for a in
                                  (SH.DATA_AXIS, SH.MODEL_AXIS)) == 1):
        return None
    why = unsupported(cfg, mesh)
    if why:
        raise NotImplementedError(why)
    return TrainLayout(cfg, mesh)


def serve_layout(cfg, mesh, batch: int) -> Optional[ServeLayout]:
    """The ``ServeLayout`` of ``cfg`` serving ``batch`` requests on ``mesh``
    (either policy) over more than one rank; None for one rank and for a
    one-device local mesh. Raises NotImplementedError where ``unsupported``
    says why (a config the port cannot split is never served whole
    instead), and for a local mesh of several devices (``local_device``)."""
    local_device(mesh)
    if (mesh is None or math.prod(mesh.shape.get(a, 1) for a in
                                  (SH.DATA_AXIS, SH.MODEL_AXIS)) == 1):
        return None
    why = unsupported(cfg, mesh)
    if why:
        raise NotImplementedError(why)
    return ServeLayout(cfg, mesh, batch)


def step_group(cfg, layout: Optional[ParamLayout], dp_axes
               ) -> Optional[TP]:
    """The model group a step's forward runs over: ``layout.tp``, and
    under dp_all, where the batch is split over ``model`` too
    (``dp_axes``), the same group with ``split_rows``."""
    tp = layout.tp if layout is not None else None
    if (tp is not None and SH.policy_for(cfg) == "dp_all"
            and SH.MODEL_AXIS in dp_axes):
        tp = dataclasses.replace(tp, split_rows=True)
    return tp
