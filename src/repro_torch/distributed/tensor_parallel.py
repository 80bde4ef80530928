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
    ``serve_step.sample`` reads unchanged on every rank;
  * ``head_slots``: the padded head layout of query heads that do not
    divide over ``model``; ``SeqPar`` and ``combine_partials``: the
    sequence-parallel decode of a batch that no batch axis divides.

Query heads that do not divide over ``model`` (qwen2-vl-7b's 28 and
musicgen-medium's 24 over 16 ranks; both under the replicated-KV rule,
since kv heads that divide over the ranks make the query heads divide
too): each rank holds whole heads, ``per_rank`` slots of them, some of
which hold padding heads (``HeadSlots``). Under GQA each kv group of G
query heads is padded to G' slots, so that a rank's slots lie in one group
(rank r reads kv head r // (n / KV); 28 heads in 4 groups of 7 -> 32 slots,
2 a rank on 16 ranks); under MHA the heads are padded at the tail (24 ->
32 slots, ranks 12-15 holding only padding). A rank's blocks of ``wq``
(columns), its bias and ``wo`` (rows) carry its slots, the padded ones
zero; every gathered tree holds the real heads alone, in JAX's layout
(``ParamLayout.block``, ``gather_leaf``). A rank attends with its real
heads only and puts zeros in its padded slots' outputs before ``wo``, so a
padded entry takes part in no output and gets a zero gradient (AdamW and
ZeRO-1 keep it zero); a rank of padding alone launches no attention kernel
(``unread`` keeps it in the backward's collectives). JAX splits ``wq``'s
columns mid-head instead (3,584 / 16 = 224) and lets GSPMD reshard around
the attention.

Sequence-parallel decode (a serving batch that no batch axis divides, the
long_500k cells' batch 1): each ``data`` rank holds the whole batch's rows
and its contiguous block of the cache's sequence, positions [r * Sb, (r +
1) * Sb), as ``cache_pspec`` lays it out; heads stay over ``model``,
Mamba2 states and conv windows are whole on every data rank (every data
rank runs the same Mamba2 step). Each rank runs the prefill of the whole
prompt and keeps its block of each layer's K/V; a decode step writes the
new row on the rank whose block holds it, attends over its block (the
decode kernel's softmax partial, ``return_lse``) and ``combine_partials``
joins the data group's partials.

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
import functools
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
             tp: TP, first: Optional[int] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The replicated-KV rule: K/V (B, S, KV, hd) whole on every rank; this
    rank's ``n_heads`` query heads (``first`` on, by default ``rank *
    n_heads``) read kv heads ``h // groups`` (groups = H / KV). Returns
    views of exactly the kv heads they read, after ``copy_to_tp`` (each kv
    head's gradient is summed over the ranks whose heads read it), so the
    kernel's ``h // G`` on local indices finds them."""
    first = tp.rank * n_heads if first is None else first
    kv0, kv1 = first // groups, (first + max(n_heads, 1) - 1) // groups
    if kv1 > kv0 and (first % groups or n_heads % groups):
        raise ValueError(f"query heads {first}-{first + n_heads - 1} over "
                         f"groups of {groups}: a rank's heads straddle kv "
                         f"heads")
    k, v = copy_to_tp(k, tp), copy_to_tp(v, tp)
    return k[:, :, kv0:kv1 + 1], v[:, :, kv0:kv1 + 1]


class _Unread(torch.autograd.Function):
    @staticmethod
    def forward(ctx, out, *inputs):
        ctx.shapes = [(t.shape, t.dtype, t.device) for t in inputs]
        return out

    @staticmethod
    def backward(ctx, g):
        return (g, *(torch.zeros(s, dtype=d, device=dev)
                     for s, d, dev in ctx.shapes))


def unread(out: torch.Tensor, *inputs: torch.Tensor) -> torch.Tensor:
    """``out``, with ``inputs`` made to take part in its backward with a
    zero gradient: a rank whose heads are all padding computes no attention,
    yet the collectives behind its q and K/V (``copy_to_tp``'s all-reduce of
    the gradient) must run on it as on the rank that attends."""
    return _Unread.apply(out, *inputs)


# ------------------------------------------------- heads padded to slots
@dataclass(frozen=True)
class HeadSlots:
    """The padded head layout of query heads that do not divide over the
    model ranks (see the module docstring): the ``n_heads`` real heads in
    ``groups`` runs of ``group`` (the kv groups, or one run of all the
    heads), each run padded to ``padded`` slots, then padding slots at the
    tail up to ``len(heads)``. ``heads[i]`` is the real head in global
    slot i or -1 for a padding slot; rank r holds slots [r * per_rank, (r +
    1) * per_rank), its real heads the first of them and consecutive."""
    n_heads: int
    per_rank: int
    groups: int
    group: int
    padded: int
    heads: Tuple[int, ...]

    def real(self, rank: int) -> Tuple[int, int]:
        """(first real head, number of real heads) of ``rank``'s slots."""
        mine = [h for h in self.heads[rank * self.per_rank:
                                      (rank + 1) * self.per_rank] if h >= 0]
        return (mine[0] if mine else 0), len(mine)


@functools.lru_cache(maxsize=None)
def _slots(H: int, KV: int, n: int) -> Optional[HeadSlots]:
    G = H // KV
    if G == 1:                              # MHA: padded at the tail
        per = -(-H // n)
        return HeadSlots(H, per, 1, H, H,
                         tuple(range(H)) + (-1,) * (n * per - H))
    if n % KV:                              # a rank's slots would straddle
        return None
    step = n // KV                          # ranks a kv head
    padded = -(-G // step) * step           # G', a multiple of the ranks
    heads = tuple(kv * G + j if j < G else -1
                  for kv in range(KV) for j in range(padded))
    return HeadSlots(H, padded // step, KV, G, padded, heads)


def head_slots(cfg, n) -> Optional[HeadSlots]:
    """The padded head layout of ``cfg``'s query heads over ``n`` model
    ranks (an int, or a ``TP``), or None where they divide (or under
    dp_all, MLA or one rank); None too where no layout keeps a rank's heads
    on one kv head (``unsupported`` says so)."""
    n = n.size if isinstance(n, TP) else (n or 1)
    if (n == 1 or not cfg.num_heads or cfg.use_mla
            or SH.policy_for(cfg) != "tp16" or cfg.num_heads % n == 0):
        return None
    return _slots(cfg.num_heads, cfg.num_kv_heads, n)


_HEAD_DIM = {"wq/w": -1, "wq/b": -1, "wo/w": -2}


def head_dim_of(path: str) -> Optional[int]:
    """The dim of a GQA leaf that holds its query heads (``attn/wq``'s
    columns and bias, ``attn/wo``'s rows), or None."""
    parts = path.split("/")
    if len(parts) < 3 or parts[-3] != "attn":
        return None
    return _HEAD_DIM.get("/".join(parts[-2:]))


def pad_heads(t: torch.Tensor, dim: int, slots: HeadSlots) -> torch.Tensor:
    """``t`` with its ``dim`` (negative) of H heads laid out in ``slots``'
    global slots, zeros in the padding ones (fake and meta tensors too)."""
    hd = t.shape[dim] // slots.n_heads
    x = t.unflatten(dim, (slots.groups, slots.group, hd))
    g = dim - 1                              # the heads of a run
    x = torch.cat([x, x.new_zeros(x.shape[:g] + (slots.padded - slots.group,)
                                  + x.shape[g + 1:])], g).flatten(g - 1, g)
    tail = len(slots.heads) - slots.groups * slots.padded
    x = torch.cat([x, x.new_zeros(x.shape[:g] + (tail,) + x.shape[g + 1:])],
                  g)
    return x.flatten(g, g + 1)


def unpad_heads(t: torch.Tensor, dim: int, slots: HeadSlots) -> torch.Tensor:
    """The inverse of ``pad_heads``: the real heads of ``t``'s slots along
    ``dim`` (negative), in head order."""
    hd = t.shape[dim] // len(slots.heads)
    x = t.unflatten(dim, (len(slots.heads), hd)).narrow(
        dim - 1, 0, slots.groups * slots.padded)
    x = x.unflatten(dim - 1, (slots.groups, slots.padded)).narrow(
        dim - 1, 0, slots.group)
    return x.flatten(dim - 2, dim - 1).flatten(dim - 1, dim)


# ----------------------------------------------------------- layouts
class ParamLayout:
    """How the ranks of ``mesh`` hold a model's parameters: each leaf's
    block by its spec (``sharding.params_pspec``: under tp16 split over
    ``model``, under dp_all only the vocabulary; replicated over ``data``),
    and this rank's model group (``tp``). Where the query heads do not
    divide over ``model`` (``heads``, a ``HeadSlots``), the blocks of the
    GQA leaves that hold them are those of the leaf padded to its slots
    (``padded_shapes``); ``shapes`` are the leaves' own (JAX's)."""

    def __init__(self, cfg, mesh):
        from repro_torch.models.model import init_params   # models imports us
        struct = init_params(cfg, device="meta")
        self.cfg = cfg
        self.mesh = mesh
        self.tp = model_group(mesh)
        self.specs = SH.params_pspec(cfg, mesh, struct)
        self.shapes = {p: tuple(t.shape) for p, t in T.flatten(struct)}
        self.heads = head_slots(cfg, self.tp) if self.tp is not None else None
        self._padded = ({p: head_dim_of(p) for p in self.shapes
                         if head_dim_of(p) is not None}
                        if self.heads is not None else {})
        self.padded_shapes = {
            p: (tuple(pad_heads(t, self._padded[p], self.heads).shape)
                if p in self._padded else tuple(t.shape))
            for p, t in T.flatten(struct)}
        self._split = {p for p, spec in self.specs.items()
                       if self.tp is not None
                       and any(SH.MODEL_AXIS in SH._axes_of(e) for e in spec)}

    def split_over_model(self, path: str) -> bool:
        """Whether ranks of the model group hold other parts of the leaf."""
        return path in self._split

    def block(self, path: str, t: torch.Tensor, specs=None) -> torch.Tensor:
        """This rank's block of the whole leaf ``t`` at ``path`` under
        ``specs`` (by default the parameters'): a contiguous copy, of the
        leaf padded to its head slots where it has them."""
        if path in self._padded:
            t = pad_heads(t, self._padded[path], self.heads)
        spec = (specs or self.specs)[path]
        sl = SH.local_slices(spec, tuple(t.shape), self.mesh)
        return t[sl].clone(memory_format=torch.contiguous_format)

    def gather_leaf(self, path: str, t: torch.Tensor, specs=None
                    ) -> torch.Tensor:
        """The whole leaf from every rank's block ``t`` (collective), its
        real heads alone where it has head slots: the inverse of
        ``block``."""
        whole = SH.gather_leaf(t, (specs or self.specs)[path], self.mesh)
        if path in self._padded:
            whole = unpad_heads(whole, self._padded[path], self.heads)
        return whole

    def shard_params(self, params):
        """This rank's block of every leaf of a whole parameter tree."""
        return T.unflatten(params, [self.block(p, t)
                                    for p, t in T.flatten(params)])

    def gather_params(self, params):
        """The whole tree from every rank's blocks (collective)."""
        return T.unflatten(params, [self.gather_leaf(p, t)
                                    for p, t in T.flatten(params)])

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
            return t if path is None else self.block(path, t)
        with L.drawn_leaves(block):
            params = M.init_params(self.cfg, seed=seed, device=device)
        # the leaves drawn otherwise (zeros, the Mamba2 per-head draws) are
        # whole yet; a block of a whole leaf is itself
        return T.unflatten(params, [
            self.block(p, t) if tuple(t.shape) == self.shapes[p] else t
            for p, t in T.flatten(params)])


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
            self.specs[path], self.padded_shapes[path], self.mesh)]
        only_data = tuple(SH.DATA_AXIS if i == dim else None
                          for i in range(len(local)))
        return dim, SH.local_slices(only_data, tuple(local), self.mesh)

    def gather_moments(self, tree):
        """The whole moments from every rank's blocks (collective)."""
        return T.unflatten(tree, [
            self.gather_leaf(p, t, self.moment_specs)
            for p, t in T.flatten(tree)])


@dataclass(frozen=True)
class SeqPar:
    """The data group of a sequence-parallel decode: ``group`` (None for
    one rank), ``size``, this rank's ``rank`` in it and the ``rows`` of its
    block of the cache's sequence, positions [rank * rows, (rank + 1) *
    rows)."""
    group: Any
    size: int
    rank: int
    rows: int


def combine_partials(o: torch.Tensor, lse: torch.Tensor, sp: SeqPar
                     ) -> torch.Tensor:
    """The attention over the whole cache from this rank's softmax partial
    of its block, (o (B, 1, H, hd) f32, lse (B, H) f32; the decode kernel's
    ``return_lse``), over the data group: one all-reduce MAX of lse (L),
    then one all-reduce SUM of (w * o, w) concatenated, w = e^(lse - L)
    (0 where the block holds no valid row, lse -inf), and O = sum w * o /
    sum w, f32. Every head has a valid row on some rank (position 0's)."""
    L = all_reduce(lse.clone(), sp.group, op=dist.ReduceOp.MAX)
    w = torch.exp(lse - L)                           # (B, H)
    wo = w[:, None, :, None] * o                     # (B, 1, H, hd)
    both = all_reduce(torch.cat([wo.reshape(-1), w.reshape(-1)]), sp.group)
    n = wo.numel()
    return both[:n].view_as(wo) / both[n:].view(w.shape)[:, None, :, None]


class ServeLayout(ParamLayout):
    """How the ranks of ``mesh`` serve a batch of ``batch`` requests: the
    parameter blocks of ``ParamLayout`` (no moments), each decode cache
    leaf's block by ``sharding.cache_pspec``, the batch's rows over
    ``batch_axes(mesh, cfg, batch)`` (``rows`` a rank), and the model
    group ``tp`` the prefill and decode steps run over: under dp_all with
    ``split_rows`` where that serving batch splits over ``model`` too (on
    the production mesh B = 32 and 128 drop ``model``, so a group's ranks
    hold the same rows).

    A batch that no batch axis divides (the long_500k cells' batch 1) on a
    mesh whose ``data`` axis has several ranks is served sequence-parallel
    (``seq_parallel``; see the module docstring): every rank holds the
    whole batch, and the cache's sequence is split over ``data``
    (``seq_par``). MLA, whose latents ``cache_pspec`` would split alike, is
    refused: no MLA architecture runs long_500k."""

    def __init__(self, cfg, mesh, batch: int):
        super().__init__(cfg, mesh)
        self.batch_axes = SH.batch_axes(mesh, cfg, batch)
        n_data = mesh.shape.get(SH.DATA_AXIS, 1)
        self.seq_parallel = not self.batch_axes and n_data > 1
        if self.seq_parallel and cfg.use_mla:
            raise NotImplementedError(
                f"{cfg.name}: a batch of {batch} does not divide over the "
                f"{n_data} data ranks, and the sequence-parallel decode of "
                f"MLA's latent cache is not implemented (no MLA architecture "
                f"runs long_500k)")
        self.rows = batch // mesh.axes_size(self.batch_axes)
        self.cache_specs = SH.cache_pspec(cfg, mesh, batch)
        self.tp = step_group(cfg, self, self.batch_axes)

    def seq_par(self, capacity: int) -> Optional[SeqPar]:
        """The data group's ``SeqPar`` for a cache of ``capacity``
        positions, or None where the batch's rows are split instead. A
        capacity that does not divide over ``data`` raises ValueError."""
        if not self.seq_parallel:
            return None
        n = self.mesh.shape[SH.DATA_AXIS]
        if capacity % n:
            raise ValueError(
                f"a cache of {capacity} positions does not divide over the "
                f"{n} data ranks of a sequence-parallel decode")
        return SeqPar(self.mesh.group((SH.DATA_AXIS,)), n,
                      self.mesh.coordinate()[SH.DATA_AXIS], capacity // n)

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
    ``model`` axis, or None (also for one rank). Query heads that do not
    divide are padded (``head_slots``) where a rank's slots can keep to one
    kv head."""
    n = mesh.shape.get(SH.MODEL_AXIS, 1)
    if n == 1:
        return None
    if cfg.vocab_tp and cfg.padded_vocab % n:
        return (f"{cfg.name}: the vocabulary of {cfg.padded_vocab} rows does "
                f"not divide over {n} model ranks")
    if SH.policy_for(cfg) != "tp16":
        return None
    H, KV = cfg.num_heads, cfg.num_kv_heads
    if H % n and (cfg.use_mla or head_slots(cfg, n) is None):
        return (f"{cfg.name}: {H} query heads do not divide over {n} model "
                f"ranks, and " + ("MLA's heads are not padded" if cfg.use_mla
                                  else f"their {KV} kv heads do not divide "
                                  f"the ranks (a rank's padded heads would "
                                  f"straddle kv heads)"))
    if cfg.family == "hybrid":
        H, G = cfg.ssm_heads, cfg.ssm_groups
        if H % n:
            return (f"{cfg.name}: {H} SSD heads do not divide over {n} model "
                    f"ranks")
        per_group, mine = H // G, H // n
        if mine % per_group and per_group % mine:
            return (f"{cfg.name}: {mine} SSD heads a rank straddle the "
                    f"{G} B/C groups of {per_group} heads")
    return None


def local_device(mesh):
    """The device of a one-device local mesh (``make_local_mesh``, a Flux
    partition of one card), where a step runs as on one rank; None for any
    other mesh. A local mesh of several devices raises NotImplementedError
    when a step is made over it in the calling process: the port's data and
    tensor parallelism run over ranks, so such a step runs in a group of
    ranks spawned over the mesh's devices, each with a mesh over the group
    (``launch/ranks.run_on_mesh``, which the flux executor calls for a task
    on such a partition)."""
    if mesh is None or getattr(mesh, "devices", None) is None:
        return None
    if mesh.size > 1:
        raise NotImplementedError(
            f"a step over the {mesh.size} local devices of {mesh!r} runs in "
            f"a group of ranks, one a device: call it through "
            f"launch.ranks.run_on_mesh(mesh, fn, ...), or submit it as a "
            f"flux task on the partition (the flux executor spawns the "
            f"group), or run a mesh over ranks (make_host_mesh under a "
            f"launcher)")
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
