"""Per-op profile of one step of the port: the counterpart of the JAX
package's ``repro/launch/hloprof.py``, which parses a compiled module's HLO
text. PyTorch has no HLO and no ahead-of-time compile, so the step itself
runs once under ``OpProfile``, a ``TorchDispatchMode`` that sees every aten
op after autograd (the backward's and a remat recompute's ops included, as
XLA's module holds the rematerialised ops), on fake tensors
(``FakeTensorMode``: shapes and dtypes, no memory, no arithmetic) or on
real ones. For every op it records:

  * the FLOPs of a matmul-like op (``mm``, ``bmm``, ``addmm``, ``baddbmm``,
    convolutions, the fused attention ops): 2 * numel(out) * k, with the
    output shape and k (the formulas of ``torch.utils.flop_counter``);
  * the bytes of its tensor inputs and outputs (a view moves none);
  * the storage it creates, held by a weak reference until it is freed, so
    the peak of the live bytes above the step's arguments is known without
    keeping a tensor alive;
  * the c10d collectives (kind, dtype, shape, the result's bytes).

What the JAX package counts differently:
  * ``bytes`` is the sum over unfused ops, an upper bound on XLA's
    post-fusion "bytes accessed";
  * there is no HLO text, so ``roofline.parse_collective_bytes`` and
    ``roofline._shape_bytes`` have no counterpart: the collectives are the
    ops dispatched, with their tensors' own shapes;
  * ``dot_flops`` there counts only HLO ``dot``s; here the matmul FLOPs are
    the ``matmul_flops`` (``mm``, ``bmm``, ``addmm``, ``baddbmm``), and
    ``flops`` adds the convolutions and attention ops.
"""
from __future__ import annotations

import weakref
from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

_MATMUL = ("mm", "bmm", "addmm", "baddbmm")
# c10d op name fragments -> the JAX package's collective kinds
_COLLECTIVE_KINDS = (("allreduce", "all-reduce"), ("all_reduce", "all-reduce"),
                     ("reduce_scatter", "reduce-scatter"),
                     ("allgather", "all-gather"), ("all_gather", "all-gather"),
                     ("alltoall", "all-to-all"), ("all_to_all", "all-to-all"),
                     ("broadcast", "broadcast"), ("send", "collective-permute"),
                     ("recv", "collective-permute"))


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage(t: torch.Tensor):
    s = t.untyped_storage()
    return s._cdata, s


def _collective_kind(func) -> Optional[str]:
    if func.namespace not in ("c10d", "_c10d_functional"):
        return None
    name = func.__name__
    for frag, kind in _COLLECTIVE_KINDS:
        if frag in name:
            return kind
    return None


class OpProfile(TorchDispatchMode):
    """Records the ops of the code run under it (see the module docstring).
    ``hold(tree)`` first names the step's arguments, whose storages are not
    counted as temporaries; the caller may set ``argument_bytes`` (what
    ``hold`` returned) and ``output_bytes`` (the live bytes when the step
    returned) for its readers."""

    def __init__(self):
        super().__init__()
        self.dots: List[Dict[str, Any]] = []
        self.collectives: List[Dict[str, Any]] = []
        self.n_ops = 0
        self.bytes = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self.argument_bytes = 0
        self.output_bytes = 0
        self._args = set()
        self._live: Dict[int, int] = {}

    def hold(self, *trees) -> int:
        """Mark the storages of ``trees``' tensors as arguments; returns
        their bytes (each storage once)."""
        n = 0
        for t in _tensors(trees):
            key, s = _storage(t)
            if key not in self._args:
                self._args.add(key)
                n += s.nbytes()
        return n

    @property
    def flops(self) -> float:
        return float(sum(d["flops"] for d in self.dots))

    @property
    def matmul_flops(self) -> int:
        return sum(d["flops"] for d in self.dots if d["op"] in _MATMUL)

    def _freed(self, key: int, n: int):
        if self._live.pop(key, None) is not None:
            self.live_bytes -= n

    def _track(self, outs: List[torch.Tensor]):
        for t in outs:
            key, s = _storage(t)
            if key in self._args or key in self._live:
                continue
            n = s.nbytes()
            self._live[key] = n
            self.live_bytes += n
            weakref.finalize(s, self._freed, key, n)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "prim":
            return out
        self.n_ops += 1
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        packet = func.overloadpacket
        if not func.is_view:
            self.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        if packet in flop_registry:
            flops = int(flop_registry[packet](*args, **kwargs, out_val=out))
            o = outs[0]
            self.dots.append({"op": packet.__name__,
                              "out_shape": tuple(o.shape),
                              "k": flops // max(1, 2 * o.numel()),
                              "flops": flops})
        kind = _collective_kind(func)
        if kind is not None:
            # the c10d ops write into their first argument; the functional
            # ones return their result
            res = _tensors(args[0] if func.namespace == "c10d" else out)
            for t in res:
                self.collectives.append({"kind": kind,
                                         "dtype": str(t.dtype).split(".")[-1],
                                         "shape": tuple(t.shape),
                                         "bytes": _nbytes(t)})
        self._track(outs)
        return out

    def collective_bytes(self) -> Dict[str, int]:
        """Result bytes per collective kind, ``count`` and ``total``, as
        ``roofline.parse_collective_bytes`` gives them in the JAX package."""
        out: Dict[str, int] = defaultdict(int)
        for c in self.collectives:
            out[c["kind"]] += c["bytes"]
        out = dict(out)
        out["count"] = len(self.collectives)
        out["total"] = sum(c["bytes"] for c in self.collectives)
        return out


def top_dots(prof: OpProfile, n: int = 15) -> List[Dict[str, Any]]:
    """Top FLOP contributors grouped by (out_shape, k)."""
    groups: Dict[Tuple, Dict] = defaultdict(lambda: {"flops": 0, "count": 0})
    for d in prof.dots:
        g = groups[(d["out_shape"], d["k"])]
        g["flops"] += d["flops"]
        g["count"] += 1
        g["example"] = d["op"]
    rows = [{"out_shape": k[0], "contract_k": k[1], **v}
            for k, v in groups.items()]
    rows.sort(key=lambda r: -r["flops"])
    return rows[:n]


def collective_report(prof: OpProfile, n: int = 15) -> List[Dict[str, Any]]:
    """Collectives grouped by (kind, dtype, shape), result bytes; empty
    where the step ran none (one rank)."""
    groups: Dict[Tuple, Dict] = defaultdict(lambda: {"bytes": 0, "count": 0})
    for c in prof.collectives:
        g = groups[(c["kind"], c["dtype"], c["shape"])]
        g["bytes"] += c["bytes"]
        g["count"] += 1
    rows = [{"kind": k[0], "dtype": k[1], "shape": k[2], **v}
            for k, v in groups.items()]
    rows.sort(key=lambda r: -r["bytes"])
    return rows[:n]


def profile_cell(arch: str, shape: str, multi_pod: bool = False,
                 cfg_overrides=None) -> Dict[str, Any]:
    """Run the first probe depth of a cell (``costmodel.probe_depths``) on
    fake tensors and return its top compute and collective contributors,
    with the per-layer and fixed FLOPs from the two probe depths."""
    from repro_torch.configs import get_config
    from repro_torch.launch.costmodel import probe_depths
    from repro_torch.launch.dryrun import lower_cell
    cfg = get_config(arch, **(cfg_overrides or {}))
    ov_a, ov_b, n_a, n_b, _ = probe_depths(cfg)
    profs = []
    for ov in (ov_a, ov_b):
        cell, meta = lower_cell(arch, shape, multi_pod,
                                {**(cfg_overrides or {}), **ov})
        if cell is None:
            return {"skipped": meta["skipped"]}
        profs.append(cell.run())
    a, b = profs
    per_layer = (b.flops - a.flops) / (n_b - n_a)
    return {"top_dots": top_dots(a), "collectives": collective_report(a),
            "cost": {"flops": a.flops, "matmul_flops": a.matmul_flops,
                     "bytes accessed": float(a.bytes)},
            "flops_per_layer": per_layer,
            "flops_fixed": a.flops - n_a * per_layer,
            "n_layers_probe": ov_a["num_layers"],
            "n_ops": a.n_ops}
