"""The benchmark's weights: made from ``--seed`` on the device, by the
benchmark and not by the program, so that the plain reference can make the
same values again without reading anything the program holds.

What is drawn is the configuration's reference module's table,
``ref.leaves(m)``: (path, shape, std) of each leaf, by the port's parameter
paths. Each leaf is drawn by its own ``torch.Generator`` on the device,
seeded from the run's seed and the leaf's index, in one call per leaf (a
stacked leaf holds every layer), in float32 and rounded once to the dtype
the configuration serves in. So one leaf can be made again alone, and the
same seed on the same device gives the same bits.

``to_program`` checks the names and shapes against the program's own tree
before handing them over.
"""
from __future__ import annotations

from typing import Dict

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def leaf_seed(seed: int, index: int) -> int:
    """A generator seed for leaf ``index`` of run ``seed`` (any whole
    number, also one past 32 bits)."""
    return (int(seed) * 1_000_003 + 7919 * (index + 1)) % (1 << 63)


def make_leaf(ref, m: Dict, seed: int, path: str, device, dtype=None
              ) -> torch.Tensor:
    """Leaf ``path`` of run ``seed``, made again alone."""
    table = ref.leaves(m)
    index = [p for p, _, _ in table].index(path)
    _, shape, std = table[index]
    dtype = dtype or DTYPES[m["dtype"]]
    if std == 0.0:
        return torch.zeros(shape, dtype=dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(leaf_seed(seed, index))
    t = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return t.mul_(std).to(dtype)


def make(ref, m: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every leaf of run ``seed``, by path."""
    return {p: make_leaf(ref, m, seed, p, device) for p, _, _ in
            ref.leaves(m)}


def to_program(cfg, leaves: Dict[str, torch.Tensor]):
    """The port's parameter tree holding ``leaves``; raises unless their
    paths and shapes are exactly those of the tree the program builds for
    ``cfg`` (read on the ``meta`` device: shapes only)."""
    from repro_torch import tree as T
    from repro_torch.models import model as M
    template = M.init_params(cfg, device="meta")
    want = {p: tuple(t.shape) for p, t in T.flatten(template)}
    have = {p: tuple(t.shape) for p, t in leaves.items()}
    if want != have:
        raise ValueError(f"the benchmark's leaves {have} are not the "
                         f"program's {want}")
    return T.unflatten(template, [leaves[p] for p, _ in T.flatten(template)])
