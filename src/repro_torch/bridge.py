"""Carry weights between the JAX package and the port, as numpy.

The JAX side's ``init_params`` returns a nested dict of arrays; handed over as
numpy, ``to_torch`` turns it into the port's nested dict of tensors and
``to_numpy`` goes back. Leaf names, the stacked leading layer dim and the
``(d_in, d_out)`` orientation of linear weights are kept, so ``x @ w`` means
the same on both sides.

bf16 arrives as an ``ml_dtypes`` bfloat16 array, which ``torch.from_numpy``
rejects: it crosses as a ``uint16`` view of the same bits (the trick the JAX
package's checkpoint format uses for ``.npz``).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.device import resolve_device


def _leaf_to_torch(a: np.ndarray, device) -> torch.Tensor:
    if not isinstance(a, np.ndarray):
        raise TypeError(f"bridge takes numpy arrays, got {type(a).__name__}")
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device)


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes               # only needed to hand bf16 back to numpy
        return t.view(torch.int16).numpy().view(np.uint16).view(
            ml_dtypes.bfloat16)
    return t.numpy().copy()


def to_torch(tree: Dict[str, Any], device="cuda") -> Dict[str, Any]:
    """Nested dict of numpy arrays -> nested dict of tensors on ``device``:
    the card unless the caller asks for the CPU (without CUDA the default
    raises, as the port's entry points do)."""
    return _tree_to_torch(tree, resolve_device(device))


def _tree_to_torch(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to_torch(v, device) for k, v in tree.items()}
    return _leaf_to_torch(tree, device)


def to_numpy(tree: Dict[str, Any]) -> Dict[str, Any]:
    """Inverse of ``to_torch``: bit-exact, bf16 back as ``ml_dtypes`` bf16."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    return _leaf_to_numpy(tree)
