"""Device selection for the port's entry points: the CUDA card by default,
the CPU only when the caller asks for it. There is no silent fallback.

Also what the kernel wrappers ask of a device on every launch, made cheap:
its SM count, read once per device, and its current stream as a raw
pointer."""
from __future__ import annotations

from typing import Dict

import torch

_sm_counts: Dict[int, int] = {}


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the port on the CPU")
    return dev


def same_device(where: torch.device, dev: torch.device) -> bool:
    """Whether a tensor's device ``where`` is ``dev``. A CPU tensor carries
    no index, whatever index a mesh names its CPU device by."""
    return where.type == dev.type and (dev.type == "cpu"
                                       or where.index == dev.index)


def sm_count(index: int) -> int:
    """The SM count of CUDA device ``index``, queried once and cached."""
    n = _sm_counts.get(index)
    if n is None:
        n = torch.cuda.get_device_properties(index).multi_processor_count
        _sm_counts[index] = n
    return n


def stream_ptr(index: int) -> int:
    """PyTorch's current stream on CUDA device ``index`` as a raw pointer,
    without building a ``torch.cuda.Stream`` (as Triton's launcher reads
    it)."""
    return torch._C._cuda_getCurrentRawStream(index)
