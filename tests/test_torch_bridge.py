"""JAX params -> the port -> numpy round-trips bit-exactly."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.models import model as jM
from repro_torch import bridge


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["chatglm3-6b", "qwen2-vl-7b", "gemma-7b"])
def test_bridge_round_trip_is_bit_exact(arch, dtype):
    cfg = get_smoke_config(arch, dtype=dtype)
    params = jax.tree.map(np.asarray, jM.init_params(jax.random.PRNGKey(3), cfg))
    tp = bridge.to_torch(params, device="cpu")
    want_dtype = torch.float32 if dtype == "float32" else torch.bfloat16
    for name, t in _leaves(tp):
        assert t.dtype == want_dtype, name
        assert t.device.type == "cpu"
    back = bridge.to_numpy(tp)
    src, out = dict(_leaves(params)), dict(_leaves(back))
    assert src.keys() == out.keys()
    for name, a in src.items():
        b = out[name]
        assert b.dtype == a.dtype and b.shape == a.shape, name
        assert a.tobytes() == b.tobytes(), name


def test_bridge_keeps_layout_and_values():
    cfg = get_smoke_config("stablelm-3b", dtype="float32")
    params = jax.tree.map(np.asarray, jM.init_params(jax.random.PRNGKey(0), cfg))
    tp = bridge.to_torch(params, device="cpu")
    w = params["layers"]["attn"]["wq"]["w"]
    assert tuple(tp["layers"]["attn"]["wq"]["w"].shape) == w.shape
    assert w.shape == (cfg.num_layers, cfg.d_model, cfg.num_heads * cfg.head_dim)
    np.testing.assert_array_equal(tp["layers"]["attn"]["wq"]["w"].numpy(), w)


def test_bridge_rejects_non_numpy():
    with pytest.raises(TypeError):
        bridge.to_torch({"w": [1.0, 2.0]}, device="cpu")


def test_bridge_defaults_to_the_card_and_raises_without_cuda(monkeypatch):
    """Like the port's entry points, the bridge puts weights on the card
    unless the caller asks for the CPU: without CUDA the default raises
    instead of quietly keeping them on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bridge.to_torch({"w": np.zeros(2, np.float32)})
    assert bridge.to_torch({"w": np.zeros(2, np.float32)},
                           device="cpu")["w"].device.type == "cpu"
