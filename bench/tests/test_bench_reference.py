"""Each configuration's plain reference (``bench/reference/<reference>.py``)
against the port's forward, loss, gradients and AdamW steps, on the CPU at
the configuration's smoke size in float32 (the port's kernels take their
plain versions on CPU tensors), from the benchmark's own weights. This
holds the reference before the card uses it."""
import json

import pytest
import torch

from bench import harness, weights

MAN = harness.manifest()
CONFIGS = sorted(c["name"] for c in MAN["configs"])


def smoke(name):
    """(the configuration as run at its smoke size in float32, its
    reference module)."""
    entry = next(c for c in MAN["configs"] if c["name"] == name)
    conf = json.loads((harness.ROOT / entry["file"]).read_text())
    m = {**harness.port_config(conf), **conf["smoke"], "dtype": "float32"}
    return m, harness.reference_of(conf)


def optimizer():
    """The AdamW settings of the first traffic that trains."""
    for path in sorted((harness.BENCH / "traffic").glob("*.json")):
        opt = json.loads(path.read_text()).get("optimizer")
        if opt:
            return opt
    pytest.skip("no traffic trains")


def batch_of(m, B=3, S=24, seed=0):
    g = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, m["vocab_size"], (B, S), generator=g)
    pos = torch.arange(S, dtype=torch.int32)[None].expand(B, S)
    return {"tokens": toks, "labels": toks, "positions": pos}


def by_layer(path, t):
    return ([(f"{path}:{i}", t[i]) for i in range(t.shape[0])]
            if path.startswith("layers/") else [(path, t)])


@pytest.mark.parametrize("config", CONFIGS)
def test_forward_and_logprobs(config):
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import model as M
    m, ref = smoke(config)
    cfg = ModelConfig(**m)
    leaves = weights.make(ref, m, 11, "cpu")
    batch = batch_of(m)
    with torch.no_grad():
        got, _, _ = M.forward(weights.to_program(cfg, leaves), cfg, batch)
    W = ref.split(leaves, m)
    want = ref.logits(W, m, batch["tokens"])
    assert got.shape == want.shape
    assert (got - want).abs().max() < 1e-5
    lp = ref.token_logprobs(W, m, batch["tokens"])
    mine = torch.log_softmax(got[:, :-1], -1).gather(
        -1, batch["tokens"][:, 1:, None])[..., 0]
    assert (lp - mine).abs().max() < 1e-5


@pytest.mark.parametrize("config", CONFIGS)
def test_loss_and_gradients(config):
    from repro_torch import tree as T
    from repro_torch.configs.base import ModelConfig
    from repro_torch.distributed.train_step import make_grad_fn
    m, ref = smoke(config)
    cfg = ModelConfig(**m)
    leaves = weights.make(ref, m, 12, "cpu")
    batch = batch_of(m)
    grads, metrics = make_grad_fn(cfg)(weights.to_program(cfg, leaves), batch)
    W = {n: t.clone().requires_grad_() for n, t in ref.split(leaves, m).items()}
    loss = ref.cross_entropy(W, m, batch["tokens"], batch["labels"])
    loss.backward()
    assert abs(loss.item() - metrics["loss"].item()) < 1e-5
    for path, g in T.flatten(grads):
        for name, gp in by_layer(path, g):
            gr = W[name].grad
            assert (gp - gr).abs().max() <= 1e-4 * gr.abs().max() + 1e-9, name


@pytest.mark.parametrize("config", CONFIGS)
def test_adamw_steps(config):
    from repro_torch import tree as T
    from repro_torch.configs.base import ModelConfig
    from repro_torch.distributed.train_step import make_train_step
    from repro_torch.optim import adamw
    m, ref = smoke(config)
    cfg = ModelConfig(**m)
    opt = optimizer()
    batch = batch_of(m, B=4)
    params = weights.to_program(cfg, weights.make(ref, m, 13, "cpu"))
    state = adamw.init(params)
    step = make_train_step(cfg, adamw.OptimizerConfig(
        **dict(opt, betas=tuple(opt["betas"]))))
    losses = []
    for _ in range(3):
        params, state, metrics = step(params, state, batch)
        losses.append(metrics["loss"].item())
    got = {}
    want = ref.train(m, weights.make(ref, m, 13, "cpu"), batch["tokens"],
                     batch["labels"], opt, 3,
                     observe=lambda s, g, st: got.update(st))
    assert max(abs(a - b) for a, b in zip(losses, want["losses"])) < 1e-5
    for path, p in T.flatten(params):
        for name, pp in by_layer(path, p):
            assert (pp - got[name]).abs().max() < 1e-5, name
