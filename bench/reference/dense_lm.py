"""Plain PyTorch reference of the dense decoder the benchmark runs
(stablelm-3b as its configuration file states it), with its loss, its
gradients by autograd and AdamW. It imports nothing of the program.

The model, from the configuration's ``port`` block:
  x = embed[tokens]
  per layer:  h = rms(x) * (1 + s1);  q, k, v = h Wq, h Wk, h Wv
              rotary (rotate-half) on the first ``rotary_pct`` of each head
              x += softmax(q k^T / sqrt(hd), causal) v Wo
              h = rms(x) * (1 + s2);  x += (silu(h Wg) * (h Wi)) Wo'
  logits = (rms(x) * (1 + s)) U   over the padded vocabulary
The parameters are the benchmark's leaves (``leaves`` lists them,
``bench/weights.py`` draws them), each stacked leaf cut into one tensor a
layer.

A reference module is found by the ``reference`` key of a configuration's
file, and gives the harness and its loops, for that configuration:
``leaves(m)``, the table of parameters to draw; ``split``, ``logits``,
``token_logprobs``, ``cross_entropy`` and ``train``, the model, its loss
and AdamW; and ``matmul_params`` and ``attention_fwd_flops``, the model
FLOPs that the shares of the peak count.

``prec`` is the arithmetic of every matrix product: ``"fp32"`` (float32,
TF32 off: the reference), or ``"fp8"``, the control: each operand of each
product rounded to float8 e4m3 with a per-tensor scale (the gradients
flowing back through a product to e5m2), the rest in float32.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

E4M3, E5M2 = torch.float8_e4m3fn, torch.float8_e5m2


def padded_vocab(m: Dict) -> int:
    k = m["vocab_pad_multiple"]
    return (m["vocab_size"] + k - 1) // k * k


def leaves(m: Dict) -> List[Tuple[str, Tuple[int, ...], float]]:
    """(path, shape, std) of every leaf, by the port's parameter paths (a
    leading layer dimension on every ``layers/`` leaf); std 0 makes zeros
    (the norms' scales, stored as w - 1). Linear weights are drawn at
    1/sqrt(fan-in), the out-projections further by 1/sqrt(2 L) so the
    residual stream keeps its scale over the depth."""
    d, L, ff, hd = m["d_model"], m["num_layers"], m["d_ff"], m["head_dim"]
    hq, hkv, vp = m["num_heads"] * hd, m["num_kv_heads"] * hd, padded_vocab(m)
    out = 1.0 / math.sqrt(2 * L)
    return [
        ("embed/table", (vp, d), 1.0 / math.sqrt(d)),
        ("final_norm/scale", (d,), 0.0),
        ("layers/attn/wk/w", (L, d, hkv), 1.0 / math.sqrt(d)),
        ("layers/attn/wo/w", (L, hq, d), out / math.sqrt(hq)),
        ("layers/attn/wq/w", (L, d, hq), 1.0 / math.sqrt(d)),
        ("layers/attn/wv/w", (L, d, hkv), 1.0 / math.sqrt(d)),
        ("layers/mlp/w_gate/w", (L, d, ff), 1.0 / math.sqrt(d)),
        ("layers/mlp/w_in/w", (L, d, ff), 1.0 / math.sqrt(d)),
        ("layers/mlp/w_out/w", (L, ff, d), out / math.sqrt(ff)),
        ("layers/norm1/scale", (L, d), 0.0),
        ("layers/norm2/scale", (L, d), 0.0),
        ("unembed/w", (d, vp), 1.0 / math.sqrt(d)),
    ]


def matmul_params(m: Dict) -> int:
    """Parameters that take part in a matrix product for each token: the
    attention projections and the gated MLP of every layer, and the output
    head over the real vocabulary. The embedding lookup is no product and
    is left out."""
    d, hd = m["d_model"], m["head_dim"]
    attn = d * m["num_heads"] * hd * 2 + d * m["num_kv_heads"] * hd * 2
    mlp = 3 * d * m["d_ff"]
    return m["num_layers"] * (attn + mlp) + d * m["vocab_size"]


def attention_fwd_flops(m: Dict, batch: int, seq: int) -> float:
    """The forward's attention products over every layer: Q K^T and P V,
    two FLOPs a multiply-add, over the (query, key) pairs a causal mask
    keeps."""
    return (4.0 * batch * m["num_heads"] * m["head_dim"]
            * (seq * (seq + 1) // 2) * m["num_layers"])


def _fp8(x: torch.Tensor, dtype) -> torch.Tensor:
    """x rounded to ``dtype`` with a per-tensor scale, back in float32."""
    top = torch.finfo(dtype).max
    amax = x.detach().abs().amax().clamp(min=1e-12)
    scale = top / amax
    return (x * scale).clamp(-top, top).to(dtype).float() / scale


class _Q8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _fp8(x, E4M3)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, E5M2)


def _mm(a, b, prec: str):
    if prec == "fp8":
        return torch.matmul(_Q8.apply(a), _Q8.apply(b))
    return torch.matmul(a, b)


@contextlib.contextmanager
def full_fp32():
    """float32 products without TF32, restored on exit."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def split(leaves: Dict[str, torch.Tensor], m: Dict,
          dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """The leaves by reference name: each ``layers/`` leaf cut into its
    layers (``<path>:<layer>``), all in ``dtype``."""
    out = {}
    for path, t in leaves.items():
        if path.startswith("layers/"):
            for i in range(m["num_layers"]):
                out[f"{path}:{i}"] = t[i].to(dtype)
        else:
            out[path] = t.to(dtype)
    return out


def _rms(x, s, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1 + s)


def _rotary(x, pos, m):
    """Rotate-half rotary embedding on the first rotary_pct of each head."""
    hd = m["head_dim"]
    rot = int(m["rotary_pct"] * hd)
    rot -= rot % 2
    half = rot // 2
    inv = 1.0 / (m["rope_theta"] ** (torch.arange(
        half, dtype=torch.float32, device=x.device) / half))
    ang = pos.float()[:, None] * inv                       # (S, half)
    c, s = ang.cos()[None, :, None], ang.sin()[None, :, None]
    x1, x2, rest = x[..., :half], x[..., half:rot], x[..., rot:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s, rest], dim=-1)


def _layer(x, pos, m, prec, s1, wq, wk, wv, wo, s2, wg, wi, wout):
    B, S, _ = x.shape
    H, KV, hd, eps = m["num_heads"], m["num_kv_heads"], m["head_dim"], \
        m["norm_eps"]
    h = _rms(x, s1, eps)
    q = _rotary(_mm(h, wq, prec).view(B, S, H, hd), pos, m)
    k = _rotary(_mm(h, wk, prec).view(B, S, KV, hd), pos, m)
    v = _mm(h, wv, prec).view(B, S, KV, hd)
    rep = H // KV
    q, k, v = (q.transpose(1, 2), k.repeat_interleave(rep, 2).transpose(1, 2),
               v.repeat_interleave(rep, 2).transpose(1, 2))
    scores = _mm(q, k.transpose(-1, -2), prec) / math.sqrt(hd)
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    p = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    o = _mm(p, v, prec).transpose(1, 2).reshape(B, S, H * hd)
    x = x + _mm(o, wo, prec)
    h = _rms(x, s2, eps)
    return x + _mm(F.silu(_mm(h, wg, prec)) * _mm(h, wi, prec), wout, prec)


_LAYER_LEAVES = ("layers/norm1/scale", "layers/attn/wq/w", "layers/attn/wk/w",
                 "layers/attn/wv/w", "layers/attn/wo/w", "layers/norm2/scale",
                 "layers/mlp/w_gate/w", "layers/mlp/w_in/w",
                 "layers/mlp/w_out/w")


def logits(W: Dict[str, torch.Tensor], m: Dict, tokens: torch.Tensor,
           prec: str = "fp32", remat: bool = False) -> torch.Tensor:
    """(B, S, padded vocab) float32 logits of ``tokens`` (B, S); with
    ``remat`` each layer keeps only its input for the backward."""
    S = tokens.shape[1]
    pos = torch.arange(S, device=tokens.device)
    x = W["embed/table"][tokens]
    for i in range(m["num_layers"]):
        args = [W[f"{p}:{i}"] for p in _LAYER_LEAVES]
        if remat:
            x = checkpoint(_layer, x, pos, m, prec, *args, use_reentrant=False)
        else:
            x = _layer(x, pos, m, prec, *args)
    x = _rms(x, W["final_norm/scale"], m["norm_eps"])
    return _mm(x, W["unembed/w"], prec)


def token_logprobs(W, m, tokens: torch.Tensor, prec: str = "fp32"
                   ) -> torch.Tensor:
    """(B, S - 1): the log-probability of each next token."""
    with torch.no_grad(), full_fp32():
        lp = torch.log_softmax(logits(W, m, tokens, prec)[:, :-1], dim=-1)
        return lp.gather(-1, tokens[:, 1:, None].long())[..., 0]


def cross_entropy(W, m, tokens, labels, prec: str = "fp32",
                  remat: bool = True) -> torch.Tensor:
    """Mean over every token of logsumexp(logits) - logits[label]."""
    lg = logits(W, m, tokens, prec, remat)
    gold = lg.gather(-1, labels[..., None].long())[..., 0]
    return (torch.logsumexp(lg, dim=-1) - gold).mean()


def no_decay(name: str) -> bool:
    """AdamW's decay skips the norms' scales (stored as w - 1)."""
    return name.split(":")[0].endswith("/scale")


def learning_rate(opt: Dict, step: int) -> float:
    """Warmup to ``lr`` over ``warmup_steps``, then a cosine down to
    ``min_lr_ratio`` of it at ``total_steps``; ``step`` counts from 0."""
    warm = min(1.0, (step + 1.0) / max(1, opt["warmup_steps"]))
    prog = min(1.0, max(0.0, (step - opt["warmup_steps"])
                        / max(1, opt["total_steps"] - opt["warmup_steps"])))
    cos = 0.5 * (1.0 + math.cos(math.pi * prog))
    r = opt["min_lr_ratio"]
    return opt["lr"] * warm * (r + (1 - r) * cos)


def train(m: Dict, leaves: Dict[str, torch.Tensor], tokens: torch.Tensor,
          labels: torch.Tensor, opt: Dict, steps: int, prec: str = "fp32",
          rows: Optional[List[int]] = None,
          observe: Optional[Callable] = None) -> Dict:
    """``steps`` AdamW steps from ``leaves``, the parameters stored in the
    configuration's dtype (each update computed in float32 and rounded
    once to it, as the configuration states), the moments in float32.

    The loss is the mean over every token of ``rows`` of the batch (all by
    default), its gradient summed over one sequence at a time. Gradients
    are clipped by their global norm before the moments. Returns each
    step's ``losses``, and ``observe(step, grads_as_optimizer_gets_them,
    stored)`` is called after each update, the gradients already scaled.
    """
    store_dtype = next(iter(leaves.values())).dtype
    store = split(leaves, m, store_dtype)
    del leaves
    mu = {n: torch.zeros(t.shape, dtype=torch.float32, device=t.device)
          for n, t in store.items()}
    nu = {n: torch.zeros_like(v) for n, v in mu.items()}
    b1, b2 = opt["betas"]
    rows = list(range(tokens.shape[0])) if rows is None else rows
    losses = []
    with full_fp32():
        for step in range(1, steps + 1):
            W = {n: t.to(torch.float32, copy=True).requires_grad_()
                 for n, t in store.items()}
            total = 0.0
            for r in rows:
                loss = cross_entropy(W, m, tokens[r:r + 1], labels[r:r + 1],
                                     prec) / len(rows)
                loss.backward()
                total += loss.item()
            losses.append(total)
            grads = {n: w.grad for n, w in W.items()}
            del W
            gnorm = math.sqrt(sum(g.double().square().sum().item()
                                  for g in grads.values()))
            scale = min(1.0, opt["clip_norm"] / (gnorm + 1e-9))
            lr = learning_rate(opt, step - 1)
            bc1, bc2 = 1.0 - b1 ** step, 1.0 - b2 ** step
            for n, g in grads.items():
                g.mul_(scale)
                mu[n].mul_(b1).add_(g, alpha=1 - b1)
                nu[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                upd = (mu[n] / bc1) / ((nu[n] / bc2).sqrt() + opt["eps"])
                p = store[n].float()
                if not no_decay(n):
                    upd = upd + opt["weight_decay"] * p
                store[n] = (p - lr * upd).to(store_dtype)
            if observe is not None:
                observe(step, grads, store)
            del grads
    return {"losses": losses}
