"""Matmul FLOPs of the port's steps (``repro_torch.launch.opprof`` over the
dry-run's fake step) against the JAX package's profile of the same step
(``repro.launch.hloprof.dot_flops`` over the HLO of the step compiled
unrolled, ``scan_layers=False``, on one CPU device): every smoke config, the
train, prefill and decode steps, batch 2 x 16, ``use_pallas=False`` on both.

They are equal to the FLOP, with one difference by design, pinned here:
the train step of a Mamba2 layer (mamba2-130m, zamba2-7b). ``ssd_chunked``
multiplies a per-position decay (b, c, l, h) into two three-operand
einsums (``Sc``, ``y_inter``). JAX's transpose of each writes that factor's
gradient as a dot_general contracting the head dim P; torch's autograd of
the broadcast product computes the same sum as a multiply and a sum, which
no matmul counter sees. So JAX counts 2 x 2*B*S*H*P = 4*B*S*d_inner more
per Mamba2 layer, for the same arithmetic (ROADMAP.md section 3).

Two other gaps were faults of the port, now repaired, and these tests fail
without the repairs: the hybrid's shared attention block ran under remat
(JAX's does not), and an MoE layer's aux loss came after its shared experts,
so the recompute ran their down projection again.
"""
import dataclasses

import jax
import pytest

from repro.configs import get_smoke_config as jget_smoke
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.distributed.serve_step import make_decode_step as jdecode_step
from repro.distributed.serve_step import make_prefill_step as jprefill_step
from repro.distributed.train_step import make_train_step as jtrain_step
from repro.launch import hloprof
from repro.launch import specs as JSP
from repro.optim.adamw import OptimizerConfig as JOptimizerConfig
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun as D
from repro_torch.launch import opprof
from repro_torch.launch.mesh import abstract_mesh

B, S = 2, 16


def _jax_dot_flops(arch, kind):
    cfg = dataclasses.replace(jget_smoke(arch), scan_layers=False)
    shape = JShapeConfig("smoke", S, B, kind)
    params = JSP.params_struct(cfg)
    if kind == "train":
        lowered = jax.jit(jtrain_step(cfg, JOptimizerConfig())).lower(
            params, JSP.opt_state_struct(params),
            JSP.train_input_specs(cfg, shape))
    elif kind == "prefill":
        lowered = jax.jit(jprefill_step(cfg)).lower(
            params, JSP.prefill_input_specs(cfg, shape))
    else:
        batch, cache = JSP.decode_input_specs(cfg, shape)
        lowered = jax.jit(jdecode_step(cfg)).lower(params, batch, cache)
    return sum(d["flops"]
               for d in hloprof.dot_flops(lowered.compile().as_text()))


def _port_profile(arch, kind):
    full, sm = get_config(arch), get_smoke_config(arch)
    over = {f.name: getattr(sm, f.name) for f in dataclasses.fields(sm)
            if f.name != "name" and getattr(sm, f.name) != getattr(full,
                                                                   f.name)}
    cell, _ = D.lower_cell(arch, None, False, over,
                           shape=ShapeConfig("smoke", S, B, kind),
                           mesh=abstract_mesh(data=1, model=1))
    return cell.run()


def pinned_gap(arch, kind) -> int:
    """JAX's dot FLOPs minus the port's matmul FLOPs (see the docstring)."""
    cfg = get_smoke_config(arch)
    if kind != "train" or not cfg.ssm_state:
        return 0
    return cfg.num_layers * 4 * B * S * cfg.ssm_d_inner


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_matmul_flops_equal_jax_hlo_dots(arch, kind):
    got = _port_profile(arch, kind).matmul_flops
    want = _jax_dot_flops(arch, kind)
    assert want - got == pinned_gap(arch, kind), (got, want)


def test_top_dots_group_the_step_by_shape():
    prof = _port_profile("stablelm-3b", "train")
    rows = opprof.top_dots(prof, n=1000)
    assert sum(r["flops"] for r in rows) == prof.flops
    assert sum(r["count"] for r in rows) == len(prof.dots)
    assert [r["flops"] for r in rows] == sorted((r["flops"] for r in rows),
                                                reverse=True)
    # the unembedding (B*S tokens x padded vocab, k = d_model), once: the
    # gradient of its input contracts over the vocabulary instead
    cfg = get_smoke_config("stablelm-3b")
    unembed = [r for r in rows if r["out_shape"] == (B * S, cfg.padded_vocab)
               and r["contract_k"] == cfg.d_model]
    assert [r["count"] for r in unembed] == [1]
    assert unembed[0]["flops"] == 2 * B * S * cfg.padded_vocab * cfg.d_model


def test_profile_cell_splits_per_layer_and_fixed():
    """The first probe depth's profile, as JAX's ``profile_cell``, with the
    per-layer FLOPs from the two probe depths (the dp_all train cell: the
    split vocabulary's gathers and all-reduces, the gradient mean's f32
    all-reduces and the ZeRO-1 all-gathers are the collectives)."""
    full, sm = get_config("mamba2-130m"), get_smoke_config("mamba2-130m")
    over = {f.name: getattr(sm, f.name) for f in dataclasses.fields(sm)
            if f.name != "name" and getattr(sm, f.name) != getattr(full,
                                                                   f.name)}
    rec = opprof.profile_cell("mamba2-130m", "train_4k", False, over)
    assert rec["n_layers_probe"] == 2
    assert rec["flops_fixed"] + 2 * rec["flops_per_layer"] == \
        rec["cost"]["flops"]
    assert rec["flops_per_layer"] > 0 and rec["flops_fixed"] > 0
    assert rec["top_dots"][0]["flops"] >= rec["top_dots"][-1]["flops"]
    assert {c["kind"] for c in rec["collectives"]} == {"all-reduce",
                                                        "all-gather"}
    assert any(c["kind"] == "all-reduce" and c["dtype"] == "float32"
               for c in rec["collectives"])
    assert set(opprof.profile_cell("gemma-7b", "long_500k")) == {"skipped"}
