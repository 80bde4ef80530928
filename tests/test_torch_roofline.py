"""The port's roofline and cost model (``repro_torch.launch.roofline``,
``launch.costmodel``) held against the JAX package's on the same configs.

What carries over from JAX is held equal: the cell rules, ``model_flops``
(relative 1e-12: the same float arithmetic on the same integers),
``probe_depths`` and ``extrapolate``. What does not (the TPU's peaks) is
held to the H100 data sheet's terms: ``derive``'s three terms are the
counts over them, each mesh axis gets the link its ranks cross, and the
kernel bounds are the ones ``chip_smoke.py`` printed before they moved here.
"""
import dataclasses

import pytest

from repro.configs import get_config as jget_config
from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import cell_is_runnable as jcell_is_runnable
from repro.launch import costmodel as JCM
from repro.launch import roofline as JRL
from repro_torch.configs import ARCH_IDS, SHAPES, all_configs, get_config
from repro_torch.configs.base import cell_is_runnable
from repro_torch.launch import costmodel as CM
from repro_torch.launch import roofline as RL

CELLS = [(a, s) for a in ARCH_IDS for s in SHAPES]


def test_shapes_equal_jax():
    assert list(SHAPES) == list(JSHAPES)
    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in JSHAPES.items()}


def test_all_configs_equal_jax():
    port = all_configs()
    assert list(port) == ARCH_IDS
    for arch, cfg in port.items():
        want = dataclasses.asdict(jget_config(arch))
        got = dataclasses.asdict(cfg)
        # the one deliberate difference: the port's kernels on by default
        assert got.pop("use_pallas") and not want.pop("use_pallas")
        assert got == want, arch


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_rule_and_model_flops_equal_jax(arch, shape):
    cfg, jcfg = get_config(arch), jget_config(arch)
    ok, why = cell_is_runnable(cfg, SHAPES[shape])
    assert (ok, why) == jcell_is_runnable(jcfg, JSHAPES[shape])
    if ok:
        got = RL.model_flops(cfg, SHAPES[shape])
        want = JRL.model_flops(jcfg, JSHAPES[shape])
        assert got == pytest.approx(want, rel=1e-12)
    else:
        assert shape == "long_500k" and not cfg.supports_long_context


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_probe_depths_and_extrapolate_equal_jax(arch):
    got = CM.probe_depths(get_config(arch))
    want = JCM.probe_depths(jget_config(arch))
    assert got == want
    _, _, n_a, n_b, n_t = got
    a = {"flops": 3.0e12, "bytes accessed": 7.0e9, "coll_total": 5.0}
    b = {"flops": 5.5e12, "bytes accessed": 9.0e9, "coll_all-reduce": 2.0}
    assert CM.extrapolate(a, b, n_a, n_b, n_t) == \
        JCM.extrapolate(a, b, n_a, n_b, n_t)


@pytest.mark.parametrize("coll_total,link", [(0, RL.IB_BW),
                                             (3.2e9, RL.IB_BW),
                                             (3.2e9, RL.NVLINK_BW)])
def test_derive_terms_are_counts_over_h100_terms(coll_total, link):
    cfg, shape = get_config("gemma-7b"), SHAPES["train_4k"]
    cost = {"flops": 2.9e14, "bytes accessed": 1.6e12}
    t = RL.derive("gemma-7b", shape, cfg, "single_pod", 256, cost,
                  {"total": coll_total}, peak_bytes_dev=1e9, link_bw=link)
    assert t.compute_s == cost["flops"] / 989e12
    assert t.memory_s == cost["bytes accessed"] / 3.35e12
    assert t.collective_s == coll_total / link
    assert t.step_time_s == max(t.compute_s, t.memory_s, t.collective_s)
    assert t.bottleneck == "memory"
    mf = RL.model_flops(cfg, shape)
    assert t.useful_ratio == mf / (cost["flops"] * 256)
    assert t.hw_frac == mf / (t.step_time_s * 256 * 989e12)
    # the same fields as the JAX package's terms
    assert [f.name for f in dataclasses.fields(RL.RooflineTerms)] == \
        [f.name for f in dataclasses.fields(JRL.RooflineTerms)]


def test_h100_terms_are_the_data_sheet_peaks():
    assert RL.PEAK_FLOPS == RL.PEAK_FLOPS_BY_DTYPE["bfloat16"] == 989e12
    assert RL.PEAK_FLOPS_BY_DTYPE["float32"] == 67e12
    assert (RL.HBM_BW, RL.NVLINK_BW, RL.IB_BW) == (3.35e12, 450e9, 50e9)
    assert RL.PEAK_FLOPS != JRL.PEAK_FLOPS and RL.HBM_BW != JRL.HBM_BW


@pytest.mark.parametrize("shape,axes,link", [
    # the production meshes: every axis spans nodes of 8 cards
    ({"data": 16, "model": 16}, ("model",), RL.IB_BW),
    ({"data": 16, "model": 16}, ("data",), RL.IB_BW),
    ({"data": 16, "model": 16}, ("data", "model"), RL.IB_BW),
    ({"pod": 2, "data": 16, "model": 16}, ("pod", "data"), RL.IB_BW),
    # inside one node
    ({"data": 4, "model": 2}, ("data", "model"), RL.NVLINK_BW),
    ({"data": 32, "model": 8}, ("model",), RL.NVLINK_BW),
    ({"data": 32, "model": 8}, ("data",), RL.IB_BW),
    ({"data": 1, "model": 1}, ("data",), RL.NVLINK_BW)])
def test_link_bandwidth_by_axis(shape, axes, link):
    assert RL.link_bandwidth(shape, axes) == link


@pytest.mark.parametrize("flops,nbytes,dtype", [
    (4 * 128 * 8 * 32 * 1024 * 1025 // 2, 2 * 2 * 8 * 1024 * (32 + 2) * 128,
     "bfloat16"),                        # chatglm3-6b's flash attention
    (4 * 8192 * 4096, 2 * (2 * 8192 * 4096 + 4096), "float32"),   # RMSNorm
    (10 ** 9, 10 ** 3, "bfloat16")])
def test_kernel_bound_is_chip_smoke_formula(flops, nbytes, dtype):
    """The bound chip_smoke.py computed itself before (bytes over 3.35 TB/s
    or operations over the peak of their type, the larger)."""
    t_bytes = nbytes / 3.35e12 * 1e3
    t_ops = flops / {"bfloat16": 989e12, "float32": 67e12}[dtype] * 1e3
    r = {"flops": flops, "bytes": nbytes, "dtype": dtype}
    RL.add_bound(r)
    assert r["bound_ms"] == max(t_bytes, t_ops)
    assert r["bound_by"] == ("bytes" if t_bytes >= t_ops else "operations")
