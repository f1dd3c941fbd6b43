"""``repro_torch.launch.roofline`` against ``repro.launch.roofline``.

With the port's ``hw`` constants set to the TPU v5e's, every formula
(``walk_row_bytes``, ``walk_step_roofline``, ``model_flops``,
``analyze``'s arithmetic, ``grade_walk_snapshot``) equals the
reference's exactly; with the H100's it moves as the formula says.  The
cost counter, on fake worlds of 4 and 16 ranks, tallies a known
``all_to_all_single`` and ``all_reduce`` at their operand bytes and
splits them on and off the node; it tracks the arguments, outputs,
aliases and peak of a call's fake storages.
"""

import pytest

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import ARCHS as J_ARCHS
from repro.configs import get_config as j_get_config
from repro.launch import hw as j_hw
from repro.launch import roofline as jr

from repro_torch.configs import get_config
from repro_torch.launch import dryrun, hw
from repro_torch.launch import roofline as tr

V5E = {"PEAK_FLOPS_BF16": j_hw.PEAK_FLOPS_BF16, "HBM_BW": j_hw.HBM_BW,
       "NVLINK_BW": j_hw.ICI_BW, "NET_BW": j_hw.ICI_BW,
       "DMA_LATENCY": j_hw.DMA_LATENCY, "HBM_BYTES": j_hw.HBM_BYTES}


@pytest.fixture
def v5e(monkeypatch):
    for k, v in V5E.items():
        monkeypatch.setattr(hw, k, v)


def test_h100_constants():
    assert hw.PEAK_FLOPS_BF16 == 989e12 and hw.HBM_BW == 3.35e12
    assert hw.NVLINK_BW == 450e9 and hw.NET_BW == 50e9
    assert hw.NODE_CARDS == 8 and hw.HBM_BYTES == 80 * 10**9
    assert (hw.SINGLE_POD_CHIPS, hw.MULTI_POD_CHIPS) == (256, 512)
    assert 0 < hw.DMA_LATENCY < 1e-4


@pytest.mark.parametrize("capacity", [1, 32, 128, 1024])
@pytest.mark.parametrize("kin", [1, 12, 17])
@pytest.mark.parametrize("fp", [False, True])
def test_walk_row_bytes_equal_the_reference(capacity, kin, fp):
    assert tr.walk_row_bytes(capacity, kin, fp) == \
        jr.walk_row_bytes(capacity, kin, fp)


@pytest.mark.parametrize("cohorts", [1, 2, 4])
def test_walk_step_roofline(v5e, monkeypatch, cohorts):
    kw = dict(walkers=4096, capacity=1024, kin=16, length=80,
              cohorts=cohorts)
    assert tr.walk_step_roofline(**kw) == jr.walk_step_roofline(**kw)
    monkeypatch.setattr(hw, "HBM_BW", 3.35e12)
    monkeypatch.setattr(hw, "DMA_LATENCY", 1.5e-6)
    got = tr.walk_step_roofline(**kw)
    row = jr.walk_row_bytes(1024, 16)
    assert got["t_bandwidth"] == 4096 * row / 3.35e12
    assert got["t_latency"] == 1.5e-6 / cohorts
    assert got["predicted_steps_per_s"] == \
        4096 / (4096 * row / 3.35e12 + 1.5e-6 / cohorts)


@pytest.mark.parametrize("arch", J_ARCHS)
def test_model_flops_equal_the_reference(arch):
    for kind, tokens in (("train", 1 << 20), ("prefill", 4096),
                         ("decode", 128)):
        assert tr.model_flops(get_config(arch), kind, tokens) == \
            jr.model_flops(j_get_config(arch), kind, tokens)


HLO = """HloModule m
ENTRY %main {
  %p0 = f32[1024]{0} parameter(0)
  %p1 = s32[256,3]{1,0} parameter(1)
  %ag = f32[4096]{0} all-gather(%p0), dimensions={0}
  %a2a = s32[256,3]{1,0} all-to-all(%p1), dimensions={0}
  ROOT %ar = f32[1024]{0} all-reduce(%p0), to_apply=%sum
}
"""
COLL = {"all_gather": 4096, "all_to_all_single": 3072, "all_reduce": 4096}


def test_analyze_equals_the_reference(v5e):
    cfg, jcfg = get_config("qwen2-0.5b"), j_get_config("qwen2-0.5b")
    flops, byts = 3.7e13, 9.1e10
    mem = {"total_nonalias_bytes": 5}
    j = jr.analyze(arch="a", shape="s", mesh_name="m", chips=256,
                   cost={"flops": flops, "bytes accessed": byts},
                   hlo_text=HLO, mem=mem, cfg=jcfg, kind="train",
                   tokens=1 << 20, meta={})
    coll = sum(COLL.values())
    t = tr.analyze(arch="a", shape="s", mesh_name="m", chips=256,
                   cost={"flops": flops, "bytes accessed": byts,
                         "collectives": COLL, "on_node": coll * 0.25,
                         "off_node": coll * 0.75},
                   mem=mem, cfg=cfg, kind="train", tokens=1 << 20,
                   meta={})
    jd, td = j.to_json(), t.to_json()
    for k in ("flops_per_device", "bytes_per_device", "coll_bytes_per_device",
              "t_compute", "t_memory", "t_collective", "bottleneck",
              "model_flops", "useful_ratio", "tokens", "chips"):
        assert td[k] == jd[k], k
    assert sum(jd["coll_breakdown"].values()) == sum(td["coll_breakdown"].values())


def test_analyze_on_the_h100_constants():
    cost = {"flops": 1e12, "bytes accessed": 6.7e9,
            "collectives": {"all_to_all_single": 1000}, "on_node": 300.0,
            "off_node": 700.0}
    r = tr.analyze(arch="a", shape="s", mesh_name="m", chips=4, cost=cost,
                   mem={}, cfg=get_config("qwen2-0.5b"), kind="prefill",
                   tokens=1)
    assert r.t_compute == 1e12 / 989e12 and r.t_memory == 6.7e9 / 3.35e12
    assert r.t_collective == 300 / 450e9 + 700 / 50e9
    assert r.bottleneck == "memory"
    assert (r.coll_on_node_bytes, r.coll_off_node_bytes) == (300.0, 700.0)


def _snap(interpret=False):
    return {"env": {"platform": "tpu", "interpret": interpret},
            "sizing": {"walkers": 512, "capacity": 256, "kin": 16,
                       "walk_length": 16},
            "cases": {"deepwalk-pallas-fused-K1": 2.5e7,
                      "deepwalk-pallas-fused-K2": 4.0e7,
                      "ppr-pallas-fused-K4": 1.0e7,
                      "deepwalk-reference": 1.0e6}}


def test_grade_walk_snapshot(v5e, monkeypatch):
    assert tr.grade_walk_snapshot(_snap()) == jr.grade_walk_snapshot(_snap())
    assert tr.grade_walk_snapshot(_snap(interpret=True)) == []
    monkeypatch.setattr(hw, "HBM_BW", 3.35e12)
    monkeypatch.setattr(hw, "DMA_LATENCY", 1.7e-6)
    rows = tr.grade_walk_snapshot(_snap())
    row = jr.walk_row_bytes(256, 16)
    for r in rows:
        pred = 512 / (512 * row / 3.35e12 + 1.7e-6 / r["cohorts"])
        assert r["predicted_steps_per_s"] == pred
        assert r["ratio"] == r["achieved_steps_per_s"] / pred
    assert [r["cohorts"] for r in rows] == [1, 2, 4]


@pytest.mark.parametrize("capacity,degree,fp,want", [
    (1024, 35, False, 4 * (4 + 35)), (1024, 35, True, 4 * (4 + 70)),
    (2048, 35, False, 4 * (4 + 35)), (32, 35, False, 4 * (4 + 32)),
    (1024, 2000, False, 4 * (4 + 1024))])
def test_walk_step_bytes(capacity, degree, fp, want):
    """The port's walk step reads deg, one prob and one alias entry, the
    row's live bias slots (and frac slots in fp mode) and one nbr word:
    the capacity moves it only where the degree reaches it."""
    assert tr.walk_step_bytes(capacity, degree, fp) == want


def test_kernel_work_models():
    step = tr.walk_step_bytes(1024, tr.MEAN_DEGREE)
    assert step == 4 * (4 + tr.MEAN_DEGREE)
    shape = {"walkers": 10, "length": 80, "capacity": 1024, "kin": 16,
             "fp": 0}
    b, o = tr.kernel_work("walk_fused", shape)
    assert b == 10 * 80 * step + 4 * 10 * 82
    assert o == 2 * tr.MEAN_DEGREE * 10 * 80
    assert tr.kernel_work("walk_fused", {**shape, "capacity": 2048}) == (b, o)
    b2, o2 = tr.kernel_work("walk_fused", {**shape, "capacity": 20})
    assert b2 == 10 * 80 * 4 * (4 + 20) + 4 * 10 * 82
    assert o2 == 2 * 20 * 10 * 80
    bs, _ = tr.kernel_work("walk_segment", shape)
    assert bs == b + 4 * 10 * 4
    bu, ou = tr.kernel_work("walk_fused", {**shape, "kin": 0})
    assert bu == 10 * 80 * 8 + 4 * 10 * 82 and ou == 0
    b, o = tr.kernel_work("walk_sample", {"walkers": 7, "capacity": 1024,
                                          "kin": 16, "fp": 0, "ucols": 3})
    assert b == 7 * step + 4 * 7 * 6 and o == 2 * tr.MEAN_DEGREE * 7
    shape = {"lanes": 1000, "vertices": 100, "capacity": 64, "num_radix": 16,
             "group_capacity": 27, "kin": 16, "fp": 0, "adaptive": 1}
    rb = tr.update_row_bytes(**{k: shape[k] for k in (
        "capacity", "num_radix", "group_capacity", "kin", "fp", "adaptive")})
    assert rb == 4 * (2 * 64 + 16 * 27 + 2 + 32 + 32) + 16
    b, _ = tr.kernel_work("update_fused", shape, share=0.5)
    assert b == 2 * rb * 100 + 14 * 1000          # rows capped at the table
    b, _ = tr.kernel_work("update_fused", shape, share=0.05)
    assert b == 2 * rb * 50 + 14 * 1000
    assert tr.bound(3.35e9, 0) == (1.0, "bytes")
    assert tr.bound(0, 67e9) == (1.0, "operations")


@pytest.fixture
def world():
    """``fake_world(n)`` as a factory; destroys what it made."""
    made = []

    def start(n):
        w = dryrun.fake_world(n)
        w.__enter__()
        made.append(w)
        return w
    yield start
    for w in made:
        w.__exit__(None, None, None)


@pytest.mark.parametrize("n, near", [(4, 3), (16, 7)])
def test_counter_tallies_collectives_on_and_off_the_node(world, n, near):
    world(n)
    mode, c = FakeTensorMode(), tr.CostCounter()
    with mode, c:
        x = torch.zeros(n * 5, 3, dtype=torch.int32)
        y = torch.empty_like(x)
        dist.all_to_all_single(y, x)
        s = torch.zeros(6, dtype=torch.int64)
        dist.all_reduce(s)
    a2a, ar = n * 5 * 3 * 4, 6 * 8
    assert c.coll["all_to_all_single"] == a2a and c.coll["all_reduce"] == ar
    sent = a2a * (n - 1) / n + ar
    assert c.on_node == pytest.approx(sent * near / (n - 1), rel=1e-12)
    assert c.off_node == pytest.approx(sent * (n - 1 - near) / (n - 1),
                                       rel=1e-12)
    cost = c.cost()
    assert cost["collectives"]["all_to_all_single"] == a2a


def test_counter_splits_a_strided_group(world):
    world(16)
    g = dist.new_group(list(range(0, 16, 4)))       # ranks 0, 4, 8, 12
    mode, c = FakeTensorMode(), tr.CostCounter()
    with mode, c:
        x = torch.zeros(8, dtype=torch.float32)
        dist.all_reduce(x, group=g)
    assert c.coll["all_reduce"] == 32
    assert c.on_node == pytest.approx(32 / 3) and c.off_node == \
        pytest.approx(64 / 3)


def test_counter_memory_and_work():
    mode = FakeTensorMode()
    with mode:
        a = torch.zeros(1000, dtype=torch.float32)
        b = torch.zeros(500, dtype=torch.int32)
    c = tr.CostCounter()
    c.track_args((a, b), donated=(0,))

    def fn(a, b):
        t = a * 2.0                 # 4000 B live beside the arguments
        u = t + 1.0                 # and 4000 more at the peak
        del t
        a.add_(1.0)                 # in place: the donated argument
        return a, u[:100].clone()

    with mode, c:
        out = fn(a, b)
    mem = c.finish(out)
    assert mem["argument_size_in_bytes"] == 6000
    assert mem["output_size_in_bytes"] == 4000 + 400
    assert mem["alias_size_in_bytes"] == 4000
    assert c.peak == 6000 + 8000
    assert mem["total_nonalias_bytes"] == c.peak
    assert mem["temp_size_in_bytes"] == c.peak - 6000 - 400
    # mul, add, add_ and clone: inputs + outputs, an operation an element
    assert c.bytes == 8000 + 8000 + 8000 + 800
    assert c.flops == 1000 + 1000 + 1000 + 100


def test_counter_uses_the_matmul_formula():
    mode, c = FakeTensorMode(), tr.CostCounter()
    with mode:
        x, w = torch.zeros(8, 16), torch.zeros(16, 32)
    with mode, c:
        torch.mm(x, w)
    assert c.flops == 2 * 8 * 16 * 32
