"""``roofline.CostCounter`` on DTensors: one rank's local work.

On a fake world of 16 ranks (a 4 × 4 ``data`` × ``model`` mesh) an FSDP ×
TP matmul counts the rank's local ``2·m·k·n``, the local operands' and
output's bytes and exactly the all-gather of the weight's FSDP shard; an
``all_reduce``-ing sum counts its scalar over the data group, split on
and off the node; a second identical call counts what the first did
(DTensor's sharding propagation, cached after the first call, is never
counted; a torch that lacks one of the planning methods the counter
hides is refused).  Arguments' storages are their local shards.  The
walk cells at SMOKE on four ranks count what they counted before the
counter learned DTensors (the numbers below were taken from the walk
cells' dry run before that change), and the costing of ``models.steps``
(time loops on a few steps, the train step's microbatches on one)
counts what the whole loop does.
"""

import dataclasses

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs import SHAPES, bingo_walk, smoke_config
from repro_torch.launch import dryrun
from repro_torch.launch import roofline as tr

F32 = 4


@pytest.fixture
def mesh4x4():
    with dryrun.fake_world(16):
        yield init_device_mesh("cpu", (4, 4), mesh_dim_names=("data", "model"))


def _operands(mesh, mode):
    with mode:
        x = DTensor.from_local(torch.zeros(8, 64), mesh,
                               [Shard(0), Replicate()], run_check=False)
        w = DTensor.from_local(torch.zeros(16, 32), mesh, [Shard(0), Shard(1)],
                               run_check=False)
    return x, w


def _count(mode, fn, *args):
    c = tr.CostCounter()
    c.track_args(args)
    with mode, c:
        out = fn(*args)
    c.finish(out)
    return c


def test_fsdp_tp_matmul_counts_the_local_product(mesh4x4):
    mode = FakeTensorMode()
    x, w = _operands(mesh4x4, mode)
    first = _count(mode, torch.matmul, x, w)
    # x (32, 64) rows over data, w (64, 128) rows over data, columns over
    # model: the rank gathers w's 16 rows of its 32 columns over data and
    # multiplies its 8 rows by them
    assert first.flops == 2 * 8 * 64 * 32
    assert first.bytes == F32 * (8 * 64 + 64 * 32 + 8 * 32)
    assert first.coll == {**{k: 0 for k in tr.COLLECTIVES},
                          "all_gather": F32 * 16 * 32}
    assert first.arg_bytes == F32 * (8 * 64 + 16 * 32)
    second = _count(mode, torch.matmul, x, w)
    assert (second.flops, second.bytes, second.coll) == \
        (first.flops, first.bytes, first.coll)


def test_sum_all_reduces_over_the_data_group(mesh4x4):
    mode = FakeTensorMode()
    x, _ = _operands(mesh4x4, mode)

    def total(x):
        return x.sum().redistribute(x.device_mesh, [Replicate(), Replicate()])

    for _ in range(2):
        c = _count(mode, total, x)
        assert c.flops == 1 and c.bytes == F32 * (8 * 64 + 1)
        assert c.coll["all_reduce"] == F32
        assert sum(c.coll.values()) == F32
        # the data group of rank 0 is ranks 0, 4, 8, 12: rank 4 shares its
        # node of 8
        assert c.on_node == pytest.approx(F32 / 3)
        assert c.off_node == pytest.approx(2 * F32 / 3)


# (FLOPs, bytes, collective bytes by kind, on-node, off-node, peak bytes)
# of each walk cell at SMOKE on a 2 x 2 fake world
WALK_SMOKE_4 = {
    "walk_step": (3303.0, 15972.0, {'all_to_all_single': 128}, 96.0, 0.0,
                  64904),
    "walk_whole": (26754.0, 100560.0, {}, 0.0, 0.0, 81156),
    "walk_relay": (74584.0, 466236.0,
                   {'all_to_all_single': 3840, 'all_reduce': 24}, 2904.0, 0.0,
                   106652),
    "walk_relay_2d": (103864.0, 713228.0, {'all_reduce': 24}, 24.0, 0.0,
                      356480),
    "update_walk": (42218.0, 140980.0, {'all_reduce': 264}, 264.0, 0.0,
                    82472),
    "serve_round": (28721279.0, 167085896.0,
                    {'all_to_all_single': 1966080, 'all_reduce': 288},
                    1474848.0, 0.0, 18462668),
    "update_walk__tier2x": (66282.0, 226996.0, {'all_reduce': 264}, 264.0,
                            0.0, 152104),
    "walk_relay__tier2x": (95320.0, 610108.0,
                           {'all_to_all_single': 3840, 'all_reduce': 24},
                           2904.0, 0.0, 167424),
    "update_step": (14279.0, 33468.0, {'all_reduce': 264}, 264.0, 0.0,
                    68736),
}


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_walk_cells_count_what_they_did(device):
    with dryrun.fake_world(4):
        mesh = init_device_mesh(device, (2, 2),
                                mesh_dim_names=("data", "model"))
        for shape, ov in dryrun.WALK_CELLS + (("update_step", None),):
            doc = dryrun.run_cell("bingo-walk", shape, overrides=ov or {},
                                  mesh=mesh, wcfg=bingo_walk.SMOKE,
                                  out_dir=None, verbose=False)
            key = shape + ("__" + ov["tag"] if ov else "")
            flops, nbytes, coll, on, off, peak = WALK_SMOKE_4[key]
            assert doc["flops_per_device"] == flops, key
            assert doc["bytes_per_device"] == nbytes, key
            assert {k: v for k, v in doc["coll_breakdown"].items() if v} == \
                coll, key
            assert (doc["coll_on_node_bytes"], doc["coll_off_node_bytes"]) \
                == (on, off), key
            assert doc["memory_analysis"]["total_nonalias_bytes"] == peak, key


# jamba's mamba block and its attention block with experts, one each (the
# MoE arch trains with remat "full": each costed loop runs inside a
# checkpoint)
JAMBA_CUT = {"num_layers": 2, "stage_period": 2,
             "block_pattern": ("mamba", "attn"), "moe_pattern": (False, True)}


@pytest.mark.parametrize("arch, shape", [("jamba-v0.1-52b", "prefill_32k"),
                                         ("xlstm-350m", "prefill_32k"),
                                         ("jamba-v0.1-52b", "train_4k"),
                                         ("xlstm-350m", "train_4k")])
def test_costed_loops_count_the_whole_loop(monkeypatch, arch, shape):
    """A recurrence costed on 8 of its 16 steps counts what all 16 do:
    exactly without a backward pass, the peak bytes too; with one, within
    1 % of the FLOPs and 3 % of the bytes and of the peak (the chunks'
    own bookkeeping: a chunk of 8 steps stacks and saves per chunk what a
    chunk of 16 does; the peak's stand-in for the uncosted steps' graph
    is the costed steps' scaled).  jamba SMOKE is cut to one mamba layer
    and one attention layer with experts (``JAMBA_CUT``), which hold
    every path its eight layers take."""
    sh = dataclasses.replace(SHAPES[shape], seq_len=16, global_batch=16)
    cfg = smoke_config(arch)
    if arch.startswith("jamba"):
        cfg = dataclasses.replace(cfg, **JAMBA_CUT)
    got = {}
    with dryrun.fake_world(256):
        mesh = init_device_mesh("cpu", (16, 16),
                                mesh_dim_names=("data", "model"))
        for k in (None, 8):
            monkeypatch.setattr(dryrun, "STEPS_COSTED", k)
            got[k] = dryrun.run_cell(arch, shape, mesh=mesh, cfg=cfg,
                                     lm_shape=sh, out_dir=None, verbose=False)
    whole, costed = got[None], got[8]
    assert "steps_costed" not in whole["meta"]
    n_loops = costed["meta"]["steps_total"] // 16
    assert costed["meta"]["steps_costed"] == 8 * n_loops
    peak = [d["memory_analysis"]["total_nonalias_bytes"]
            for d in (whole, costed)]
    if shape == "prefill_32k":
        assert costed["flops_per_device"] == whole["flops_per_device"]
        assert costed["bytes_per_device"] == whole["bytes_per_device"]
        assert peak[1] == peak[0]
    else:
        assert costed["flops_per_device"] == pytest.approx(
            whole["flops_per_device"], rel=0.01)
        assert costed["bytes_per_device"] == pytest.approx(
            whole["bytes_per_device"], rel=0.03)
        assert peak[1] == pytest.approx(peak[0], rel=0.03)
    assert costed["coll_breakdown"] == whole["coll_breakdown"]


def test_costed_microbatches_count_the_whole_step(monkeypatch):
    """The train step's microbatches costed on one count what all do: a
    global batch of 32 on 16 data ranks is 2 rows a rank, cut into 2
    microbatches; FLOPs and bytes within 1e-6 (the one costed
    microbatch's running sums are counted twice where the whole loop
    adds its own), the collectives and the peak bytes equal (each
    microbatch frees the sums before it)."""
    sh = dataclasses.replace(SHAPES["train_4k"], seq_len=16, global_batch=32)
    got = {}
    with dryrun.fake_world(256):
        mesh = init_device_mesh("cpu", (16, 16),
                                mesh_dim_names=("data", "model"))
        for k in (None, 8):
            monkeypatch.setattr(dryrun, "STEPS_COSTED", k)
            got[k] = dryrun.run_cell("qwen2-0.5b", "train_4k", mesh=mesh,
                                     cfg=smoke_config("qwen2-0.5b"),
                                     lm_shape=sh, out_dir=None, verbose=False)
    whole, costed = got[None], got[8]
    assert whole["meta"]["plan"]["microbatches"] == 2
    assert costed["meta"]["microbatches_costed"] == 1
    for key in ("flops_per_device", "bytes_per_device"):
        assert costed[key] == pytest.approx(whole[key], rel=1e-6)
    assert costed["coll_breakdown"] == whole["coll_breakdown"]
    assert costed["memory_analysis"] == whole["memory_analysis"]


def test_hide_propagation_raises_on_a_missing_method(monkeypatch):
    """A torch without one of DTensor's planning methods that the counter
    hides is refused, not counted at global shapes."""
    mod, cls, names = tr._PLANNING[0]
    monkeypatch.setattr(tr, "_PLANNING", tr._PLANNING + (
        (mod, cls, ("no_such_planning_method",)),))
    with pytest.raises(RuntimeError, match="no_such_planning_method"):
        tr._hide_propagation()


def test_smoke_counter_check_on_cpu():
    """``chip_smoke.counter_check``, phase 3l's check of the counter on
    the card's torch, passes here on fake ``cpu`` DTensors with the
    numbers of ``test_fsdp_tp_matmul_counts_the_local_product``."""
    import chip_smoke
    out = chip_smoke.counter_check("cpu", device="cpu")
    local = F32 * (8 * 64 + 64 * 32 + 8 * 32)
    assert out["matmul"] == (2 * 8 * 64 * 32, local, F32 * 16 * 32,
                             F32 * 16 * 32)


def test_decode_down_projection_stays_on_its_shards(monkeypatch):
    """qwen2-0.5b SMOKE's decode_32k cell on a fake 4 x 4 world: the MLP's
    down projection ``wo`` (d_ff over ``model``, D over ``data``) is
    counted as the local (b, d_ff/model) @ (d_ff/model, D/data) product of
    the whole batch b, once a layer (``layers.dot``'s stated layout, not
    DTensor's choice), no collective moves a shard of that weight, and no
    product reads it gathered over ``data``."""
    from torch.utils._pytree import tree_flatten
    seen = []

    class Tally(tr.CostCounter):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if out is not NotImplemented and not tr._PROPAGATING[0]:
                seen.append((str(func), [tuple(t.shape) for t in
                                         tree_flatten(args)[0]
                                         if isinstance(t, torch.Tensor)]))
            return out

    monkeypatch.setattr(dryrun, "CostCounter", Tally)
    cfg = smoke_config("qwen2-0.5b")
    B = 16
    shape = dataclasses.replace(SHAPES["decode_32k"], seq_len=16,
                                global_batch=B)
    with dryrun.fake_world(16):
        mesh = init_device_mesh("cpu", (4, 4),
                                mesh_dim_names=("data", "model"))
        dryrun.run_cell("qwen2-0.5b", "decode_32k", mesh=mesh, cfg=cfg,
                        lm_shape=shape, out_dir=None, verbose=False)
    ff, d = cfg.d_ff // 4, cfg.d_model // 4
    products = [s for f, s in seen if f.startswith("aten.mm")]
    assert products.count([(B, ff), (ff, d)]) == cfg.num_layers
    moved = {x for f, s in seen if f.startswith(("_c10d_functional",
                                                  "_dtensor")) for x in s}
    assert (ff, d) not in moved
    assert not any(s[1] == (ff, cfg.d_model) for s in products)


@pytest.mark.parametrize("arch, shape", [
    ("qwen2-0.5b", "decode_32k"), ("mixtral-8x7b", "decode_32k"),
    ("jamba-v0.1-52b", "long_500k"), ("xlstm-350m", "decode_32k")])
def test_smoke2x2_records_hold(arch, shape):
    """The committed SMOKE 2 x 2 records that the card's torch is held to
    (``chip_smoke.record_check``, phase 3l and
    ``test_torch_launch_cells_cuda.py``) are what this code counts here:
    a decode cell of each kind of layer (attention with the KV heads
    split, dense experts, mamba's and the xLSTM's states on local shards)
    on a fake 2 x 2 world."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from chip_smoke import SMOKE2X2, record_check
    with dryrun.fake_world(4):
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        doc = dryrun.run_cell(arch, shape, mesh=mesh, cfg=smoke_config(arch),
                              out_dir=None, verbose=False)
    rel = record_check(doc, SMOKE2X2 / f"mesh2x2__{arch}__{shape}.json",
                       f"{arch} {shape}")
    assert max(abs(v) for v in rel.values()) <= 1e-6
