"""The port's dry run of the walk cells on fake worlds.

At SMOKE sizing on a fake world of 4 ranks (a (2, 2) mesh) every walk
cell and the capacity-ladder tier runs with no kernel launched; each
cell's per-rank argument bytes equal the reference's: the leaves of
``jax.eval_shape(empty_state)`` split over the vertex dim, plus the
walker and lane arrays as the reference's cell shards them; the cells
that write the state in place alias exactly its bytes.  At FULL on a
fake world of 256 ranks ``walk_whole`` and ``update_walk`` (and its C' =
2C tier) fit the H100's 80 GB with the layout's arithmetic.  The CLI
writes its JSONs and the report reads them (a subprocess; ``--all
--arch-filter bingo-walk``: the walk cells alone, the LM cells being
``test_torch_launch_lm_cells.py``'s).  Kernel wrappers on fake tensors
return their plain versions' shapes and launch nothing.
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.device_mesh import init_device_mesh

from repro.configs import bingo_walk as j_bingo_walk
from repro.core.dyngraph import BingoConfig as JBingoConfig
from repro.core.dyngraph import empty_state as j_empty_state

from repro_torch.configs import bingo_walk
from repro_torch.core import dyngraph as tdg
from repro_torch.kernels import ops
from repro_torch.launch import dryrun, hw
from repro_torch.launch.walk_cell import one_rank_share

ROOT = Path(__file__).resolve().parents[1]


def _jax_state_bytes(wcfg, cmult=1):
    cfg = JBingoConfig(num_vertices=wcfg.num_vertices,
                       capacity=wcfg.capacity * cmult,
                       bias_bits=wcfg.bias_bits)
    sds = jax.eval_shape(functools.partial(j_empty_state, cfg))
    return sum(int(np.prod(x.shape)) * x.dtype.itemsize
               for x in jax.tree.leaves(sds))


def _want_args(shape, wcfg, chips, ov):
    """The reference cell's per-rank argument bytes, less its int32 seed:
    the state split over the vertex shards, the walkers and update lanes
    as its in_shardings split them."""
    S_w = ov.get("walker_replicas", 4) if shape == "walk_relay_2d" else 1
    S_v = chips // S_w
    state = _jax_state_bytes(wcfg, ov.get("capacity_mult", 1))
    assert state % S_v == 0
    W, Bu = wcfg.walkers, wcfg.update_batch
    lanes = Bu * (1 + 3 * 4)                      # is_insert, u, v, w
    rest = {"walk_step": 4 * W // chips, "walk_whole": 4 * W // chips,
            "walk_relay": 4 * W, "walk_relay_2d": 4 * W // S_w,
            "update_step": lanes, "update_walk": lanes + 4 * W // chips,
            "serve_round": lanes + Bu + 4 * ov.get("serve_walkers", 65536)}
    return state // S_v + rest[shape], state // S_v


@pytest.fixture
def fake4():
    with dryrun.fake_world(4):
        yield init_device_mesh("cuda", (2, 2), mesh_dim_names=("data", "model"))


CELLS = dryrun.WALK_CELLS + (("update_step", None),)


def test_smoke_cells_on_four_ranks(fake4):
    """Every walk cell, the tier and ``update_step``: no launch, the
    reference's argument bytes, the state's alias bytes where written in
    place, one relay round costed."""
    before = ops.launch_counts()
    for shape, ov in CELLS:
        ov = ov or {}
        doc = dryrun.run_cell("bingo-walk", shape, overrides=ov, mesh=fake4,
                              wcfg=bingo_walk.SMOKE, out_dir=None,
                              verbose=False)
        mem = doc["memory_analysis"]
        want, state = _want_args(shape, j_bingo_walk.SMOKE, 4, ov)
        assert mem["argument_size_in_bytes"] == want, shape
        donating = shape in ("update_step", "update_walk", "serve_round")
        assert mem["alias_size_in_bytes"] == (state if donating else 0), shape
        assert mem["total_nonalias_bytes"] >= want
        assert doc["hbm_fit"] and doc["mesh"] == "mesh2x2"
        assert doc["t_memory"] > 0 and doc["bytes_per_device"] > 0
        if "relay" in shape or shape == "serve_round":
            assert doc["meta"]["rounds_costed"] == 1
            assert doc["coll_breakdown"]["all_reduce"] > 0
        if shape in ("walk_step", "walk_relay", "serve_round"):
            assert doc["coll_breakdown"]["all_to_all_single"] > 0
            # 4 ranks on one node: every byte sent to a peer goes over NVLink
            assert doc["coll_off_node_bytes"] == 0
        assert set(doc["meta"]["kernels"]) == {
            "walk_step": {"walk_sample"}, "walk_whole": {"walk_fused"},
            "walk_relay": {"walk_segment"}, "walk_relay_2d": {"walk_segment"},
            "update_step": {"update_fused"},
            "update_walk": {"update_fused", "walk_fused"},
            "serve_round": {"walk_segment", "update_fused"}}[shape]
    assert ops.launch_counts() == before


def test_one_rank_share_on_a_world_of_one():
    """The cells phase 3k of ``chip_smoke.py`` runs for real: one rank's
    share of FULL on a world of one."""
    wcfg = one_rank_share()
    assert (wcfg.num_vertices, wcfg.walkers) == (163840, 16384)
    assert (wcfg.capacity, wcfg.walk_length, wcfg.update_batch) == \
        (1024, 80, 102400)
    jw = dataclasses.replace(j_bingo_walk.FULL, num_vertices=163840,
                             walkers=16384)
    with dryrun.fake_world(1):
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
        for shape, ov in dryrun.RANK_CELLS:
            ov = ov or {}
            doc = dryrun.run_cell("bingo-walk", shape, overrides=ov, mesh=mesh,
                                  wcfg=wcfg, out_dir=None, verbose=False)
            want, _ = _want_args(shape, jw, 1, ov)
            assert doc["memory_analysis"]["argument_size_in_bytes"] == want
            assert doc["coll_on_node_bytes"] == doc["coll_off_node_bytes"] == 0


@pytest.mark.parametrize("shape, ov", [("walk_whole", {}),
                                       ("update_walk", {}),
                                       ("update_walk", {"capacity_mult": 2})])
def test_full_cells_fit_on_256_ranks(shape, ov):
    with dryrun.fake_world(256):
        doc = dryrun.run_cell("bingo-walk", shape, overrides=ov, out_dir=None,
                              verbose=False)
    mem = doc["memory_analysis"]
    want, state = _want_args(shape, j_bingo_walk.FULL, 256, ov)
    assert mem["argument_size_in_bytes"] == want
    # the FULL layout: 163,840 rows a rank of C nbr/bias/frac words, 16
    # radix groups of Cg = ceil(0.4 C) + 1 member slots, 16-entry alias rows
    C = 1024 * ov.get("capacity_mult", 1)
    rows, Cg = 41_943_040 // 256, -(-4 * C // 10) + 1
    assert state == rows * (3 * 4 * C + 4 * 16 * Cg + 4 * 2 + 16 * (4 + 4 + 1)
                            + 16 * 8)
    assert doc["mesh"] == "pod16x16" and doc["chips"] == 256
    assert doc["hbm_fit"] == (mem["total_nonalias_bytes"] <= hw.HBM_BYTES)
    assert doc["hbm_fit"]
    assert doc["meta"]["constants"]["HBM_BYTES"] == 80 * 10**9
    assert doc["bottleneck"] == "memory"


def test_cli_writes_json_and_the_report_reads_it(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
         "--arch-filter", "bingo-walk", "--mesh", "2x2", "--sizing", "smoke",
         "--out", str(tmp_path)],
        capture_output=True, text=True, env=env, cwd=str(ROOT), timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    assert "all requested cells ran OK" in run.stdout
    names = sorted(p.name for p in tmp_path.glob("*.json"))
    assert names == sorted(
        f"mesh2x2__bingo-walk__{s}{'__' + ov['tag'] if ov else ''}.json"
        for s, ov in dryrun.WALK_CELLS)
    doc = json.loads((tmp_path / names[0]).read_text())
    assert doc["meta"]["sizing"] == "bingo-walk-smoke"
    rep = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.report", "--dir",
         str(tmp_path)], capture_output=True, text=True, env=env,
        cwd=str(ROOT), timeout=120)
    assert rep.returncode == 0, rep.stderr[-3000:]
    assert rep.stdout.count("| bingo-walk |") >= 8


def _small_state():
    rng = np.random.default_rng(0)
    V, C = 16, 8
    src = np.repeat(np.arange(V, dtype=np.int32), 3)
    dst = rng.integers(0, V, src.size, dtype=np.int32)
    w = rng.integers(1, 64, src.size, dtype=np.int32)
    cfg = tdg.BingoConfig(num_vertices=V, capacity=C, bias_bits=6)
    return tdg.from_edges(cfg, src, dst, w, device="cpu"), cfg


def _calls(st, cfg):
    zeros = torch.zeros(4, dtype=torch.int32)
    return {
        "walk_fused": lambda s: (ops.walk_fused(
            s.itable.prob, s.itable.alias, s.bias, s.nbr, s.deg, None,
            zeros.to(s.nbr.device), 1, length=5),),
        "walk_segment": lambda s: ops.walk_segment(
            s.itable.prob, s.itable.alias, s.bias, s.nbr, s.deg, None,
            zeros.to(s.nbr.device), zeros.to(s.nbr.device), 1, length=5),
        "walk_sample": lambda s: ops.walk_sample(
            s.itable.prob, s.itable.alias, s.bias, s.nbr, s.deg,
            torch.zeros((4, 3), device=s.nbr.device),
            rows=zeros.to(s.nbr.device)),
        "walk_sample_uniform": lambda s: ops.walk_sample_uniform(
            s.nbr, s.deg, torch.zeros((4, 1), device=s.nbr.device),
            rows=zeros.to(s.nbr.device)),
        "update_fused": lambda s: tuple(ops.update_fused(
            s, cfg, torch.ones(4, dtype=torch.bool, device=s.nbr.device),
            zeros.to(s.nbr.device), zeros.to(s.nbr.device) + 3,
            zeros.to(s.nbr.device) + 5)[1][:4]),
    }


@pytest.mark.parametrize("name", ["walk_fused", "walk_segment", "walk_sample",
                                  "walk_sample_uniform", "update_fused"])
def test_wrappers_on_fake_tensors_record_and_launch_nothing(name):
    """A wrapper on fake tensors returns the shapes its plain version
    returns, records its kernel once and launches nothing."""
    from repro_torch.kernels import _fake
    st, cfg = _small_state()
    plain = _calls(st, cfg)[name](st)
    mode = FakeTensorMode()
    fst = tdg.BingoState(*[
        None if x is None else
        (type(x)(*[mode.from_tensor(y) for y in x]) if isinstance(x, tuple)
         else mode.from_tensor(x)) for x in st])
    seen = []
    _fake.LISTENERS.append(lambda n, shape: seen.append(n))
    before = ops.launch_counts()
    try:
        with mode:
            fake = _calls(st, cfg)[name](fst)
    finally:
        _fake.LISTENERS.pop()
    assert seen == [name]
    assert ops.launch_counts() == before
    assert [(f.shape, f.dtype) for f in fake] == \
        [(p.shape, p.dtype) for p in plain]
