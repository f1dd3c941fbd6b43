"""The sharded engine on a 2D vertex × walker mesh against the
single-device engines (``DynamicWalkEngine(mesh=..., walker_axes=...)``).

Four gloo ranks on the CPU, spawned once for the module
(``spawn_ranks`` of ``test_torch_sharded_serving.py``), build a (2, 2)
``DeviceMesh`` ``("data", "walker")``: S_v = 2 vertex shards, each held
by S_w = 2 walker groups.  They run ``test_torch_sharded_serving.py``'s
scenarios with ``mesh=``/``walker_axes=`` in place of ``group=``, and
its checks hold them to the single-device port and JAX:

* ingest stats are counted once (summed over the vertex group, not over
  the replicas), the guard's books per round and deferred, ``audit()``
  counts equal to the single device's;
* a lockstep regrow, the scheduler's live == replay across regrows and
  on mixed traffic, crash and restore (only rank (0, 0) writes);
* both replicas of a vertex shard hold the same rows after the traffic;
* walk buckets must divide over S_v·S_w = 4, and each rank's home block
  is block g·S_v + v of the padded batch.

JAX's engine on a (2, 2) mesh of 4 fake CPU devices, in a subprocess
beside the spawn (``tests/test_relay_overlap.py:319``'s
``test_engine_serves_on_2d_mesh``), gives the same stats every round and
the same walk.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import torch

from repro.kernels.ops import seed_from_key
from repro_torch.core import dyngraph as tdg
from repro_torch.core.walks import WalkParams
from repro_torch.serve import DynamicWalkEngine
from tests import test_torch_sharded_serving as ts
from tests.conftest import random_graph
from tests.test_torch_sharded_serving import (GUARD_POLICIES, S, check_audit,
                                              check_guarded_ingest,
                                              check_recovery, check_regrow,
                                              check_scheduler, spawn_ranks)

ROOT = Path(__file__).resolve().parent.parent
WAXES = ("walker",)
ENGINE_LEN = 6


def _engine_rounds():
    """Three mixed rounds of 8 updates on the 64-vertex graph of
    ``_mixed_engine``, inserts and deletes of present edges."""
    src, dst, _ = random_graph(64, 8, max_bias=15, seed=3)
    rng = np.random.default_rng(5)
    for _ in range(3):
        k = rng.choice(len(src), 4, replace=False)
        yield (np.array([True] * 4 + [False] * 4),
               np.concatenate([rng.integers(0, 64, 4), src[k]]).astype(
                   np.int32),
               np.concatenate([rng.integers(0, 64, 4), dst[k]]).astype(
                   np.int32),
               np.array([2, 5, 1, 3, 1, 1, 1, 1], np.int32))


STARTS = np.arange(16, dtype=np.int32) * 3 % 64


def engine_scenario(kw, seed):
    """Ingest stats per round and a stitched walk, unguarded."""
    src, dst, w = random_graph(64, 8, max_bias=15, seed=3)
    cfg = tdg.BingoConfig(num_vertices=64, capacity=8, bias_bits=4)
    eng = DynamicWalkEngine(tdg.from_edges(cfg, src, dst, w, device="cpu"),
                            cfg, WalkParams("deepwalk", ENGINE_LEN), **kw)
    stats = [ts._stats(eng.ingest(*ts._t(*r))) for r in _engine_rounds()]
    return {"stats": stats, "state": ts._whole(eng),
            "walk": eng.walk(torch.from_numpy(STARTS), seed,
                             stitch=True).numpy()}


def bucket_scenario_2d(kw):
    """5 starts pad to 8 with -1 free slots; each rank's home block."""
    st, _, cfg = ts._small()
    eng = DynamicWalkEngine(st, cfg, ts.PARAMS, walk_buckets=ts.BUCKETS,
                            **kw)
    five = torch.tensor([3, 7, 12, 30, 17], dtype=torch.int32)
    return {"home": eng.walk(five, 11).numpy(),
            "whole": eng.walk(five, 11, stitch=True).numpy(),
            "place": (eng.rank, eng.num_shards, eng.num_groups)}


def refusals_2d(kw, group):
    """The 2D engine's refusals: (what, ValueError message)."""
    st, _, cfg = ts._small()
    out = {}
    for what, extra in (
            ("bucket 6", dict(walk_buckets=(8, 6))),
            ("bucket 2", dict(walk_buckets=(2,))),
            ("node2vec", dict(params=WalkParams("node2vec", 5))),
            ("not in mesh", dict(walker_axes=("nope",))),
            ("vertex axis", dict(walker_axes=("data", "walker"))),
            ("mesh and group", dict(group=group))):
        args = {**kw, "params": ts.PARAMS, **extra}
        try:
            DynamicWalkEngine(st, cfg, args.pop("params"), **args)
            out[what] = None
        except ValueError as e:
            out[what] = str(e)
    return out


def mesh_job(rank, group, job):
    from torch.distributed.device_mesh import init_device_mesh
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "walker"))
    kw = {"mesh": mesh, "walker_axes": WAXES}
    d = Path(job["dir"]) / "shared"
    out = {"audit": ts.audit_scenario(kw), "regrow": ts.regrow_scenario(kw),
           "recovery": ts.recovery_scenario(kw, d),
           "buckets": bucket_scenario_2d(kw),
           "engine": engine_scenario(kw, job["seed"]),
           "refusals": refusals_2d(kw, group)}
    for guard in (None, True):
        out[("hub", guard)] = ts.hub_scenario(kw, guard)
        out[("mixed", guard)] = ts.mixed_scenario(kw, guard)
    for defer in (False, True):
        for policy in GUARD_POLICIES:
            out[("guard", defer, policy)] = ts.guard_scenario(kw, defer,
                                                              policy)
    return out


_JAX_ENGINE = """
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.core import walks
from repro.core.dyngraph import BingoConfig, from_edges
from repro.serve.dynwalk import DynamicWalkEngine
from tests.conftest import random_graph
assert len(jax.devices()) == 4
job = json.loads(sys.argv[2])
src, dst, w = random_graph(64, 8, max_bias=15, seed=3)
cfg = BingoConfig(num_vertices=64, capacity=8, bias_bits=4)
mesh = jax.make_mesh((2, 2), ("data", "walker"))
eng = DynamicWalkEngine(from_edges(cfg, src, dst, w), cfg,
                        walks.WalkParams(kind="deepwalk", length=job["L"]),
                        backend="reference", mesh=mesh,
                        walker_axes=("walker",))
stats = []
for ins, u, v, ww in job["rounds"]:
    s = eng.ingest(jnp.asarray(ins, bool), jnp.asarray(u, jnp.int32),
                   jnp.asarray(v, jnp.int32), jnp.asarray(ww, jnp.int32))
    stats.append([np.asarray(x).tolist() for x in s[:4]])
paths = eng.walk(jnp.asarray(job["starts"], jnp.int32),
                 key=jax.random.key(9))
with open(sys.argv[1], "w") as f:
    json.dump({"stats": stats, "walk": np.asarray(paths).tolist()}, f)
"""


@pytest.fixture(scope="module")
def walk_seed():
    return int(np.asarray(seed_from_key(jax.random.key(9)))[0])


@pytest.fixture(scope="module")
def mesh2d(walk_seed, tmp_path_factory):
    """The four ranks' results by rank and their directory, beside JAX's
    2D engine on 4 fake devices."""
    d = tmp_path_factory.mktemp("sharded_serving_2d")
    ts._write_jax_snapshot(d / "shared")
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "PYTHONPATH": os.pathsep.join([str(ROOT / "src"), str(ROOT)])}
    spec = {"L": ENGINE_LEN, "starts": STARTS.tolist(),
            "rounds": [[x.tolist() for x in r] for r in _engine_rounds()]}
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_ENGINE, str(d / "jax.json"),
         json.dumps(spec)], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        out = spawn_ranks(S, {"dir": str(d), "seed": walk_seed}, d,
                          __name__ + ".mesh_job")
        log, _ = jax_proc.communicate(timeout=300)
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
            jax_proc.communicate()
    assert jax_proc.returncode == 0, log
    return out, d, json.loads((d / "jax.json").read_text())


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    """The port's single-device engine through the same scenarios."""
    d = tmp_path_factory.mktemp("single_serving_2d")
    ts._write_jax_snapshot(d)
    return ts.run_all(None, d)


# ------------------------------------------------------------------ tests
def test_2d_audit_counts_each_row_once(mesh2d, single):
    """The violation planted in vertex shard 0's rows (in both of its
    replicas) is counted once: the single-device port's and JAX's
    counts."""
    check_audit(mesh2d[0], single)


def test_2d_lockstep_regrow_matches_single_device(mesh2d, single):
    check_regrow(mesh2d[0], single)


@pytest.mark.parametrize("kind", ["hub", "mixed"])
@pytest.mark.parametrize("guard", [None, True], ids=["guard=off",
                                                     "guard=on"])
def test_2d_scheduler_live_equals_replay(mesh2d, single, kind, guard):
    """On every rank of the (2, 2) mesh the trace, per-request paths,
    stamps, books and state equal the single-device port's and JAX's
    scheduler's, and the replay equals the live run."""
    check_scheduler(mesh2d[0], single, kind, guard)


@pytest.mark.parametrize("policy", list(GUARD_POLICIES))
@pytest.mark.parametrize("defer", [False, True], ids=["round", "deferred"])
def test_2d_guarded_ingest(mesh2d, single, defer, policy):
    """Stats counted once and books per round and deferred, equal to the
    single-device port's and JAX's on every rank."""
    check_guarded_ingest(mesh2d[0], single, defer, policy)


def test_2d_crash_and_restore(mesh2d, single):
    """``restore(mesh=..., walker_axes=...)``: every rank keeps the rows
    of its vertex index; only rank (0, 0) writes the WAL and snapshots."""
    check_recovery(mesh2d[0], single, mesh2d[1])


def test_2d_engine_matches_single_device_and_jax(mesh2d, walk_seed):
    """``test_engine_serves_on_2d_mesh``: the stats of every round (once,
    not once a replica) and the walk equal the single-device port's and
    JAX's 2D engine's."""
    outs, _, jax_out = mesh2d
    want = engine_scenario({}, walk_seed)
    for o in outs:
        got = o["engine"]
        for a, b, j in zip(got["stats"], want["stats"], jax_out["stats"]):
            for x, y, z in zip(a[:4], b[:4], j):
                np.testing.assert_array_equal(x, y)
                np.testing.assert_array_equal(x, np.array(z))
            assert a[4] == b[4]
        ts.assert_np_states_equal(got["state"], want["state"])
        np.testing.assert_array_equal(got["walk"], want["walk"])
    np.testing.assert_array_equal(np.array(jax_out["walk"]), want["walk"])
    assert sum(int(np.sum(s[0])) + int(np.sum(s[1]))
               for s in want["stats"]) > 0


def test_2d_replicas_hold_the_same_rows(mesh2d):
    """Ranks (v, 0) and (v, 1) end every scenario with the same whole
    state, gathered over their own vertex groups."""
    outs = mesh2d[0]
    for key in [("hub", True), ("mixed", True), ("guard", True, "strict")]:
        for o in outs[1:]:
            ts.assert_np_states_equal(o[key]["state"], outs[0][key]["state"])


def test_2d_walk_buckets_and_home_blocks(mesh2d, single):
    """Rank (v, g) returns block g·S_v + v of the padded batch of 8 (two
    rows each) cut to the 5 real rows; stitched, the single device's."""
    want = single["buckets"]["whole"]
    blocks = []
    for o in mesh2d[0]:
        got = o["buckets"]
        v, S_v, S_w = got["place"]
        assert (S_v, S_w) == (2, 2)
        np.testing.assert_array_equal(got["whole"], want)
        k = len(blocks) % 2 * S_v + v          # rank r = v·S_w + g
        np.testing.assert_array_equal(got["home"], want[2 * k:2 * k + 2])
        blocks.append(got["home"].shape[0])
    # blocks by rank: (0,0) rows 0-1, (0,1) rows 4-5, (1,0) 2-3, (1,1) none
    assert blocks == [2, 1, 2, 0]


def test_2d_engine_refusals(mesh2d):
    """Buckets must divide over S_v·S_w = 4; node2vec is refused; the
    reference's mesh errors; ``mesh=`` and ``group=`` together."""
    for o in mesh2d[0]:
        got = o["refusals"]
        assert "multiple of the shard count (4)" in got["bucket 6"]
        assert "multiple of the shard count (4)" in got["bucket 2"]
        assert "whole walks" in got["node2vec"]
        assert "not in mesh" in got["not in mesh"]
        assert "vertex axis" in got["vertex axis"]
        assert "not both" in got["mesh and group"]
