"""The port's 2D vertex × walker relay against the single-device walk and
JAX's ``make_relay(walker_axes=...)`` (``tests/test_relay_overlap.py``'s
mesh cases).

Four gloo ranks on the CPU, spawned once for the module
(``spawn_ranks`` of ``test_torch_sharded_serving.py``), build each mesh
below with ``init_device_mesh("cpu", ...)`` and run every case on it:

* ``relay_layout``: each rank's vertex index, walker group, mesh index
  and the stitched block order, whatever the order of the mesh's dims
  (``("walker", "data")`` too) and with two vertex dims (a 2×1×2 mesh,
  whose vertex group is built with ``new_group``).
* The relay on (2, 2), (1, 4), (4, 1) and both 3-dim and reordered
  meshes, bulk and overlapped, fed uniforms and the hash PRNG: the
  stitched paths equal the single-device whole walk bit for bit; the
  peak slots stay within one walker group's pool,
  ``slot_count(B // S_w, S_v)``; (4, 1) equals today's ``group=`` relay
  (paths, rounds, overflow, peak).
* The reference's three ``ValueError``s, and ``group=`` with
  ``walker_axes`` or with ``mesh=``.
* Chaos on (2, 2): duplicate, delay and starvation schedules give the
  fault-free walk with no walker lost, drops and a killed transport
  raise on every rank.
* JAX's ``make_relay`` and ``run_chaos_relay`` on a (2, 2) mesh of 4
  fake CPU devices, in a subprocess beside the spawn: the same paths,
  rounds, overflow and peak, and the same ``ChaosReport`` field by field.
"""

import dataclasses
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
from repro_torch.core.backend import get_backend
from repro_torch.core.walks import WalkParams, random_walk
from repro_torch.distributed import chaos as tchaos
from repro_torch.distributed import relay as trelay
from tests.conftest import random_graph
from tests.test_torch_sharded_serving import spawn_ranks

ROOT = Path(__file__).resolve().parent.parent
S, V, C, B, L = 4, 32, 16, 24, 10
WAXES = ("walker",)
# name: (shape, dim names)
MESHES = {
    "2x2": ((2, 2), ("data", "walker")),
    "1x4": ((1, 4), ("data", "walker")),
    "4x1": ((4, 1), ("data", "walker")),
    "2x2-walker-first": ((2, 2), ("walker", "data")),
    "2x1x2": ((2, 1, 2), ("data", "walker", "model")),
}
# (rank -> (vertex index, walker group)) of each mesh, as JAX's
# shard_index(mesh, vertex axes) / shard_index(mesh, walker axes) give it
PLACES = {
    "2x2": [(0, 0), (0, 1), (1, 0), (1, 1)],
    "1x4": [(0, 0), (0, 1), (0, 2), (0, 3)],
    "4x1": [(0, 0), (1, 0), (2, 0), (3, 0)],
    "2x2-walker-first": [(0, 0), (1, 0), (0, 1), (1, 1)],
    "2x1x2": [(0, 0), (1, 0), (2, 0), (3, 0)],
}
SCHEDULES = {
    "delay": dict(seed=1, delay=0.3),
    "dup": dict(seed=2, dup=0.3),
    "starve+dup+delay+pathfaults": dict(seed=4, dup=0.2, delay=0.2,
                                        mailbox_cap=1, path_faults=True),
}
OVERLAPPED = "dup"               # also run on the overlapped schedule
RAISING = {"drop": (dict(seed=5, drop=0.15), None),
           "kill": (dict(seed=6, kill_round=1), 12)}
PARAMS = WalkParams("deepwalk", L)
WALKERS = torch.arange(B, dtype=torch.int32) % V


def _cfg():
    return tdg.BingoConfig(num_vertices=V, capacity=C, bias_bits=6,
                           base_log2=1, lam=4.0)


def _state():
    src, dst, w = random_graph(V, C, max_bias=63, seed=3)
    return tdg.from_edges(_cfg(), src, dst, w, device="cpu")


def _rows(st, sidx, n):
    """Rows of vertex shard ``sidx`` of ``n``."""
    Vs = st.nbr.shape[0] // n
    lo = sidx * Vs
    return tdg.BingoState(
        *[None if x is None else x[lo:lo + Vs] for x in st[:-1]],
        itable=type(st.itable)(*[x[lo:lo + Vs] for x in st.itable]))


# ---------------------------------------------------------------- the ranks
def mesh_job(rank, group, job):
    from torch.distributed.device_mesh import init_device_mesh
    bk, cfg, st = get_backend("fused"), _cfg(), _state()
    seed, u = job["seed"], torch.from_numpy(np.array(job["u"]))
    out = {"layout": {}, "relay": {}}
    meshes = {name: init_device_mesh("cpu", shape, mesh_dim_names=names)
              for name, (shape, names) in MESHES.items()}
    for name, mesh in meshes.items():
        lay = trelay.relay_layout(mesh=mesh, walker_axes=WAXES)
        out["layout"][name] = (lay.sidx, lay.gidx, lay.num_shards,
                               lay.num_groups, lay.blocks, lay.mesh_index,
                               lay.root)
        sl = _rows(st, lay.sidx, lay.num_shards)
        for overlap in (False, True):
            for fed in (False, True):
                run = trelay.make_relay(bk, cfg, PARAMS, mesh=mesh,
                                        walker_axes=WAXES, overlap=overlap,
                                        diagnostics=True)
                home, rounds, ovf, peak = run(sl, WALKERS, seed,
                                              u if fed else None)
                out["relay"][(name, overlap, fed)] = (
                    trelay.stitch(home, mesh=mesh,
                                  walker_axes=WAXES).numpy(),
                    rounds, ovf, peak)
    # today's 1D relay over the plain group, to hold (4, 1) against
    for overlap in (False, True):
        for fed in (False, True):
            run = trelay.make_relay(bk, cfg, PARAMS, group, overlap=overlap,
                                    diagnostics=True)
            home, rounds, ovf, peak = run(_rows(st, rank, S), WALKERS, seed,
                                          u if fed else None)
            out["relay"][("group", overlap, fed)] = (
                trelay.stitch(home, group).numpy(), rounds, ovf, peak)
    # the refusals
    mesh = meshes["2x2"]
    refused = {}
    for what, fn in (
            ("walker group", lambda: trelay.make_relay(
                bk, cfg, PARAMS, mesh=mesh, walker_axes=WAXES)(
                    _rows(st, rank // 2, 2), WALKERS[:23], seed)),
            ("vertex axis", lambda: trelay.make_relay(
                bk, cfg, PARAMS, mesh=mesh, walker_axes=("data", "walker"))),
            ("not in mesh", lambda: trelay.make_relay(
                bk, cfg, PARAMS, mesh=mesh, walker_axes=("nope",))),
            ("group walker_axes", lambda: trelay.make_relay(
                bk, cfg, PARAMS, group, walker_axes=WAXES)),
            ("mesh and group", lambda: trelay.make_relay(
                bk, cfg, PARAMS, group, mesh=mesh, walker_axes=WAXES))):
        try:
            fn()
            refused[what] = None
        except ValueError as e:
            refused[what] = str(e)
    out["refused"] = refused
    # chaos on (2, 2)
    sl = _rows(st, rank // 2, 2)
    out["chaos"] = {}
    for name, kw in SCHEDULES.items():
        for overlap in (False, True) if name == OVERLAPPED else (False,):
            paths, rep = tchaos.run_chaos_relay(
                bk, cfg, PARAMS, None, sl, WALKERS, seed,
                tchaos.ChaosSchedule(**kw), full_length=True,
                overlap=overlap, mesh=mesh, walker_axes=WAXES)
            out["chaos"][f"{name}/{overlap}"] = (paths.numpy(),
                                                 dataclasses.asdict(rep))
    for name, (kw, max_rounds) in RAISING.items():
        try:
            tchaos.run_chaos_relay(bk, cfg, PARAMS, None, sl, WALKERS, seed,
                                   tchaos.ChaosSchedule(**kw),
                                   max_rounds=max_rounds, mesh=mesh,
                                   walker_axes=WAXES)
            out["chaos"][name] = None
        except trelay.RelayIntegrityError as e:
            out["chaos"][name] = (dataclasses.asdict(e.report), str(e))
    return out


_JAX_2D = """
import dataclasses, json, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.core import walks
from repro.core.backend import get_backend
from repro.core.dyngraph import BingoConfig, from_edges
from repro.distributed.chaos import (ChaosSchedule, RelayIntegrityError,
                                     run_chaos_relay)
from repro.distributed.relay import make_relay
from repro.kernels.ops import seed_from_key
from tests.conftest import random_graph
assert len(jax.devices()) == 4
job = json.loads(sys.argv[2])
src, dst, w = random_graph(32, 16, max_bias=63, seed=3)
cfg = BingoConfig(num_vertices=32, capacity=16, bias_bits=6, base_log2=1,
                  lam=4.0)
st = from_edges(cfg, src, dst, w)
params = walks.WalkParams(kind="deepwalk", length=10)
walkers = jnp.arange(24, dtype=jnp.int32) % 32
key = jax.random.key(0)
seed = seed_from_key(key)
u = jax.random.uniform(key, (10, 24, 6))
mesh = jax.make_mesh((2, 2), ("data", "walker"))
bk = get_backend("reference")
out = {"relay": {}, "reports": {}, "paths": {}}
for ov in (False, True):
    for fed in (False, True):
        run = make_relay(bk, cfg, params, mesh, overlap=ov,
                         diagnostics=True, walker_axes=("walker",))
        p, r, o, pk = run(st, walkers, seed, *((u,) if fed else ()))
        out["relay"][f"{ov}/{fed}"] = [np.asarray(p).tolist(), int(r),
                                       int(o), int(pk)]
for name, kw in job["schedules"].items():
    for ov in ((False, True) if name == job["overlapped"] else (False,)):
        p, rep = run_chaos_relay(bk, cfg, params, mesh, st, walkers, seed,
                                 ChaosSchedule(**kw), full_length=True,
                                 overlap=ov, walker_axes=("walker",))
        out["reports"][f"{name}/{ov}"] = dataclasses.asdict(rep)
        out["paths"][f"{name}/{ov}"] = np.asarray(p).tolist()
for name, (kw, mr) in job["raising"].items():
    try:
        run_chaos_relay(bk, cfg, params, mesh, st, walkers, seed,
                        ChaosSchedule(**kw), max_rounds=mr,
                        walker_axes=("walker",))
        out["reports"][name] = None
    except RelayIntegrityError as e:
        out["reports"][name] = dataclasses.asdict(e.report)
with open(sys.argv[1], "w") as f:
    json.dump(out, f)
"""


@pytest.fixture(scope="module")
def job():
    key = jax.random.key(0)
    return {"seed": int(np.asarray(seed_from_key(key))[0]),
            "u": np.asarray(jax.random.uniform(key, (L, B, 6)))}


@pytest.fixture(scope="module")
def ranks(job, tmp_path_factory):
    """The 4 ranks' results, beside JAX's 2D relays on 4 fake devices."""
    d = tmp_path_factory.mktemp("relay2d")
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "PYTHONPATH": os.pathsep.join([str(ROOT / "src"), str(ROOT)])}
    spec = {"schedules": SCHEDULES, "overlapped": OVERLAPPED,
            "raising": RAISING}
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_2D, str(d / "jax.json"),
         json.dumps(spec)], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        out = spawn_ranks(S, job, d, __name__ + ".mesh_job")
        log, _ = jax_proc.communicate(timeout=300)
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
            jax_proc.communicate()
    assert jax_proc.returncode == 0, log
    return out, json.loads((d / "jax.json").read_text())


@pytest.fixture(scope="module")
def single(job):
    """The single-device whole walks, hashed and fed."""
    st = _state()
    u = torch.from_numpy(np.array(job["u"]))
    return {False: random_walk(st, _cfg(), WALKERS, job["seed"],
                               PARAMS).numpy(),
            True: random_walk(st, _cfg(), WALKERS, job["seed"], PARAMS,
                              uniforms=u).numpy()}


# ------------------------------------------------------------------ tests
def test_layout_places_every_rank(ranks):
    """Each rank's vertex index and walker group are JAX's shard indices
    over the vertex and the walker axes; the mesh index is the rank's
    position in the mesh; block g·S_v + v of the stitched paths is held
    by the rank at (v, g); only (0, 0) is the root."""
    out, _ = ranks
    for name, places in PLACES.items():
        for rank, o in enumerate(out):
            sidx, gidx, S_v, S_w, blocks, mesh_index, root = \
                o["layout"][name]
            assert (sidx, gidx) == places[rank], name
            assert S_v * S_w == S and root == (places[rank] == (0, 0))
            assert mesh_index == rank
            assert [places[r] for r in blocks] == \
                [(v, g) for g in range(S_w) for v in range(S_v)]


@pytest.mark.parametrize("fed", [False, True], ids=["hash", "fed"])
@pytest.mark.parametrize("overlap", [False, True], ids=["bulk", "overlap"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_mesh_relay_matches_single_device(ranks, single, mesh, overlap, fed):
    """The stitched paths on every rank equal the single-device whole
    walk; every rank agrees on the rounds, overflow and peak, and the
    peak stays within one walker group's pool."""
    out, _ = ranks
    got = [o["relay"][(mesh, overlap, fed)] for o in out]
    for paths, *counts in got:
        np.testing.assert_array_equal(paths, single[fed])
        assert counts == list(got[0][1:])
    S_w = dict(zip(MESHES[mesh][1], MESHES[mesh][0]))["walker"]
    assert got[0][3] <= trelay.slot_count(B // S_w, S // S_w)


@pytest.mark.parametrize("fed", [False, True], ids=["hash", "fed"])
@pytest.mark.parametrize("overlap", [False, True], ids=["bulk", "overlap"])
def test_mesh_4x1_equals_group_relay(ranks, overlap, fed):
    """A (4, 1) mesh is the 1D relay: paths, rounds, overflow and peak
    equal ``make_relay(group=...)``'s."""
    out, _ = ranks
    for o in out:
        a = o["relay"][("4x1", overlap, fed)]
        b = o["relay"][("group", overlap, fed)]
        np.testing.assert_array_equal(a[0], b[0])
        assert a[1:] == b[1:]


@pytest.mark.parametrize("fed", [False, True], ids=["hash", "fed"])
@pytest.mark.parametrize("overlap", [False, True], ids=["bulk", "overlap"])
def test_mesh_2x2_matches_jax_make_relay(ranks, overlap, fed):
    """Paths, rounds, overflow and peak of the (2, 2) relay equal JAX's
    ``make_relay(mesh, walker_axes=("walker",))`` on 4 devices."""
    out, jax_out = ranks
    paths, rounds, ovf, peak = out[0]["relay"][("2x2", overlap, fed)]
    jp, jr, jo, jpk = jax_out["relay"][f"{overlap}/{fed}"]
    np.testing.assert_array_equal(paths, np.array(jp))
    assert [rounds, ovf, peak] == [jr, jo, jpk]


def test_group_pools_shrink_with_walker_groups(ranks):
    """``tests/test_relay_overlap.py:175``: with S_w = 2 groups over S_v =
    2 shards each pool holds ``slot_count(B/2, 2)`` slots, below the 1D
    relay's over 4 shards of all B walkers, and the peak stays in it."""
    out, _ = ranks
    for o in out:
        assert o["relay"][("2x2", True, False)][3] <= \
            trelay.slot_count(B // 2, 2)
        assert o["relay"][("1x4", True, False)][3] <= \
            trelay.slot_count(B // 4, 1)
    assert trelay.slot_count(B // 2, 2) < B


def test_mesh_relay_refusals(ranks):
    """JAX's three ``ValueError``s, and a plain group has no named axes."""
    out, _ = ranks
    for o in out:
        got = o["refused"]
        assert "walker group" in got["walker group"]
        assert "vertex axis" in got["vertex axis"]
        assert "not in mesh" in got["not in mesh"]
        assert "not in mesh" in got["group walker_axes"]
        assert "not both" in got["mesh and group"]


@pytest.mark.parametrize("name,overlap", [(n, False) for n in SCHEDULES]
                         + [(OVERLAPPED, True)])
def test_chaos_2d_recoverable_schedules(ranks, single, name, overlap):
    """``tests/test_relay_overlap.py:283``: duplicates, delays and
    starvation on (2, 2) lose no walker, the paths on every rank equal
    the fault-free walk, and the report (finished counted over both
    walker groups) equals JAX's field by field."""
    out, jax_out = ranks
    key = f"{name}/{overlap}"
    for o in out:
        paths, rep = o["chaos"][key]
        np.testing.assert_array_equal(paths, single[False])
        assert rep == jax_out["reports"][key]
        assert rep["lost"] == 0 and rep["finished"] == B
        if SCHEDULES[name].get("dup"):
            assert rep["duplicated"] > 0
        if SCHEDULES[name].get("delay"):
            assert rep["delayed"] > 0
    np.testing.assert_array_equal(np.array(jax_out["paths"][key]),
                                  single[False])


@pytest.mark.parametrize("name", list(RAISING))
def test_chaos_2d_faults_raise_on_every_rank(ranks, name):
    """Drops lose walkers and a killed transport leaves work pending: on
    every rank of both walker groups the relay raises with JAX's
    report."""
    out, jax_out = ranks
    for o in out:
        rep, msg = o["chaos"][name]
        assert rep == jax_out["reports"][name]
        if name == "drop":
            assert rep["lost"] > 0 and "lost" in msg
        else:
            assert rep["pending_at_exit"] > 0 and rep["rounds"] == 12
