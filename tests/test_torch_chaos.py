"""The port's relay fault-injection harness against JAX's
(``tests/test_chaos.py``, ``tests/test_regrow.py:472``).

* In one process: ``audit_paths``, ``merge_into_free``, ``_u01`` and one
  faulty exchange at one shard equal JAX's; ``Partition1D`` is
  ``tests/test_distributed.py:90``'s.
* Four gloo ranks on the CPU (one spawn, as ``test_torch_sharded_serving``
  spawns): the census equals the production relay on a clean transport
  and leaves it unchanged with ``census=False``; duplicate, delay and
  starvation schedules give the fault-free single-device walk with no
  walker lost; drops and a killed transport raise ``RelayIntegrityError``
  with a report, also across a regrow; the ``slot_slack`` and
  ``path_cap`` options stay exact (``tests/test_relay_compact.py``);
  ``make_walk_step`` routes as JAX's.
* JAX's ``run_chaos_relay`` on 4 fake CPU devices, in a subprocess beside
  the spawn (the test process keeps one JAX device), gives the same
  ``ChaosReport`` field by field and the same paths.
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
import jax.numpy as jnp
import torch

from repro.distributed import chaos as jchaos
from repro.distributed.walker_exchange import (merge_into_free as
                                               j_merge_into_free)
from repro.graph.partition import Partition1D as JPartition1D
from repro.kernels.ops import seed_from_key
from repro_torch.core import dyngraph as tdg
from repro_torch.core.backend import get_backend
from repro_torch.core.walks import WalkParams, random_walk
from repro_torch.distributed import chaos as tchaos
from repro_torch.distributed.relay import (RelayIntegrityError, make_relay,
                                           slot_count, stitch)
from repro_torch.distributed.walker_exchange import (make_walk_step,
                                                     merge_into_free)
from repro_torch.graph import Partition1D
from tests.conftest import random_graph
from tests.test_torch_sharded_serving import spawn_ranks

ROOT = Path(__file__).resolve().parent.parent
S, V, C, B, L = 4, 32, 16, 24, 10
SCHEDULES = {
    "delay": dict(seed=1, delay=0.3),
    "dup": dict(seed=2, dup=0.3),
    "starve+dup+delay+pathfaults": dict(seed=4, dup=0.2, delay=0.2,
                                        mailbox_cap=1, path_faults=True),
}
OVERLAPPED = "dup"               # also run on the overlapped schedule
RAISING = {"drop": (dict(seed=5, drop=0.15), None),
           "kill": (dict(seed=6, kill_round=1), 12)}
ACROSS = dict(seed=2, dup=0.2, delay=0.2)


def _cfg(ladder=None):
    kw = dict(num_vertices=V, capacity=C, bias_bits=6, base_log2=1, lam=4.0)
    if ladder:
        kw["capacity_ladder"] = ladder
    return tdg.BingoConfig(**kw)


def _state(cfg):
    src, dst, w = random_graph(V, C, max_bias=63, seed=3)
    return tdg.from_edges(cfg, src, dst, w, device="cpu")


def _funnel():
    """``tests/test_relay_compact.py``'s funnel: every neighbour on shard
    0, 4 vertices a shard."""
    Vf = S * 4
    src = np.arange(Vf, dtype=np.int32)
    cfg = tdg.BingoConfig(num_vertices=Vf, capacity=4, bias_bits=3)
    return tdg.from_edges(cfg, src, src % 4, np.full(Vf, 2, np.int32),
                          device="cpu"), cfg


def _shard(st, rank, n):
    rows = st.nbr.shape[0] // n
    lo = rank * rows
    return tdg.BingoState(
        *[None if x is None else x[lo:lo + rows].clone() for x in st[:-1]],
        itable=type(st.itable)(*[x[lo:lo + rows].clone()
                                 for x in st.itable]))


PARAMS = WalkParams("deepwalk", L)
WALKERS = torch.arange(B, dtype=torch.int32) % V
STEP_ROWS = 6


def _step_walkers():
    """(S·6, 2) ``[vertex, wid]`` rows, some empty; rank r holds rows
    ``[6r, 6r + 6)``."""
    rng = np.random.default_rng(4)
    v = rng.integers(-1, V, S * STEP_ROWS).astype(np.int32)
    return np.stack([v, np.where(v >= 0, np.arange(len(v)), -1)],
                    1).astype(np.int32)


def _next_hop(v, key):
    return torch.where(v >= 0, (v * 5 + key) % V, -1)


# ---------------------------------------------------------------- the ranks
def chaos_job(rank, group, job):
    bk = get_backend("fused")
    cfg = _cfg()
    st = _shard(_state(cfg), rank, S)
    seed, u = job["seed"], torch.from_numpy(np.array(job["u"]))
    out = {}

    def run(**kw):
        home, *rest = make_relay(bk, cfg, PARAMS, group, **kw)(
            st, WALKERS, seed)
        return (stitch(home, group).numpy(),) + tuple(rest)

    out["base"] = run()
    out["diag"] = run(diagnostics=True, census=False)
    out["census"] = run(diagnostics=True, census=True)
    for name, kw in SCHEDULES.items():
        for overlap in (False, True) if name == OVERLAPPED else (False,):
            paths, rep = tchaos.run_chaos_relay(
                bk, cfg, PARAMS, group, st, WALKERS, seed,
                tchaos.ChaosSchedule(**kw), full_length=True,
                overlap=overlap)
            out[(name, overlap)] = (paths.numpy(), dataclasses.asdict(rep))
    for name, (kw, max_rounds) in RAISING.items():
        try:
            tchaos.run_chaos_relay(bk, cfg, PARAMS, group, st, WALKERS, seed,
                                   tchaos.ChaosSchedule(**kw),
                                   max_rounds=max_rounds)
            out[name] = None
        except RelayIntegrityError as e:
            out[name] = (dataclasses.asdict(e.report), e.problems, str(e))
    # across a regrow (tests/test_regrow.py:472)
    lcfg = _cfg(ladder=(16, 32))
    lst = _shard(_state(lcfg), rank, S)
    p0, p1, r0, r1, grown = tchaos.run_chaos_across_regrow(
        bk, lcfg, PARAMS, group, lst, WALKERS, job["seeds"],
        tchaos.ChaosSchedule(**ACROSS), full_length=True)
    out["across"] = (p0.numpy(), p1.numpy(), dataclasses.asdict(r0),
                     dataclasses.asdict(r1), tdg.state_to_numpy(grown))
    try:
        tchaos.run_chaos_across_regrow(
            bk, lcfg, PARAMS, group, lst, WALKERS, job["seeds"],
            tchaos.ChaosSchedule(seed=6, kill_round=1), max_rounds=12)
        out["across_kill"] = None
    except RelayIntegrityError as e:
        out["across_kill"] = dataclasses.asdict(e.report)
    # slot_slack and path_cap (tests/test_relay_compact.py)
    for slack in (0, 1):
        out[("slack", slack)] = stitch(make_relay(
            bk, cfg, PARAMS, group, slot_slack=slack)(st, WALKERS, seed, u)[0],
            group).numpy()
    shard0 = torch.arange(B, dtype=torch.int32) % (V // S)
    home, rounds, ovf, peak = make_relay(bk, cfg, PARAMS, group, slot_slack=0,
                                         diagnostics=True)(st, shard0, seed, u)
    out["exhaust"] = (stitch(home, group).numpy(), rounds, ovf, peak)
    home, rounds, ovf, peak = make_relay(
        bk, cfg, PARAMS, group, path_cap=1, mailbox_cap=1,
        diagnostics=True)(st, WALKERS, seed, u)
    out["path_cap"] = (stitch(home, group).numpy(), rounds, ovf, peak)
    fst, fcfg = _funnel()
    fparams = WalkParams("deepwalk", 6)
    home, rounds, ovf, peak = make_relay(bk, fcfg, fparams, group,
                                         slot_slack=0, diagnostics=True)(
        _shard(fst, rank, S), WALKERS % fcfg.num_vertices, seed)
    out["funnel"] = (stitch(home, group).numpy(), rounds, ovf, peak)
    # make_walk_step
    rows = torch.from_numpy(_step_walkers()[rank * STEP_ROWS:
                                            (rank + 1) * STEP_ROWS])
    arrived, left, n = make_walk_step(_next_hop, V // S, S, group)(rows, 3)
    out["step"] = (arrived.numpy(), left.numpy(), int(n))
    return out


_JAX_CHAOS = """
import dataclasses, json, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.core import walks
from repro.core.backend import get_backend
from repro.core.dyngraph import BingoConfig, from_edges
from repro.distributed.chaos import (ChaosSchedule, RelayIntegrityError,
                                     run_chaos_relay)
from repro.distributed.relay import make_relay
from repro.distributed.walker_exchange import make_walk_step
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
seed = seed_from_key(jax.random.key(0))
mesh = jax.make_mesh((4,), ("data",))
bk = get_backend("reference")
out = {"reports": {}, "paths": {}}
for name, kw in job["schedules"].items():
    for ov in ((False, True) if name == job["overlapped"] else (False,)):
        p, rep = run_chaos_relay(bk, cfg, params, mesh, st, walkers, seed,
                                 ChaosSchedule(**kw), full_length=True,
                                 overlap=ov)
        out["reports"][f"{name}/{ov}"] = dataclasses.asdict(rep)
        out["paths"][f"{name}/{ov}"] = np.asarray(p).tolist()
for name, (kw, mr) in job["raising"].items():
    try:
        run_chaos_relay(bk, cfg, params, mesh, st, walkers, seed,
                        ChaosSchedule(**kw), max_rounds=mr)
        out["reports"][name] = None
    except RelayIntegrityError as e:
        out["reports"][name] = dataclasses.asdict(e.report)
run = make_relay(bk, cfg, params, mesh, diagnostics=True, census=True)
p, r, o, pk, fin, pend, faults = run(st, walkers, seed)
out["census"] = [int(r), int(o), int(pk), int(fin), int(pend),
                 np.asarray(faults).tolist()]
rows = jnp.asarray(np.array(job["step_walkers"], np.int32))
step = make_walk_step(lambda v, k: jnp.where(v >= 0, (v * 5 + k) % 32, -1),
                      8, 4, mesh)
a, l, n = step(rows, jnp.int32(3))
out["step"] = [np.asarray(a).tolist(), np.asarray(l).tolist(), int(n)]
with open(sys.argv[1], "w") as f:
    json.dump(out, f)
"""


@pytest.fixture(scope="module")
def job():
    key = jax.random.key(0)
    return {"seed": int(np.asarray(seed_from_key(key))[0]),
            "seeds": tuple(int(np.asarray(seed_from_key(jax.random.key(k)))[0])
                           for k in (0, 1)),
            "u": np.asarray(jax.random.uniform(key, (L, B, 6)))}


@pytest.fixture(scope="module")
def ranks(job, tmp_path_factory):
    """The 4 ranks' results, beside JAX's chaos runs on 4 fake devices."""
    d = tmp_path_factory.mktemp("chaos4")
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "PYTHONPATH": os.pathsep.join([str(ROOT / "src"), str(ROOT)])}
    spec = {"schedules": SCHEDULES, "overlapped": OVERLAPPED,
            "raising": RAISING, "step_walkers": _step_walkers().tolist()}
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_CHAOS, str(d / "jax.json"),
         json.dumps(spec)], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        out = spawn_ranks(S, job, d, __name__ + ".chaos_job")
        log, _ = jax_proc.communicate(timeout=300)
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
            jax_proc.communicate()
    assert jax_proc.returncode == 0, log
    return out, json.loads((d / "jax.json").read_text())


@pytest.fixture(scope="module")
def single(job):
    """The single-device whole walks the relays must give."""
    cfg, lcfg = _cfg(), _cfg(ladder=(16, 32))
    st, lst = _state(cfg), _state(lcfg)
    grown = tdg.regrow_state(lst, lcfg, lcfg.tier_config(1))
    fst, fcfg = _funnel()
    u = torch.from_numpy(np.array(job["u"]))
    return {
        "hash": random_walk(st, cfg, WALKERS, job["seed"], PARAMS).numpy(),
        "fed": random_walk(st, cfg, WALKERS, job["seed"], PARAMS,
                           uniforms=u).numpy(),
        "exhaust": random_walk(st, cfg, WALKERS % (V // S), job["seed"],
                               PARAMS, uniforms=u).numpy(),
        "funnel": random_walk(fst, fcfg, WALKERS % fcfg.num_vertices,
                              job["seed"], WalkParams("deepwalk", 6)).numpy(),
        "across": (random_walk(lst, lcfg, WALKERS, job["seeds"][0],
                               PARAMS).numpy(),
                   random_walk(grown, lcfg.tier_config(1), WALKERS,
                               job["seeds"][1], PARAMS).numpy()),
        "grown": grown}


# ------------------------------------------------------ one process, no mesh
def test_audit_paths_matches_jax():
    """``tests/test_chaos.py:50``'s rows, each finding JAX's."""
    starts = np.array([3, 5, -1, 7])
    clean = np.array([[3, 1, 2], [5, 0, -1], [-1, -1, -1], [7, 7, 7]])
    holed = clean.copy()
    holed[0, 1] = -1
    leaked = clean.copy()
    leaked[2, 0] = 4
    cases = [(clean, {}), (clean[[1, 1, 2, 3]], {}), (holed, {}),
             (leaked, {}), (clean, dict(full_length=True))]
    for paths, kw in cases:
        assert tchaos.audit_paths(paths, starts, **kw) == \
            jchaos.audit_paths(paths, starts, **kw)
    assert tchaos.audit_paths(clean, starts) == []
    assert any("expected 3" in p
               for p in tchaos.audit_paths(clean[[1, 1, 2, 3]], starts))
    assert any("hole" in p for p in tchaos.audit_paths(holed, starts))
    assert any("free slot" in p for p in tchaos.audit_paths(leaked, starts))
    assert any("truncated" in p for p in
               tchaos.audit_paths(clean, starts, full_length=True))


def test_merge_into_free_matches_jax():
    """``tests/test_chaos.py:68``'s buffers and seeded random ones: the
    same buffer and placed count as JAX's, first free row first."""
    buf = np.array([[4, 0], [-1, -1], [7, 1], [-1, -1]], np.int32)
    rows = np.array([[9, 9], [8, 8], [6, 6]], np.int32)
    cases = [(buf, rows, np.array([True, False, True])),
             (buf[:3], rows, np.ones(3, bool))]
    rng = np.random.default_rng(0)
    for n in (4, 9):          # more rows selected than free, and fewer
        for _ in range(4):
            b = rng.integers(-1, 9, (n, 3)).astype(np.int32)
            cases.append((b, rng.integers(0, 9, (6, 3)).astype(np.int32),
                          rng.random(6) < 0.6))
    jmerge = jax.jit(j_merge_into_free)
    for b, r, mask in cases:
        got, placed = merge_into_free(torch.from_numpy(b),
                                      torch.from_numpy(r),
                                      torch.from_numpy(mask))
        want, jplaced = jmerge(jnp.asarray(b), jnp.asarray(r),
                               jnp.asarray(mask))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert int(placed) == int(jplaced)
        assert placed.dtype == torch.int32
    _, placed = merge_into_free(torch.from_numpy(buf[:3]),
                                torch.from_numpy(rows), torch.ones(3,
                                                                   dtype=bool))
    assert int(placed) == 1


def test_fault_hash_matches_jax():
    """``_u01`` bit for bit on int32 lanes (negatives and the extremes)."""
    rng = np.random.default_rng(1)
    x = np.concatenate([rng.integers(-2**31, 2**31, 4096),
                        [0, 1, -1, 2**31 - 1, -2**31]]).astype(np.int32)
    np.testing.assert_array_equal(
        tchaos._u01(torch.from_numpy(x)).numpy(),
        np.asarray(jchaos._u01(jnp.asarray(x))))


@pytest.mark.parametrize("channel", [0, 1])
def test_chaos_exchange_matches_jax_at_one_shard(channel):
    """The faulty exchange (fault masks, duplicate and delay placement,
    the real exchange, the kill) of one shard equals JAX's inside a
    one-device ``shard_map``, round by round."""
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P
    mesh = jax.make_mesh((1,), ("data",))
    rng = np.random.default_rng(2)
    pay = rng.integers(-1, V, (40, 3)).astype(np.int32)
    pay[pay[:, 0] < 0] = -1
    for kw, cap in ((dict(seed=3, drop=0.1, dup=0.3, delay=0.3,
                          path_faults=True), None),
                    (dict(seed=7, dup=0.5, delay=0.4), 3),
                    (dict(seed=1, kill_round=2), None)):
        jex = jchaos._make_chaos_exchange(jchaos.ChaosSchedule(**kw), V, 1,
                                          mesh)
        f = jax.jit(shard_map(
            lambda p, r: jex(p, cap=cap, r=r, channel=channel), mesh=mesh,
            in_specs=(P(), P()), out_specs=(P(), P(), P(), P()),
            check_rep=False))
        tex = tchaos._make_chaos_exchange(tchaos.ChaosSchedule(**kw), V, 1,
                                          None)
        for r in range(4):
            want = f(jnp.asarray(pay), jnp.int32(r))
            got = tex(torch.from_numpy(pay), cap=cap, r=r, channel=channel)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_partition_1d_matches_jax():
    """``tests/test_distributed.py:90``, and JAX's on other sizes."""
    p = Partition1D(num_vertices=100, num_shards=8)
    assert p.padded_vertices == 104
    assert p.shard_size == 13
    np.testing.assert_array_equal(p.shard_of([0, 13, 99]), [0, 1, 7])
    assert p.vertex_range(7) == (91, 100)
    np.testing.assert_array_equal(p.local_id([0, 13, 99]), [0, 0, 8])
    for n, s in ((1 << 20, 4), (7, 3), (64, 64), (5, 8)):
        a, b = Partition1D(n, s), JPartition1D(n, s)
        assert (a.padded_vertices, a.shard_size) == \
            (b.padded_vertices, b.shard_size)
        ids = np.arange(n)
        np.testing.assert_array_equal(a.shard_of(ids), b.shard_of(ids))
        np.testing.assert_array_equal(a.local_id(ids), b.local_id(ids))
        assert [a.vertex_range(k) for k in range(s)] == \
            [b.vertex_range(k) for k in range(s)]


# ------------------------------------------------------------ four ranks
def test_census_matches_production_on_clean_transport(ranks, single):
    """``tests/test_chaos.py:85``: with ``census=True`` the paths, rounds,
    overflow and peak are the production relay's, every walker is seen
    finishing, nothing is pending and no fault is counted; with
    ``census=False`` the outputs are unchanged."""
    out, jax_out = ranks
    for o in out:
        base, diag, census = o["base"], o["diag"], o["census"]
        np.testing.assert_array_equal(base[0], single["hash"])
        for x in (diag, census):
            np.testing.assert_array_equal(x[0], base[0])
            assert x[1:3] == base[1:3]
        assert census[3] == diag[3]
        assert census[4:] == (B, 0, (0, 0, 0))
        assert len(diag) == 4 and len(base) == 3
        assert [census[1], census[2], census[3], census[4], census[5],
                list(census[6])] == jax_out["census"]


@pytest.mark.parametrize("name,overlap", [(n, False) for n in SCHEDULES]
                         + [(OVERLAPPED, True)])
def test_recoverable_schedules_stay_bit_exact(ranks, single, name, overlap):
    """``tests/test_chaos.py:104``: duplicates, delays and starvation lose
    no walker, the stitched paths on every rank equal the fault-free
    single-device walk, and the report equals JAX's field by field."""
    out, jax_out = ranks
    key = f"{name}/{overlap}"
    for o in out:
        paths, rep = o[(name, overlap)]
        np.testing.assert_array_equal(paths, single["hash"])
        assert rep == jax_out["reports"][key]
        assert rep["lost"] == 0 and rep["pending_at_exit"] == 0
        if SCHEDULES[name].get("dup"):
            assert rep["duplicated"] > 0
        if SCHEDULES[name].get("delay"):
            assert rep["delayed"] > 0
    np.testing.assert_array_equal(np.array(jax_out["paths"][key]),
                                  single["hash"])


def test_dropped_walkers_raise_structured_diagnostic(ranks):
    """``tests/test_chaos.py:123``: on every rank, with JAX's report."""
    out, jax_out = ranks
    for o in out:
        rep, problems, msg = o["drop"]
        assert rep["lost"] > 0 and rep["dropped"] > 0
        assert rep["finished"] + rep["lost"] == rep["walkers"] == B
        assert "lost" in msg and problems == []
        assert rep == jax_out["reports"]["drop"]


def test_killed_transport_raises_with_pending_work(ranks):
    """``tests/test_chaos.py:136``: the relay gives up against its bound
    with work pending, on every rank, with JAX's report."""
    out, jax_out = ranks
    for o in out:
        rep, _, msg = o["kill"]
        assert rep["pending_at_exit"] > 0 and rep["rounds"] == 12
        assert "pending at exit" in msg
        assert rep == jax_out["reports"]["kill"]


def test_chaos_across_regrow(ranks, single):
    """``tests/test_regrow.py:472``: exact on both sides of the regrow,
    the grown slices are the single-device regrow's rows, and a killed
    transport still raises."""
    out, _ = ranks
    want0, want1 = single["across"]
    grown = tdg.state_to_numpy(single["grown"])
    for rank, o in enumerate(out):
        p0, p1, r0, r1, g = o["across"]
        np.testing.assert_array_equal(p0, want0)
        np.testing.assert_array_equal(p1, want1)
        assert r0["lost"] == r1["lost"] == 0
        assert r0["duplicated"] + r1["duplicated"] > 0
        rows = V // S
        for name, a, b in zip(g._fields, g, grown):
            if name == "itable":
                for x, y in zip(a, b):
                    np.testing.assert_array_equal(
                        x, y[rank * rows:(rank + 1) * rows])
            elif a is not None:
                np.testing.assert_array_equal(
                    a, b[rank * rows:(rank + 1) * rows], err_msg=name)
        assert o["across_kill"]["pending_at_exit"] > 0


def test_slot_slack_and_path_cap_stay_exact(ranks, single):
    """``tests/test_relay_compact.py``'s ``slot_slack=0`` cases at S = 4:
    slack 0 and 1, the free list exhausted at placement (peak == Wl),
    an arrival funnel onto rank 0; and one-row path and walker
    mailboxes.  Tight sizing costs rounds, never paths."""
    out, _ = ranks
    Wl = slot_count(B, S, slack=0)
    for o in out:
        for slack in (0, 1):
            np.testing.assert_array_equal(o[("slack", slack)],
                                          single["fed"])
        paths, rounds, _, peak = o["exhaust"]
        np.testing.assert_array_equal(paths, single["exhaust"])
        assert rounds >= B // Wl and peak == Wl
        paths, rounds, ovf, _ = o["path_cap"]
        np.testing.assert_array_equal(paths, single["fed"])
        assert ovf > 0
        paths, rounds, _, peak = o["funnel"]
        np.testing.assert_array_equal(paths, single["funnel"])
        assert (paths >= 0).all() and peak == Wl and rounds > 6


def test_walk_step_matches_jax(ranks):
    """``make_walk_step``: each rank's arrivals and leftovers are JAX's
    shard's, and rank 0's overflow count JAX's."""
    out, jax_out = ranks
    arrived, left, n = jax_out["step"]
    arrived, left = np.array(arrived), np.array(left)
    na, nl = len(arrived) // S, len(left) // S
    for r, o in enumerate(out):
        np.testing.assert_array_equal(o["step"][0], arrived[r * na:
                                                            (r + 1) * na])
        np.testing.assert_array_equal(o["step"][1], left[r * nl:(r + 1) * nl])
    assert out[0]["step"][2] == n
