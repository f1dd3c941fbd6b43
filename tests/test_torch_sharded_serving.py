"""The sharded engine's serving layer against the single-device engines.

Four gloo ranks on the CPU, spawned once for the module (start method
``spawn``, a ``FileStore`` under ``tmp_path``, as ``test_torch_relay.py``
does), run every scenario below through ``DynamicWalkEngine(group=...)``.
The same scenario functions run in the test process with no group (the
port's single-device engine), and JAX's single-device engine takes the
same inputs.  Everything integer is compared bit for bit; JAX's own
sharded pins (``tests/test_regrow.py``, ``tests/test_scheduler.py``,
``tests/test_recovery.py``) hold JAX-sharded equal to JAX-single.

* ``audit()`` of a sharded engine counts the whole state: a violation
  planted in rank 1's rows is reported by every rank, with JAX's counts.
* Guarded ingest, per round and deferred: summed stats, guard books and
  the final state.
* Lockstep regrow (``tests/test_regrow.py:401``), the scheduler across a
  regrow (``:433``) and live == replay (``tests/test_scheduler.py:103``),
  guard on and off: traces, per-request paths, books and states.
* Crash and restore (``tests/test_recovery.py:169``): the snapshot a
  sharded engine writes is read by JAX's ``restore_checkpoint``, and a
  JAX snapshot by the port.
* Walk buckets: multiples of S only, -1 pads, home blocks cut to the
  real rows; the refusals left (node2vec, per-step walks, walker_axes).
"""

import datetime
import importlib
import pickle
import time
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.core import dyngraph as jdg
from repro.core.invariants import check_state_device as j_check_state_device
from repro.core.walks import WalkParams as JWalkParams
from repro.serve import DynamicWalkEngine as JEngine
from repro.serve.guard import GuardPolicy as JGuardPolicy
from repro.serve.scheduler import SchedulerConfig as JSchedulerConfig
from repro.serve.scheduler import ServingScheduler as JScheduler
from repro.train import checkpoint as jckpt
from repro_torch.core import dyngraph as tdg
from repro_torch.core.walks import WalkParams
from repro_torch.serve import DynamicWalkEngine, GuardPolicy
from repro_torch.serve.recovery import RecoverableEngine
from repro_torch.serve.scheduler import (SchedulerConfig, ServingScheduler,
                                         WalkOp, replay_admission_trace)
from repro_torch.train import checkpoint as tckpt
from tests.conftest import random_graph
from tests.test_torch_guard import _dirty_rounds as _guard_rounds
from tests.test_torch_guard import _state as _guard_state
from tests.test_torch_recovery import STARTS as REC_STARTS
from tests.test_torch_recovery import _dirty_rounds as _rec_rounds
from tests.test_torch_recovery import _fresh as _rec_fresh
from tests.test_torch_regrow import _trace_key
from tests.test_torch_scheduler import _mixed_traffic
from tests.test_torch_state import assert_state_matches, configs
from tests.test_torch_updates import _jax_state

S = 4
SPAWN_TIMEOUT_S = 240
PARAMS = WalkParams(kind="deepwalk", length=5)
JPARAMS = JWalkParams(kind="deepwalk", length=5)
GUARD_POLICIES = {"default": {}, "strict": dict(max_retries=0,
                                                reject_duplicates=True)}


def _np(st):
    """A port state as numpy leaves, copied (a CPU tensor's numpy view
    shares the memory the engine updates in place)."""
    a = tdg.state_to_numpy(st)

    def cp(x):
        return None if x is None else np.array(x, copy=True)
    return tdg.BingoState(*[cp(x) for x in a[:-1]],
                          itable=type(a.itable)(*map(cp, a.itable)))


def _whole(eng):
    """The engine's whole state as numpy (all-gathered when sharded)."""
    return _np(eng.gather_state())


def assert_np_states_equal(a, b):
    for name, x, y in zip(a._fields, a, b):
        if name == "itable":
            for xx, yy in zip(x, y):
                np.testing.assert_array_equal(xx, yy, err_msg=name)
        elif x is None:
            assert y is None, name
        else:
            assert x.dtype == y.dtype, name
            np.testing.assert_array_equal(x, y, err_msg=name)


def _grp(group):
    return {} if group is None else {"group": group}


def _t(*xs):
    return [torch.from_numpy(np.asarray(x)) for x in xs]


def _stats(s):
    return [x.numpy().copy() for x in s[:4]] + [float(s.max_fill)]


# ------------------------------------------------------------- scenarios
# Each runs on every rank with the group, or in the test process with
# group=None, and returns plain data.

AUDIT_ROW = 9        # a row of rank 1 (rows 8..15 of 32 at S = 4)


def _small(ladder=None):
    V, C = 32, 8
    src, dst, w = random_graph(V, C, max_bias=15, seed=8)
    kw = dict(num_vertices=V, capacity=C, bias_bits=4)
    if ladder:
        kw["capacity_ladder"] = ladder
    jcfg, tcfg = configs(**kw)
    return tdg.from_edges(tcfg, src, dst, w, device="cpu"), jcfg, tcfg


def audit_scenario(group):
    """One violation planted in ``wdec`` of ``AUDIT_ROW``, on the rank
    that holds it; every rank audits."""
    st, _, cfg = _small()
    eng = DynamicWalkEngine(st, cfg, PARAMS, **_grp(group))
    lo = eng.rank * eng.shard_size
    if lo <= AUDIT_ROW < lo + eng.shard_size:
        eng.state.wdec[AUDIT_ROW - lo] += 1.0
    return {"audit": eng.audit(), "pressure": eng.audit(pressure=True),
            "state": _whole(eng)}


def regrow_scenario(group):
    """``tests/test_regrow.py:401``: the trigger, the lockstep migration
    and a walk after it."""
    st, _, cfg = _small(ladder=(8, 16))
    eng = DynamicWalkEngine(st, cfg, PARAMS, seed=0, **_grp(group))
    out = {"want": eng.want_regrow(0.5), "fill": eng.max_fill()}
    eng.regrow()
    starts = torch.arange(16, dtype=torch.int32) % 32
    out.update(tier=eng.tier, capacity=eng.cfg.capacity,
               counts=list(eng.regrow_counts), state=_whole(eng),
               walk=eng.walk(starts, 9, stitch=True).numpy(),
               audit=eng.audit(pressure=True))
    return out


def _hub():
    """``tests/test_regrow.py``'s hub soak: V = 16 on a 3-rung ladder."""
    src = np.array([0, 0, 0, 1, 1, 1, 2], np.int32)
    dst = np.array([1, 2, 3, 4, 5, 6, 7], np.int32)
    w = np.ones(7, np.int32)
    jcfg, tcfg = configs(num_vertices=16, capacity=4, bias_bits=3,
                         capacity_ladder=(4, 8, 16))
    return src, dst, w, jcfg, tcfg


def _hub_traffic(rng):
    """6 four-lane rounds: 2 hub inserts + 1 filler insert + 1 delete of
    one of vertex 1's edges, and a walk request of 2-7 starts."""
    for r in range(6):
        t1, t2 = 4 + 2 * r, 5 + 2 * r
        yield (np.array([True, True, True, False]),
               np.array([0, 0, 3 + r, 1], np.int32),
               np.array([t1, t2, 9, 4 + (r % 3)], np.int32),
               np.ones(4, np.int32),
               rng.integers(0, 16, int(rng.integers(2, 8))).astype(np.int32))


HUB_SCHED = dict(update_lanes=4, max_update_delay=1, guard_drain_rounds=2,
                 regrow_watermark=0.9)
MIXED_SCHED = dict(update_lanes=8, max_update_delay=2)


def _drive_hub(sched):
    for ins, u, v, ww, starts in _hub_traffic(np.random.default_rng(1)):
        assert sched.submit_update(ins, u, v, ww)
        assert sched.submit_walk(starts) is not None
        sched.tick()
    return {r.rid: r for r in sched.close()}


def _served(eng, sched, done, mk):
    """What a scheduler run served, and a fresh engine's replay of its
    trace."""
    fresh = mk()
    replayed = replay_admission_trace(fresh, sched.trace)
    return {"trace": [_trace_key(op) for op in sched.trace],
            "paths": {rid: d.paths for rid, d in done.items()},
            "gens": {rid: d.generation for rid, d in done.items()},
            "stats": sched.stats(),
            "replay": replayed, "tier": eng.tier, "fresh_tier": fresh.tier,
            "state": _whole(eng), "fresh_state": _whole(fresh),
            "guard": None if eng.guard is None else eng.guard.snapshot(),
            "fresh_guard": None if fresh.guard is None
            else fresh.guard.snapshot()}


def hub_scenario(group, guard):
    """``tests/test_regrow.py:433``: live == replay with RegrowOps."""
    src, dst, w, _, cfg = _hub()

    def mk():
        return DynamicWalkEngine(tdg.from_edges(cfg, src, dst, w,
                                                device="cpu"),
                                 cfg, PARAMS, seed=7, guard=guard,
                                 walk_buckets=(8,), **_grp(group))
    eng = mk()
    sched = ServingScheduler(eng, SchedulerConfig(**HUB_SCHED))
    return _served(eng, sched, _drive_hub(sched), mk)


def _mixed_engine(guard, group=None, cls=DynamicWalkEngine):
    src, dst, w = random_graph(64, 8, max_bias=15, seed=3)
    jcfg, tcfg = configs(num_vertices=64, capacity=8, bias_bits=4)
    st = tdg.from_edges(tcfg, src, dst, w, device="cpu")
    if cls is JEngine:
        return JEngine(_jax_state(st), jcfg,
                       JWalkParams(kind="deepwalk", length=6), seed=7,
                       guard=guard, walk_buckets=(8, 16, 32))
    return DynamicWalkEngine(st, tcfg, WalkParams(kind="deepwalk", length=6),
                             seed=7, guard=guard, walk_buckets=(8, 16, 32),
                             **_grp(group))


def mixed_scenario(group, guard):
    """``tests/test_scheduler.py:103``: live == replay, 15 mixed ticks."""
    eng = _mixed_engine(guard, group)
    sched = ServingScheduler(eng, SchedulerConfig(**MIXED_SCHED))
    done = _mixed_traffic(sched, n=15)
    return _served(eng, sched, done, lambda: _mixed_engine(guard, group))


GUARD_EXTRA = (np.array([True, True, False]), np.array([6, 0, 6], np.int32),
               np.array([7, 7, 2], np.int32), np.array([3, 3, 1], np.int32))


def _guard_traffic():
    rounds = list(_guard_rounds(6, 8, seed=0))
    rounds.insert(2, GUARD_EXTRA)
    return rounds


def guard_scenario(group, defer, policy):
    """``test_torch_guard.py``'s dirty rounds through a guarded engine:
    per round its stats and books, a drain every third round."""
    st, _, cfg = _guard_state()
    eng = DynamicWalkEngine(st, cfg, WalkParams(length=4),
                            guard=GuardPolicy(**GUARD_POLICIES[policy]),
                            defer_guard=defer, **_grp(group))
    out = {"stats": [], "books": []}
    for i, r in enumerate(_guard_traffic()):
        out["stats"].append(_stats(eng.ingest(*_t(*r))))
        if defer and i % 3 == 2:
            assert eng.drain_guard() == 3
        out["books"].append(eng.guard.snapshot())
    eng.drain_guard()
    eng.guard.check_conservation()
    out.update(final=eng.guard.snapshot(), state=_whole(eng),
               audit=eng.audit(), retry_rounds=eng.retry_rounds)
    return out


def _facts(e):
    return {"state": _whole(e), "gen": e._gen.get_state().numpy().copy(),
            "counters": (e.rounds_ingested, e.updates_applied,
                         e.walks_served, e.cfg, list(e.regrow_counts)),
            "guard": e.guard.snapshot()}


def recovery_scenario(group, d):
    """``tests/test_recovery.py:169``: crash after two guarded rounds with
    a snapshot a round, restore, then one more walk; and a JAX snapshot
    (``d/jax``) read into the engine."""
    d = Path(d)
    rounds = _rec_rounds(n_rounds=2, seed=3)

    def build():
        st, _, cfg = _rec_fresh()
        return DynamicWalkEngine(st, cfg, PARAMS, guard=True, seed=0,
                                 **_grp(group)), cfg
    ref, cfg = build()
    out = {"ref_paths": []}
    for r in rounds:
        ref.ingest(*r)
        out["ref_paths"].append(ref.walk(REC_STARTS, stitch=True).numpy())
    eng, _ = build()
    rec = RecoverableEngine(eng, ckpt_dir=str(d / "rec"), checkpoint_every=1)
    for r in rounds:
        rec.ingest(*r)
        rec.walk(REC_STARTS)
    rec.wait()
    del rec, eng                                        # crash
    rec2 = RecoverableEngine.restore(str(d / "rec"), cfg, PARAMS, guard=True,
                                     device="cpu", **_grp(group))
    out["ref"], out["restored"] = _facts(ref), _facts(rec2.engine)
    out["writer"] = (rec2.wal.write, rec2.ckpt.writer)
    out["ref_next"] = ref.walk(REC_STARTS, stitch=True).numpy()
    out["rec_next"] = rec2.engine.walk(REC_STARTS, stitch=True).numpy()
    js = tckpt.restore_checkpoint(str(d / "jax"), 5,
                                  like=tdg.empty_state(cfg, "meta"),
                                  device="cpu")
    out["from_jax"] = _whole(DynamicWalkEngine(js, cfg, PARAMS,
                                               **_grp(group)))
    return out


BUCKETS = (8, 16)


def bucket_scenario(group):
    """5 starts pad to 8 (-1 free slots sharded), 12 to 16."""
    st, _, cfg = _small()
    eng = DynamicWalkEngine(st, cfg, PARAMS, walk_buckets=BUCKETS,
                            **_grp(group))
    five = torch.tensor([3, 7, 12, 30, 17], dtype=torch.int32)
    return {"home": eng.walk(five, 11).numpy(),
            "whole": eng.walk(five, 11, stitch=True).numpy(),
            "twelve": eng.walk(torch.arange(12, dtype=torch.int32) * 2, 12,
                               stitch=True).numpy(),
            "served": eng.walks_served, "rank": eng.rank,
            "block": BUCKETS[0] // eng.num_shards}


def refusals(group):
    """The sharded engine's refusals: (what, ValueError message)."""
    st, _, cfg = _small()
    out = {}
    for what, kw in (("bucket 6", dict(walk_buckets=(8, 6))),
                     ("node2vec", dict(params=WalkParams("node2vec", 5))),
                     ("per-step", dict(whole_walk=False)),
                     ("walker_axes", dict(walker_axes=("w",)))):
        kw = {"params": PARAMS, **kw}
        try:
            DynamicWalkEngine(st, cfg, kw.pop("params"), group=group, **kw)
            out[what] = None
        except ValueError as e:
            out[what] = str(e)
    eng = DynamicWalkEngine(
        st, tdg.BingoConfig(num_vertices=32, capacity=8, bias_bits=4,
                            capacity_ladder=(8, 16)), PARAMS, group=group,
        guard=True, defer_guard=True, walk_buckets=(8, 16))
    out["accepted"] = (eng.guard is not None, eng.defer_guard,
                       eng.walk_buckets, eng.cfg.ladder)
    return out


def run_all(group, d):
    out = {"audit": audit_scenario(group), "regrow": regrow_scenario(group),
           "buckets": bucket_scenario(group),
           "recovery": recovery_scenario(group, d)}
    for guard in (None, True):
        out[("hub", guard)] = hub_scenario(group, guard)
        out[("mixed", guard)] = mixed_scenario(group, guard)
    for defer in (False, True):
        for policy in GUARD_POLICIES:
            out[("guard", defer, policy)] = guard_scenario(group, defer,
                                                           policy)
    if group is not None:
        out["refusals"] = refusals(group)
    return out


def _rank_job(rank, group, job):
    return run_all(group, Path(job["dir"]) / "shared")


# ------------------------------------------------------------- the spawn
def _rank_main(rank, n, d, target):
    """One gloo rank: ``target(rank, group, job)`` on ``d/job.pkl``, its
    result to ``d/out_<rank>.pkl``."""
    import torch.distributed as dist
    d = Path(d)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(str(d / "store"), n),
                            rank=rank, world_size=n,
                            timeout=datetime.timedelta(seconds=120))
    try:
        mod, fn = target.rsplit(".", 1)
        job = pickle.loads((d / "job.pkl").read_bytes())
        out = getattr(importlib.import_module(mod), fn)(
            rank, dist.group.WORLD, job)
        (d / f"out_{rank}.pkl").write_bytes(pickle.dumps(out))
    finally:
        dist.destroy_process_group()


def spawn_ranks(n, job, d, target):
    """Run ``target`` (a ``module.function`` name) on ``n`` gloo ranks
    (start method ``spawn``), stop them all — at once if one fails — and
    return their results by rank."""
    (d / "job.pkl").write_bytes(pickle.dumps(job))
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, n, str(d), target))
             for r in range(n)]
    for p in procs:
        p.start()
    end = time.monotonic() + SPAWN_TIMEOUT_S
    try:
        while (time.monotonic() < end and any(p.is_alive() for p in procs)
               and not any(p.exitcode for p in procs)):
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    assert [p.exitcode for p in procs] == [0] * n
    return [pickle.loads((d / f"out_{r}.pkl").read_bytes()) for r in range(n)]


# --------------------------------------------------------------- fixtures
def _write_jax_snapshot(d):
    st, _, _ = _rec_fresh()
    jckpt.save_checkpoint(str(d / "jax"), 5, _jax_state(st), {"a": 1})


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """The four ranks' results, by rank, and their shared directory."""
    d = tmp_path_factory.mktemp("sharded_serving")
    _write_jax_snapshot(d / "shared")
    return spawn_ranks(S, {"dir": str(d)}, d, __name__ + "._rank_job"), d


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    """The port's single-device engine through the same scenarios."""
    d = tmp_path_factory.mktemp("single_serving")
    _write_jax_snapshot(d)
    return run_all(None, d)


def _jax_serving(kind, guard):
    """JAX's single-device scheduler on the scenario's traffic."""
    if kind == "hub":
        src, dst, w, jcfg, tcfg = _hub()
        st = tdg.from_edges(tcfg, src, dst, w, device="cpu")
        jeng = JEngine(_jax_state(st), jcfg, JPARAMS, seed=7, guard=guard,
                       walk_buckets=(8,))
        sched = JScheduler(jeng, JSchedulerConfig(**HUB_SCHED))
        done = _drive_hub(sched)
    else:
        jeng = _mixed_engine(guard, cls=JEngine)
        sched = JScheduler(jeng, JSchedulerConfig(**MIXED_SCHED))
        done = _mixed_traffic(sched, n=15)
    return jeng, sched, done


# ------------------------------------------------------------------ tests
def test_sharded_audit_counts_the_whole_state(sharded, single):
    """Every rank's ``audit()`` reports the violation planted in rank 1's
    rows: the single-device port's counts and JAX's
    ``check_state_device`` of the same state."""
    sharded, _ = sharded
    want = single["audit"]
    assert want["audit"]["wdec"] == 1 and sum(want["audit"].values()) == 1
    _, jcfg, tcfg = _small()
    jcounts = np.asarray(j_check_state_device(
        _jax_state(tdg.state_from_numpy(want["state"], tcfg, device="cpu")),
        jcfg, 0)).tolist()
    assert list(want["audit"].values()) == jcounts
    for out in sharded:
        assert out["audit"]["audit"] == want["audit"]
        assert out["audit"]["pressure"] == want["pressure"]
    assert_np_states_equal(sharded[0]["audit"]["state"], want["state"])


def test_lockstep_regrow_matches_single_device(sharded, single):
    sharded, _ = sharded
    want = single["regrow"]
    assert want["tier"] == 1 and want["capacity"] == 16
    st, jcfg, _ = _small(ladder=(8, 16))
    jeng = JEngine(_jax_state(st), jcfg, JPARAMS, seed=0)
    assert jeng.want_regrow(0.5) == want["want"]
    assert jeng.max_fill() == want["fill"]
    jeng.regrow()
    for out in sharded:
        got = out["regrow"]
        assert (got["want"], got["fill"], got["tier"], got["capacity"],
                got["counts"], got["audit"]) == \
            (want["want"], want["fill"], want["tier"], want["capacity"],
             want["counts"], want["audit"])
        assert_np_states_equal(got["state"], want["state"])
        np.testing.assert_array_equal(got["walk"], want["walk"])
    assert_state_matches(jeng.state, tdg.state_from_numpy(
        want["state"], jeng.cfg, device="cpu"), False)


@pytest.mark.parametrize("kind", ["hub", "mixed"])
@pytest.mark.parametrize("guard", [None, True], ids=["guard=off",
                                                     "guard=on"])
def test_sharded_scheduler_live_equals_replay(sharded, single, kind, guard):
    """``tests/test_regrow.py:433`` (hub, across regrows) and
    ``tests/test_scheduler.py:103`` (mixed): on every rank the trace,
    per-request paths, stamps, books and state equal the single-device
    port's, the replay equals the live run, and the trace, stamps, books
    and state equal JAX's scheduler's."""
    sharded, _ = sharded
    want = single[(kind, guard)]
    for out in sharded:
        got = out[(kind, guard)]
        assert got["trace"] == want["trace"]
        assert got["gens"] == want["gens"] and got["stats"] == want["stats"]
        assert got["paths"].keys() == want["paths"].keys()
        for rid, p in want["paths"].items():
            np.testing.assert_array_equal(got["paths"][rid], p)
        for a, b in zip(got["replay"], want["replay"]):
            np.testing.assert_array_equal(a, b)
        assert got["tier"] == got["fresh_tier"] == want["tier"]
        assert got["guard"] == got["fresh_guard"] == want["guard"]
        assert_np_states_equal(got["state"], want["state"])
        assert_np_states_equal(got["fresh_state"], want["state"])
    # live == replay, cohort by cohort
    got = sharded[0][(kind, guard)]
    replayed = iter(got["replay"])
    n_ops = 0
    for key in got["trace"]:
        if key[0] == WalkOp.__name__:
            rep = next(replayed)
            off = np.cumsum([0] + list(key[3]))
            for j, rid in enumerate(key[2]):
                np.testing.assert_array_equal(got["paths"][rid],
                                              rep[off[j]:off[j + 1]])
            n_ops += 1
    assert n_ops > 0
    if kind == "hub":
        assert got["tier"] >= 1
        assert any(k[0] == "RegrowOp" for k in got["trace"])
    jeng, jsched, jdone = _jax_serving(kind, guard)
    assert [_trace_key(op) for op in jsched.trace] == want["trace"]
    assert {r: d.generation for r, d in jdone.items()} == want["gens"]
    assert jsched.stats() == want["stats"]
    assert_state_matches(jeng.state, tdg.state_from_numpy(
        want["state"], jeng.cfg, device="cpu"), False)
    if guard:
        assert jeng.guard.snapshot() == want["guard"]


@pytest.mark.parametrize("policy", list(GUARD_POLICIES))
@pytest.mark.parametrize("defer", [False, True], ids=["round", "deferred"])
def test_sharded_guarded_ingest(sharded, single, defer, policy):
    """Per round the summed stats (the guard's tally included) and the
    books equal the single-device port's and JAX's on every rank; so do
    the final state and books after the last drain."""
    sharded, _ = sharded
    want = single[("guard", defer, policy)]
    st, jcfg, _ = _guard_state()
    jeng = JEngine(_jax_state(st), jcfg, JWalkParams(length=4),
                   guard=JGuardPolicy(**GUARD_POLICIES[policy]),
                   defer_guard=defer)
    for i, r in enumerate(_guard_traffic()):
        js = jeng.ingest(*map(jnp.asarray, r))
        for a, b in zip(want["stats"][i][:4],
                        (js.ins_applied, js.del_applied, js.transitions,
                         js.rejected)):
            np.testing.assert_array_equal(a, np.asarray(b))
        assert want["stats"][i][4] == float(js.max_fill)
        if defer and i % 3 == 2:
            jeng.drain_guard()
        assert jeng.guard.snapshot() == want["books"][i]
    jeng.drain_guard()
    assert jeng.guard.snapshot() == want["final"]
    assert jeng.audit() == want["audit"]
    assert want["final"]["quarantined"] > 0
    for out in sharded:
        got = out[("guard", defer, policy)]
        for a, b in zip(got["stats"], want["stats"]):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        assert got["books"] == want["books"] and got["final"] == want["final"]
        assert got["audit"] == want["audit"]
        assert got["retry_rounds"] == want["retry_rounds"]
        assert_np_states_equal(got["state"], want["state"])


def test_sharded_crash_and_restore(sharded, single):
    """The restored sharded engine equals its uninterrupted twin and the
    single-device port's (state, generator, counters, books, next walk);
    only rank 0 writes the WAL and the snapshots; JAX's
    ``restore_checkpoint`` reads the sharded engine's last snapshot (the
    state after both rounds), and the port reads a JAX snapshot."""
    sharded, d = sharded
    want = single["recovery"]
    assert [o["recovery"]["writer"] for o in sharded] == \
        [(True, True)] + [(False, False)] * (S - 1)
    for out in sharded:
        got = out["recovery"]
        for facts in (got["ref"], got["restored"]):
            assert_np_states_equal(facts["state"], want["ref"]["state"])
            np.testing.assert_array_equal(facts["gen"], want["ref"]["gen"])
            assert facts["counters"] == want["ref"]["counters"]
            assert facts["guard"] == want["ref"]["guard"]
        for a, b in zip(got["ref_paths"], want["ref_paths"]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(got["rec_next"], want["ref_next"])
        np.testing.assert_array_equal(got["ref_next"], want["ref_next"])
        assert_np_states_equal(got["from_jax"], want["from_jax"])
    st, jcfg, tcfg = _rec_fresh()
    assert_np_states_equal(want["from_jax"], _np(st))
    d = d / "shared" / "rec"
    step = jckpt.latest_step(str(d))
    # records: round, walks, round, walks; the last snapshot folds the
    # first three in
    assert step == tckpt.latest_step(str(d)) == 3
    assert len(list((d / "wal").glob("*.npz"))) == 4
    jst = jckpt.restore_checkpoint(str(d), step, like=jdg.empty_state(jcfg))
    assert_state_matches(jst, tdg.state_from_numpy(
        want["ref"]["state"], tcfg, device="cpu"), False)


def test_sharded_walk_buckets_cut_home_blocks(sharded, single):
    """Rank r's home block is rows ``[r·B/S, (r+1)·B/S)`` of the padded
    batch cut to the real rows; stitched, the rows equal the
    single-device engine's."""
    sharded, _ = sharded
    want = single["buckets"]
    for out in sharded:
        got = out["buckets"]
        np.testing.assert_array_equal(got["whole"], want["whole"])
        np.testing.assert_array_equal(got["twelve"], want["twelve"])
        lo = got["rank"] * got["block"]
        np.testing.assert_array_equal(got["home"], want["whole"][lo:lo + 2])
        assert got["served"] == want["served"] == 5 + 5 + 12
    assert [o["buckets"]["home"].shape[0] for o in sharded] == [2, 2, 1, 0]


def test_sharded_engine_refusals(sharded):
    """guard=, defer_guard=, walk buckets and a ladder are accepted; a
    bucket that does not divide over S, node2vec, per-step walks and
    walker_axes are refused."""
    for out in sharded[0]:
        got = out["refusals"]
        assert got["accepted"] == (True, True, (8, 16), (8, 16))
        assert "multiple of the shard count" in got["bucket 6"]
        assert "whole walks" in got["node2vec"]
        assert "whole walks" in got["per-step"]
        assert "A.10" in got["walker_axes"]
