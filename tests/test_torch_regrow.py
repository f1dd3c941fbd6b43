"""Capacity-ladder regrowth in the port against JAX (``tests/test_regrow.py``).

* ``regrow_state`` equals JAX's ``regrow_state`` on the same state and
  the port's ``from_edges`` at the larger capacity over the same edges,
  in adaptive, baseline and fp-bias mode, chunked and unchunked.
* The ladder's validation and tier configs are the reference's.
* An insert-only guarded stream across a regrow, and a hub driven
  through two tiers by the scheduler, give the same state, stats,
  pending queue and quarantine in both packages after every step.
* Whole walks after the regrow equal JAX's on the regrown state under
  the same JAX-derived seed.

States are built by the port and copied to JAX (``_jax_state``).
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.core import dyngraph as jdg
from repro.core.walks import WalkParams as JWalkParams
from repro.kernels import ref
from repro.kernels.ops import seed_from_key
from repro.serve import DynamicWalkEngine as JEngine
from repro.serve.guard import GuardPolicy as JGuardPolicy
from repro.serve.scheduler import RegrowOp as JRegrowOp
from repro.serve.scheduler import SchedulerConfig as JSchedulerConfig
from repro.serve.scheduler import ServingScheduler as JScheduler
from repro_torch.core import dyngraph as tdg
from repro_torch.core.invariants import check_state
from repro_torch.core.updates import R_CAPACITY
from repro_torch.core.walks import WalkParams
from repro_torch.serve import DynamicWalkEngine, GuardPolicy
from repro_torch.serve.scheduler import (RegrowOp, SchedulerConfig,
                                         ServingScheduler, WalkOp,
                                         replay_admission_trace)
from tests.conftest import random_graph
from tests.test_torch_state import assert_state_matches, configs
from tests.test_torch_updates import _jax_state

PARAMS = WalkParams(kind="deepwalk", length=5)
JPARAMS = JWalkParams(kind="deepwalk", length=5)
_j_regrow = jax.jit(jdg.regrow_state, static_argnums=(1, 2, 3))


def assert_states_equal(a, b):
    """Two port states, leaf by leaf, bit for bit."""
    for name, x, y in zip(a._fields, tdg.state_to_numpy(a),
                          tdg.state_to_numpy(b)):
        if name == "itable":
            for xx, yy in zip(x, y):
                np.testing.assert_array_equal(xx, yy, err_msg=name)
        elif x is None:
            assert y is None, name
        else:
            assert x.dtype == y.dtype, name
            np.testing.assert_array_equal(x, y, err_msg=name)


def test_ladder_validation_and_tiers():
    for mod in (jdg, tdg):
        cfg = mod.BingoConfig(num_vertices=8, capacity=4, bias_bits=3,
                              capacity_ladder=(4, 8, 16))
        assert cfg.ladder == (4, 8, 16) and cfg.tier == 0
        c2 = cfg.tier_config(2)
        assert c2.capacity == 16 and c2.tier == 2 and c2.ladder == cfg.ladder
        flat = mod.BingoConfig(num_vertices=8, capacity=4, bias_bits=3)
        assert flat.ladder == (4,) and flat.tier == 0
        with pytest.raises(ValueError, match="strictly increasing"):
            mod.BingoConfig(num_vertices=8, capacity=4, bias_bits=3,
                            capacity_ladder=(4, 4, 8))
        with pytest.raises(ValueError, match="not a rung"):
            mod.BingoConfig(num_vertices=8, capacity=5, bias_bits=3,
                            capacity_ladder=(4, 8))
    cfg = tdg.BingoConfig(num_vertices=8, capacity=4, bias_bits=3,
                          capacity_ladder=(4, 8))
    st = tdg.from_edges(cfg, np.zeros(2, np.int32), np.arange(1, 3),
                        np.ones(2, np.int32), device="cpu")
    with pytest.raises(ValueError, match="only change capacity"):
        tdg.regrow_state(st, cfg, dataclasses.replace(
            cfg.tier_config(1), bias_bits=4))
    with pytest.raises(ValueError, match="only change capacity"):
        tdg.regrow_state(st, cfg, dataclasses.replace(
            cfg.tier_config(1), adaptive=False))


@pytest.mark.parametrize("chunk", [None, 8], ids=["unchunked", "chunk8"])
@pytest.mark.parametrize("adaptive,fp", [(True, False), (False, False),
                                         (True, True)],
                         ids=["adaptive", "baseline", "fp-bias"])
def test_regrow_rebuild_equivalent(adaptive, fp, chunk):
    """``regrow_state`` == JAX's ``regrow_state`` == the port's
    ``from_edges`` at C' (bit for bit; JAX's fp leaves at the state
    tolerances), and it leaves the old state as it was."""
    V, C = 32, 8
    src, dst, w = random_graph(V, C, max_bias=31, seed=4)
    bias = w.astype(np.float32) / 4 + 0.25 if fp else w
    kw = dict(num_vertices=V, capacity=C, bias_bits=5, adaptive=adaptive,
              fp_bias=fp, lam=4.0, capacity_ladder=(8, 16))
    jcfg, tcfg = configs(**kw)
    st = tdg.from_edges(tcfg, src, dst, bias, device="cpu")
    before = tdg.state_to_numpy(st)
    before = [None if x is None else np.array(x) for x in before[:-1]] \
        + [np.array(x) for x in before.itable]
    ref_st = tdg.from_edges(tcfg.tier_config(1), src, dst, bias,
                            device="cpu")
    grown = tdg.regrow_state(st, tcfg, tcfg.tier_config(1), chunk=chunk)
    assert_states_equal(grown, ref_st)
    check_state(grown, tcfg.tier_config(1))
    after = tdg.state_to_numpy(st)
    after = list(after[:-1]) + list(after.itable)
    for x, y in zip(before, after):
        if x is not None:
            np.testing.assert_array_equal(x, y)
    jgrown = _j_regrow(_jax_state(st), jcfg, jcfg.tier_config(1),
                       chunk or 4096)
    assert_state_matches(jgrown, grown, fp)
    with pytest.raises(ValueError, match="must grow"):
        tdg.regrow_state(ref_st, tcfg.tier_config(1), tcfg)


@pytest.mark.parametrize("kind", ["deepwalk", "ppr", "simple"])
def test_regrown_engine_walks_equal_jax(kind):
    """After ``engine.regrow()`` whole walks equal JAX's walk oracle on
    JAX's regrown state, and an engine built at C', for the same seed."""
    V, C = 32, 8
    src, dst, w = random_graph(V, C, max_bias=15, seed=6)
    jcfg, tcfg = configs(num_vertices=V, capacity=C, bias_bits=4,
                         capacity_ladder=(8, 16))
    params = WalkParams(kind=kind, length=7,
                        stop_prob=0.2 if kind == "ppr" else 0.0)
    st = tdg.from_edges(tcfg, src, dst, w, device="cpu")
    jgrown = _j_regrow(_jax_state(st), jcfg, jcfg.tier_config(1), 4096)
    eng = DynamicWalkEngine(st, tcfg, params, seed=3, guard=True)
    built = DynamicWalkEngine(
        tdg.from_edges(tcfg.tier_config(1), src, dst, w, device="cpu"),
        tcfg.tier_config(1), params, seed=3)
    assert eng.regrow().capacity == 16
    assert eng.tier == 1 and eng.regrow_counts == [0, 1]
    starts = (np.arange(16) % V).astype(np.int32)
    seed = int(seed_from_key(jax.random.key(42))[0])
    got = eng.walk(starts, seed=seed)
    np.testing.assert_array_equal(got.numpy(),
                                  built.walk(starts, seed=seed).numpy())
    want = ref.walk_fused_ref(
        jgrown.itable.prob, jgrown.itable.alias, jgrown.bias, jgrown.nbr,
        jgrown.deg, None, jnp.asarray(starts), None,
        stop_prob=params.stop_prob, uniform=kind == "simple",
        seed=jnp.array([seed], jnp.int32), length=params.length)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert all(v == 0 for v in eng.audit().values())
    with pytest.raises(ValueError, match="top tier"):
        eng.regrow()


def _pair(src, dst, w, kw, **engine_kw):
    """The same engine in both packages over the port's ``from_edges``."""
    jcfg, tcfg = configs(**kw)
    ts = tdg.from_edges(tcfg, src, dst, w, device="cpu")
    jeng = JEngine(_jax_state(ts), jcfg, JPARAMS, seed=0, **engine_kw)
    teng = DynamicWalkEngine(ts, tcfg, PARAMS, seed=0, **engine_kw)
    return jeng, teng


def assert_engines_match(jeng, teng, jstats=None, tstats=None):
    assert_state_matches(jeng.state, teng.state, False)
    if jeng.guard is not None:
        assert teng.guard.snapshot() == jeng.guard.snapshot()
    if jstats is not None:
        for name in ("ins_applied", "del_applied", "transitions",
                     "rejected"):
            np.testing.assert_array_equal(
                np.asarray(getattr(jstats, name)),
                getattr(tstats, name).numpy(), err_msg=name)
        assert float(jstats.max_fill) == float(tstats.max_fill)


def test_insert_only_stream_retries_after_regrow_matches_jax():
    """``tests/test_regrow.py``'s insert-only stream: spills wait with
    their budgets untouched, the regrow drains them — in both packages,
    with equal state, stats, pending queue and quarantine at every step."""
    src = np.array([0, 0, 0, 0, 1], np.int32)
    dst = np.array([1, 2, 3, 4, 0], np.int32)
    w = np.ones(5, np.int32)
    jeng, teng = _pair(src, dst, w, dict(num_vertices=8, capacity=4,
                                         bias_bits=3,
                                         capacity_ladder=(4, 8)),
                       guard=True)
    rounds = [(np.ones(3, bool), np.zeros(3, np.int32),
               np.array([5, 6, 7], np.int32), np.ones(3, np.int32)),
              (np.ones(1, bool), np.array([2], np.int32),
               np.array([3], np.int32), np.ones(1, np.int32))]
    for r in rounds:
        js = jeng.ingest(*map(jnp.asarray, r))
        ts = teng.ingest(*map(torch.from_numpy, r))
        assert_engines_match(jeng, teng, js, ts)
    g = teng.guard
    assert len(g.pending) == 3 and g.quarantined == 0 and not g.want_retry()
    assert all(p.retries_left == g.policy.max_retries for p in g.pending)
    audit = teng.audit(pressure=True)
    assert audit == jeng.audit(pressure=True)
    assert audit["at_capacity"] >= 1 and audit["pending_depth"] == 3
    assert audit["max_fill"] == 1.0
    jeng.regrow()
    teng.regrow()
    assert_engines_match(jeng, teng)
    assert not g.pending and g.quarantined == 0 and g.retried == 3
    assert teng.retry_rounds == 1
    g.check_conservation()
    deg = int(teng.state.deg[0])
    assert deg == 7 and {5, 6, 7} <= set(teng.state.nbr[0, :deg].tolist())
    assert teng.audit(pressure=True) == jeng.audit(pressure=True)


def _hub_soak_kw():
    src = np.array([0, 0, 0, 1, 1, 1, 2], np.int32)
    dst = np.array([1, 2, 3, 4, 5, 6, 7], np.int32)
    return (src, dst, np.ones(7, np.int32),
            dict(num_vertices=16, capacity=4, bias_bits=3,
                 capacity_ladder=(4, 8, 16)))


def _hub_traffic(rng):
    """6 four-lane rounds: 2 hub inserts + 1 filler insert + 1 delete
    of one of vertex 1's seeded edges (absent after round 3)."""
    for r in range(6):
        t1, t2 = 4 + 2 * r, 5 + 2 * r
        yield (np.array([True, True, True, False]),
               np.array([0, 0, 3 + r, 1], np.int32),
               np.array([t1, t2, 9, 4 + (r % 3)], np.int32),
               np.ones(4, np.int32),
               rng.integers(0, 16, int(rng.integers(2, 8))).astype(
                   np.int32))


def _trace_key(op):
    """A trace op as plain data (the same for both packages' ops)."""
    name = type(op).__name__
    if name == "UpdateOp":
        return (name,) + tuple(np.asarray(x).tolist() for x in op[:4]) \
            + (op.n_valid,)
    if name == "WalkOp":
        return (name, op.starts.tolist(), op.rids, op.sizes)
    return (name, op[0])


def test_growth_soak_zero_loss_matches_jax():
    """``tests/test_regrow.py``'s soak: a hub driven through two tiers by
    the scheduler loses no growth edge; the admission trace (with its
    ``RegrowOp``s), generation stamps, final state and guard books equal
    JAX's; the port's live results equal its own replay bit for bit."""
    src, dst, w, kw = _hub_soak_kw()
    jcfg, tcfg = configs(**kw)
    policy = dict(max_retries=2)

    def mk():
        return DynamicWalkEngine(
            tdg.from_edges(tcfg, src, dst, w, device="cpu"), tcfg, PARAMS,
            seed=7, guard=GuardPolicy(**policy), walk_buckets=(8,))

    eng = mk()
    jeng = JEngine(_jax_state(eng.state), jcfg, JPARAMS, seed=7,
                   guard=JGuardPolicy(**policy), walk_buckets=(8,))
    scfg = dict(update_lanes=4, max_update_delay=1, guard_drain_rounds=2)
    sched = ServingScheduler(eng, SchedulerConfig(**scfg))
    jsched = JScheduler(jeng, JSchedulerConfig(**scfg))
    for ins, u, v, ww, starts in _hub_traffic(np.random.default_rng(0)):
        for s in (sched, jsched):
            assert s.submit_update(ins, u, v, ww)
            assert s.submit_walk(starts) is not None
            s.tick()
    done = {r.rid: r for r in sched.close()}
    jdone = {r.rid: r for r in jsched.close()}
    sched.check_conservation()
    eng.guard.check_conservation()
    assert [_trace_key(op) for op in sched.trace] == \
        [_trace_key(op) for op in jsched.trace]
    assert {r: d.generation for r, d in done.items()} == \
        {r: d.generation for r, d in jdone.items()}
    assert_engines_match(jeng, eng)
    assert eng.tier == 2 and eng.regrow_counts == [0, 1, 1]
    assert sum(isinstance(op, RegrowOp) for op in sched.trace) == 2
    assert sum(isinstance(op, JRegrowOp) for op in jsched.trace) == 2
    g = eng.guard
    assert not g.pending and all(q.reason != R_CAPACITY
                                 for q in g.quarantine)
    deg = int(eng.state.deg[0])
    assert deg == 15 and set(range(1, 16)) <= set(
        eng.state.nbr[0, :deg].tolist())

    fresh = mk()
    replayed = iter(replay_admission_trace(fresh, sched.trace))
    n_walks = 0
    for op in sched.trace:
        if isinstance(op, WalkOp):
            rep = next(replayed)
            off = np.cumsum([0] + list(op.sizes))
            for j, rid in enumerate(op.rids):
                np.testing.assert_array_equal(done[rid].paths,
                                              rep[off[j]:off[j + 1]])
            n_walks += 1
    assert n_walks == 6
    assert fresh.tier == 2 and fresh.guard.snapshot() == g.snapshot()
    assert_states_equal(fresh.state, eng.state)
