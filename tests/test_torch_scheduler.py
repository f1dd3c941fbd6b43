"""The port's continuous-serving scheduler (``tests/test_scheduler.py``).

* The same submissions give the same admission trace, generation stamps
  and final state (and guard books) in both packages, guard on and off.
* The port's live results equal its serial replay of the trace bit for
  bit, guard on and off, and with a capacity regrow mid-stream; capacity
  spills retry at the recorded drain points.
* Backpressure conserves requests, a deadline flush pads a partial
  window, a padded cohort's real lanes equal an unpadded walk, and the
  deferred guarded ingest makes no host copy.
* ``coalesce_windows`` / ``windows_on_device`` equal JAX's windows.
"""

import numpy as np
import pytest

import torch

from repro.core.walks import WalkParams as JWalkParams
from repro.graph.streams import coalesce_windows as j_coalesce_windows
from repro.serve import DynamicWalkEngine as JEngine
from repro.serve.scheduler import SchedulerConfig as JSchedulerConfig
from repro.serve.scheduler import ServingScheduler as JScheduler
from repro_torch.core import dyngraph as tdg
from repro_torch.core.updates import R_CAPACITY
from repro_torch.core.walks import WalkParams
from repro_torch.graph.streams import (UpdateStream, coalesce_windows,
                                       windows_on_device)
from repro_torch.serve import dynwalk as dynwalk_mod
from repro_torch.serve.dynwalk import DynamicWalkEngine
from repro_torch.serve.scheduler import (DrainOp, RegrowOp, SchedulerConfig,
                                         ServingScheduler, UpdateOp, WalkOp,
                                         replay_admission_trace)
from tests.conftest import random_graph
from tests.test_torch_regrow import (_trace_key, assert_engines_match,
                                     assert_states_equal)
from tests.test_torch_state import configs
from tests.test_torch_updates import _jax_state

V, C = 64, 8
PARAMS = WalkParams(kind="deepwalk", length=6)


def _cfgs(**kw):
    return configs(num_vertices=V, capacity=C, bias_bits=4, **kw)


def _engine(guard=None, buckets=(8, 16, 32), seed=7, cfg_kw=None, **kw):
    src, dst, w = random_graph(V, C, max_bias=15, seed=3)
    _, cfg = _cfgs(**(cfg_kw or {}))
    return DynamicWalkEngine(tdg.from_edges(cfg, src, dst, w, device="cpu"),
                             cfg, PARAMS, seed=seed, guard=guard,
                             walk_buckets=buckets, **kw)


def _mixed_traffic(sched, *, n=24, seed=0, upd_batch=4, max_req=10,
                   sources=V):
    """``tests/test_scheduler.py``'s seeded mixed stream (updates on
    source vertices below ``sources``)."""
    rng = np.random.default_rng(seed)
    for i in range(n):
        if i % 3 == 0:
            assert sched.submit_update(
                rng.random(upd_batch) < 0.7,
                rng.integers(0, sources, upd_batch).astype(np.int32),
                rng.integers(0, V, upd_batch).astype(np.int32),
                np.full(upd_batch, 2, np.int32))
        else:
            nreq = int(rng.integers(1, max_req))
            assert sched.submit_walk(
                rng.integers(0, V, nreq).astype(np.int32)) is not None
        sched.tick()
    done = {r.rid: r for r in sched.drain()}
    sched.check_conservation()
    return done


def _assert_replay_equal(sched, done, fresh_engine):
    """Every served path == the serial replay of the admission trace."""
    replayed = iter(replay_admission_trace(fresh_engine, sched.trace))
    n_ops = 0
    for op in sched.trace:
        if isinstance(op, WalkOp):
            rep = next(replayed)
            off = np.cumsum([0] + list(op.sizes))
            for j, rid in enumerate(op.rids):
                np.testing.assert_array_equal(
                    done[rid].paths, rep[off[j]:off[j + 1]],
                    err_msg=f"rid {rid} diverged from serial replay")
            n_ops += 1
    assert n_ops > 0


@pytest.mark.parametrize("guard", [None, True],
                         ids=["guard=off", "guard=on"])
def test_traces_and_states_match_jax(guard):
    """One seeded stream through both packages' schedulers: equal trace
    (update windows, cohorts, drain points), generation stamps, final
    state and guard books."""
    scfg = dict(update_lanes=8, max_update_delay=2)
    eng = _engine(guard)
    jcfg, _ = _cfgs()
    jeng = JEngine(_jax_state(eng.state), jcfg,
                   JWalkParams(kind="deepwalk", length=6), seed=7,
                   guard=guard, walk_buckets=(8, 16, 32))
    sched = ServingScheduler(eng, SchedulerConfig(**scfg))
    done = _mixed_traffic(sched)
    jsched = JScheduler(jeng, JSchedulerConfig(**scfg))
    jdone = _mixed_traffic(jsched)
    assert [_trace_key(op) for op in sched.trace] == \
        [_trace_key(op) for op in jsched.trace]
    assert {r: d.generation for r, d in done.items()} == \
        {r: d.generation for r, d in jdone.items()}
    assert sched.generation == jsched.generation > 0
    assert sched.stats() == jsched.stats()
    assert_engines_match(jeng, eng)
    if guard:
        assert any(isinstance(op, DrainOp) for op in sched.trace)


@pytest.mark.parametrize("guard", [None, True],
                         ids=["guard=off", "guard=on"])
def test_overlapped_equals_serial_replay(guard):
    eng = _engine(guard)
    sched = ServingScheduler(eng, SchedulerConfig(update_lanes=8,
                                                  max_update_delay=2))
    done = _mixed_traffic(sched)
    assert done and sched.generation > 0
    _assert_replay_equal(sched, done, _engine(guard))
    if guard:
        eng.guard.check_conservation()


@pytest.mark.parametrize("guard", [None, True],
                         ids=["guard=off", "guard=on"])
def test_replay_with_mid_stream_regrow(guard):
    """A ladder (8 -> 16) and a watermark the traffic crosses: the
    ``RegrowOp`` lands in the trace at a drain point, and live == replay
    with the migration at the same position."""
    mk = dict(cfg_kw=dict(capacity_ladder=(8, 16)))
    eng = _engine(guard, **mk)
    sched = ServingScheduler(eng, SchedulerConfig(
        update_lanes=8, max_update_delay=2, guard_drain_rounds=2,
        regrow_watermark=0.9))
    done = _mixed_traffic(sched, n=30, upd_batch=8, sources=4)
    assert any(isinstance(op, RegrowOp) for op in sched.trace)
    assert eng.tier == 1 and eng.cfg.capacity == 16
    fresh = _engine(guard, **mk)
    _assert_replay_equal(sched, done, fresh)
    assert fresh.tier == 1
    assert_states_equal(fresh.state, eng.state)
    if guard:
        assert fresh.guard.snapshot() == eng.guard.snapshot()


def test_replay_capacity_spill_retries_at_drain_points():
    """Spills retry at the scheduler's ``DrainOp``, not per round: a walk
    between the freeing delete and the drain samples the pre-retry state
    in live and replay alike."""
    Vs, Cs = 8, 2
    src, dst, w = random_graph(Vs, Cs, max_bias=7, seed=9)
    cfg = tdg.BingoConfig(num_vertices=Vs, capacity=Cs, bias_bits=3)

    def mk():
        return DynamicWalkEngine(tdg.from_edges(cfg, src, dst, w,
                                                device="cpu"), cfg, PARAMS,
                                 seed=13, guard=True, walk_buckets=(8,))

    dst0 = int(dst[src == 0][0])
    tgt = [x for x in range(1, Vs) if x != dst0][:3]
    eng = mk()
    sched = ServingScheduler(eng, SchedulerConfig(update_lanes=4,
                                                  max_update_delay=1))
    assert sched.submit_update(np.ones(3, bool), np.zeros(3, np.int32),
                               np.array(tgt, np.int32),
                               np.full(3, 2, np.int32))
    sched.tick()
    assert sched.submit_update(np.zeros(1, bool), np.zeros(1, np.int32),
                               np.array([dst0], np.int32),
                               np.ones(1, np.int32))
    sched.tick()
    assert sched.submit_walk(np.zeros(8, np.int32)) is not None
    sched.tick()
    done = {r.rid: r for r in sched.drain()}
    assert any(isinstance(op, DrainOp) for op in sched.trace)
    g = eng.guard
    assert g.retried == 1 and len(g.pending) == 1
    assert g.reason_counts[R_CAPACITY] >= 2
    g.check_conservation()
    assert sched.submit_walk(np.zeros(8, np.int32)) is not None
    sched.tick()
    done.update({r.rid: r for r in sched.drain()})
    sched.check_conservation()
    fresh = mk()
    _assert_replay_equal(sched, done, fresh)
    assert fresh.guard.snapshot() == g.snapshot()


def test_admission_contract():
    """Lossy weight dtypes fail at admission; backpressure conserves
    requests at every moment; ``close()`` restores the engine's guard
    mode; stamps are monotone and a walk admitted before a window
    flushes samples the older generation."""
    sched = ServingScheduler(_engine())
    with pytest.raises(TypeError, match="safe-cast"):
        sched.submit_update(np.ones(4, bool), np.zeros(4, np.int32),
                            np.ones(4, np.int32), np.full(4, 2.5))
    assert sched.updates_offered == 0
    sched.check_conservation()

    sched = ServingScheduler(_engine(), SchedulerConfig(
        update_lanes=8, max_walk_queue=16, max_update_queue=16,
        max_inflight=1))
    rng = np.random.default_rng(1)
    w_rej = u_rej = 0
    for i in range(40):
        if i % 2:
            ok = sched.submit_update(
                np.ones(8, bool), rng.integers(0, V, 8).astype(np.int32),
                rng.integers(0, V, 8).astype(np.int32),
                np.full(8, 2, np.int32))
            u_rej += 0 if ok else 8
        else:
            w_rej += sched.submit_walk(
                rng.integers(0, V, 8).astype(np.int32)) is None
        sched.check_conservation()
    assert sched.submit_walk(np.zeros(33, np.int32)) is None
    w_rej += 1
    sched.drain()
    sched.check_conservation()
    assert sched.walks_rejected == w_rej > 0
    assert sched.updates_rejected == u_rej
    assert sched.stats()["updates"]["queued_lanes"] == 0

    eng = _engine(guard=True)
    sched = ServingScheduler(eng)
    assert eng.defer_guard is True
    sched.submit_update(np.ones(4, bool), np.arange(4, dtype=np.int32),
                        np.arange(4, dtype=np.int32) + 1,
                        np.full(4, 2, np.int32))
    sched.close()
    assert eng.defer_guard is False and eng.guard_backlog == 0
    eng.ingest(torch.ones(2, dtype=torch.bool),
               torch.zeros(2, dtype=torch.int32),
               torch.ones(2, dtype=torch.int32),
               torch.full((2,), 2, dtype=torch.int32))
    assert eng.guard_backlog == 0
    eng.guard.check_conservation()

    sched = ServingScheduler(_engine(), SchedulerConfig(
        update_lanes=64, max_update_delay=100))
    r0 = sched.submit_walk(np.zeros(4, np.int32))
    sched.tick()
    for _ in range(16):
        sched.submit_update(np.ones(4, bool), np.zeros(4, np.int32),
                            np.ones(4, np.int32), np.full(4, 2, np.int32))
    sched.tick()
    r1 = sched.submit_walk(np.zeros(4, np.int32))
    sched.tick()
    done = {r.rid: r for r in sched.drain()}
    assert done[r0].generation == 0 and done[r1].generation == 1


def test_deadline_flush_pads_partial_window():
    sched = ServingScheduler(_engine(), SchedulerConfig(update_lanes=64,
                                                        max_update_delay=3))
    sched.submit_update(np.ones(4, bool), np.zeros(4, np.int32),
                        np.ones(4, np.int32), np.full(4, 2, np.int32))
    sched.tick()
    sched.tick()
    assert sched.generation == 0
    sched.tick()
    assert sched.generation == 1
    (op,) = [op for op in sched.trace if isinstance(op, UpdateOp)]
    assert op.n_valid == 4 and len(op.u) == 64
    assert sched.stats()["updates"]["queued_lanes"] == 0


def test_padded_cohorts_equal_unpadded_walks():
    """Whole walks draw per (seed, lane, step): a padded cohort's real
    lanes equal the unpadded call; ``walks_served`` counts real lanes;
    the cache-size gauges are -1 (torch keeps no program cache)."""
    src, dst, w = random_graph(16, 4, max_bias=7, seed=5)
    cfg = tdg.BingoConfig(num_vertices=16, capacity=4, bias_bits=3)
    starts = np.array([3, 1, 4, 1, 5], np.int32)

    def run(buckets):
        eng = DynamicWalkEngine(tdg.from_edges(cfg, src, dst, w,
                                               device="cpu"), cfg,
                                WalkParams(length=5), seed=11,
                                walk_buckets=buckets)
        return eng, eng.walk(starts).numpy()

    _, plain = run(None)
    eng, padded = run((8, 16))
    np.testing.assert_array_equal(plain, padded)
    assert padded.shape == (5, 6) and eng.walks_served == 5
    assert eng.walk_cache_size() == -1 and eng.update_cache_size() == -1
    with pytest.raises(ValueError, match="largest lane bucket"):
        eng.walk(np.zeros(17, np.int32))


def test_deferred_guard_ingest_never_copies_to_host():
    """With ``defer_guard`` the ingest path copies nothing back to the
    host (the card's no-sync contract, checked here by a tripwire on
    every tensor-to-host exit); the drain settles the backlog."""
    eng = _engine(guard=True, defer_guard=True)
    rng = np.random.default_rng(3)
    rounds = [(torch.from_numpy(rng.random(4) < 0.7),
               torch.from_numpy(rng.integers(-2, V, 4).astype(np.int32)),
               torch.from_numpy(rng.integers(0, V, 4).astype(np.int32)),
               torch.full((4,), 2, dtype=torch.int32)) for _ in range(5)]

    def tripwire(*a, **k):
        raise AssertionError("host copy on the deferred ingest path")

    names = ("item", "tolist", "numpy", "cpu", "nonzero", "__bool__",
             "__int__", "__float__")
    saved = {n: getattr(torch.Tensor, n) for n in names}
    real_host = dynwalk_mod._host
    for n in names:
        setattr(torch.Tensor, n, tripwire)
    dynwalk_mod._host = tripwire
    try:
        for r in rounds:
            eng.ingest(*r)
    finally:
        for n, f in saved.items():
            setattr(torch.Tensor, n, f)
        dynwalk_mod._host = real_host
    assert eng.guard_backlog == 5
    assert eng.drain_guard() == 5 and eng.guard_backlog == 0
    eng.guard.check_conservation()
    assert eng.guard.ingested == 20


def _stream(rounds, B, seed, w=None):
    rng = np.random.default_rng(seed)
    src, dst, ww = random_graph(V, C, max_bias=15, seed=6)
    return UpdateStream(
        src, dst, ww, np.ones((rounds, B), bool),
        rng.integers(0, V, (rounds, B)).astype(np.int32),
        rng.integers(0, V, (rounds, B)).astype(np.int32),
        np.full((rounds, B), 2, np.int32) if w is None else w)


@pytest.mark.parametrize("max_lanes,max_delay", [(4, 1), (4, 0), (16, 2),
                                                 (5, 3)])
def test_coalesce_windows_match_jax(max_lanes, max_delay):
    """Fixed shape, order-preserving, deadline-flushed windows equal to
    JAX's; the device variant uploads the same windows."""
    st = _stream(6, 3, seed=max_lanes + max_delay)
    got = list(coalesce_windows(st, max_lanes=max_lanes,
                                max_delay=max_delay))
    want = list(j_coalesce_windows(st, max_lanes=max_lanes,
                                   max_delay=max_delay))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[4] == w[4]
        for a, b in zip(g[:4], w[:4]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert sum(w[4] for w in got) == 18
    dev = list(windows_on_device(st, max_lanes=max_lanes,
                                 max_delay=max_delay, device="cpu"))
    assert len(dev) == len(got)
    for d, h in zip(dev, got):
        assert d[4] == h[4]
        for a, b in zip(d[:4], h[:4]):
            np.testing.assert_array_equal(a.numpy(), b)


def test_windows_feed_engine_like_rounds():
    """Padded windows through ``ingest(n_valid=)`` land the same state as
    the raw per-round stream."""
    st = _stream(4, 6, seed=8)
    _, cfg = _cfgs()

    def mk():
        return DynamicWalkEngine(tdg.from_edges(cfg, st.init_src,
                                                st.init_dst, st.init_w,
                                                device="cpu"), cfg, PARAMS,
                                 seed=0, walk_buckets=(8,))
    e1, e2 = mk(), mk()
    for r in range(4):
        e1.ingest(st.is_insert[r], st.u[r], st.v[r], st.w[r])
    for ins, u, v, w, nv in windows_on_device(st, max_lanes=16,
                                              max_delay=2, device="cpu"):
        e2.ingest(ins, u, v, w, n_valid=nv)
    assert_states_equal(e1.state, e2.state)
    np.testing.assert_array_equal(e1.walk(np.arange(8)).numpy(),
                                  e2.walk(np.arange(8)).numpy())
