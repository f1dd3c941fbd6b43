"""The port's ingestion guard against JAX's (``tests/test_guard.py``).

* The classifier's reason codes equal JAX's on ``tests/test_guard.py``'s
  rounds and, as a ``hypothesis`` property, on dirty rounds (bad
  endpoints and weights, absent and same-round deletes, duplicates,
  capacity overflows) in integer and fp mode under both duplicate
  policies; it leaves the state unchanged.
* A guarded engine's per-round ledger — state, stats, quarantine,
  pending queue, counters — equals JAX's, per round and deferred.
"""

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings, strategies as hs

import jax.numpy as jnp
import torch

from repro.core.walks import WalkParams as JWalkParams
from repro.serve import DynamicWalkEngine as JEngine
from repro.serve.guard import GuardPolicy as JGuardPolicy
from repro.serve.guard import make_classifier as j_make_classifier
from repro_torch.core import dyngraph as tdg
from repro_torch.core.updates import (R_ABSENT, R_CAPACITY, R_DUP, R_OK,
                                      R_VERTEX, R_WEIGHT, make_updater)
from repro_torch.core.walks import WalkParams
from repro_torch.serve import DynamicWalkEngine
from repro_torch.serve.guard import (GuardPolicy, make_classifier,
                                     valid_lanes)
from tests.test_torch_regrow import assert_engines_match, assert_states_equal
from tests.test_torch_state import configs
from tests.test_torch_updates import _jax_state

V, C, LANES = 8, 4, 12


def _state(fp=False, **kw):
    """Known rows: v0 -> {1,2,3} (deg 3), v1 -> {0}, v6 full (deg C)."""
    src = np.array([0, 0, 0, 1] + [6] * C, np.int32)
    dst = np.array([1, 2, 3, 0] + list(range(2, 2 + C)), np.int32)
    w = np.full(len(src), 2, np.float32 if fp else np.int32)
    jcfg, tcfg = configs(num_vertices=V, capacity=C, bias_bits=5,
                         fp_bias=fp, lam=4.0, **kw)
    return tdg.from_edges(tcfg, src, dst, w, device="cpu"), jcfg, tcfg


def t(*xs):
    return [torch.from_numpy(np.asarray(x)) for x in xs]


def _classify_both(st, jcfg, tcfg, lanes, policy=None, jfn=None):
    """Reasons from both packages (asserted equal) and the port's."""
    kw = {} if policy is None else policy
    got = make_classifier(tcfg, GuardPolicy(**kw))(st, *t(*lanes))
    jfn = jfn or j_make_classifier(jcfg, JGuardPolicy(**kw))
    want = np.asarray(jfn(_jax_state(st), *map(jnp.asarray, lanes)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    return got.numpy()


def test_valid_lanes_checks_global_range():
    _, _, tcfg = _state()
    u = torch.tensor([0, -1, 7, 8, 3], dtype=torch.int32)
    v = torch.tensor([1, 1, -2, 0, 8], dtype=torch.int32)
    assert valid_lanes(tcfg, u, v).tolist() == [True, False, False, False,
                                                False]


def test_classifier_taxonomy():
    st, jcfg, tcfg = _state()
    lanes = (np.array([1, 1, 1, 1, 1, 0, 0, 0], bool),
             np.array([0, 0, -1, 2, 3, 1, 0, 1], np.int32),
             np.array([4, 5, 2, 8, 1, 5, 2, 0], np.int32),
             np.array([2, 2, 1, 1, 0, 1, 1, 1], np.int32))
    assert _classify_both(st, jcfg, tcfg, lanes).tolist() == [
        R_OK, R_CAPACITY, R_VERTEX, R_VERTEX, R_WEIGHT, R_ABSENT, R_OK, R_OK]


def test_classifier_ok_lanes_always_apply():
    st, jcfg, tcfg = _state()
    lanes = (np.array([1, 1, 1, 0, 0, 0], bool),
             np.array([0, 0, 6, 1, 1, 0], np.int32),
             np.array([4, 5, 7, 0, 0, 7], np.int32),
             np.array([2, 2, 2, 1, 1, 1], np.int32))
    reasons = _classify_both(st, jcfg, tcfg, lanes)
    st2, stats = make_updater(tcfg)(st, *t(*lanes),
                                    torch.from_numpy(reasons == R_OK))
    assert int(stats.rejected.sum()) == 0
    assert int(stats.ins_applied + stats.del_applied) == \
        int((reasons == R_OK).sum())


def test_classifier_duplicate_policy_and_same_round_delete():
    st, jcfg, tcfg = _state()
    lanes = (np.ones(4, bool), np.array([0, 2, 2, 3], np.int32),
             np.array([1, 6, 6, 4], np.int32), np.full(4, 2, np.int32))
    assert _classify_both(st, jcfg, tcfg, lanes).tolist() == [R_OK] * 4
    assert _classify_both(st, jcfg, tcfg, lanes,
                          dict(reject_duplicates=True)).tolist() == \
        [R_DUP, R_OK, R_DUP, R_OK]
    lanes = (np.array([True, False]), np.array([3, 3], np.int32),
             np.array([5, 5], np.int32), np.array([2, 1], np.int32))
    assert _classify_both(st, jcfg, tcfg, lanes).tolist() == [R_OK, R_OK]


_J_CLASSIFIERS = {}


def _j_classifier(jcfg, dup):
    key = (jcfg, dup)
    if key not in _J_CLASSIFIERS:
        _J_CLASSIFIERS[key] = j_make_classifier(
            jcfg, JGuardPolicy(reject_duplicates=dup))
    return _J_CLASSIFIERS[key]


lane_strategy = hs.tuples(hs.booleans(), hs.integers(-1, V),
                          hs.integers(-1, V), hs.integers(-1, 3))


@settings(max_examples=60, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(fp=hs.booleans(), dup=hs.booleans(),
       deg=hs.lists(hs.integers(0, C), min_size=V, max_size=V),
       lanes=hs.lists(lane_strategy, min_size=1, max_size=LANES),
       echo=hs.lists(hs.integers(0, LANES - 1), max_size=4))
def test_classifier_matches_jax_on_dirty_rounds(fp, dup, deg, lanes, echo):
    """Random rows (degrees 0..C, neighbours among 0..3 so duplicates and
    present deletes are common), a round of dirty lanes padded to one
    shape, some lanes repeated: reasons equal JAX's, ``state`` unchanged."""
    rng = np.random.default_rng(sum(deg) + len(lanes))
    src = np.repeat(np.arange(V), deg).astype(np.int32)
    dst = rng.integers(0, 4, src.size).astype(np.int32)
    w = rng.integers(1, 8, src.size).astype(np.int32)
    jcfg, tcfg = configs(num_vertices=V, capacity=C, bias_bits=3,
                         fp_bias=fp, lam=4.0)
    st = tdg.from_edges(tcfg, src, dst, w.astype(np.float32) if fp else w,
                        device="cpu")
    lanes = lanes + [lanes[i % len(lanes)] for i in echo]
    lanes = (lanes + [(False, -1, 0, 1)] * LANES)[:LANES]
    ins, uu, vv, ww = (np.array(x) for x in zip(*lanes))
    ww = ww.astype(np.float32) * np.float32(0.75) if fp \
        else ww.astype(np.int32)
    if fp:
        ww[(np.arange(LANES) % 5) == 4] = np.nan
    batch = (ins.astype(bool), uu.astype(np.int32), vv.astype(np.int32), ww)
    before = tdg.state_to_numpy(st)
    before = [np.array(x) for x in before[:-1] if x is not None]
    got = make_classifier(tcfg, GuardPolicy(reject_duplicates=dup))(
        st, *t(*batch))
    want = _j_classifier(jcfg, dup)(_jax_state(st), *map(jnp.asarray, batch))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    after = [x for x in tdg.state_to_numpy(st)[:-1] if x is not None]
    for a, b in zip(before, after):
        np.testing.assert_array_equal(a, b)


def _dirty_rounds(n, B, seed):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        yield (rng.random(B) < 0.7,
               rng.integers(-2, V + 2, B).astype(np.int32),
               rng.integers(-2, V + 2, B).astype(np.int32),
               rng.integers(0, 5, B).astype(np.int32))


@pytest.mark.parametrize("defer", [False, True], ids=["round", "deferred"])
@pytest.mark.parametrize("policy", [dict(), dict(max_retries=1),
                                    dict(max_retries=0,
                                         reject_duplicates=True)],
                         ids=["default", "retries1", "strict"])
def test_guarded_engine_ledger_matches_jax(defer, policy):
    """Dirty rounds (bad endpoints and weights, absent deletes, spills on
    the full row 6 and on row 0, deletes that free slots) through a
    guarded engine in both packages: after every round the state, the
    stats (the guard's reject tally included) and the guard's books are
    JAX's; deferred books after each drain."""
    st, jcfg, tcfg = _state()
    jeng = JEngine(_jax_state(st), jcfg, JWalkParams(length=4),
                   guard=JGuardPolicy(**policy), defer_guard=defer)
    teng = DynamicWalkEngine(st, tcfg, WalkParams(length=4),
                             guard=GuardPolicy(**policy), defer_guard=defer)
    rounds = list(_dirty_rounds(6, 8, seed=0))
    rounds.insert(2, (np.array([True, True, False]),
                      np.array([6, 0, 6], np.int32),
                      np.array([7, 7, 2], np.int32),
                      np.array([3, 3, 1], np.int32)))
    for i, r in enumerate(rounds):
        js = jeng.ingest(*map(jnp.asarray, r))
        ts = teng.ingest(*t(*r))
        if defer and i % 3 == 2:
            assert jeng.drain_guard() == teng.drain_guard() == 3
        assert_engines_match(jeng, teng, js, ts)
        if not defer or i % 3 == 2:
            teng.guard.check_conservation()
    jeng.drain_guard()
    teng.drain_guard()
    assert_engines_match(jeng, teng)
    g = teng.guard
    assert g.ingested == sum(len(r[0]) for r in rounds)
    assert g.quarantined == len(g.quarantine) > 0
    assert teng.audit() == jeng.audit()


def test_capacity_spill_retry_and_budget_match_jax():
    """``tests/test_guard.py``'s spill / retry-after-delete / budget
    exhaustion sequences: every step's books equal JAX's."""
    for policy, steps, end in (
            (dict(), [(True, 6, 7, 3), (False, 6, 2, 1)], "retried"),
            (dict(max_retries=1), [(True, 6, 7, 3), (False, 0, 1, 1)],
             "exhausted"),
            (dict(max_retries=0), [(True, 6, 7, 3)], "direct")):
        st, jcfg, tcfg = _state()
        jeng = JEngine(_jax_state(st), jcfg, guard=JGuardPolicy(**policy))
        teng = DynamicWalkEngine(st, tcfg, guard=GuardPolicy(**policy))
        for ins, u, v, w in steps:
            lanes = (np.array([ins]), np.array([u], np.int32),
                     np.array([v], np.int32), np.array([w], np.int32))
            js = jeng.ingest(*map(jnp.asarray, lanes))
            ts = teng.ingest(*t(*lanes))
            assert_engines_match(jeng, teng, js, ts)
            teng.guard.check_conservation()
        g = teng.guard
        if end == "retried":
            assert not g.pending and g.retried == 1 and teng.retry_rounds == 1
            assert 7 in teng.state.nbr[6, :int(teng.state.deg[6])].tolist()
        else:
            assert not g.pending and g.quarantine[-1].reason == R_CAPACITY
            assert (g.quarantine[-1].u, g.quarantine[-1].v) == (6, 7)


def test_guarded_engine_bit_exact_on_clean_stream():
    """On a valid stream the guard only observes: states and stats equal
    the unguarded engine's."""
    from repro_torch.graph.streams import make_update_stream
    from tests.conftest import random_graph
    src, dst, w = random_graph(16, 8, max_bias=31, seed=4)
    cfg = tdg.BingoConfig(num_vertices=16, capacity=8, bias_bits=5)
    stream = make_update_stream(src, dst, w, batch_size=4, rounds=3,
                                seed=1, num_vertices=16)

    def run(guard):
        eng = DynamicWalkEngine(tdg.from_edges(
            cfg, stream.init_src, stream.init_dst, stream.init_w,
            device="cpu"), cfg, guard=guard)
        out = [eng.ingest(*t(stream.is_insert[r], stream.u[r], stream.v[r],
                             stream.w[r])) for r in range(3)]
        return eng, out

    e0, s0 = run(None)
    e1, s1 = run(True)
    for a, b in zip(s0, s1):
        assert a.rejected.tolist() == b.rejected.tolist()
        assert int(b.rejected.sum()) == 0
    assert_states_equal(e0.state, e1.state)
    e1.guard.check_conservation()
    assert not e1.guard.quarantine and not e1.guard.pending
