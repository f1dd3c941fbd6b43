"""What the port's batched-update kernel relies on, checked on the CPU
against JAX from the same numpy inputs.

- A ``hypothesis`` property: random sequences of ``from_edges``, batched
  rounds (``ops.update_fused`` on CPU tensors, i.e. ``batched_update``,
  against JAX's ``batched_update``) and single-edge streaming updates
  (``insert_edge``/``delete_edge`` against JAX's), the two states equal
  after every step.  Invariants: the adjacency slots at or above ``deg``
  hold -1 / 0 / +0.0 (``ginv`` -1 in baseline mode); in baseline mode a
  group's list is exactly its ``gsize`` entries, then -1; in adaptive mode
  a row rebuilt by ``from_edges`` or a round has its non-DENSE groups'
  lists at exactly ``min(gsize, Cg)`` entries and its DENSE groups' empty,
  while a row touched by streaming may hold stale entries (any slot index
  below C) that ``gsize`` and ``gtype`` do not describe.  That last case
  is why the kernel writes every list entry of an affected row in
  adaptive mode.
- The reference keeps the same stale lists: ``chip_smoke.streamed_state``
  (a group turned DENSE by a streaming insert and emptied by deletes, one
  appended to afterwards) through JAX's ``stream_updates`` equals the
  port's, and a round over those rows clears them alike.
- ``round_stats`` (a ``scatter_add_`` into 25 bins, no boolean index, no
  ``bincount``) against JAX's ``UpdateStats`` on rounds with transitions.
- ``plan_round``'s torch ops (the prep kernels' plain version) against
  the ordering prepass of JAX's ``update_fused_pallas``: the affected
  vertices U, the sorted insert and delete lanes, their ranks and the
  per-row segments, where the two correspond.
- ``from_edges`` of no edges, in both packages.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from hypothesis import HealthCheck, given, settings, strategies as hs

from repro.core import dyngraph as jdg
from repro.core import radix as jradix
from repro.core import updates as jup
from repro_torch.core import dyngraph as tdg
from repro_torch.core import updates as tup
from repro_torch.kernels import ops
from repro_torch.kernels.update_fused import plan_round
from tests.test_torch_state import assert_state_matches, configs
from tests.test_torch_updates import _jax_state

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import (UPDATE_CONFIGS, stale_lists,  # noqa: E402
                        streamed_config, streamed_inputs, streamed_state)

_j_update = jax.jit(jup.batched_update, static_argnums=1)
_j_insert = jax.jit(jup.insert_edge, static_argnums=1)
_j_delete = jax.jit(jup.delete_edge, static_argnums=1)

V, C, LANES = 6, 10, 8


def check_invariants(st, cfg, clean):
    """The invariants of the module docstring; ``clean`` (V,) bool marks
    rows no streaming update touched since their last rebuild."""
    a = tdg.state_to_numpy(st)
    Cg = cfg.group_capacity
    past = np.arange(cfg.capacity)[None, :] >= a.deg[:, None]
    assert (a.nbr[past] == -1).all() and (a.bias[past] == 0).all()
    f = a.frac[past]
    assert (f == 0).all() and not np.signbit(f).any()      # +0.0
    assert ((a.gmem >= -1) & (a.gmem < cfg.capacity)).all()
    pos = np.arange(Cg)[None, None, :]
    if a.ginv is not None:
        assert (a.ginv.transpose(0, 2, 1)[past] == -1).all()
        exact = np.where(pos < a.gsize[..., None], a.gmem >= 0, a.gmem == -1)
        assert exact.all()
        return
    keep = np.where(a.gtype == jdg.DENSE, 0, np.minimum(a.gsize, Cg))
    exact = np.where(pos < keep[..., None], a.gmem >= 0, a.gmem == -1)
    assert exact.all(-1).all(-1)[clean].all()


ops_strategy = hs.lists(
    hs.one_of(
        hs.tuples(hs.just("stream"), hs.booleans(), hs.integers(0, V - 1),
                  hs.integers(0, V - 1), hs.integers(0, 7)),
        hs.tuples(hs.just("round"), hs.lists(
            hs.tuples(hs.booleans(), hs.integers(0, V - 1),
                      hs.integers(0, V - 1), hs.integers(0, 7)),
            min_size=1, max_size=LANES))),
    min_size=1, max_size=24)


@settings(max_examples=40, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(adaptive=hs.booleans(),
       edges=hs.lists(hs.tuples(hs.integers(0, V - 1), hs.integers(0, V - 1),
                                hs.integers(0, 7)), max_size=16),
       steps=ops_strategy)
def test_update_invariants_hold_and_match_jax(adaptive, edges, steps):
    """Small biases (0..7 over 3 bits) keep groups near the DENSE
    threshold, so DENSE types come and go under streaming."""
    jcfg, tcfg = configs(num_vertices=V, capacity=C, bias_bits=3,
                         adaptive=adaptive)
    src, dst, w = (np.array(x, np.int32).reshape(-1)
                   for x in zip(*edges)) if edges else (
        np.zeros(0, np.int32),) * 3
    ts = tdg.from_edges(tcfg, src, dst, w, device="cpu")
    js = _jax_state(ts)
    clean = np.ones(V, bool)
    check_invariants(ts, tcfg, clean)
    for step in steps:
        if step[0] == "stream":
            _, ins, u, v, wt = step
            if ins:
                js, jok = _j_insert(js, jcfg, u, v, wt)
                ts, tok = tup.insert_edge(ts, tcfg, u, v, wt)
            else:
                js, jok = _j_delete(js, jcfg, u, v)
                ts, tok = tup.delete_edge(ts, tcfg, u, v)
            assert bool(jok) == bool(tok)
            clean[u] = False
        else:
            lanes = step[1] + [(True, 0, 0, 1)] * (LANES - len(step[1]))
            ins, uu, vv, ww = (np.array(x) for x in zip(*lanes))
            act = np.arange(LANES) < len(step[1])
            batch = (ins, uu.astype(np.int32), vv.astype(np.int32),
                     ww.astype(np.int32))
            js, jstats = _j_update(js, jcfg, *map(jnp.asarray, batch),
                                   jnp.asarray(act))
            ts, tstats = ops.update_fused(ts, tcfg, *map(torch.from_numpy,
                                                         batch),
                                          torch.from_numpy(act))
            for a, b in zip(jstats[:4], tstats[:4]):
                np.testing.assert_array_equal(np.asarray(a), b.numpy())
            clean[np.unique(uu[act])] = True
        assert_state_matches(js, ts, False)
        check_invariants(ts, tcfg, clean)


@pytest.mark.parametrize("adaptive,fp,base_log2", UPDATE_CONFIGS)
def test_reference_keeps_the_same_stale_lists(adaptive, fp, base_log2):
    """``streamed_state`` in both packages: equal states holding the
    stale lists (adaptive mode), then one round over every streamed row
    equal again, the lists rebuilt."""
    C, seed = 37, 38
    kw = streamed_config(C, adaptive, fp, base_log2)
    jcfg, tcfg = configs(**kw)
    graph, stream = streamed_inputs(C, fp, seed)
    ts = tdg.from_edges(tcfg, *graph, device="cpu")
    js = _jax_state(ts)
    js, jok = jup.stream_updates(js, jcfg, *map(jnp.asarray, stream))
    ts, tok = tup.stream_updates(ts, tcfg, *map(torch.from_numpy, stream))
    np.testing.assert_array_equal(np.asarray(jok), tok.numpy())
    assert_state_matches(js, ts, fp)
    assert stale_lists(ts, tcfg)
    st2, _ = streamed_state(C, adaptive, fp, base_log2, seed, device="cpu")
    for a, b in zip(tdg.state_to_numpy(st2)[:-1], tdg.state_to_numpy(ts)[:-1]):
        if a is not None:
            np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(3)
    Bn = 40
    ins = rng.random(Bn) < 0.5
    uu = np.concatenate([np.repeat(np.arange(8), 3),
                         rng.integers(0, 16, Bn - 24)]).astype(np.int32)
    vv = rng.integers(0, 16, Bn).astype(np.int32)
    ww = rng.integers(0, 8, Bn)
    ww = ((ww + 0.5) / 4.0).astype(np.float32) if fp else ww.astype(np.int32)
    batch = (ins, uu, vv, ww)
    js, jstats = _j_update(js, jcfg, *map(jnp.asarray, batch), None)
    ts, tstats = ops.update_fused(ts, tcfg, *map(torch.from_numpy, batch))
    assert_state_matches(js, ts, fp)
    for a, b in zip(jstats[:4], tstats[:4]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    gm = ts.gmem.numpy()[:8]
    keep = np.where(ts.gtype.numpy()[:8] == tdg.DENSE, 0,
                    np.minimum(ts.gsize.numpy()[:8], tcfg.group_capacity))
    pos = np.arange(tcfg.group_capacity)[None, None, :]
    assert np.where(pos < keep[..., None], gm >= 0, gm == -1).all()


@pytest.mark.parametrize("adaptive", [True, False])
def test_round_stats_without_host_sync_match_jax(adaptive):
    """Rounds whose groups change type: transitions, applied counts and
    rejects equal JAX's ``UpdateStats``."""
    jcfg, tcfg = configs(num_vertices=32, capacity=16, bias_bits=4,
                         adaptive=adaptive)
    rng = np.random.default_rng(12)
    src = rng.integers(0, 32, 200).astype(np.int32)
    dst = rng.integers(0, 32, 200).astype(np.int32)
    ts = tdg.from_edges(tcfg, src, dst, rng.integers(1, 16, 200), device="cpu")
    js = _jax_state(ts)
    seen = 0
    for r in range(3):
        Bn = 96
        ins = rng.random(Bn) < (0.7 if r == 0 else 0.3)
        uu = rng.integers(-1, 34, Bn).astype(np.int32)
        nbr, deg = ts.nbr.numpy(), ts.deg.numpy()
        vv = np.array([nbr[u, rng.integers(deg[u])] if 0 <= u < 32
                       and deg[u] and not i else rng.integers(0, 32)
                       for u, i in zip(uu, ins)], np.int32)
        ww = rng.integers(1, 16, Bn).astype(np.int32)
        batch = (ins, uu, vv, ww)
        js, jstats = _j_update(js, jcfg, *map(jnp.asarray, batch), None)
        ts, tstats = tup.batched_update(ts, tcfg,
                                        *map(torch.from_numpy, batch))
        for a, b in zip(jstats[:4], tstats[:4]):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        seen += int(tstats.transitions.sum())
    assert seen > 0


def jax_prepass(jcfg, is_insert, u, v, w, active):
    """The ordering prepass of ``repro.kernels.update_fused.
    update_fused_pallas`` (its lines from the lane validity to the
    duplicate ranks), as jnp ops on the same inputs."""
    Vn = jcfg.num_vertices
    B = u.shape[0]
    lane_ok = (u >= 0) & (u < Vn) & (v >= 0)
    ins = is_insert & active & lane_ok
    dele = (~is_insert) & active & lane_ok
    if jcfg.fp_bias:
        w_int, w_frac = jradix.decompose_fp(w, jcfg.lam)
    else:
        w_int, w_frac = jnp.asarray(w, jnp.int32), jnp.zeros((B,), jnp.float32)
    U = jup._padded_unique(jnp.where(ins | dele, u, Vn), Vn)
    idx = jnp.arange(B, dtype=jnp.int32)
    su = jnp.where(ins, u, Vn)
    order = jnp.argsort(su)
    su_s = su[order]
    first = jnp.concatenate([jnp.ones((1,), bool), su_s[1:] != su_s[:-1]])
    rank = idx - jax.lax.cummax(jnp.where(first, idx, -1), axis=0)
    du = jnp.where(dele, u, Vn)
    dv = jnp.where(dele, v, -1)
    ordD = jnp.lexsort((dv, du))
    du_s, dv_s = du[ordD], dv[ordD]
    firstD = jnp.concatenate(
        [jnp.ones((1,), bool),
         (du_s[1:] != du_s[:-1]) | (dv_s[1:] != dv_s[:-1])])
    rankD = idx - jax.lax.cummax(jnp.where(firstD, idx, -1), axis=0)
    return {k: np.asarray(x) for k, x in dict(
        U=U, su_s=su_s, v_s=v[order], wi_s=w_int[order], wf_s=w_frac[order],
        rank=rank, du_s=du_s, dv_s=dv_s, rankD=rankD).items()}


@pytest.mark.parametrize("adaptive,fp,base_log2", UPDATE_CONFIGS)
def test_plan_round_matches_jax_prepass(adaptive, fp, base_log2):
    """Out-of-range and inactive lanes, duplicate deletes, several
    inserts a row."""
    Vn, Bn = 12, 160
    jcfg, tcfg = configs(num_vertices=Vn, capacity=8, bias_bits=6,
                         adaptive=adaptive, fp_bias=fp, base_log2=base_log2,
                         lam=4.0)
    rng = np.random.default_rng(base_log2 * 5 + fp)
    ins = rng.random(Bn) < 0.5
    uu = rng.integers(-2, Vn + 2, Bn).astype(np.int32)
    vv = rng.integers(-1, 5, Bn).astype(np.int32)         # duplicates
    ww = rng.integers(1, 60, Bn)
    ww = (ww + rng.random(Bn)).astype(np.float32) / 4 if fp else \
        ww.astype(np.int32)
    act = rng.random(Bn) < 0.9
    want = jax_prepass(jcfg, *map(jnp.asarray, (ins, uu, vv, ww, act)))
    p = plan_round(tcfg, *map(torch.from_numpy, (ins, uu, vv, ww, act)))
    got = {f: x.numpy() for f, x in zip(p._fields, p)}
    U = got["U"]
    np.testing.assert_array_equal(U, want["U"])
    rows = np.flatnonzero(U < Vn)
    for kind, ref_keys in (("ins", want["su_s"]), ("del", want["du_s"])):
        lo, hi = got[f"{kind}_lo"][rows], got[f"{kind}_hi"][rows]
        at = np.concatenate([np.arange(a, b) for a, b in zip(lo, hi)])
        n = int((ref_keys < Vn).sum())   # JAX's real lanes sort first
        np.testing.assert_array_equal(np.repeat(U[rows], hi - lo),
                                      ref_keys[:n])
        rank = np.concatenate([np.arange(b - a) for a, b in zip(lo, hi)])
        if kind == "ins":
            for f in ("v_s", "wi_s", "wf_s"):
                np.testing.assert_array_equal(got[f][at], want[f][:n],
                                              err_msg=f)
            np.testing.assert_array_equal(rank, want["rank"][:n])
        else:
            np.testing.assert_array_equal(got["dv_s"][at], want["dv_s"][:n])
            np.testing.assert_array_equal(got["rank_d"][at],
                                          want["rankD"][:n])
    rej = got["stats"][27:]
    lane_ok = (uu >= 0) & (uu < Vn) & (vv >= 0)
    assert rej[tup.R_VERTEX] == (act & ~lane_ok).sum()
    assert rej[tup.R_CAPACITY] == (ins & act & lane_ok).sum()
    assert rej[tup.R_ABSENT] == (~ins & act & lane_ok).sum()


@pytest.mark.parametrize("adaptive", [True, False])
def test_from_edges_with_no_edges_matches_jax(adaptive):
    """An empty edge list builds the empty state in both packages (the
    port's segment ranks once indexed entry 0 of an empty tensor)."""
    jcfg, tcfg = configs(num_vertices=5, capacity=4, bias_bits=3,
                         adaptive=adaptive)
    none = np.zeros(0, np.int32)
    js = jdg.from_edges(jcfg, none, none, none)
    ts = tdg.from_edges(tcfg, none, none, none, device="cpu")
    assert_state_matches(js, ts, False)
