"""The port's crash-exact recovery against JAX's (``tests/test_recovery.py``,
``tests/test_regrow.py``'s crash cases).

* Each package reads the other's WAL records and state snapshots (the
  same files, names and manifest keys); torn ``.tmp`` files are ignored.
* A crashed engine restored from snapshot + WAL replay equals its
  uninterrupted twin bit for bit — state, generator, counters, guard
  books, and the next round and walk — with snapshots every 2 rounds or
  only at construction, and across a regrow: a crash between the regrow
  record and its migration, before the record, and a snapshot taken
  after the migration.
* ``AsyncCheckpointer`` writes the generation it was called at, though
  an in-place ingest follows at once.
"""

import json
import os

import numpy as np
import pytest

import torch

from repro.core import dyngraph as jdg
from repro.serve.recovery import WriteAheadLog as JWriteAheadLog
from repro.train import checkpoint as jckpt
from repro_torch.core import dyngraph as tdg
from repro_torch.core.walks import WalkParams
from repro_torch.serve import DynamicWalkEngine
from repro_torch.serve.recovery import RecoverableEngine, WriteAheadLog
from repro_torch.train import checkpoint as tckpt
from tests.conftest import random_graph
from tests.test_torch_regrow import assert_states_equal
from tests.test_torch_state import assert_state_matches, configs
from tests.test_torch_updates import _jax_state

V, C = 16, 8
PARAMS = WalkParams(kind="deepwalk", length=6)
STARTS = (np.arange(8) % V).astype(np.int32)


def _fresh(**kw):
    src, dst, w = random_graph(V, C, max_bias=31, seed=5)
    jcfg, tcfg = configs(num_vertices=V, capacity=C, bias_bits=5, **kw)
    return tdg.from_edges(tcfg, src, dst, w, device="cpu"), jcfg, tcfg


def _dirty_rounds(n_rounds=4, B=6, seed=2):
    rng = np.random.default_rng(seed)
    rounds = []
    for _ in range(n_rounds):
        u = rng.integers(0, V, B).astype(np.int32)
        u[0] = -1                      # quarantined every round
        rounds.append((rng.random(B) < 0.7, u,
                       rng.integers(0, V, B).astype(np.int32),
                       rng.integers(1, 16, B).astype(np.int32)))
    return rounds


def assert_engines_identical(e0, e1):
    assert_states_equal(e0.state, e1.state)
    assert torch.equal(e0._gen.get_state(), e1._gen.get_state())
    assert (e0.rounds_ingested, e0.updates_applied, e0.walks_served,
            e0.cfg, e0.regrow_counts) == \
        (e1.rounds_ingested, e1.updates_applied, e1.walks_served,
         e1.cfg, e1.regrow_counts)
    if e0.guard is not None:
        assert e0.guard.snapshot() == e1.guard.snapshot()


# -- the WAL and the snapshots, across packages -----------------------------

@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_wal_roundtrip_across_packages(tmp_path, writer):
    """Records one package appends, both replay the same; a reopened
    log continues its sequence and ignores a torn write."""
    Log = JWriteAheadLog if writer == "jax" else WriteAheadLog
    wal = Log(str(tmp_path))
    wal.append_round(np.array([True, False]), np.array([1, 4]),
                     np.array([2, 5]), np.array([3, 1]))
    wal.append_walks(1, 8)
    wal.append_regrow(1)
    wal.append_round(torch.tensor([False]) if writer == "torch"
                     else np.array([False]), np.array([4]), np.array([5]),
                     np.array([1]))
    open(os.path.join(str(tmp_path), "0000000004.npz.tmp-999"),
         "wb").write(b"garbage")
    for Reader in (JWriteAheadLog, WriteAheadLog):
        log = Reader(str(tmp_path))
        assert log.next_seq == 4
        recs = list(log.replay())
        assert [(s, k) for s, k, _ in recs] == \
            [(0, "round"), (1, "walks"), (2, "regrow"), (3, "round")]
        p = recs[0][2]
        assert p["is_insert"].dtype == bool and p["u"].dtype == np.int32
        np.testing.assert_array_equal(p["u"], [1, 4])
        assert int(recs[1][2]["served"]) == 8 and int(recs[2][2]["tier"]) == 1
        assert [s for s, _, _ in log.replay(from_seq=3)] == [3]


@pytest.mark.parametrize("kw", [{}, dict(adaptive=False)],
                         ids=["adaptive", "baseline"])
def test_snapshots_across_packages(tmp_path, kw):
    """A state saved by either package restores in both, and both write
    the same files and manifest leaves."""
    st, jcfg, tcfg = _fresh(**kw)
    js = _jax_state(st)
    jckpt.save_checkpoint(str(tmp_path / "j"), 3, js, {"a": 1})
    tckpt.save_checkpoint(str(tmp_path / "t"), 3, st, {"a": 1})
    mj = json.load(open(tmp_path / "j" / "step_3" / "manifest.json"))
    mt = json.load(open(tmp_path / "t" / "step_3" / "manifest.json"))
    assert mt == mj
    assert sorted(os.listdir(tmp_path / "t" / "step_3")) == \
        sorted(os.listdir(tmp_path / "j" / "step_3"))
    assert ".itable__.prob.npy" in os.listdir(tmp_path / "t" / "step_3")
    assert (".ginv" in mt["leaves"]) == (not tcfg.adaptive)
    for d in ("j", "t"):
        assert tckpt.latest_step(str(tmp_path / d)) == 3
        got = tckpt.restore_checkpoint(str(tmp_path / d), 3,
                                       like=tdg.empty_state(tcfg, "meta"),
                                       device="cpu")
        assert_states_equal(got, st)
        jgot = jckpt.restore_checkpoint(str(tmp_path / d), 3,
                                        like=jdg.empty_state(jcfg))
        assert_state_matches(jgot, st, False)
    os.makedirs(tmp_path / "t" / "step_9.tmp-1")
    assert tckpt.latest_step(str(tmp_path / "t")) == 3


def test_async_checkpoint_writes_the_generation_it_was_called_at(tmp_path):
    """The host copy is taken before ``save`` returns: an in-place round
    right after it does not reach the snapshot."""
    st, _, tcfg = _fresh()
    eng = DynamicWalkEngine(st, tcfg, PARAMS)
    want = tdg.state_to_numpy(eng.state)
    want = [None if x is None else np.array(x) for x in want[:-1]] \
        + [np.array(x) for x in want.itable]
    ck = tckpt.AsyncCheckpointer(str(tmp_path))
    ck.save(0, eng.state)
    for r in _dirty_rounds(3, seed=4):
        eng.ingest(*r)
    ck.wait()
    got = tckpt.restore_checkpoint(str(tmp_path), 0,
                                   like=tdg.empty_state(tcfg, "meta"),
                                   device="cpu")
    got = list(got[:-1]) + list(got.itable)
    for a, b in zip(want, got):
        if a is not None:
            np.testing.assert_array_equal(a, b.numpy())
    assert not torch.equal(eng.state.nbr, got[0])


# -- crash-exact restore ------------------------------------------------------

def _uninterrupted(rounds, **kw):
    st, _, tcfg = _fresh()
    eng = DynamicWalkEngine(st, tcfg, PARAMS, guard=True, seed=0, **kw)
    paths = []
    for r in rounds:
        eng.ingest(*r)
        paths.append(eng.walk(STARTS).numpy())
    return eng, paths


@pytest.mark.parametrize("every", [2, 0], ids=["every2", "gen0only"])
def test_crash_replay_bit_identical(tmp_path, every):
    rounds = _dirty_rounds()
    ref, ref_paths = _uninterrupted(rounds)
    st, _, tcfg = _fresh()
    rec = RecoverableEngine(
        DynamicWalkEngine(st, tcfg, PARAMS, guard=True, seed=0),
        ckpt_dir=str(tmp_path), checkpoint_every=every)
    for r, want in zip(rounds, ref_paths):
        rec.ingest(*r)
        np.testing.assert_array_equal(rec.walk(STARTS).numpy(), want)
    rec.wait()
    del rec                                            # crash
    rec2 = RecoverableEngine.restore(str(tmp_path), tcfg, PARAMS,
                                     guard=True, device="cpu")
    assert_engines_identical(ref, rec2.engine)
    extra = _dirty_rounds(n_rounds=1, seed=9)[0]
    ref.ingest(*extra)
    rec2.ingest(*extra)
    np.testing.assert_array_equal(ref.walk(STARTS).numpy(),
                                  rec2.walk(STARTS).numpy())
    assert_engines_identical(ref, rec2.engine)


def _spill_rounds():
    """Two rounds that leave vertex 0 over capacity with live pending."""
    return [(np.ones(3, bool), np.zeros(3, np.int32),
             np.array([5, 6, 7], np.int32), np.ones(3, np.int32)),
            (np.ones(2, bool), np.array([2, 0], np.int32),
             np.array([6, 8], np.int32), np.ones(2, np.int32))]


def _ladder_engine(seed=0, src=(0, 0, 0, 0, 1), dst=(1, 2, 3, 4, 0)):
    cfg = tdg.BingoConfig(num_vertices=8, capacity=4, bias_bits=3,
                          capacity_ladder=(4, 8))
    st = tdg.from_edges(cfg, np.array(src, np.int32),
                        np.array(dst, np.int32),
                        np.ones(len(src), np.int32), device="cpu")
    return DynamicWalkEngine(st, cfg, PARAMS, guard=True, seed=seed), cfg


def test_crash_mid_regrow_restores_bit_exact(tmp_path):
    """A crash between the regrow record and its migration restores equal
    to the uninterrupted twin (the regrow replays once); a crash before
    the record restores the old tier with the spills still pending."""
    starts = np.arange(8, dtype=np.int32)

    def build(d):
        eng, cfg = _ladder_engine()
        rec = RecoverableEngine(eng, ckpt_dir=str(d))
        for r in _spill_rounds():
            rec.ingest(*r)
        return rec, cfg

    ref, cfg = build(tmp_path / "ref")
    ref.regrow()
    crashed, _ = build(tmp_path / "mid")
    crashed.wal.append_regrow(crashed.engine.tier + 1)
    crashed.wait()
    del crashed
    rec2 = RecoverableEngine.restore(str(tmp_path / "mid"), cfg, PARAMS,
                                     guard=True, device="cpu")
    assert rec2.engine.cfg.capacity == 8 and rec2.engine.tier == 1
    assert_engines_identical(ref.engine, rec2.engine)
    np.testing.assert_array_equal(ref.walk(starts).numpy(),
                                  rec2.walk(starts).numpy())

    early, _ = build(tmp_path / "pre")
    early.wait()
    del early
    rec3 = RecoverableEngine.restore(str(tmp_path / "pre"), cfg, PARAMS,
                                     guard=True, device="cpu")
    assert rec3.engine.cfg.capacity == 4 and rec3.engine.tier == 0
    assert len(rec3.engine.guard.pending) > 0
    rec3.engine.guard.check_conservation()


def test_checkpoint_after_regrow_restores_at_tier(tmp_path):
    """A snapshot taken after a regrow has C'-wide tables: restore reads
    the manifest's tier before it builds the state."""
    eng, cfg = _ladder_engine(seed=1, src=(0, 0, 0, 0), dst=(1, 2, 3, 4))
    rec = RecoverableEngine(eng, ckpt_dir=str(tmp_path))
    for r in _spill_rounds():
        rec.ingest(*r)
    rec.regrow()
    rec.checkpoint()
    rec.wait()
    del rec
    rec2 = RecoverableEngine.restore(str(tmp_path), cfg, PARAMS,
                                     guard=True, device="cpu")
    assert rec2.engine.cfg.capacity == 8
    assert_engines_identical(eng, rec2.engine)
