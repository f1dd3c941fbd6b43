"""The slice end to end: the port's engine beside JAX's on one stream.

R-MAT graph (scale 8) with degree biases, a 3-round mixed update stream,
a JAX ``DynamicWalkEngine(backend="reference")`` and the port's engine on
the CPU.  After every ``ingest`` the states are equal leaf by leaf and the
stats equal; every port walk equals ``ref.walk_fused_ref`` on the JAX
engine's state under the same JAX-derived seed.

The per-step engines (node2vec, and deepwalk with ``whole_walk=False``)
drive ``run_stream`` on the same stream: their update state stays equal
to the JAX engine's leaf by leaf, every hop they walk is an edge of the
current state, and ``last_seed`` replays a batch exactly.
"""

import pytest

import numpy as np

import jax
import jax.numpy as jnp
import torch

from repro.core import dyngraph as jdg
from repro.core.walks import WalkParams as JWalkParams
from repro.graph import rmat as jrmat
from repro.graph import streams as jstreams
from repro.kernels import ref
from repro.kernels.ops import seed_from_key
from repro.serve import DynamicWalkEngine as JEngine
from repro_torch.core import dyngraph as tdg
from repro_torch.core.walks import WalkParams
from repro_torch.graph import rmat as trmat
from repro_torch.graph import streams as tstreams
from repro_torch.serve import DynamicWalkEngine
from tests.test_torch_state import assert_state_matches, configs
from tests.test_torch_updates import _jax_state

SCALE, BATCH, ROUNDS, L = 8, 64, 3, 12


def _stream(rmat, streams):
    src, dst = rmat.rmat_edges(SCALE, 8, seed=0)
    w = rmat.degree_bias(src, dst, 1 << SCALE)
    return src, dst, w, streams.make_update_stream(
        src, dst, w, batch_size=BATCH, rounds=ROUNDS, mode="mixed", seed=0)


def test_copied_generators_match_jax():
    *jg, js = _stream(jrmat, jstreams)
    *tg, ts = _stream(trmat, tstreams)
    for a, b in zip(jg + list(js), tg + list(ts)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_engine_matches_jax_engine():
    V = 1 << SCALE
    _, _, _, stream = _stream(trmat, tstreams)
    jcfg, tcfg = configs(num_vertices=V, capacity=32, bias_bits=16)
    init = (stream.init_src, stream.init_dst, stream.init_w)
    jeng = JEngine(jdg.from_edges(jcfg, *init), jcfg,
                   JWalkParams("deepwalk", L), backend="reference")
    teng = DynamicWalkEngine(tdg.from_edges(tcfg, *init, device="cpu"), tcfg,
                             WalkParams("deepwalk", L))
    assert_state_matches(jeng.state, teng.state, fp=False)
    starts = np.arange(0, V, 4, dtype=np.int32)
    key = jax.random.key(0)
    for r in range(ROUNDS):
        batch = (stream.is_insert[r], stream.u[r], stream.v[r], stream.w[r])
        jstats = jeng.ingest(*map(jnp.asarray, batch))
        tstats = teng.ingest(*batch)
        assert_state_matches(jeng.state, teng.state, fp=False)
        for name, a, b in zip(jstats._fields, jstats, tstats):
            np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                          err_msg=name)
        key, sub = jax.random.split(key)
        seed = int(seed_from_key(sub)[0])
        js = jeng.state
        want = ref.walk_fused_ref(
            js.itable.prob, js.itable.alias, js.bias, js.nbr, js.deg, None,
            jnp.asarray(starts), None, seed=jnp.array([seed], jnp.int32),
            length=L)
        got = teng.walk(starts, seed=seed)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert teng.rounds_ingested == ROUNDS
    assert teng.updates_applied == ROUNDS * BATCH
    assert teng.walks_served == ROUNDS * len(starts)


def test_run_stream_and_engine_seed():
    """``run_stream`` yields one (round, stats, paths) per round; walks
    without a seed draw from the engine's own generator (same engine
    seed, same walks)."""
    V = 1 << SCALE
    _, _, _, stream = _stream(trmat, tstreams)
    cfg = tdg.BingoConfig(num_vertices=V, capacity=32, bias_bits=16)
    init = (stream.init_src, stream.init_dst, stream.init_w)
    runs = []
    for _ in range(2):
        eng = DynamicWalkEngine(tdg.from_edges(cfg, *init, device="cpu"), cfg,
                                WalkParams("deepwalk", 6), seed=3)
        starts = torch.arange(0, V, 8, dtype=torch.int32)
        out = list(eng.run_stream(stream, starts, walks_per_round=2))
        assert [r for r, _, _ in out] == list(range(ROUNDS))
        assert all(p.shape == (2, len(starts), 7) for _, _, p in out)
        assert all(float(s.max_fill) <= 1.0 for _, s, _ in out)
        runs.append(torch.stack([p for _, _, p in out]))
    assert torch.equal(runs[0], runs[1])


@pytest.mark.parametrize("kind,whole_walk", [("node2vec", None),
                                             ("deepwalk", False)])
def test_per_step_engines_run_stream(kind, whole_walk):
    V = 1 << SCALE
    _, _, _, stream = _stream(trmat, tstreams)
    jcfg, tcfg = configs(num_vertices=V, capacity=32, bias_bits=16)
    init = (stream.init_src, stream.init_dst, stream.init_w)
    teng = DynamicWalkEngine(tdg.from_edges(tcfg, *init, device="cpu"), tcfg,
                             WalkParams(kind, 6), whole_walk=whole_walk,
                             seed=1)
    jeng = JEngine(_jax_state(teng.state), jcfg, JWalkParams(kind, 6),
                   backend="reference", whole_walk=whole_walk)
    starts = torch.arange(0, V, 8, dtype=torch.int32)
    for r, tstats, paths in teng.run_stream(stream, starts):
        batch = (stream.is_insert[r], stream.u[r], stream.v[r], stream.w[r])
        jstats = jeng.ingest(*map(jnp.asarray, batch))
        assert_state_matches(jeng.state, teng.state, fp=False)
        np.testing.assert_array_equal(np.asarray(jstats.rejected),
                                      tstats.rejected.numpy())
        st = teng.state
        a, b = paths[:, :-1].long(), paths[:, 1:].long()
        hop = (a >= 0) & (b >= 0)
        assert hop.any()
        assert ((st.nbr[a[hop]] == b[hop][:, None])
                & (torch.arange(32)[None, :] < st.deg[a[hop]][:, None])
                ).any(1).all()
        assert torch.equal(teng.walk(starts, seed=teng.last_seed), paths)
    assert teng.rounds_ingested == ROUNDS
