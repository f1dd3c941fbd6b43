"""Update paths of the port against JAX's: batched §5.2 rounds
(``batched_update``) and streaming single-edge updates (``insert_edge``,
``delete_edge``, ``stream_updates``).

Batched rounds: the sweep of ``tests/test_update_fused.py``: insert/delete/mixed rounds
across the five (adaptive, fp, base) rows, chained over 3 rounds, plus its
all-group-types, delete-heavy and ``active`` mask cases, and a batch wider
than 2·C on one row.  The port runs through ``ops.update_fused`` on CPU
tensors, i.e. its plain ``batched_update``.  Integer mode: the full state
and ``UpdateStats`` (``rejected`` included) are bit-equal.  fp mode: the
tolerances of ``tests/test_torch_state.py``.

Streaming: the sequences of ``tests/test_updates.py`` (the paper's
Fig. 5/6 vertex, random insert/delete sequences) over adaptive and
baseline mode, fp mode and base 4, plus out-of-range endpoints, absent
deletes, full rows and a DENSE -> materialized transition.  After every
update the state and the ``ok`` flag equal JAX's (integer mode bit for
bit; fp mode at the same tolerances).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.core import alias as jalias
from repro.core import dyngraph as jdg
from repro.core import updates as jup
from repro.core.sampler import transition_probs as j_transition_probs
from repro.core.updates import batched_update as j_batched_update
from repro.core.updates import two_phase_delete as j_two_phase_delete
from repro_torch.core import dyngraph as tdg
from repro_torch.core import updates as tup
from repro_torch.core.sampler import transition_probs
from repro_torch.core.updates import two_phase_delete as t_two_phase_delete
from repro_torch.kernels import ops
from tests.conftest import random_graph
from tests.test_torch_state import assert_state_matches, configs

# jit only to keep the suite quick: the compiled and eager reference agree
# (the fp-mode tolerances cover the one float sum XLA may reorder).
_j_update = jax.jit(j_batched_update, static_argnums=1)

ROWS = [(True, False, 1), (False, False, 1), (True, True, 1),
        (True, False, 2), (True, True, 2)]


def make_round(rng, V, edges, Bn, mode, fp=False):
    """One update batch as numpy arrays (deletes mostly hit live edges)."""
    ins = {"insert": np.ones(Bn, bool), "delete": np.zeros(Bn, bool),
           "mixed": rng.random(Bn) < 0.5}[mode]
    uu = rng.integers(0, V, Bn).astype(np.int32)
    vv = rng.integers(0, V, Bn).astype(np.int32)
    ww = rng.integers(1, 32, Bn).astype(np.int32)
    for i in range(Bn):
        if not ins[i] and rng.random() < 0.8 and edges:
            uu[i], vv[i] = edges[int(rng.integers(len(edges)))]
    if fp:
        ww = ww.astype(np.float32) + rng.random(Bn).astype(np.float32)
    return ins, uu, vv, ww


def apply_both(js, ts, jcfg, tcfg, batch, active=None, fp=False):
    """One round in both packages; asserts equal states and stats."""
    jact = None if active is None else jnp.asarray(active)
    tact = None if active is None else torch.from_numpy(active)
    js, jstats = _j_update(js, jcfg, *map(jnp.asarray, batch), jact)
    ts, tstats = ops.update_fused(ts, tcfg, *map(torch.from_numpy, batch),
                                  tact)
    assert_state_matches(js, ts, fp)
    for name, a, b in zip(jstats._fields, jstats, tstats):
        if a is None:
            continue
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=name)
    return js, ts, tstats


@pytest.mark.parametrize("mode", ["insert", "delete", "mixed"])
@pytest.mark.parametrize("adaptive,fp,base_log2", ROWS)
def test_batched_update_matches_jax(mode, adaptive, fp, base_log2):
    V, C = 12, 16
    rng = np.random.default_rng(base_log2 * 7 + fp * 3 + adaptive)
    jcfg, tcfg = configs(num_vertices=V, capacity=C, bias_bits=6,
                         adaptive=adaptive, fp_bias=fp, base_log2=base_log2)
    src, dst, w = random_graph(V, C, max_bias=31, seed=4, density=0.4)
    wv = w.astype(np.float32) + rng.random(len(w)).astype(np.float32) \
        if fp else w
    js = jdg.from_edges(jcfg, src, dst, wv)
    ts = tdg.from_edges(tcfg, src, dst, wv, device="cpu")
    edges = list(zip(src.tolist(), dst.tolist()))
    for _ in range(3):
        batch = make_round(rng, V, edges, 20, mode, fp)
        js, ts, _ = apply_both(js, ts, jcfg, tcfg, batch, fp=fp)


def test_all_group_types_transition():
    d = 24
    w = np.ones(d, np.int64)
    w[16] += 2
    w[17:19] += 4
    w[19:24] += 8 - 1
    src = np.zeros(d, np.int32)
    dst = np.arange(1, d + 1, dtype=np.int32)
    jcfg, tcfg = configs(num_vertices=d + 1, capacity=32, bias_bits=4)
    js = jdg.from_edges(jcfg, src, dst, w.astype(np.int32))
    ts = tdg.from_edges(tcfg, src, dst, w.astype(np.int32), device="cpu")
    batch = (np.array([True, True, False, False, False]),
             np.zeros(5, np.int32), np.array([7, 9, 17, 18, 16], np.int32),
             np.array([2, 8, 0, 0, 0], np.int32))
    _, _, stats = apply_both(js, ts, jcfg, tcfg, batch)
    assert int(stats.transitions.sum()) > 0


def test_delete_heavy_single_vertex():
    """Six deletes on one 4-slot row, one of them a duplicate miss."""
    jcfg, tcfg = configs(num_vertices=4, capacity=4, bias_bits=3)
    args = (np.array([0, 0, 0, 0]), np.array([1, 1, 2, 2]),
            np.array([1, 1, 1, 1]))
    js, ts = jdg.from_edges(jcfg, *args), tdg.from_edges(tcfg, *args, "cpu")
    batch = (np.zeros(6, bool), np.zeros(6, np.int32),
             np.array([1, 1, 1, 2, 2, 2], np.int32), np.zeros(6, np.int32))
    _, ts, stats = apply_both(js, ts, jcfg, tcfg, batch)
    assert int(stats.del_applied) == 4 and int(ts.deg[0]) == 0


def test_batch_wider_than_twice_capacity():
    """B = 48 > 2·C = 8, nearly all lanes on one row: inserts past
    capacity, duplicate deletes, misses and out-of-range lanes — every
    lane counts, with no per-row lane bound."""
    V, C = 6, 4
    jcfg, tcfg = configs(num_vertices=V, capacity=C, bias_bits=5)
    args = (np.array([0, 0, 0, 1]), np.array([1, 2, 2, 3]),
            np.array([3, 5, 7, 9]))
    js, ts = jdg.from_edges(jcfg, *args), tdg.from_edges(tcfg, *args, "cpu")
    rng = np.random.default_rng(11)
    Bn = 48
    ins = rng.random(Bn) < 0.4
    uu = np.where(rng.random(Bn) < 0.85, 0, rng.integers(-1, V + 1, Bn))
    vv = rng.integers(0, 4, Bn)
    ww = rng.integers(1, 32, Bn)
    batch = (ins, uu.astype(np.int32), vv.astype(np.int32),
             ww.astype(np.int32))
    _, _, stats = apply_both(js, ts, jcfg, tcfg, batch)
    assert int(stats.rejected.sum()) > 0
    assert int(stats.ins_applied) + int(stats.del_applied) > 0


def test_active_mask():
    V, C = 10, 8
    jcfg, tcfg = configs(num_vertices=V, capacity=C, bias_bits=4)
    src, dst, w = random_graph(V, C, max_bias=15, seed=2, density=0.4)
    js = jdg.from_edges(jcfg, src, dst, w)
    ts = tdg.from_edges(tcfg, src, dst, w, device="cpu")
    rng = np.random.default_rng(0)
    Bn = 12
    batch = (rng.random(Bn) < 0.5, rng.integers(0, V, Bn).astype(np.int32),
             rng.integers(0, V, Bn).astype(np.int32),
             rng.integers(1, 16, Bn).astype(np.int32))
    apply_both(js, ts, jcfg, tcfg, batch, active=rng.random(Bn) < 0.5)


def test_two_phase_delete_matches_jax():
    rng = np.random.default_rng(5)
    R, C = 9, 16
    vals = rng.integers(0, 100, (R, C)).astype(np.int32)
    dm = rng.random((R, C)) < 0.3
    d = rng.integers(0, C + 1, R).astype(np.int32)
    (tv,), tlen, tremap = t_two_phase_delete(
        ((torch.from_numpy(vals), -1),), torch.from_numpy(dm),
        torch.from_numpy(d))
    for r in range(R):
        (jv,), jlen, jremap = j_two_phase_delete(
            ((jnp.asarray(vals[r]), -1),), jnp.asarray(dm[r]), int(d[r]))
        np.testing.assert_array_equal(np.asarray(jv), tv[r].numpy())
        assert int(jlen) == int(tlen[r])
        np.testing.assert_array_equal(np.asarray(jremap), tremap[r].numpy())


# ---------------------------------------------------------------------------
# streaming updates (§4.2)
# ---------------------------------------------------------------------------

_j_insert = jax.jit(jup.insert_edge, static_argnums=1)
_j_delete = jax.jit(jup.delete_edge, static_argnums=1)
STREAM_ROWS = [(True, False, 1), (False, False, 1), (True, True, 1),
               (True, False, 2), (False, True, 2)]


def _stream_both(js, ts, jcfg, tcfg, op, fp):
    """One streaming update in both packages; asserts equal states and
    ``ok`` flags and returns the new states and the flag."""
    if op[0]:
        js, jok = _j_insert(js, jcfg, *op[1:])
        ts, tok = tup.insert_edge(ts, tcfg, *op[1:])
    else:
        js, jok = _j_delete(js, jcfg, *op[1:3])
        ts, tok = tup.delete_edge(ts, tcfg, *op[1:3])
    assert tok.dtype == torch.bool and tok.shape == ()
    assert bool(jok) == bool(tok), op
    assert_state_matches(js, ts, fp)
    return js, ts, bool(tok)


def _jax_state(ts):
    """The port's state as a JAX state (the same tables, both packages
    start from them; ``from_edges`` itself is pinned in
    ``tests/test_torch_state.py``).  Copies: a CPU tensor's numpy view
    shares its memory, and the port updates its tensors in place."""
    a = tdg.state_to_numpy(ts)

    def cp(x):
        return None if x is None else jnp.asarray(np.array(x, copy=True))
    return jdg.BingoState(*[cp(x) for x in a[:-1]],
                          itable=jalias.AliasTable(cp(a.itable.prob),
                                                   cp(a.itable.alias)))


def _stream_case(adaptive, fp, base_log2, V=8, C=12, seed=0):
    jcfg, tcfg = configs(num_vertices=V, capacity=C, bias_bits=5,
                         adaptive=adaptive, fp_bias=fp, base_log2=base_log2,
                         lam=4.0)
    src, dst, w = random_graph(V, C, max_bias=31, seed=seed, density=0.4)
    if fp:
        w = w.astype(np.float32) + np.random.default_rng(seed).random(
            len(w)).astype(np.float32) * 0.75
    ts = tdg.from_edges(tcfg, src, dst, w, device="cpu")
    return _jax_state(ts), ts, jcfg, tcfg


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("adaptive,fp,base_log2", STREAM_ROWS)
def test_streaming_random_sequence_matches_jax(adaptive, fp, base_log2,
                                               seed):
    """``tests/test_updates.py``'s random sequences (deletes of live edges,
    inserts of random edges), with absent deletes, out-of-range endpoints
    and inserts into full rows mixed in."""
    V = 8
    js, ts, jcfg, tcfg = _stream_case(adaptive, fp, base_log2, V=V, seed=seed)
    rng = np.random.default_rng(100 + seed)
    for _ in range(40):
        deg = np.asarray(js.deg)
        nbr = np.asarray(js.nbr)
        live = [(u, int(v)) for u in range(V) for v in nbr[u, :deg[u]]]
        r = rng.random()
        if r < 0.45 and live:
            op = (False, *live[rng.integers(len(live))])
        elif r < 0.55:
            op = (False, int(rng.integers(-2, V + 2)), int(rng.integers(V)))
        else:
            u = int(rng.integers(-1, V + 1)) if r < 0.6 else int(
                rng.integers(V))
            w = rng.integers(1, 32)
            w = np.float32(w + 0.5 * rng.random()) if fp else int(w)
            op = (True, u, int(rng.integers(-1, V)), w)
        js, ts, _ = _stream_both(js, ts, jcfg, tcfg, op, fp)


@pytest.mark.parametrize("adaptive", [True, False])
def test_paper_fig5_fig6_and_quickstart(adaptive):
    """The paper's Fig. 1/4 vertex 2: insert (2, 3, 3), delete (2, 1),
    the absent delete again; then the transition row of vertex 2 is
    {4: 0.4, 5: 0.3, 3: 0.3} (``examples/quickstart.py``)."""
    jcfg, tcfg = configs(num_vertices=8, capacity=8, bias_bits=5,
                         adaptive=adaptive)
    src = np.array([2, 2, 2, 1, 4, 5, 3, 0])
    dst = np.array([1, 4, 5, 2, 2, 2, 2, 2])
    w = np.array([5, 4, 3, 2, 2, 2, 2, 1])
    ts = tdg.from_edges(tcfg, src, dst, w, device="cpu")
    js = _jax_state(ts)
    oks = []
    for op in [(True, 2, 3, 3), (False, 2, 1), (False, 2, 1)]:
        js, ts, ok = _stream_both(js, ts, jcfg, tcfg, op, False)
        oks.append(ok)
    assert oks == [True, True, False]
    p = transition_probs(ts, tcfg, torch.tensor([2]))[0].numpy()
    np.testing.assert_array_equal(
        p, np.asarray(j_transition_probs(js, jcfg, jnp.array([2])))[0])
    row = {int(ts.nbr[2, s]): float(p[s]) for s in range(int(ts.deg[2]))}
    assert row == pytest.approx({4: 0.4, 5: 0.3, 3: 0.3}, abs=1e-6)


def test_dense_to_materialized_rebuild_and_full_row():
    """A DENSE group (bit 0 on most of the hub's edges) becomes
    materialized as its members are deleted — the rebuild branch — and
    an insert into the full row is refused with the state untouched."""
    V, C = 6, 8
    jcfg, tcfg = configs(num_vertices=V, capacity=C, bias_bits=3)
    src = np.zeros(C, np.int32)
    dst = np.arange(C, dtype=np.int32) % V
    w = np.array([1, 1, 1, 1, 2, 2, 2, 2], np.int32)
    ts = tdg.from_edges(tcfg, src, dst, w, device="cpu")
    js = _jax_state(ts)
    assert int(ts.gtype[0, 0]) == jdg.DENSE
    js, ts, ok = _stream_both(js, ts, jcfg, tcfg, (True, 0, 1, 5), False)
    assert not ok                                           # full row
    types = []
    for v in (2, 3):                 # bit 0 on 3 of 7, then 2 of 6 edges
        js, ts, ok = _stream_both(js, ts, jcfg, tcfg, (False, 0, v), False)
        assert ok
        types.append(int(ts.gtype[0, 0]))
    assert types == [jdg.DENSE, jdg.REGULAR]
    for op in [(True, 0, 2, 6), (True, V, 1, 3), (True, 0, -1, 3),
               (False, -1, 0), (False, 0, 5)]:
        js, ts, _ = _stream_both(js, ts, jcfg, tcfg, op, False)


@pytest.mark.parametrize("adaptive,fp,base_log2", [(True, False, 1),
                                                   (False, True, 2)])
def test_stream_updates_matches_jax_scan(adaptive, fp, base_log2):
    """``stream_updates`` (the reference's ``lax.scan``) over one mixed
    sequence: final state and every ``ok`` flag."""
    js, ts, jcfg, tcfg = _stream_case(adaptive, fp, base_log2, seed=5)
    rng = np.random.default_rng(7)
    n = 24
    ins = rng.random(n) < 0.5
    nbr, deg = np.asarray(js.nbr), np.asarray(js.deg)
    uu = rng.integers(-1, 9, n).astype(np.int32)
    vv = rng.integers(0, 8, n).astype(np.int32)
    for i in np.flatnonzero(~ins)[::2]:                  # live deletes
        uu[i] = rng.integers(8)
        if deg[uu[i]]:
            vv[i] = nbr[uu[i], rng.integers(deg[uu[i]])]
    ww = rng.integers(1, 32, n).astype(np.int32)
    if fp:
        ww = ww.astype(np.float32) + rng.random(n).astype(np.float32) * 0.5
    js, jok = jup.stream_updates(js, jcfg, *map(jnp.asarray, (ins, uu, vv, ww)))
    ts, tok = tup.stream_updates(ts, tcfg, *map(torch.from_numpy,
                                                (ins, uu, vv, ww)))
    np.testing.assert_array_equal(np.asarray(jok), tok.numpy())
    assert tok.any() and not tok.all()
    assert_state_matches(js, ts, fp)
