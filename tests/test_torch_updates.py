"""Batched §5.2 update rounds of the port against JAX's ``batched_update``.

The sweep of ``tests/test_update_fused.py``: insert/delete/mixed rounds
across the five (adaptive, fp, base) rows, chained over 3 rounds, plus its
all-group-types, delete-heavy and ``active`` mask cases, and a batch wider
than 2·C on one row.  The port runs through ``ops.update_fused`` on CPU
tensors, i.e. its plain ``batched_update``.  Integer mode: the full state
and ``UpdateStats`` (``rejected`` included) are bit-equal.  fp mode: the
tolerances of ``tests/test_torch_state.py``.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.core import dyngraph as jdg
from repro.core.updates import batched_update as j_batched_update
from repro.core.updates import two_phase_delete as j_two_phase_delete
from repro_torch.core import dyngraph as tdg
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
