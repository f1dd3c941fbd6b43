"""The paper's comparison samplers (``core/baselines.py``) against JAX's.

Numpy inputs from a seed go through both packages; biases are integers,
so every float sum is exact:

* ``adj_from_edges`` / ``adj_insert`` / ``adj_delete`` bit-equal after
  every update of a seeded sequence (full rows, absent edges, the last
  entry, repeated edges);
* each baseline's table after ``build`` and after every update: alias
  tables within 1e-6 (and their exact probabilities), the ITS prefix
  sums and ``wmax`` bit-equal, on the ITS rows' valid entries (past the
  degree the port keeps the row's total, see the module); the ``*_ops``
  counters equal;
* each sampler's draws pass a chi-square test against the row's
  normalised biases, before and after updates (``tests/test_baselines.py``'s
  cases, plus an insert the row keeps), on the CPU with a seeded
  ``torch.Generator``.
"""

import numpy as np
import pytest
from scipy import stats

import jax.numpy as jnp
import torch

from repro.core import baselines as jb
from repro_torch.core import baselines as tb
from repro_torch.core.alias import alias_probs
from tests.conftest import random_graph

CLASSES = ["AliasBaseline", "ITSBaseline", "RejectionBaseline",
           "ReservoirBaseline"]
DRAWS = 30000


def _edges(seed=6, V=10, C=12):
    src, dst, w = random_graph(V, C, max_bias=31, seed=seed)
    return V, C, src, dst, w.astype(np.float32)


def _updates(V, C, src, dst, seed):
    """A seeded sequence of (op, u, v, w): inserts (some on full rows),
    deletes of present edges (the earliest match, the row's last entry),
    absent deletes and repeated inserts."""
    rng = np.random.default_rng(seed)
    ops = []
    for i in range(40):
        u = int(rng.integers(0, V))
        kind = i % 4
        if kind == 0:
            ops.append(("insert", u, int(rng.integers(0, V)),
                        float(rng.integers(1, 32))))
        elif kind == 1:
            k = int(rng.integers(0, len(src)))
            ops.append(("delete", int(src[k]), int(dst[k]), 0.0))
        elif kind == 2:
            ops.append(("delete", u, int(rng.integers(0, V)), 0.0))
        else:
            ops.append(("insert", 0, 3, 7.0))       # fills row 0 up
    return ops


def _np(adj):
    return [np.asarray(x) for x in adj]


def _apply(obj, op, u, v, w, jax_side):
    if op == "insert":
        args = (jnp.int32(u), jnp.int32(v), jnp.float32(w)) if jax_side \
            else (u, v, w)
        return obj.insert(*args)
    args = (jnp.int32(u), jnp.int32(v)) if jax_side else (u, v)
    return obj.delete(*args)


def test_adjacency_matches_jax():
    V, C, src, dst, w = _edges()
    ja = jb.adj_from_edges(V, C, src, dst, w)
    ta = tb.adj_from_edges(V, C, src, dst, w, device="cpu")
    for a, b in zip(_np(ta), _np(ja)):
        np.testing.assert_array_equal(a, b)
    assert ta.nbr.dtype == torch.int32 and ta.w.dtype == torch.float32
    # a row cut at C: more edges than slots
    over = tb.adj_from_edges(4, 2, [1, 1, 1, 3], [0, 2, 3, 1], [1, 2, 3, 4],
                             device="cpu")
    jover = jb.adj_from_edges(4, 2, np.array([1, 1, 1, 3]),
                              np.array([0, 2, 3, 1]),
                              np.array([1., 2., 3., 4.]))
    for a, b in zip(_np(over), _np(jover)):
        np.testing.assert_array_equal(a, b)
    for op, u, v, ww in _updates(V, C, src, dst, seed=1):
        if op == "insert":
            ja = jb.adj_insert(ja, jnp.int32(u), jnp.int32(v),
                               jnp.float32(ww))
            ta = tb.adj_insert(ta, u, v, ww)
        else:
            ja = jb.adj_delete(ja, jnp.int32(u), jnp.int32(v))
            ta = tb.adj_delete(ta, u, v)
        for a, b in zip(_np(ta), _np(ja)):
            np.testing.assert_array_equal(a, b, err_msg=f"{op} {u} {v}")
    assert int(ta.deg[0]) == C                       # the full row


def _tables_equal(t, j, name):
    """The baseline's structure against JAX's."""
    deg = t.adj.deg.numpy()
    valid = np.arange(t.adj.nbr.shape[1])[None, :] < deg[:, None]
    if name == "AliasBaseline":
        np.testing.assert_allclose(t.table.prob.numpy(),
                                   np.asarray(j.table.prob), atol=1e-6)
        np.testing.assert_array_equal(t.table.alias.numpy(),
                                      np.asarray(j.table.alias))
        want = t.adj.w.numpy() * valid
        tot = want.sum(-1, keepdims=True)
        np.testing.assert_allclose(alias_probs(t.table).numpy(),
                                   np.where(tot > 0, want / np.maximum(
                                       tot, 1e-30), 1.0 / want.shape[1]),
                                   atol=1e-6)
    elif name == "ITSBaseline":
        cdf = t.cdf.numpy()
        np.testing.assert_array_equal(cdf[valid], np.asarray(j.cdf)[valid])
        np.testing.assert_array_equal(
            cdf, np.cumsum(t.adj.w.numpy() * valid, -1, dtype=np.float32))
    elif name == "RejectionBaseline":
        np.testing.assert_array_equal(t.wmax.numpy(), np.asarray(j.wmax))


@pytest.mark.parametrize("name", CLASSES)
def test_tables_match_jax_through_updates(name):
    """After ``build`` and after every update of the seeded sequence."""
    V, C, src, dst, w = _edges()
    t = getattr(tb, name).build(tb.adj_from_edges(V, C, src, dst, w,
                                                  device="cpu"))
    j = getattr(jb, name).build(jb.adj_from_edges(V, C, src, dst, w))
    _tables_equal(t, j, name)
    for op, u, v, ww in _updates(V, C, src, dst, seed=2):
        t2 = _apply(t, op, u, v, ww, False)
        j = _apply(j, op, u, v, ww, True)
        for a, b in zip(_np(t2.adj), _np(j.adj)):
            np.testing.assert_array_equal(a, b)
        _tables_equal(t2, j, name)
        t = t2


def test_updates_leave_the_old_baseline_as_it_was():
    """Functional updates: a baseline (and its shared adjacency) keeps
    its tables after an update of the one it was derived into."""
    V, C, src, dst, w = _edges()
    adj = tb.adj_from_edges(V, C, src, dst, w, device="cpu")
    before = [x.clone() for x in adj]
    its = tb.ITSBaseline.build(adj)
    cdf = its.cdf.clone()
    its.insert(1, 2, 5.0).delete(int(src[0]), int(dst[0]))
    tb.AliasBaseline.build(adj).insert(3, 4, 2.0)
    for a, b in zip(adj, before):
        assert torch.equal(a, b)
    assert torch.equal(its.cdf, cdf)


@pytest.mark.parametrize("name", CLASSES)
def test_ops_counters_match_jax(name):
    d = np.array([0, 1, 2, 3, 7, 8, 100, 256], np.int32)
    t, j = getattr(tb, name), getattr(jb, name)
    for fn in ("sample_ops", "update_ops"):
        np.testing.assert_array_equal(
            getattr(t, fn)(torch.from_numpy(d)).numpy(),
            np.asarray(getattr(j, fn)(jnp.asarray(d))))
    if name == "RejectionBaseline":
        wmax = np.array([0, 1, 2, 3, 4, 5, 6, 7], np.float32)
        wsum = np.array([0, 1, 4, 9, 10, 50, 60, 700], np.float32)
        np.testing.assert_array_equal(
            t.sample_ops(torch.from_numpy(d), torch.from_numpy(wmax),
                         torch.from_numpy(wsum)).numpy(),
            np.asarray(j.sample_ops(jnp.asarray(d), jnp.asarray(wmax),
                                    jnp.asarray(wsum))))


def _chi_square_ok(nxt, want, V):
    """Pearson's statistic of the draws against ``want`` below the
    0.9999 quantile of its chi-square law; no draw off the row."""
    counts = np.bincount(nxt, minlength=V)
    exp = want * counts.sum()
    mask = exp > 0
    assert counts[~mask].sum() == 0, "a draw of probability 0"
    stat = float(((counts[mask] - exp[mask]) ** 2 / exp[mask]).sum())
    return stat < stats.chi2.ppf(0.9999, max(1, int(mask.sum()) - 1))


def _row_dist(adj, u, V):
    want = np.zeros(V)
    for v, ww in zip(adj.nbr[u, :adj.deg[u]].numpy(),
                     adj.w[u, :adj.deg[u]].numpy()):
        want[v] += ww
    return want / want.sum()


def _draw(base, u, seed):
    gen = torch.Generator().manual_seed(seed)
    return base.sample(torch.full((DRAWS,), u, dtype=torch.int32),
                       gen).numpy()


@pytest.mark.parametrize("name", CLASSES)
def test_distribution(name):
    """``tests/test_baselines.py:17``: row 2 -> {1: 5, 4: 4, 5: 3}."""
    adj = tb.adj_from_edges(8, 8, [2, 2, 2], [1, 4, 5], [5.0, 4.0, 3.0],
                            device="cpu")
    base = getattr(tb, name).build(adj)
    want = np.zeros(8)
    want[[1, 4, 5]] = np.array([5, 4, 3]) / 12
    assert _chi_square_ok(_draw(base, 2, 0), want, 8)


@pytest.mark.parametrize("name", CLASSES)
def test_update_then_distribution(name):
    """``tests/test_baselines.py:34``: insert (2, 3, 3) then delete (2, 1);
    and an insert the row keeps, with no delete after it."""
    adj = tb.adj_from_edges(8, 8, [2, 2, 2], [1, 4, 5], [5.0, 4.0, 3.0],
                            device="cpu")
    base = getattr(tb, name).build(adj).insert(2, 3, 3.0).delete(2, 1)
    want = np.zeros(8)
    want[[4, 5, 3]] = np.array([4, 3, 3]) / 10
    assert _chi_square_ok(_draw(base, 2, 1), want, 8)
    base = base.insert(2, 6, 10.0)
    want = np.zeros(8)
    want[[4, 5, 3, 6]] = np.array([4, 3, 3, 10]) / 20
    assert _chi_square_ok(_draw(base, 2, 2), want, 8)


@pytest.mark.parametrize("name", CLASSES)
def test_random_graph_distribution(name):
    """``tests/test_baselines.py:51``: rows 0 and 5 of a random graph,
    then again after the seeded update sequence."""
    V, C, src, dst, w = _edges()
    adj = tb.adj_from_edges(V, C, src, dst, w, device="cpu")
    base = getattr(tb, name).build(adj)
    for rnd in range(2):
        for u in (0, 5):
            assert _chi_square_ok(_draw(base, u, 10 * rnd + u),
                                  _row_dist(base.adj, u, V), V), (rnd, u)
        for op, u, v, ww in _updates(V, C, src, dst, seed=3):
            base = _apply(base, op, u, v, ww, False)
