"""node2vec in the port against JAX: the second-order step in distribution,
the neighbour test bit for bit.

The second-order step ``_n2v_accept`` draws proposals through a backend
(the per-step kernel's plain version for ``"fused"``, ``sample_neighbor``
for ``"reference"``) and accepts with the Eq. 1 history factor, with the
exact second-order ITS as fallback.  Its next-vertex distribution from a
fixed (prev, cur) must match the exact one within TV 0.02 at 30,000
walkers, the bound of ``tests/test_walks.py``'s node2vec test (E[TV] is
below 0.01 there): on the triangle + pendant graph against the
hand-computed distribution, and on a random graph against the exact
second-order probabilities w(cur, v)·f(prev, v) computed from JAX's
``transition_probs`` and ``_n2v_factor`` on the same tables.  The
fallback alone (no proposal trials) is held to the same.  The draws
differ from JAX's; the distribution may not.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.core import dyngraph as jdg
from repro.core import walks as jwalks
from repro.core.sampler import transition_probs as j_transition_probs
from repro_torch.core import dyngraph as tdg
from repro_torch.core import walks as twalks
from repro_torch.core.walks import WalkParams, generator, node2vec
from tests.conftest import empirical_dist, random_graph, tv_distance
from tests.test_torch_updates import _jax_state

B = 30000
BACKENDS = ["fused", "reference"]
P, Q = 0.5, 2.0


def _triangle_pendant():
    """Undirected 0-1, 1-2, 0-2, 1-3 (``tests/test_walks.py``)."""
    src = np.array([0, 1, 1, 2, 0, 2, 1, 3], np.int32)
    dst = np.array([1, 0, 2, 1, 2, 0, 3, 1], np.int32)
    cfg = tdg.BingoConfig(num_vertices=4, capacity=4, bias_bits=2)
    return tdg.from_edges(cfg, src, dst, np.ones(8, np.int32), device="cpu"), cfg


def _step(ts, cfg, prev, cur, backend, seed=0):
    n = B
    return twalks._n2v_accept(
        ts, cfg, torch.full((n,), prev), torch.full((n,), cur),
        torch.ones(n, dtype=torch.bool), generator(seed, "cpu"),
        WalkParams("node2vec", p=P, q=Q),
        twalks.get_backend(backend)).numpy()


@pytest.mark.parametrize("trials", [16, 0])
@pytest.mark.parametrize("backend", BACKENDS)
def test_triangle_pendant_exact(backend, trials, monkeypatch):
    """From cur=1 with prev=0: neighbours {0 (1/p), 2 (in N(0): 1),
    3 (1/q)}.  ``trials=0`` sends every walker to the exact fallback."""
    monkeypatch.setattr(twalks, "_N2V_TRIALS", trials)
    ts, cfg = _triangle_pendant()
    nxt = _step(ts, cfg, 0, 1, backend)
    f = np.array([1 / P, 0, 1.0, 1 / Q])
    assert tv_distance(empirical_dist(nxt, 4), f / f.sum()) < 0.02


def _second_order(js, jcfg, prev, cur, V):
    """Exact P(v | prev, cur) ∝ w(cur, v)·f(prev, v) from JAX's functions."""
    w = np.asarray(j_transition_probs(js, jcfg, jnp.array([cur])))[0]
    nbrs = np.asarray(js.nbr[cur])
    d = int(js.deg[cur])
    f = np.asarray(jwalks._n2v_factor(
        js, jcfg, jnp.full((d,), prev, jnp.int32),
        jnp.asarray(nbrs[:d]), P, Q))
    want = np.zeros(V)
    for j in range(d):
        want[nbrs[j]] += w[j] * f[j]
    return want / want.sum()


@pytest.mark.parametrize("trials", [16, 0])
@pytest.mark.parametrize("backend", BACKENDS)
def test_random_graph_second_order(backend, trials, monkeypatch):
    monkeypatch.setattr(twalks, "_N2V_TRIALS", trials)
    V, C = 10, 12
    src, dst, w = random_graph(V, C, max_bias=31, seed=8, density=0.7)
    cfg = tdg.BingoConfig(num_vertices=V, capacity=C, bias_bits=5)
    jcfg = jdg.BingoConfig(num_vertices=V, capacity=C, bias_bits=5)
    ts = tdg.from_edges(cfg, src, dst, w, device="cpu")
    cur = 3
    prev = int(ts.nbr[cur, 0])              # an edge cur -> prev exists
    nxt = _step(ts, cfg, prev, cur, backend, seed=trials)
    want = _second_order(_jax_state(ts), jcfg, prev, cur, V)
    assert tv_distance(empirical_dist(nxt, V), want) < 0.02


def test_is_neighbor_bit_equal():
    V, C = 16, 12
    src, dst, w = random_graph(V, C, max_bias=31, seed=2, density=0.5)
    cfg = tdg.BingoConfig(num_vertices=V, capacity=C, bias_bits=5)
    jcfg = jdg.BingoConfig(num_vertices=V, capacity=C, bias_bits=5)
    ts = tdg.from_edges(cfg, src, dst, w, device="cpu")
    js = _jax_state(ts)
    rng = np.random.default_rng(0)
    s = rng.integers(0, V, 4000).astype(np.int32)
    c = rng.integers(-1, V, 4000).astype(np.int32)
    want = np.asarray(jwalks._is_neighbor(js, jcfg, jnp.asarray(s),
                                          jnp.asarray(c)))
    got = twalks._is_neighbor(ts, cfg, torch.from_numpy(s),
                              torch.from_numpy(c))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and not want.all()


@pytest.mark.parametrize("backend", BACKENDS)
def test_node2vec_walks(backend):
    """Whole node2vec walks: column 0 is the starts, every hop an edge,
    walkers from degree-0 vertices stop at once, ``seed`` replays, and
    ``whole_walk=True`` still takes the per-step path."""
    V, C = 12, 8
    src, dst, w = random_graph(V, C, max_bias=31, seed=4, density=0.5)
    keep = src != 5                          # vertex 5 is a dead end
    cfg = tdg.BingoConfig(num_vertices=V, capacity=C, bias_bits=5)
    ts = tdg.from_edges(cfg, src[keep], dst[keep], w[keep], device="cpu")
    starts = torch.arange(60, dtype=torch.int32) % V
    a = node2vec(ts, cfg, starts, 9, length=10, backend=backend)
    b = twalks.random_walk(ts, cfg, starts, 9, WalkParams("node2vec", 10),
                           backend=backend, whole_walk=True)
    assert torch.equal(a, b) and a.shape == (60, 11)
    assert torch.equal(a[:, 0], starts)
    assert (a[starts == 5, 1:] == -1).all()
    adj = set(zip(src[keep].tolist(), dst[keep].tolist()))
    for row in a.tolist():
        for x, y in zip(row[:-1], row[1:]):
            if y < 0:
                break
            assert (x, y) in adj
