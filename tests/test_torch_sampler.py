"""Both port backends' per-step samplers against JAX's ground truth.

The states are built from numpy edges by the port's ``from_edges`` (pinned
leaf by leaf to JAX's in ``tests/test_torch_state.py``) and copied to JAX,
whose ``transition_probs`` on the same tables is the ground truth.
``sample_step`` of the ``"fused"`` backend (the
per-step kernel's plain version here) and of the ``"reference"`` backend
(the plain torch ``sample_neighbor``) draw 25,000 samples from one vertex;
the empirical next-vertex distribution must lie within TV 0.02 of JAX's
``transition_probs`` (Eq. 2), the bound ``tests/test_backend_equiv.py``
uses at this sample size (E[TV] is about 0.01 for its graphs).  The graphs
are that file's: the hub whose bias row spans DENSE/ONE/SPARSE/REGULAR, a
random graph with adaptive mode on and off, fp mode at bases 2 and 4,
radix bases 2 and 4.  The draws differ from JAX's (a ``torch.Generator``
against ``jax.random``); the distribution may not.  ``sample_alias`` and
the ITS helper are held bit-equal.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.core import alias as jalias
from repro.core import dyngraph as jdg
from repro.core import sampler as jsampler
from repro_torch.core import alias as talias
from repro_torch.core import dyngraph as tdg
from repro_torch.core import sampler as tsampler
from repro_torch.core.backend import (available_backends, get_backend,
                                      FusedBackend)
from repro_torch.core.walks import WalkParams, generator
from tests.conftest import empirical_dist, random_graph, tv_distance
from tests.test_backend_equiv import _hub_graph
from tests.test_torch_updates import _jax_state

B = 25000
BACKENDS = ["fused", "reference"]


GRAPHS = {
    "hub": lambda: _hub_graph()[:3],
    "random12": lambda: random_graph(12, 16, max_bias=63, seed=5),
    "random10": lambda: random_graph(10, 8, max_bias=63, seed=3),
}


@functools.lru_cache(maxsize=None)
def _state(graph, fp, kw):
    """The port's state of a named graph (built once; no test writes it)."""
    src, dst, w = GRAPHS[graph]()
    if fp:
        w = w.astype(np.float32) + 0.37
    return tdg.from_edges(tdg.BingoConfig(**dict(kw)), src, dst, w,
                          device="cpu")


def _states(graph, fp=False, **kw):
    """``(JAX state, JAX config, port state, port config)``: the same tables."""
    ts = _state(graph, fp, tuple(sorted(kw.items())))
    return _jax_state(ts), jdg.BingoConfig(**kw), ts, tdg.BingoConfig(**kw)


def _want(js, jcfg, u, V):
    """JAX's Eq. 2 next-vertex distribution out of ``u``."""
    probs = np.asarray(jsampler.transition_probs(
        js, jcfg, jnp.full((1,), u, jnp.int32)))[0]
    nbrs = np.asarray(js.nbr[u])
    want = np.zeros(V)
    for slot, p in enumerate(probs):
        if p > 0:
            want[nbrs[slot]] += p
    return want


def _check(js, jcfg, ts, tcfg, backend, u, V, seed=0):
    bk = get_backend(backend)
    us = torch.full((B,), u, dtype=torch.int32)
    nxt, slot = bk.sample_step(ts, tcfg, us, generator(seed + 1, "cpu"))
    nxt = nxt.numpy()
    assert (nxt >= 0).all(), f"{backend}: invalid sample from deg>0 vertex"
    np.testing.assert_array_equal(
        ts.nbr[u, torch.as_tensor(slot).long()].numpy(), nxt)
    got = empirical_dist(nxt, V)
    assert tv_distance(got, _want(js, jcfg, u, V)) < 0.02, (backend, u)


def test_registry():
    names = available_backends()
    assert "reference" in names and "fused" in names and "auto" in names
    assert isinstance(get_backend("auto"), FusedBackend)
    assert get_backend("reference").name == "reference"
    with pytest.raises(ValueError):
        get_backend("no-such-backend")


@pytest.mark.parametrize("backend", BACKENDS)
def test_all_group_types(backend):
    V = _hub_graph()[3]
    js, jcfg, ts, tcfg = _states("hub", num_vertices=V, capacity=32,
                                 bias_bits=4)
    types = set(np.asarray(js.gtype[0]).tolist())
    assert {jdg.DENSE, jdg.ONE, jdg.SPARSE, jdg.REGULAR} <= types
    _check(js, jcfg, ts, tcfg, backend, 0, V)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("adaptive", [True, False])
def test_random_graph(backend, adaptive):
    V = 12
    js, jcfg, ts, tcfg = _states("random12", num_vertices=V, capacity=16,
                                 bias_bits=6, adaptive=adaptive)
    for u in (0, 5, 11):
        _check(js, jcfg, ts, tcfg, backend, u, V, seed=u)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("base_log2", [1, 2])
def test_fp_bias(backend, base_log2):
    V = _hub_graph()[3]
    js, jcfg, ts, tcfg = _states("hub", True, num_vertices=V, capacity=32,
                                 bias_bits=6, base_log2=base_log2,
                                 fp_bias=True, lam=4.0)
    assert float(ts.wdec[0]) > 0
    _check(js, jcfg, ts, tcfg, backend, 0, V)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("base_log2", [1, 2])
def test_radix_bases(backend, base_log2):
    V = 10
    js, jcfg, ts, tcfg = _states("random10", num_vertices=V, capacity=8,
                                 bias_bits=6, base_log2=base_log2)
    for u in (0, 4, 8):
        _check(js, jcfg, ts, tcfg, backend, u, V, seed=u)


@pytest.mark.parametrize("backend", BACKENDS)
def test_sample_uniform(backend):
    """The unbiased pick is uniform over the row (TV 0.02) and never
    leaves it; degree-0 vertices give -1."""
    V = _hub_graph()[3]
    js, jcfg, ts, tcfg = _states("hub", num_vertices=V, capacity=32,
                                 bias_bits=4)
    bk = get_backend(backend)
    nxt, _ = bk.sample_uniform(ts, tcfg, torch.zeros(B, dtype=torch.int32),
                               generator(2, "cpu"))
    want = np.zeros(V)
    want[1:] = 1.0 / (V - 1)
    assert tv_distance(empirical_dist(nxt.numpy(), V), want) < 0.02
    dead, _ = bk.sample_uniform(ts, tcfg, torch.ones(4, dtype=torch.int32),
                                generator(2, "cpu"))
    assert (dead == -1).all()


def test_sample_alias_and_its_rows_bit_equal():
    rng = np.random.default_rng(0)
    w = rng.random((500, 9)).astype(np.float32) * (rng.random((500, 9)) < 0.7)
    jt = jalias.build_alias(jnp.asarray(w))
    tt = talias.AliasTable(torch.tensor(np.asarray(jt.prob)),
                           torch.tensor(np.asarray(jt.alias)))
    u0, u1 = rng.random((2, 500)).astype(np.float32)
    want = np.asarray(jalias.sample_alias(jt, jnp.asarray(u0), jnp.asarray(u1)))
    got = talias.sample_alias(tt, torch.from_numpy(u0), torch.from_numpy(u1))
    np.testing.assert_array_equal(got.numpy(), want)
    wi = rng.integers(0, 5, (500, 16)).astype(np.float32)   # exact sums
    x = rng.random(500).astype(np.float32)
    np.testing.assert_array_equal(
        tsampler._its_rows(torch.from_numpy(wi), torch.from_numpy(x)).numpy(),
        np.asarray(jsampler._its_rows(jnp.asarray(wi), jnp.asarray(x))))


def test_reference_backend_walks_and_updates():
    """``ReferenceBackend.sample_walk`` with fed uniforms is the fed plain
    walk (equal to the fused backend's), and ``apply_updates`` is
    ``batched_update``."""
    V = 12
    src, dst, _ = GRAPHS["random12"]()
    js, jcfg, ts, tcfg = _states("random12", num_vertices=V, capacity=16,
                                 bias_bits=6)
    starts = torch.arange(V, dtype=torch.int32)
    u = torch.tensor(np.asarray(jax.random.uniform(jax.random.key(1),
                                                   (7, V, 6))))
    for kind in ("deepwalk", "ppr", "simple"):
        params = WalkParams(kind, 7, stop_prob=0.2)
        a = get_backend("reference").sample_walk(ts, tcfg, starts, 3, params, u)
        b = get_backend("fused").sample_walk(ts, tcfg, starts, 3, params, u)
        assert torch.equal(a, b)
    batch = (torch.tensor([True, False]), torch.tensor([0, int(src[0])]),
             torch.tensor([3, int(dst[0])]), torch.tensor([5, 0]))
    ta = tdg.state_from_numpy(js, tcfg, device="cpu")     # updated in place
    tb = tdg.state_from_numpy(js, tcfg, device="cpu")
    _, sa = get_backend("reference").apply_updates(ta, tcfg, *batch)
    _, sb = get_backend("fused").apply_updates(tb, tcfg, *batch)
    for x, y in zip(tdg.state_to_numpy(ta), tdg.state_to_numpy(tb)):
        for p, q in zip(x if isinstance(x, tuple) else [x],
                        y if isinstance(y, tuple) else [y]):
            np.testing.assert_array_equal(p, q)
    assert int(sa.ins_applied) == int(sb.ins_applied) == 1
    assert int(sa.del_applied) == int(sb.del_applied) == 1
