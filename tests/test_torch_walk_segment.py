"""The port's segment walk (the relay's per-round kernel entry) against JAX's.

The port's ``walk_segment`` runs its plain version on CPU tensors; it is
held against JAX's oracle ``ref.walk_segment_ref`` and against JAX's
Pallas segment entry (``ops.walk_segment``, interpret mode here), on the
same numpy-made inputs: adjacency rows with remote neighbours encoded
``-(g + 2)``, start steps spread over ``[0, L+1]`` (``L`` and ``L+1``
among them), free slots (``starts < 0``) and a permuted slot → walker id
map, under fed and hashed uniforms.  Integer mode (bases 2 and 4) is
bit-equal.  fp mode is held at ROADMAP C's fp-walk tolerance, a share of
equal rows of at least 99.9 %; at these sizes every row agrees.  Both
backends' ``sample_walk_segment`` are held against their JAX
counterparts, and node2vec raises ``ValueError`` as in JAX.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.core import dyngraph as jdg
from repro.core.backend import get_backend as j_get_backend
from repro.core.walks import WalkParams as JWalkParams
from repro.kernels import ops as jops
from repro.kernels import ref
from repro_torch.core import dyngraph as tdg
from repro_torch.core.backend import get_backend
from repro_torch.core.walks import WalkParams
from repro_torch.kernels.walk_fused import walk_segment
from tests.conftest import random_graph
from tests.test_torch_state import configs

V, C, L, B = 32, 16, 10, 40
SEED = 1234
MODES = [(1, False), (2, False), (1, True), (2, True)]


def _case(base_log2, fp):
    """A JAX state, the same state in the port, and segment inputs: the
    adjacency with about 30 % of its neighbours made remote, starts with
    free slots, start steps over [0, L+1], a permuted wid map and fed
    uniforms."""
    src, dst, w = random_graph(V, C, max_bias=63, seed=3)
    wf = w.astype(np.float32) + 0.37 if fp else w
    jcfg, tcfg = configs(num_vertices=V, capacity=C, bias_bits=6,
                         base_log2=base_log2, fp_bias=fp, lam=4.0)
    js = jdg.from_edges(jcfg, src, dst, wf)
    rng = np.random.default_rng(10 * base_log2 + fp)
    nbr = np.asarray(js.nbr).copy()
    remote = (rng.random(nbr.shape) < 0.3) & (nbr >= 0)
    nbr = np.where(remote, -(nbr + 2), nbr).astype(np.int32)
    js = js._replace(nbr=jnp.asarray(nbr))
    ts = tdg.state_from_numpy(js, tcfg, device="cpu")
    starts = rng.integers(-1, V, B).astype(np.int32)
    t0 = rng.integers(0, L + 2, B).astype(np.int32)
    t0[:2] = [L, L + 1]
    wid = (rng.permutation(B) + 5).astype(np.int32)
    u = rng.random((L, B, 6)).astype(np.float32)
    return js, jcfg, ts, tcfg, starts, t0, wid, u


def _tables(st, fp):
    return (st.itable.prob, st.itable.alias, st.bias, st.nbr, st.deg,
            st.frac if fp else None)


def _kw(kind, base_log2):
    return dict(length=L, base_log2=base_log2,
                stop_prob=0.2 if kind == "ppr" else 0.0,
                uniform=kind == "simple")


def _assert_same(got, want, fp):
    """Paths and frontiers equal: bit for bit in integer mode, on at least
    99.9 % of rows in fp mode."""
    (gp, gf), (wp, wf) = [tuple(np.asarray(x) for x in pair)
                          for pair in (got, want)]
    if not fp:
        np.testing.assert_array_equal(gp, wp)
        np.testing.assert_array_equal(gf, wf)
        return
    same = (gp == wp).all(1) & (gf == wf).all(1)
    assert same.mean() >= 0.999, f"{(~same).sum()} of {len(same)} rows differ"


def _port(ts, fp, starts, t0, wid, u, fed, kind, base_log2):
    return walk_segment(*_tables(ts, fp), torch.from_numpy(starts),
                        torch.from_numpy(t0), SEED,
                        torch.from_numpy(u) if fed else None,
                        torch.from_numpy(wid), **_kw(kind, base_log2))


@pytest.mark.parametrize("fed", [True, False])
@pytest.mark.parametrize("base_log2,fp", MODES)
@pytest.mark.parametrize("kind", ["deepwalk", "ppr", "simple"])
def test_segment_matches_jax_oracle(kind, base_log2, fp, fed):
    js, _, ts, _, starts, t0, wid, u = _case(base_log2, fp)
    got = _port(ts, fp, starts, t0, wid, u, fed, kind, base_log2)
    want = ref.walk_segment_ref(
        *_tables(js, fp), jnp.asarray(starts), jnp.asarray(t0),
        jnp.asarray(u) if fed else None, jnp.asarray(wid),
        seed=jnp.array([SEED], jnp.int32), **_kw(kind, base_log2))
    _assert_same(got, want, fp)
    assert (got[1][:, 0] >= 0).any()             # some walkers exit remote


@pytest.mark.parametrize("fed", [True, False])
@pytest.mark.parametrize("base_log2,fp", [(1, False), (2, True)])
@pytest.mark.parametrize("kind", ["deepwalk", "ppr", "simple"])
def test_segment_matches_pallas_entry(kind, base_log2, fp, fed):
    """Against the TPU kernel's segment entry itself (interpret mode)."""
    js, _, ts, _, starts, t0, wid, u = _case(base_log2, fp)
    got = _port(ts, fp, starts, t0, wid, u, fed, kind, base_log2)
    want = jops.walk_segment(
        *_tables(js, fp), jnp.asarray(starts), jnp.asarray(t0),
        jnp.array([SEED], jnp.int32), jnp.asarray(u) if fed else None,
        jnp.asarray(wid), **_kw(kind, base_log2))
    _assert_same(got, want, fp)


@pytest.mark.parametrize("kind", ["deepwalk", "ppr", "simple"])
@pytest.mark.parametrize("name,jname", [("fused", "pallas"),
                                        ("reference", "reference")])
def test_backend_segment_matches_jax(name, jname, kind):
    """``sample_walk_segment`` of each port backend == its JAX
    counterpart's, hashed uniforms, base 4."""
    js, jcfg, ts, tcfg, starts, t0, wid, _ = _case(2, False)
    params = dict(kind=kind, length=L, stop_prob=0.2 if kind == "ppr" else 0.0)
    got = get_backend(name).sample_walk_segment(
        ts, tcfg, torch.from_numpy(starts), torch.from_numpy(t0), SEED,
        WalkParams(**params), wid=torch.from_numpy(wid))
    want = j_get_backend(jname).sample_walk_segment(
        js, jcfg, jnp.asarray(starts), jnp.asarray(t0),
        jnp.array([SEED], jnp.int32), JWalkParams(**params),
        wid=jnp.asarray(wid))
    _assert_same(got, want, False)


@pytest.mark.parametrize("name", ["fused", "reference"])
def test_node2vec_has_no_segment_path(name):
    _, _, ts, tcfg, starts, t0, wid, _ = _case(1, False)
    with pytest.raises(ValueError, match="node2vec"):
        get_backend(name).sample_walk_segment(
            ts, tcfg, torch.from_numpy(starts), torch.from_numpy(t0), SEED,
            WalkParams("node2vec", L))


def test_segment_windows_and_frontier():
    """What a segment writes: -1 before ``t0``, the start at ``t0``, a free
    slot or ``t0 > L`` all -1; a frontier exit at step s leaves column s
    -1, after which the row stays -1; and ``wid`` keys the stream (a
    walker keeps its path under any slot permutation)."""
    _, _, ts, _, starts, t0, wid, _ = _case(1, False)
    path, fr = (x.numpy() for x in
                _port(ts, False, starts, t0, wid, None, False, "deepwalk", 1))
    col = np.arange(L + 1)[None, :]
    occupied = (starts >= 0) & (t0 <= L)
    assert (path[~occupied] == -1).all() and (fr[~occupied] == -1).all()
    assert (path[(col < t0[:, None]) & occupied[:, None]] == -1).all()
    assert (path[occupied, t0[occupied]] == starts[occupied]).all()
    ex = fr[:, 0] >= 0
    assert ex.any()
    assert ((fr[ex, 1] > t0[ex]) & (fr[ex, 1] <= L)).all()
    for b in np.flatnonzero(ex):
        assert (path[b, fr[b, 1]:] == -1).all()
    perm = np.random.default_rng(0).permutation(B)
    p2, f2 = _port(ts, False, starts[perm], t0[perm], wid[perm], None, False,
                   "deepwalk", 1)
    np.testing.assert_array_equal(p2.numpy(), path[perm])
    np.testing.assert_array_equal(f2.numpy(), fr[perm])
