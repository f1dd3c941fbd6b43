"""The port's walk PRNG, sampler and whole walks against JAX's oracles.

JAX's side runs through its plain references (``ref.walk_sample_ref``,
``ref.walk_fused_ref``), which is how its own tests pin the Pallas walk
kernels.  The walk seed is derived in JAX (``ops.seed_from_key``) and the
integer handed to the port.  Integer mode (bases 2 and 4) is bit-equal;
in fp mode the decimal group's ITS sums floats in an order JAX leaves to
XLA, so single draws may differ there and fp walks are held in
distribution against ``transition_probs`` instead.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.core import dyngraph as jdg
from repro.core.alias import build_alias
from repro.kernels import ref
from repro.kernels.ops import seed_from_key
from repro.kernels.walk_fused import uniforms_at as j_uniforms_at
from repro_torch.core import dyngraph as tdg
from repro_torch.core.sampler import transition_probs
from repro_torch.core.walks import WalkParams, random_walk
from repro_torch.kernels.walk_fused import (hash_uniforms, uniforms_at,
                                           walk_fused_ref)
from repro_torch.kernels.walk_sample import sample_rows
from tests.conftest import empirical_dist, random_graph, tv_distance
from tests.test_torch_state import configs


def t(x):
    return torch.from_numpy(np.array(x, copy=True))


@pytest.mark.parametrize("seed", [0, 1234, -7, 2**31 - 2, 2**31 - 1])
def test_uniforms_at_bit_equal(seed):
    wid = np.arange(37, dtype=np.int32)
    ts = np.arange(9, dtype=np.int32)
    want = np.asarray(j_uniforms_at(jnp.int32(seed), jnp.asarray(wid)[None, :, None],
                                    jnp.asarray(ts)[:, None, None]))
    got = uniforms_at(seed, t(wid)[None, :], t(ts)[:, None]).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert (got >= 0).all() and (got < 1).all()
    stream = np.asarray(ref.hash_uniforms_ref(jnp.array([seed], jnp.int32), 9, 37))
    np.testing.assert_array_equal(hash_uniforms(seed, 9, 37, device="cpu").numpy(), stream)


def _rows_case(base_log2, fp, B=3000, C=32, bits=12, seed=0):
    rng = np.random.default_rng(seed + 7 * base_log2 + fp)
    K = -(-bits // base_log2)
    bias = rng.integers(0, 1 << bits, (B, C)).astype(np.int32)
    nbr = rng.integers(0, 1000, (B, C)).astype(np.int32)
    deg = rng.integers(0, C + 1, B).astype(np.int32)
    valid = np.arange(C)[None, :] < deg[:, None]
    dmask = (1 << base_log2) - 1
    digs = (np.where(valid, bias, 0)[..., None] >> (np.arange(K) * base_log2)) \
        & dmask
    gw = (digs.sum(1) * (2.0 ** (np.arange(K) * base_log2))).astype(np.float32)
    frac = None
    if fp:
        frac = rng.random((B, C)).astype(np.float32)
        wdec = np.where(valid, frac, 0).sum(-1, keepdims=True) * 4.0
        gw = np.concatenate([gw, wdec.astype(np.float32)], -1)
    tab = build_alias(jnp.asarray(gw))
    u = rng.random((B, 5)).astype(np.float32)
    return (np.asarray(tab.prob), np.asarray(tab.alias), bias, nbr, deg, u,
            frac)


@pytest.mark.parametrize("base_log2,fp", [(1, False), (2, False), (1, True),
                                          (2, True)])
def test_sample_rows_matches_walk_sample_ref(base_log2, fp):
    prob, alias, bias, nbr, deg, u, frac = _rows_case(base_log2, fp)
    jn, js = ref.walk_sample_ref(
        *map(jnp.asarray, (prob, alias, bias, nbr, deg)),
        *(jnp.asarray(u[:, c]) for c in range(5)),
        frac=None if frac is None else jnp.asarray(frac), base_log2=base_log2)
    tn, ts, _ = sample_rows(*map(t, (prob, alias, bias, nbr, deg, u)),
                            None if frac is None else t(frac),
                            base_log2=base_log2)
    jn, js = np.asarray(jn), np.asarray(js)
    if not fp:
        np.testing.assert_array_equal(jn, tn.numpy())
        np.testing.assert_array_equal(js, ts.numpy())
        return
    # fp: agreement on >= 99.9% of lanes; every disagreement is a
    # decimal-group draw (stage (i) landed on the last inter-group lane)
    Kin = prob.shape[1]
    i = np.minimum((u[:, 0] * np.float32(Kin)).astype(np.int32), Kin - 1)
    rows = np.arange(len(i))
    k = np.where(u[:, 1] < prob[rows, i], i, alias[rows, i])
    diff = (jn != tn.numpy()) | (js != ts.numpy())
    assert diff.mean() <= 1e-3
    assert (k[diff] == Kin - 1).all()


def _walk_case(base_log2=1, fp=False, V=12, C=16, seed=5):
    src, dst, w = random_graph(V, C, max_bias=63, seed=seed)
    wf = w.astype(np.float32) + 0.37 if fp else w
    jcfg, tcfg = configs(num_vertices=V, capacity=C, bias_bits=6,
                         base_log2=base_log2, fp_bias=fp, lam=4.0)
    js = jdg.from_edges(jcfg, src, dst, wf)
    return js, tdg.state_from_numpy(js, tcfg, device="cpu"), tcfg


def _jax_walk(js, starts, kind, L, base_log2, u=None, seed=None):
    stop = 0.15 if kind == "ppr" else 0.0
    return np.asarray(ref.walk_fused_ref(
        js.itable.prob, js.itable.alias, js.bias, js.nbr, js.deg, None,
        jnp.asarray(starts), None if u is None else jnp.asarray(u),
        base_log2=base_log2, stop_prob=stop, uniform=kind == "simple",
        seed=None if seed is None else jnp.array([seed], jnp.int32),
        length=L))


@pytest.mark.parametrize("fed", [True, False])
@pytest.mark.parametrize("base_log2", [1, 2])
@pytest.mark.parametrize("kind", ["deepwalk", "ppr", "simple"])
def test_whole_walks_bit_equal(kind, base_log2, fed):
    """``random_walk`` on a carried-over JAX state vs ``ref.walk_fused_ref``
    with fed uniforms and with the hash stream of a JAX-derived seed."""
    js, ts, tcfg = _walk_case(base_log2=base_log2)
    B, L = 37, 9
    starts = (np.arange(B) % tcfg.num_vertices).astype(np.int32)
    seed = int(seed_from_key(jax.random.key(B + base_log2))[0])
    u = np.asarray(jax.random.uniform(jax.random.key(3), (L, B, 6))) \
        if fed else None
    want = _jax_walk(js, starts, kind, L, base_log2, u=u,
                     seed=None if fed else seed)
    params = WalkParams(kind=kind, length=L,
                        stop_prob=0.15 if kind == "ppr" else 0.0)
    got = random_walk(ts, tcfg, t(starts), seed, params,
                      uniforms=None if u is None else t(u))
    assert got.dtype == torch.int32 and got.shape == (B, L + 1)
    np.testing.assert_array_equal(got.numpy(), want)


def test_ragged_batch_and_dead_ends():
    """Path graph 0 -> 1 -> 2 with 2 a dead end: -1 forever after."""
    jcfg, tcfg = configs(num_vertices=3, capacity=2, bias_bits=2)
    src, dst = np.array([0, 1], np.int32), np.array([1, 2], np.int32)
    js = jdg.from_edges(jcfg, src, dst, np.ones(2, np.int32))
    ts = tdg.state_from_numpy(js, tcfg, device="cpu")
    B, L = 13, 6
    starts = np.zeros(B, np.int32)
    u = np.asarray(jax.random.uniform(jax.random.key(2), (L, B, 6)))
    got = random_walk(ts, tcfg, t(starts), 0, WalkParams(length=L),
                      uniforms=t(u)).numpy()
    np.testing.assert_array_equal(got, _jax_walk(js, starts, "deepwalk", L, 1,
                                                 u=u))
    np.testing.assert_array_equal(got[:, :3], np.tile([0, 1, 2], (B, 1)))
    assert (got[:, 3:] == -1).all()


@pytest.mark.parametrize("base_log2", [1, 2])
def test_fp_walk_distribution(base_log2):
    """fp-bias whole walks out of a hub reproduce Eq. 2 (TV against
    ``transition_probs`` pooled over steps), decimal group included."""
    d = 20
    src = np.concatenate([np.zeros(d), np.arange(1, d + 1)]).astype(np.int32)
    dst = np.concatenate([np.arange(1, d + 1), np.zeros(d)]).astype(np.int32)
    w = np.concatenate([1 + (np.arange(d) % 7) + 0.45 * (np.arange(d) % 3),
                        np.ones(d)]).astype(np.float32)
    tcfg = tdg.BingoConfig(num_vertices=d + 1, capacity=32, bias_bits=6,
                           base_log2=base_log2, fp_bias=True, lam=2.0)
    ts = tdg.from_edges(tcfg, src, dst, w, device="cpu")
    B, L = 4000, 6
    path = random_walk(ts, tcfg, torch.zeros(B, dtype=torch.int32), 77,
                       WalkParams(length=L)).numpy()
    nxt = path[:, 1:][path[:, :-1] == 0]
    nxt = nxt[nxt >= 0]
    assert nxt.size >= B
    probs = transition_probs(ts, tcfg, torch.zeros(1, dtype=torch.int64))[0]
    want = np.zeros(d + 1)
    for slot, p in enumerate(probs.numpy()):
        if p > 0:
            want[int(ts.nbr[0, slot])] += p
    assert tv_distance(empirical_dist(nxt, d + 1), want) < 0.03


def test_walk_fused_ref_direct_matches_jax():
    """The plain kernel version itself (fp tables, PPR stop) agrees with
    the JAX oracle on a case whose decimal-group sums are exact."""
    js, ts, tcfg = _walk_case(base_log2=2, fp=True)
    B, L = 29, 8
    starts = (np.arange(B) % tcfg.num_vertices).astype(np.int32)
    want = np.asarray(ref.walk_fused_ref(
        js.itable.prob, js.itable.alias, js.bias, js.nbr, js.deg, js.frac,
        jnp.asarray(starts), None, base_log2=2, stop_prob=0.15,
        seed=jnp.array([5], jnp.int32), length=L))
    got = walk_fused_ref(ts.itable.prob, ts.itable.alias, ts.bias, ts.nbr,
                         ts.deg, ts.frac, t(starts), None, base_log2=2,
                         stop_prob=0.15, seed=5, length=L)
    np.testing.assert_array_equal(got.numpy(), want)


def test_node2vec_and_per_step_raise():
    _, ts, tcfg = _walk_case()
    starts = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="later slice"):
        random_walk(ts, tcfg, starts, 0, WalkParams(kind="node2vec"))
    with pytest.raises(NotImplementedError, match="later slice"):
        random_walk(ts, tcfg, starts, 0, WalkParams(), whole_walk=False)
