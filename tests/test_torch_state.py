"""The port's state build (``repro_torch.core.dyngraph``) against JAX.

Inputs are made once with numpy and fed to both packages.  Integer mode
is bit-equal leaf by leaf.  In fp mode the integer leaves and ``frac``
are exact, while ``wdec`` (a float sum whose order JAX leaves to XLA) is
held at ``rtol=1e-6`` and the alias rows through the distribution they
encode (``alias_probs``) at ``atol=1e-6``.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.core import alias as jalias
from repro.core import dyngraph as jdg
from repro.core import radix as jradix
from repro_torch.core import alias as talias
from repro_torch.core import dyngraph as tdg
from repro_torch.core import radix as tradix
from tests.conftest import random_graph

FIELDS = ("nbr", "bias", "frac", "deg", "gmem", "ginv", "gsize", "digitsum",
          "gtype")
MODES = [(a, fp, b) for a in (True, False) for fp in (False, True)
         for b in (1, 2)]


def configs(**kw):
    """The same configuration in both packages."""
    return jdg.BingoConfig(**kw), tdg.BingoConfig(**kw)


def assert_state_matches(jstate, tstate, fp: bool):
    """Leaf-by-leaf equality of a JAX state and a port state (see the
    module docstring for the fp-mode tolerances)."""
    got = tdg.state_to_numpy(tstate)
    for f in FIELDS:
        a, b = getattr(jstate, f), getattr(got, f)
        if a is None:
            assert b is None, f
            continue
        a = np.asarray(a)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    wj, wt = np.asarray(jstate.wdec), got.wdec
    pj, aj = np.asarray(jstate.itable.prob), np.asarray(jstate.itable.alias)
    if not fp:
        np.testing.assert_array_equal(wj, wt)
        np.testing.assert_array_equal(pj, got.itable.prob)
        np.testing.assert_array_equal(aj, got.itable.alias)
        return
    np.testing.assert_allclose(wt, wj, rtol=1e-6)
    enc_j = np.asarray(jalias.alias_probs(jalias.AliasTable(pj, aj)))
    enc_t = talias.alias_probs(talias.AliasTable(
        torch.from_numpy(got.itable.prob), torch.from_numpy(got.itable.alias)))
    np.testing.assert_allclose(enc_t.numpy(), enc_j, atol=1e-6)


def graph_case(V=12, C=16, fp=False, seed=4, density=0.4):
    src, dst, w = random_graph(V, C, max_bias=31, seed=seed, density=density)
    if fp:
        rng = np.random.default_rng(seed)
        w = w.astype(np.float32) + rng.random(len(w)).astype(np.float32)
    return src, dst, w


@pytest.mark.parametrize("adaptive,fp,base_log2", MODES)
def test_from_edges_matches_jax(adaptive, fp, base_log2):
    jcfg, tcfg = configs(num_vertices=12, capacity=16, bias_bits=6,
                         adaptive=adaptive, fp_bias=fp, base_log2=base_log2)
    src, dst, w = graph_case(fp=fp)
    assert_state_matches(jdg.from_edges(jcfg, src, dst, w),
                         tdg.from_edges(tcfg, src, dst, w, device="cpu"), fp)


def test_from_edges_capacity_overflow_and_all_group_types():
    """A hub row past capacity (edges beyond C dropped in input order)
    whose groups span DENSE/ONE/SPARSE/REGULAR."""
    d = 40
    w = np.ones(d, np.int64)
    w[16] += 2
    w[17:19] += 4
    w[19:24] += 8 - 1
    src = np.zeros(d, np.int32)
    dst = (np.arange(d) % 30 + 1).astype(np.int32)
    jcfg, tcfg = configs(num_vertices=31, capacity=32, bias_bits=4)
    js = jdg.from_edges(jcfg, src, dst, w.astype(np.int32))
    assert {jdg.DENSE, jdg.ONE, jdg.SPARSE, jdg.REGULAR} <= set(
        np.asarray(js.gtype[0]).tolist())
    assert_state_matches(js, tdg.from_edges(tcfg, src, dst, w.astype(np.int32),
                                            device="cpu"), False)


@pytest.mark.parametrize("adaptive", [True, False])
def test_chunked_build_equals_unchunked(adaptive):
    cfg = tdg.BingoConfig(num_vertices=40, capacity=16, bias_bits=8,
                          adaptive=adaptive)
    src, dst, w = random_graph(40, 16, max_bias=255, seed=9, density=0.6)
    whole = tdg.from_edges(cfg, src, dst, w, device="cpu", chunk=1000)
    chunked = tdg.from_edges(cfg, src, dst, w, device="cpu", chunk=7)
    for a, b in zip(tdg.state_to_numpy(whole), tdg.state_to_numpy(chunked)):
        if isinstance(a, tuple):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        elif a is None:
            assert b is None
        else:
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("adaptive,fp", [(True, False), (False, True)])
def test_state_numpy_roundtrip(adaptive, fp):
    """JAX state -> port (``state_from_numpy``) -> numpy
    (``state_to_numpy``) is the identity, and the carried state equals
    the port's own build."""
    jcfg, tcfg = configs(num_vertices=12, capacity=16, bias_bits=6,
                         adaptive=adaptive, fp_bias=fp)
    src, dst, w = graph_case(fp=fp)
    js = jdg.from_edges(jcfg, src, dst, w)
    carried = tdg.state_from_numpy(js, tcfg, device="cpu")
    assert_state_matches(js, carried, fp=False)   # a copy is exact
    back = tdg.state_from_numpy(tdg.state_to_numpy(carried), tcfg, "cpu")
    assert_state_matches(js, back, fp=False)
    assert_state_matches(js, tdg.from_edges(tcfg, src, dst, w, "cpu"), fp)


@pytest.mark.parametrize("n,R", [(2, 5), (7, 9), (17, 33), (33, 16)])
def test_build_alias_matches_jax(n, R):
    """Batched Vose is bit-equal to the reference's per-row loop,
    including empty and single-entry rows."""
    rng = np.random.default_rng(n * R)
    w = (rng.random((R, n)) * rng.integers(1, 100, (R, n))).astype(np.float32)
    w[0] = 0.0
    w[1, 1:] = 0.0
    jt = jalias.build_alias(jnp.asarray(w))
    tt = talias.build_alias(torch.from_numpy(w))
    np.testing.assert_array_equal(np.asarray(jt.prob), tt.prob.numpy())
    np.testing.assert_array_equal(np.asarray(jt.alias), tt.alias.numpy())


def test_radix_matches_jax():
    rng = np.random.default_rng(1)
    bias = rng.integers(0, 1 << 16, (6, 10)).astype(np.int32)
    for b in (1, 2, 3):
        K = tradix.num_groups(16, b)
        np.testing.assert_array_equal(
            np.asarray(jradix.digits(jnp.asarray(bias), K, b)),
            tradix.digits(torch.from_numpy(bias), K, b).numpy())
    fp = (rng.random(50) * 100).astype(np.float32)
    for j, t in zip(jradix.decompose_fp(jnp.asarray(fp), 16.0),
                    tradix.decompose_fp(torch.from_numpy(fp), 16.0)):
        np.testing.assert_array_equal(np.asarray(j), t.numpy())


def test_group_weights_are_exact_powers():
    """The port scales by exact powers of two.  JAX's CPU ``exp2`` rounds
    some exponents >= 13 a few ulps off, so the two agree exactly below
    that, which is where every bit-equality test of this suite lies."""
    ds = torch.ones((1, 16), dtype=torch.int32)
    got = tradix.group_weights(ds, 1)[0].numpy()
    np.testing.assert_array_equal(got, 2.0 ** np.arange(16))
    jw = np.asarray(jradix.group_weights(jnp.ones((1, 16), jnp.int32), 1))[0]
    np.testing.assert_array_equal(got[:13], jw[:13])
