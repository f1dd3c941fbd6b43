"""Batched Vose tables (``kernels/alias_build.py``) against JAX.

The same weight rows, built once in numpy, go through JAX's
``alias_build_pallas`` in interpret mode (how the JAX package's own tests
run it on the CPU), JAX's ``core.alias.build_alias`` (the oracle
``ref.alias_build_ref``), and the port's ``ops.alias_build`` on CPU
tensors (its plain version).  Against ``build_alias`` the port is
bit-equal; against the Pallas kernel, which adds ``scaled + sval - 1`` in
another order, prob agrees at ``atol=1e-5`` and alias exactly, as the JAX
package's own test holds its kernel.  Every row width of
``chip_smoke.ALIAS_KS`` on its special rows is bit-equal to
``build_alias``.  On a port state the tables equal ``state.itable`` bit
for bit.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.core import alias as jalias
from repro.kernels.alias_build import alias_build_pallas
from repro_torch.core import dyngraph as tdg
from repro_torch.core import radix as tradix
from repro_torch.core.alias import AliasTable, alias_probs
from repro_torch.core.updates import batched_update
from repro_torch.kernels import ops
from tests.conftest import random_graph

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import ALIAS_KS, alias_weights  # noqa: E402


def _rows(V, K):
    rng = np.random.default_rng(V + K)
    w = (rng.random((V, K)) * rng.integers(1, 100, (V, K))).astype(np.float32)
    w[0] = 0.0                                   # an empty row
    if V > 2:
        w[1, 1:] = 0.0                           # a single-entry row
    return w


@pytest.mark.parametrize("V,K", [(1, 2), (7, 5), (33, 16), (128, 33)])
def test_alias_build_matches_jax(V, K):
    w = _rows(V, K)
    p_k, a_k = alias_build_pallas(jnp.asarray(w), block_v=32, interpret=True)
    jt = jalias.build_alias(jnp.asarray(w))
    before = ops.launch_counts()
    prob, alias = ops.alias_build(torch.from_numpy(w))
    assert ops.launch_counts() == before         # CPU tensors: plain version
    assert prob.dtype == torch.float32 and alias.dtype == torch.int32
    np.testing.assert_array_equal(prob.numpy(), np.asarray(jt.prob))
    np.testing.assert_array_equal(alias.numpy(), np.asarray(jt.alias))
    np.testing.assert_allclose(prob.numpy(), np.asarray(p_k), atol=1e-5)
    np.testing.assert_array_equal(alias.numpy(), np.asarray(a_k))


@pytest.mark.parametrize("K", ALIAS_KS)
def test_alias_build_rows_of_every_width_match_jax(K):
    """The widths the card's kernel lays out differently (8-, 16- and
    32-lane groups, two entries a lane past 32) on ``chip_smoke``'s rows:
    all-zero, single-entry, equal weights, totals near the 1e-30 floor;
    bit-equal to JAX's ``build_alias``."""
    w = alias_weights(np.random.default_rng(K), 40, K)
    jt = jalias.build_alias(jnp.asarray(w))
    prob, alias = ops.alias_build(torch.from_numpy(w))
    np.testing.assert_array_equal(prob.numpy(), np.asarray(jt.prob))
    np.testing.assert_array_equal(alias.numpy(), np.asarray(jt.alias))


def test_alias_build_encodes_distribution():
    rng = np.random.default_rng(0)
    w = rng.integers(0, 50, (16, 9)).astype(np.float32)
    w[:, 0] = np.maximum(w[:, 0], 1.0)
    prob, alias = ops.alias_build(torch.from_numpy(w))
    enc = alias_probs(AliasTable(prob, alias)).numpy()
    np.testing.assert_allclose(enc, w / w.sum(-1, keepdims=True), atol=1e-5)


@pytest.mark.parametrize("adaptive", [True, False])
def test_alias_build_of_a_state_equals_its_itable(adaptive):
    """Over the state's group weights, on a ``from_edges`` state and again
    after an update round."""
    src, dst, w = random_graph(60, 16, max_bias=(1 << 12) - 1, seed=5)
    cfg = tdg.BingoConfig(num_vertices=60, capacity=16, bias_bits=12,
                          adaptive=adaptive)
    st = tdg.from_edges(cfg, src, dst, w, device="cpu")
    rng = np.random.default_rng(6)
    for _ in range(2):
        gw = tradix.group_weights(st.digitsum, cfg.base_log2)
        prob, alias = ops.alias_build(gw)
        assert torch.equal(prob, st.itable.prob)
        assert torch.equal(alias, st.itable.alias)
        n = 64
        st, _ = batched_update(
            st, cfg, torch.from_numpy(rng.random(n) < 0.6),
            torch.from_numpy(rng.integers(0, 60, n).astype(np.int32)),
            torch.from_numpy(rng.integers(0, 60, n).astype(np.int32)),
            torch.from_numpy(rng.integers(1, 1 << 12, n).astype(np.int32)))
