"""The radix histogram (``kernels/radix_hist.py``) against JAX.

The same biases and degrees, built once in numpy, go through JAX's
``radix_hist_pallas`` in interpret mode (how the JAX package's own tests
run it on the CPU), its oracle ``ref.radix_hist_ref``, and the port's
``ops.radix_hist`` on CPU tensors (its plain version).  Integer sums:
bit-equal.  On a port state, the histogram equals the state's own
``digitsum`` and ``gsize``.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.kernels import ref
from repro.kernels.radix_hist import radix_hist_pallas
from repro_torch.core import dyngraph as tdg
from repro_torch.core.updates import batched_update
from repro_torch.kernels import ops
from repro_torch.kernels.radix_hist import radix_hist_ref
from tests.conftest import random_graph


def _case(V, C, K):
    rng = np.random.default_rng(V * C + K)
    bias = rng.integers(0, 1 << K, (V, C)).astype(np.int32)
    deg = rng.integers(0, C + 1, V).astype(np.int32)
    deg[0], deg[-1] = 0, C
    return bias, deg


@pytest.mark.parametrize("V,C,K", [(4, 8, 4), (17, 32, 16), (64, 128, 8),
                                   (33, 64, 31)])
def test_radix_hist_matches_jax(V, C, K):
    bias, deg = _case(V, C, K)
    jb, jd = jnp.asarray(bias), jnp.asarray(deg)
    ds_p, gs_p = radix_hist_pallas(jb, jd, num_k=K, block_v=16, interpret=True)
    ds_r, gs_r = ref.radix_hist_ref(jb, jd, K)
    before = ops.launch_counts()
    ds, gs = ops.radix_hist(torch.from_numpy(bias), torch.from_numpy(deg),
                            num_k=K)
    assert ops.launch_counts() == before         # CPU tensors: plain version
    assert ds.dtype == gs.dtype == torch.int32 and ds.shape == (V, K)
    for want in (ds_p, ds_r):
        np.testing.assert_array_equal(ds.numpy(), np.asarray(want))
    for want in (gs_p, gs_r):
        np.testing.assert_array_equal(gs.numpy(), np.asarray(want))
    np.testing.assert_array_equal(ds.numpy(), gs.numpy())   # base 2


def test_radix_hist_ignores_slots_past_degree():
    bias = np.full((3, 8), 0b1011, np.int32)
    deg = np.array([0, 3, 8], np.int32)
    ds, gs = radix_hist_ref(torch.from_numpy(bias), torch.from_numpy(deg), 4)
    np.testing.assert_array_equal(ds.numpy(), [[0, 0, 0, 0], [3, 3, 0, 3],
                                               [8, 8, 0, 8]])
    np.testing.assert_array_equal(gs.numpy(), ds.numpy())


@pytest.mark.parametrize("adaptive", [True, False])
def test_radix_hist_of_a_state_equals_its_counters(adaptive):
    """On a ``from_edges`` state and again after an update round."""
    src, dst, w = random_graph(60, 16, max_bias=(1 << 12) - 1, seed=3)
    cfg = tdg.BingoConfig(num_vertices=60, capacity=16, bias_bits=12,
                          adaptive=adaptive)
    st = tdg.from_edges(cfg, src, dst, w, device="cpu")
    rng = np.random.default_rng(4)
    n = 64
    st, _ = batched_update(st, cfg, torch.from_numpy(rng.random(n) < 0.6),
                           torch.from_numpy(rng.integers(0, 60, n).astype(np.int32)),
                           torch.from_numpy(rng.integers(0, 60, n).astype(np.int32)),
                           torch.from_numpy(rng.integers(1, 1 << 12, n).astype(np.int32)))
    ds, gs = ops.radix_hist(st.bias, st.deg, num_k=cfg.num_radix)
    assert torch.equal(ds, st.digitsum)
    assert torch.equal(gs, st.gsize)
