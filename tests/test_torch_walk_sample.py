"""The per-step sampler entries (``kernels/walk_sample.py``) against JAX's
Pallas kernels.

The same gathered rows and fed uniforms, built once in numpy, go through
``walk_sample_pallas`` / ``walk_sample_uniform_pallas`` in interpret mode
(how the JAX package's own tests run them on the CPU) and through the
port's ``walk_sample`` / ``walk_sample_uniform`` on CPU tensors (their
plain versions).  Integer mode (bases 2 and 4) and the uniform pick are
bit-equal.  In fp mode the decimal group's ITS sums floats in an order
JAX leaves to XLA, so >= 99.9 % of lanes must agree and every
disagreement must be a decimal-group draw.  The in-place ``rows`` entry
equals the gathered entry bit for bit.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.kernels.walk_sample import (walk_sample_pallas,
                                       walk_sample_uniform_pallas)
from repro_torch.kernels import ops
from repro_torch.kernels.walk_sample import (walk_sample,
                                            walk_sample_uniform)
from tests.test_torch_walks import _rows_case, t


def _pallas(prob, alias, bias, nbr, deg, u, frac, base_log2):
    ncols = 5 if (base_log2 > 1 or frac is not None) else 3
    nxt, slot = walk_sample_pallas(
        *map(jnp.asarray, (prob, alias, bias, nbr, deg, u[:, :ncols])),
        None if frac is None else jnp.asarray(frac), base_log2=base_log2,
        interpret=True)
    return np.asarray(nxt), np.asarray(slot)


@pytest.mark.parametrize("base_log2,fp", [(1, False), (2, False), (1, True),
                                          (2, True)])
def test_walk_sample_matches_pallas_interpret(base_log2, fp):
    prob, alias, bias, nbr, deg, u, frac = _rows_case(base_log2, fp, B=1024)
    jn, js = _pallas(prob, alias, bias, nbr, deg, u, frac, base_log2)
    before = ops.launch_counts()
    tn, ts = walk_sample(*map(t, (prob, alias, bias, nbr, deg, u)),
                         None if frac is None else t(frac),
                         base_log2=base_log2)
    assert ops.launch_counts() == before         # CPU tensors: plain version
    assert tn.dtype == ts.dtype == torch.int32
    assert (tn.numpy()[deg == 0] == -1).all()
    if not fp:
        np.testing.assert_array_equal(tn.numpy(), jn)
        np.testing.assert_array_equal(ts.numpy(), js)
        return
    Kin = prob.shape[1]
    i = np.minimum((u[:, 0] * np.float32(Kin)).astype(np.int32), Kin - 1)
    k = np.where(u[:, 1] < prob[np.arange(len(i)), i], i,
                 alias[np.arange(len(i)), i])
    diff = (tn.numpy() != jn) | (ts.numpy() != js)
    assert diff.mean() <= 1e-3
    assert (k[diff] == Kin - 1).all()


@pytest.mark.parametrize("base_log2,fp", [(1, False), (2, True)])
def test_in_place_rows_equal_gathered(base_log2, fp):
    """``rows`` reads the walkers' rows of the full tables in place: the
    same draws as the gathered rows, every walker, duplicates included."""
    prob, alias, bias, nbr, deg, u, frac = _rows_case(base_log2, fp, B=600)
    rng = np.random.default_rng(3)
    rows = rng.integers(0, len(deg), 2000).astype(np.int32)
    uu = rng.random((2000, 5)).astype(np.float32)
    tabs = [t(x) for x in (prob, alias, bias, nbr, deg)]
    ft = None if frac is None else t(frac)
    got = walk_sample(*tabs, t(uu), ft, base_log2=base_log2, rows=t(rows))
    want = walk_sample(*[x[rows] for x in tabs], t(uu),
                       None if ft is None else ft[rows], base_log2=base_log2)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    got = walk_sample_uniform(tabs[3], tabs[4], t(uu[:, 2:3]), rows=t(rows))
    want = walk_sample_uniform(tabs[3][rows], tabs[4][rows], t(uu[:, 2:3]))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_walk_sample_uniform_matches_pallas_interpret():
    rng = np.random.default_rng(11)
    B, C = 1500, 24
    nbr = rng.integers(0, 500, (B, C)).astype(np.int32)
    deg = rng.integers(0, C + 1, B).astype(np.int32)
    u = rng.random((B, 1)).astype(np.float32)
    jn, js = walk_sample_uniform_pallas(*map(jnp.asarray, (nbr, deg, u)),
                                        interpret=True)
    tn, ts = walk_sample_uniform(t(nbr), t(deg), t(u))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert (ts.numpy()[deg == 0] == -1).all()


@pytest.mark.parametrize("ucols", [1, 3, 5])
@pytest.mark.parametrize("B", [1, 3, 4, 5, 9])
def test_walk_sample_uniform_batches_match_pallas_interpret(B, ucols):
    """Batches that fill no, one or a part of a group of four walkers, one
    or more uniform columns (column 0 is the pick's), degree-0 rows first
    and last: JAX's kernel on the gathered rows, the port's entry on the
    rows in place and gathered."""
    rng = np.random.default_rng(B * 10 + ucols)
    V, C = 40, 12
    nbr = rng.integers(0, V, (V, C)).astype(np.int32)
    deg = rng.integers(0, C + 1, V).astype(np.int32)
    deg[::5] = 0
    rows = rng.integers(0, V, B).astype(np.int32)
    rows[0] = rows[-1] = 5
    u = rng.random((B, ucols)).astype(np.float32)
    jn, js = walk_sample_uniform_pallas(
        *map(jnp.asarray, (nbr[rows], deg[rows], u)), interpret=True)
    for got in (walk_sample_uniform(t(nbr), t(deg), t(u), rows=t(rows)),
                walk_sample_uniform(t(nbr[rows]), t(deg[rows]), t(u))):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(jn))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(js))
    assert got[1][0] == got[1][-1] == -1


def test_extended_paths_need_five_uniforms():
    """Base > 2 and fp mode read the acceptance coin and ITS position:
    (B, 3) uniforms are refused, as the reference's ``ops.walk_sample``
    refuses them."""
    prob, alias, bias, nbr, deg, u, frac = _rows_case(2, True, B=8)
    args = [t(x) for x in (prob, alias, bias, nbr, deg)]
    with pytest.raises(ValueError, match="need u"):
        walk_sample(*args, t(u[:, :3]), base_log2=2)
    with pytest.raises(ValueError, match="need u"):
        walk_sample(*args, t(u[:, :3]), t(frac), base_log2=1)
