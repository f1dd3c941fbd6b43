"""The radix histogram (``kernels/radix_hist.py``) against JAX.

The same biases and degrees, built once in numpy, go through JAX's
``radix_hist_pallas`` in interpret mode (how the JAX package's own tests
run it on the CPU), its oracle ``ref.radix_hist_ref``, and the port's
``ops.radix_hist`` on CPU tensors (its plain version).  Integer sums:
bit-equal.  On a port state, the histogram equals the state's own
``digitsum`` and ``gsize``.  ``kernel_counts`` replays the counting of
``csrc/radix_hist.cu`` in int32 torch ops (a lane a short row: carry-save
bit planes spread into byte-packed counts; eight lanes a long row, their
counts summed by the butterfly of ``reduce_group``), held against both
packages on
``hypothesis``-drawn rows; and in base 2 ``digitsum == gsize``, which
lets the kernel write one count to both tables.
"""

import numpy as np
import pytest
from hypothesis import given, settings, strategies as hs

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


# csrc/radix_hist.cu: kShort, kGroup, kPassVecs
SHORT, GROUP, PASS_VECS = 32, 8, 8
PASS_WORDS = 4 * GROUP * PASS_VECS


def _csa(a, b, c):
    """``csa``: a + b + c = 2 hi + lo, bit by bit."""
    u = a ^ b
    return (a & b) | (u & c), u ^ c


def _byte_counters(words):
    """The kernel's count of the last axis's words (zero-padded to
    fours): ``add4`` into six bit planes, then ``spread`` into byte-packed
    counts, byte q of counter j the count of digit 8q + j.  int32 ops:
    the arithmetic shifts move no sign bit under the masks."""
    words = torch.nn.functional.pad(words, (0, -words.shape[-1] % 4))
    p = [torch.zeros(words.shape[:-1], dtype=torch.int32) for _ in range(6)]
    for s in range(0, words.shape[-1], 4):
        a, b, c, d = (words[..., s + x] for x in range(4))
        twos_ab, p[0] = _csa(p[0], a, b)
        twos_cd, p[0] = _csa(p[0], c, d)
        fours, p[1] = _csa(p[1], twos_ab, twos_cd)
        for i in range(2, 6):
            p[i], fours = p[i] ^ fours, p[i] & fours
    return torch.stack([
        sum(((p[i] << (i - j)) if i >= j else (p[i] >> (j - i)))
            & (0x01010101 << i) for i in range(6))
        for j in range(8)], -1).to(torch.int32)


def _reduce_group(part):
    """``reduce_group`` over the GROUP lanes of axis 1: (n, GROUP, 8) byte
    counters -> (n, GROUP, 4) sums, lane g holding digits 2g, 2g + 1,
    2g + 16 and 2g + 17."""
    h = torch.cat([part & 0x00FF00FF, (part >> 8) & 0x00FF00FF], 2)
    gl = torch.arange(GROUP)
    n, s = 16, GROUP // 2
    while s > 0:
        up = ((gl & s) != 0)[None, :, None]
        lo, hi = h[:, :, : n // 2], h[:, :, n // 2: n]
        send, keep = torch.where(up, lo, hi), torch.where(up, hi, lo)
        h = keep + send[:, gl ^ s]                 # the partner lane's half
        n, s = n // 2, s // 2
    return torch.stack([h[..., 0] & 0xFFFF, h[..., 1] & 0xFFFF, h[..., 0] >> 16,
                        h[..., 1] >> 16], -1)


def kernel_counts(bias, deg, num_k):
    """The counts ``csrc/radix_hist.cu`` writes to both tables, replayed
    as it forms them (16-byte word layout, C % 4 == 0 or not: the sums do
    not depend on which lane holds a word).  A row of degree <= SHORT: one
    lane's byte counters over its words.  A longer row: passes of
    PASS_WORDS slots, slot s of a pass in lane ((s - base) // 4) % GROUP,
    each lane's byte counters summed by the group's butterfly; the
    passes' sums added."""
    V, C = bias.shape
    d = deg.clamp(0, C)
    w = torch.where(torch.arange(C)[None, :] < d[:, None], bias, 0)
    out = torch.zeros((V, 32), dtype=torch.int32)
    short = d <= SHORT
    acc = _byte_counters(w[short])
    out[short] = torch.stack([(acc[:, k % 8] >> (8 * (k // 8))) & 0xFF
                              for k in range(32)], 1)
    wl = w[~short]
    tot = torch.zeros((wl.shape[0], GROUP, 4), dtype=torch.int32)
    for base in range(0, C, PASS_WORDS):
        chunk = wl[:, base:base + PASS_WORDS]
        lane = (torch.arange(chunk.shape[1]) // 4) % GROUP
        part = torch.stack([_byte_counters(chunk[:, lane == g])
                            for g in range(GROUP)], 1)
        tot += _reduce_group(part)
    owned = torch.tensor([[2 * g, 2 * g + 1, 2 * g + 16, 2 * g + 17]
                          for g in range(GROUP)]).reshape(-1)
    long_counts = torch.zeros((wl.shape[0], 32), dtype=torch.int32)
    long_counts[:, owned] = tot.reshape(wl.shape[0], 32)
    out[~short] = long_counts
    return out[:, :num_k]


def _drawn_rows(seed, V, C, K):
    """Biases below 2^K and degrees 0..C, the short/long edge and 0 and C
    among them."""
    rng = np.random.default_rng(seed)
    bias = rng.integers(0, 1 << K, (V, C)).astype(np.int32)
    edge = [x for x in (0, 1, SHORT - 1, SHORT, SHORT + 1, C) if x <= C]
    deg = np.where(rng.random(V) < 0.5, rng.choice(edge, V),
                   rng.integers(0, C + 1, V)).astype(np.int32)
    return bias, deg


@settings(max_examples=25, deadline=None)
@given(seed=hs.integers(0, 2**32 - 1), V=hs.integers(1, 70),
       C=hs.sampled_from([1, 8, 33, 37, 64, 256, 300, 520]),
       K=hs.integers(1, 31))
def test_kernel_counting_matches_both_packages(seed, V, C, K):
    bias, deg = _drawn_rows(seed, V, C, K)
    got = kernel_counts(torch.from_numpy(bias), torch.from_numpy(deg), K)
    ds, gs = radix_hist_ref(torch.from_numpy(bias), torch.from_numpy(deg), K)
    jds, jgs = radix_hist_pallas(jnp.asarray(bias), jnp.asarray(deg), num_k=K,
                                 interpret=True)
    for want in (ds, gs, np.asarray(jds), np.asarray(jgs)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_bit_planes_spread_to_byte_counts():
    """``add4`` + ``spread`` give, byte by byte, the count of each digit
    position over up to 32 words (any int32, all ones included)."""
    rng = np.random.default_rng(2)
    words = torch.from_numpy(rng.integers(-2**31, 2**31, (200, 32)).astype(
        np.int32))
    words[0] = -1
    words[1, :5] = -1
    for n in (1, 4, 7, 16, 32):
        got = _byte_counters(words[:, :n])
        want = torch.stack([((words[:, :n] >> j) & 0x01010101).sum(
            -1, dtype=torch.int32) for j in range(8)], -1)
        np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("K", [16, 32])
def test_kernel_counting_of_full_rows_of_ones(K):
    """Every digit set in every slot of rows of 256 and 520 words (one
    and three passes): a lane's byte reaches 32, a half 256."""
    for C in (256, 520):
        bias = torch.full((3, C), -1, dtype=torch.int32)
        deg = torch.tensor([C, SHORT, SHORT + 1], dtype=torch.int32)
        got = kernel_counts(bias, deg, K)
        np.testing.assert_array_equal(got.numpy(),
                                      radix_hist_ref(bias, deg, K)[0].numpy())
        assert got[0].tolist() == [C] * K


@settings(max_examples=20, deadline=None)
@given(seed=hs.integers(0, 2**32 - 1), V=hs.integers(1, 40),
       C=hs.integers(1, 80), K=hs.integers(1, 32))
def test_base2_digit_sums_equal_group_sizes(seed, V, C, K):
    """Base 2: a digit is 0 or 1, its own nonzero flag, so ``digitsum ==
    gsize`` for any int32 biases, in both packages' references."""
    rng = np.random.default_rng(seed)
    bias = rng.integers(-2**31, 2**31, (V, C)).astype(np.int32)
    deg = rng.integers(-2, C + 3, V).astype(np.int32)
    ds, gs = radix_hist_ref(torch.from_numpy(bias), torch.from_numpy(deg), K)
    np.testing.assert_array_equal(ds.numpy(), gs.numpy())
    jds, jgs = ref.radix_hist_ref(jnp.asarray(bias), jnp.asarray(deg), K)
    np.testing.assert_array_equal(np.asarray(jds), np.asarray(jgs))
    np.testing.assert_array_equal(ds.numpy(), np.asarray(jds))
