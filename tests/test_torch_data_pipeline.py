"""The port's walk-corpus pipeline against the reference's, on the CPU.

``pack_walks`` bit for bit on random paths (terminated rows, rows too
short to keep, too few tokens for a row); a pipeline round fed the
reference's starts and walk seed (``ops.seed_from_key``) equal to the
reference's ``random_walk`` + ``pack_walks`` on its ``pallas`` walk
backend in interpret mode (the counter-hash stream the port's whole
walk shares; the reference backend draws through ``jax.random``); the
batches of both packages' pipelines across update rounds through both
packages' updaters; the port's own draws reproducible by seed.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.core import walks as j_walks
from repro.core.dyngraph import BingoConfig as JBingoConfig
from repro.core.updates import make_updater as j_make_updater
from repro.data.pipeline import WalkCorpusPipeline as JPipeline
from repro.data.pipeline import pack_walks as j_pack_walks
from repro.kernels.ops import seed_from_key
from repro_torch.core.dyngraph import BingoConfig, from_edges
from repro_torch.core.updates import make_updater
from repro_torch.data import WalkCorpusPipeline, pack_walks
from repro_torch.graph.rmat import degree_bias, rmat_edges
from tests.test_torch_state import assert_state_matches
from tests.test_torch_updates import _jax_state

SCALE, C, BITS = 6, 16, 8
V = 1 << SCALE
KW = dict(num_vertices=V, capacity=C, bias_bits=BITS)
WR, SEQ, BATCH = 8, 16, 4         # a round packs into about two batches


def graph():
    src, dst = rmat_edges(SCALE, 8, seed=0)
    return src, dst, degree_bias(src, dst, V, bias_bits=BITS)


def random_paths(rng, W, L):
    """(W, L+1) paths as walks leave them: a live prefix, then -1."""
    paths = rng.integers(0, V, (W, L + 1)).astype(np.int32)
    live = rng.integers(0, L + 2, W)
    paths[np.arange(L + 1)[None, :] >= live[:, None]] = -1
    return paths


@pytest.mark.parametrize("W,L,seq_len", [(40, 7, 9), (300, 16, 64),
                                         (3, 2, 50), (1, 0, 4)])
def test_pack_walks_matches_jax(W, L, seq_len):
    rng = np.random.default_rng(W + L)
    for _ in range(4):
        paths = random_paths(rng, W, L)
        got = pack_walks(paths, seq_len, V)
        want = j_pack_walks(paths, seq_len, V)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        assert got.shape[1] == seq_len + 1


class FedPipeline(WalkCorpusPipeline):
    """The port's pipeline drawing each producer's starts and walk seed
    from the reference's key chain (``repro.data.pipeline``'s splits)."""

    def __init__(self, *args, seed=0, **kw):
        super().__init__(*args, seed=seed, **kw)
        self.key = jax.random.key(seed)

    def _draw(self):
        self.key, k1, k2 = jax.random.split(self.key, 3)
        starts = jax.random.randint(k1, (self.Wr,), 0, self.cfg.num_vertices
                                    ).astype(jnp.int32)
        return (torch.from_numpy(np.array(starts, copy=True)),
                int(seed_from_key(k2)[0]))


@pytest.fixture(scope="module")
def pair():
    src, dst, w = graph()
    cfg = BingoConfig(**KW)
    jcfg = JBingoConfig(backend="pallas", **KW)
    state = from_edges(cfg, src, dst, w, device="cpu")
    return src, dst, w, cfg, jcfg, state


def test_fed_round_matches_jax_walk_and_pack(pair):
    """One round: the reference's walk of the same starts and key, and its
    packing, through the port's ``walk`` and ``produce``."""
    *_, cfg, jcfg, state = pair
    jstate = _jax_state(state)
    pipe = WalkCorpusPipeline(state, cfg, walkers_per_round=WR, seq_len=SEQ,
                              batch_size=BATCH)
    jwalk = jax.jit(lambda st, s, k: j_walks.random_walk(
        st, jcfg, s, k, j_walks.WalkParams(kind="deepwalk", length=16)))
    for r in range(2):
        key = jax.random.key(100 + r)
        starts = np.random.default_rng(r).integers(0, V, WR).astype(np.int32)
        want = np.asarray(jwalk(jstate, jnp.asarray(starts), key))
        paths = pipe.walk(torch.from_numpy(starts), int(seed_from_key(key)[0]))
        np.testing.assert_array_equal(paths.numpy(), want)
        packed = pipe.produce(paths)
        np.testing.assert_array_equal(packed, j_pack_walks(want, SEQ, V))
    assert pipe.rounds == 2


def test_batches_match_jax_across_update_rounds(pair):
    """Both packages' pipelines, the port's fed the reference's draws;
    an update round through each package's updater every two batches."""
    src, dst, w, cfg, jcfg, state = pair
    state = from_edges(cfg, src, dst, w, device="cpu")
    jstate = _jax_state(state)
    jpipe = JPipeline(jstate, jcfg, walkers_per_round=WR, seq_len=SEQ,
                      batch_size=BATCH, seed=3)
    tpipe = FedPipeline(state, cfg, walkers_per_round=WR, seq_len=SEQ,
                        batch_size=BATCH, seed=3)
    jupd = j_make_updater(jcfg, backend="reference")
    tupd = make_updater(cfg)
    rng = np.random.default_rng(9)
    for i in range(8):
        if i and i % 2 == 0:
            n = 24
            lanes = (rng.random(n) < 0.7,
                     rng.integers(0, V, n).astype(np.int32),
                     rng.integers(0, V, n).astype(np.int32),
                     rng.integers(1, 1 << BITS, n).astype(np.int32))
            jstate, jst = jupd(jstate, *map(jnp.asarray, lanes))
            state, st = tupd(state, *map(torch.from_numpy, lanes))
            assert int(st.ins_applied) == int(jst.ins_applied)
            assert_state_matches(jstate, state, fp=False)
            jpipe.update_graph(jstate)
            tpipe.update_graph(state)
        jb, tb = next(jpipe), next(tpipe)
        for k in ("inputs", "targets"):
            assert tb[k].dtype == torch.int32 and tb[k].shape == (BATCH, SEQ)
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]),
                                          err_msg=f"batch {i} {k}")
        np.testing.assert_array_equal(tb["inputs"][:, 1:].numpy(),
                                      tb["targets"][:, :-1].numpy())
    assert tpipe.rounds >= 4          # rounds sampled after each update


def test_own_draws_repeat_by_seed(pair):
    *_, cfg, _, state = pair

    def batches(seed, over=1, n=4):
        pipe = WalkCorpusPipeline(state, cfg, walkers_per_round=WR,
                                  seq_len=SEQ, batch_size=BATCH, seed=seed,
                                  overprovision=over)
        out = [next(pipe)["inputs"] for _ in range(n)]
        return torch.stack(out), pipe

    a, pa = batches(0)
    b, _ = batches(0)
    c, _ = batches(1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert int(a.max()) <= V and int(a.min()) >= 0      # vertex ids, sep V
    d, pd = batches(0, over=3)
    assert pd.rounds % 3 == 0 and pd.rounds // 3 >= 1   # 3 producers a round
    assert pa.rounds >= 1
