"""Each CUDA kernel against its plain PyTorch version, bit for bit, on the card.

The sweeps of ``tests/test_torch_walks.py`` and
``tests/test_torch_updates.py``: whole walks (deepwalk/ppr/simple × base
2/4 × fp on/off × fed/hashed uniforms, a ragged batch) and update rounds
(insert/delete/mixed × the five config rows, chained, plus a batch wider
than 2·C).  A CUDA kernel has no CPU mode, so these tests carry the
``cuda`` marker and skip where there is no card.  The file imports
nothing of JAX, so on a card without JAX it runs with
``PYTHONPATH=src python -m pytest -q --noconftest -m cuda
tests/test_torch_kernels_cuda.py``.
"""

import numpy as np
import pytest

import torch

from repro_torch.core import dyngraph as tdg
from repro_torch.core.updates import batched_update
from repro_torch.kernels import ops
from repro_torch.kernels.walk_fused import walk_fused_ref

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


def random_graph(V, C, *, max_bias, seed):
    rng = np.random.default_rng(seed)
    d = rng.integers(1, C // 2 + 1, V)
    src = np.repeat(np.arange(V), d).astype(np.int32)
    dst = rng.integers(0, V, src.size).astype(np.int32)
    return src, dst, rng.integers(1, max_bias + 1, src.size).astype(np.int32)


def make_round(rng, V, edges, Bn, mode, fp=False):
    """One update batch as numpy arrays (deletes mostly hit live edges)."""
    ins = {"insert": np.ones(Bn, bool), "delete": np.zeros(Bn, bool),
           "mixed": rng.random(Bn) < 0.5}[mode]
    uu = rng.integers(0, V, Bn).astype(np.int32)
    vv = rng.integers(0, V, Bn).astype(np.int32)
    ww = rng.integers(1, 32, Bn).astype(np.int32)
    for i in range(Bn):
        if not ins[i] and rng.random() < 0.8:
            uu[i], vv[i] = edges[int(rng.integers(len(edges)))]
    if fp:
        ww = ww.astype(np.float32) + rng.random(Bn).astype(np.float32)
    return ins, uu, vv, ww


def _state(V, C, fp, base_log2, adaptive=True, seed=5, bits=6):
    src, dst, w = random_graph(V, C, max_bias=(1 << bits) - 1, seed=seed)
    wf = w.astype(np.float32) + 0.37 if fp else w
    cfg = tdg.BingoConfig(num_vertices=V, capacity=C, bias_bits=bits,
                          base_log2=base_log2, fp_bias=fp, lam=4.0,
                          adaptive=adaptive)
    return tdg.from_edges(cfg, src, dst, wf, device="cuda"), cfg


def _clone(st):
    return tdg.BingoState(*[None if x is None else
                            (type(x)(*[y.clone() for y in x])
                             if isinstance(x, tuple) else x.clone())
                            for x in st])


def assert_same(a, b):
    for x, y in zip(tdg.state_to_numpy(a), tdg.state_to_numpy(b)):
        if isinstance(x, tuple):
            for p, q in zip(x, y):
                np.testing.assert_array_equal(p, q)
        elif x is None:
            assert y is None
        else:
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("fed", [True, False])
@pytest.mark.parametrize("base_log2,fp", [(1, False), (2, False), (1, True),
                                          (2, True)])
@pytest.mark.parametrize("kind", ["deepwalk", "ppr", "simple"])
def test_walk_kernel_equals_plain(kind, base_log2, fp, fed):
    st, cfg = _state(40, 64, fp, base_log2)
    B, L = 301, 12
    starts = torch.arange(B, dtype=torch.int32, device="cuda") % cfg.num_vertices
    g = torch.Generator(device="cuda").manual_seed(3)
    u = torch.rand((L, B, 6), generator=g, device="cuda") if fed else None
    kw = dict(base_log2=base_log2, stop_prob=0.15 if kind == "ppr" else 0.0,
              uniform=kind == "simple")
    frac = st.frac if fp else None
    args = (st.itable.prob, st.itable.alias, st.bias, st.nbr, st.deg, frac,
            starts)
    before = ops.launch_counts()["walk_fused"]
    got = ops.walk_fused(*args, 12345, u, length=L, **kw)
    assert ops.launch_counts()["walk_fused"] == before + 1
    want = walk_fused_ref(*args, u, seed=12345, length=L, **kw)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.parametrize("mode", ["insert", "delete", "mixed"])
@pytest.mark.parametrize("adaptive,fp,base_log2",
                         [(True, False, 1), (False, False, 1), (True, True, 1),
                          (True, False, 2), (True, True, 2)])
def test_update_kernel_equals_plain(mode, adaptive, fp, base_log2):
    V, C = 24, 32
    st, cfg = _state(V, C, fp, base_log2, adaptive=adaptive, seed=4)
    ref = _clone(st)
    rng = np.random.default_rng(base_log2 * 7 + fp * 3 + adaptive)
    nbr = st.nbr.cpu().numpy()
    edges = [(u, int(v)) for u in range(V) for v in nbr[u][nbr[u] >= 0]]
    for _ in range(3):
        batch = [torch.from_numpy(x).cuda()
                 for x in make_round(rng, V, edges, 40, mode, fp)]
        ref, s_ref = batched_update(ref, cfg, *batch)
        st, s_got = ops.update_fused(st, cfg, *batch)
        torch.cuda.synchronize()
        assert_same(ref, st)
        for a, b in zip(s_ref[:4], s_got[:4]):
            np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())


def test_update_kernel_batch_wider_than_twice_capacity():
    V, C = 6, 4
    cfg = tdg.BingoConfig(num_vertices=V, capacity=C, bias_bits=5)
    st = tdg.from_edges(cfg, np.array([0, 0, 0, 1]), np.array([1, 2, 2, 3]),
                        np.array([3, 5, 7, 9]), device="cuda")
    ref = _clone(st)
    rng = np.random.default_rng(11)
    Bn = 48
    batch = [torch.from_numpy(x).cuda() for x in (
        rng.random(Bn) < 0.4,
        np.where(rng.random(Bn) < 0.85, 0,
                 rng.integers(-1, V + 1, Bn)).astype(np.int32),
        rng.integers(0, 4, Bn).astype(np.int32),
        rng.integers(1, 32, Bn).astype(np.int32))]
    ref, s_ref = batched_update(ref, cfg, *batch)
    st, s_got = ops.update_fused(st, cfg, *batch)
    assert_same(ref, st)
    for a, b in zip(s_ref[:4], s_got[:4]):
        np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())


def test_cuda_tensors_never_take_the_plain_path():
    """A CUDA state goes to the kernels: the launch counters move."""
    st, cfg = _state(16, 32, False, 1)
    ops.reset_launch_counts()
    ops.update_fused(st, cfg, *[torch.from_numpy(x).cuda() for x in (
        np.array([True]), np.array([0], np.int32), np.array([3], np.int32),
        np.array([5], np.int32))])
    ops.walk_fused(st.itable.prob, st.itable.alias, st.bias, st.nbr, st.deg,
                   None, torch.zeros(4, dtype=torch.int32, device="cuda"), 1,
                   length=4)
    assert ops.launch_counts() == {"walk_fused": 1, "update_fused": 1}
