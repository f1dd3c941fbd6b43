"""Each CUDA kernel against its plain PyTorch version, bit for bit, on the card.

The sweeps of ``tests/test_torch_walks.py``,
``tests/test_torch_walk_segment.py``, ``tests/test_torch_walk_sample.py``
and ``tests/test_torch_updates.py``: whole walks and segment walks
(deepwalk/ppr/simple × base 2/4 × fp on/off × fed/hashed uniforms, a
ragged batch; segments on a relay view with spread start steps),
per-step samples (base 2/4 × fp on/off × gathered rows / in-place
``rows``, degree-0 rows in the batch); the same three sampler entries at
C = 256 on rows whose degrees sit around the sampler's 8-lane tile, its
32-slot first tile, its 16-byte chunks and the 256-slot window (0, 1,
3–5, 7–9, 15–17, 31–33, 63–65, 127–129, 255, 256), with a full hub row
shared by many walkers, and at C = 37 (rows not 16-byte aligned),
C = 300 (rows past the window) and C = 512 (the serving ladder's regrown
width); update rounds
(insert/delete/mixed × the five config rows, chained, plus a batch wider
than 2·C; mixed rounds at C = 37, 256, 300 and 512; a round on
``chip_smoke.streamed_state``'s states, which went through
``stream_updates`` first: a full row, an emptied row, stale member lists,
a DENSE -> ONE rebuild), the prep kernels against ``plan_round``'s torch
ops on the CPU, and a round under ``set_sync_debug_mode("error")``; the
guard's classifier against its torch ops on the CPU, and a deferred
guarded ingest under ``set_sync_debug_mode("error")``; a shard's
classifier (its rows of the state) against the CPU, and on a one-rank
NCCL group a sharded engine's deferred guarded ingest, with the
classifier's and the stats' ``all_reduce``s, under the same mode; the
segment entry at C = 512 over the relay sweep; an
``AsyncCheckpointer`` snapshot with in-place rounds right after it; the
radix histogram (K 1/4/16/31/32 × C 8/37/256, degrees on both sides of
its 32-slot short rows in every lane position; an R-MAT scale-12 state
against its own counters), the uniform pick (B 1, 3, 4, 5 and 262,147 ×
1/3/5 uniform columns × rows in place or gathered, degree-0 rows first,
last and at each residue of four) and
batched alias tables (``chip_smoke.ALIAS_KS``: K 1 to 64 over the warp
layouts, on ``alias_weights``' all-zero, single-entry, equal and
near-1e-30 rows), bit for bit; flash attention at ``chip_smoke.py``'s
phase-2 cases and limits (``FLASH_CASES``, head dims 8, 16, 64, 80,
128, 136, 200, 256, 320, 384 and 512, in float32, bfloat16 and float16;
``flash_limit``: ``FLASH_TOL`` in f32, the row-wise ``FLASH_ROW`` in 16
bits), which must also reject the kernel one tile off at the band's
edge, and the inputs the card declines (D > 512, float64).  The segment
entry runs at four occupancies of its slots (mixed, all free, about 5 %
live, all live), and on each vertex shard of a (2, 2) vertex × walker
layout, its slots carrying the walker group's global ids (``wid_base``
past 0) and the gathered columns of the global uniforms.  The comparison
samplers (``core/baselines.py``) draw on CUDA tensors in distribution
(chi-square against the row's normalised biases), before and after
updates.  The LM side (which launches none of the kernels): every
registry arch's SMOKE config on the card against the same params on the
CPU (``forward``, and ``decode_step`` over 16 positions; ``lm_cpu_limit``), and the decode
engine on the card answering with the CPU engine's greedy tokens.  Training: every SMOKE
arch's ``loss_fn`` and gradients on the card against the CPU; remat and microbatches against
the plain step on the card; the walk-corpus pipeline's batches on the card equal to the CPU's
for the same seed (the whole-walk kernel against its plain version); a bfloat16-moment
checkpoint round trip; ``launch.train`` defaulting to the card and resuming there.  The dry
run: B1, B3, B4a and B2's wrappers launch once on CUDA tensors and never on
fake ones (the kernel's output shapes), and ``chip_smoke.py`` phase 3k's
one-rank cells against their dry run (``rank_cell_checks``).  A CUDA kernel has no
CPU mode, so these tests carry the ``cuda`` marker and skip where there
is no card.  The file imports
nothing of JAX, so on a card without JAX it runs with
``PYTHONPATH=src python -m pytest -q --noconftest -m cuda
tests/test_torch_kernels_cuda.py``.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

import torch

from repro_torch.configs import ARCHS, smoke_config
from repro_torch.core import dyngraph as tdg
from repro_torch.core.updates import batched_update
from repro_torch.kernels import ops
from repro_torch.distributed.relay import relay_view
from repro_torch.kernels.alias_build import alias_build_ref
from repro_torch.kernels.radix_hist import radix_hist_ref
from repro_torch.kernels.walk_fused import walk_fused_ref, walk_segment_ref
from repro_torch.kernels.walk_sample import (walk_sample_ref,
                                            walk_sample_uniform_ref)
from repro_torch.models import forward, init_model
from repro_torch.serve import DecodeEngine, ServeRequest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import (ALIAS_KS, FLASH_CASES,  # noqa: E402
                        STREAMED_CAPACITIES, TRAIN_GRAD_TOL, UPDATE_CONFIGS,
                        alias_weights, bf16_checkpoint_check, flash_inputs,
                        flash_limit, flash_refs, flash_route, grad_excess,
                        hist_inputs, lm_cpu_limit, lm_logits_decode,
                        shifted_window, stale_lists, streamed_state,
                        train_driver_check, train_smoke_arch, tree_excess)

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


@pytest.mark.parametrize("occupancy", ["mixed", "all free", "sparse",
                                       "all live"])
@pytest.mark.parametrize("fed", [True, False])
@pytest.mark.parametrize("base_log2,fp", [(1, False), (2, False), (1, True),
                                          (2, True)])
@pytest.mark.parametrize("kind", ["deepwalk", "ppr", "simple"])
def test_segment_kernel_equals_plain(kind, base_log2, fp, fed, occupancy):
    """The segment entry on a relay view (remote neighbours -(g+2)) with a
    permuted slot → walker id map, at four occupancies: mixed (free slots,
    start steps over [0, L+1] with L and L+1 present), all free, sparse
    (about 5 % live at scattered slots with scattered start steps, t0 = L
    among them) and all live at step 0."""
    st, cfg = _state(40, 64, fp, base_log2)
    view = relay_view(st, 10, 20)
    assert bool((view.nbr <= -2).any())
    B, L = 2000, 12
    g = torch.Generator(device="cuda").manual_seed(5)
    starts = torch.randint(-1, 20, (B,), generator=g, device="cuda",
                           dtype=torch.int32)
    t0 = torch.randint(0, L + 2, (B,), generator=g, device="cuda",
                       dtype=torch.int32)
    t0[:2] = torch.tensor([L, L + 1], dtype=torch.int32)
    if occupancy == "all free":
        starts[:] = -1
    elif occupancy == "sparse":
        live = torch.randperm(B, generator=g, device="cuda")[: B // 20]
        starts[:] = -1
        starts[live] = torch.randint(0, 20, (len(live),), generator=g,
                                     device="cuda", dtype=torch.int32)
        t0[:] = L + 1
        t0[live] = torch.randint(0, L + 1, (len(live),), generator=g,
                                 device="cuda", dtype=torch.int32)
        t0[live[::7]] = L
    elif occupancy == "all live":
        starts = starts.clamp(min=0)
        t0[:] = 0
    wid = torch.randperm(B, generator=g, device="cuda").to(torch.int32) + 3
    u = torch.rand((L, B, 6), generator=g, device="cuda") if fed else None
    kw = dict(base_log2=base_log2, stop_prob=0.15 if kind == "ppr" else 0.0,
              uniform=kind == "simple", length=L)
    args = (view.itable.prob, view.itable.alias, view.bias, view.nbr,
            view.deg, view.frac if fp else None, starts, t0)
    before = ops.launch_counts()["walk_segment"]
    got = ops.walk_segment(*args, 12345, u, wid, **kw)
    assert ops.launch_counts()["walk_segment"] == before + 1
    want = walk_segment_ref(*args, u, wid, seed=12345, **kw)
    torch.cuda.synchronize()
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x.cpu().numpy(), y.cpu().numpy())
    if occupancy == "all free":
        assert bool((got[0] == -1).all()) and bool((got[1] == -1).all())
    else:
        assert bool((got[1][:, 0] >= 0).any())


@pytest.mark.parametrize("in_place", [True, False])
@pytest.mark.parametrize("base_log2,fp", [(1, False), (2, False), (1, True),
                                          (2, True)])
def test_walk_sample_kernels_equal_plain(base_log2, fp, in_place):
    """Per-step samples from every vertex (degree-0 rows included), with
    the rows read in place or gathered first."""
    st, cfg = _state(40, 64, fp, base_log2)
    st.deg[::7] = 0                                # empty rows in the batch
    B = 997
    g = torch.Generator(device="cuda").manual_seed(base_log2 + 2 * fp)
    rows = torch.randint(0, cfg.num_vertices, (B,), generator=g,
                         device="cuda", dtype=torch.int32)
    u = torch.rand((B, 5), generator=g, device="cuda")
    frac = st.frac if fp else None
    tabs = (st.itable.prob, st.itable.alias, st.bias, st.nbr, st.deg)
    if in_place:
        args, kw = tabs, dict(rows=rows)
    else:
        r = rows.long()
        args, kw = tuple(x[r].contiguous() for x in tabs), {}
        frac = None if frac is None else frac[r].contiguous()
    before = dict(ops.launch_counts())
    got = ops.walk_sample(*args, u, frac, base_log2=base_log2, **kw)
    want = walk_sample_ref(*args, u, frac, base_log2=base_log2, **kw)
    got_u = ops.walk_sample_uniform(args[3], args[4], u[:, 2:3].contiguous(),
                                    **kw)
    want_u = walk_sample_uniform_ref(args[3], args[4], u[:, 2:3], **kw)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after["walk_sample"] == before["walk_sample"] + 1
    assert after["walk_sample_uniform"] == before["walk_sample_uniform"] + 1
    for a, b in zip(got + got_u, want + want_u):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())
    assert (got[0][st.deg[rows.long()] == 0] == -1).all()


def test_walk_sample_base2_takes_three_uniforms():
    st, cfg = _state(16, 32, False, 1)
    rows = torch.arange(16, dtype=torch.int32, device="cuda")
    u = torch.rand((16, 3), device="cuda")
    tabs = (st.itable.prob, st.itable.alias, st.bias, st.nbr, st.deg)
    got = ops.walk_sample(*tabs, u, rows=rows)
    want = walk_sample_ref(*tabs, u, rows=rows)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())


# degrees around the sampler's 8-lane tile, its 32-slot first tile, its
# 16-byte chunks and its 256-slot window, on a C = 256 state
DEGREES = (0, 1, 3, 4, 5, 7, 8, 9, 15, 16, 17, 31, 32, 33, 63, 64, 65, 127,
           128, 129, 255, 256)
WIDE_MODES = [(1, False), (2, False), (1, True), (2, True)]


def _wide_state(fp, base_log2, V=512, C=256, bits=8, seed=21,
                degrees=DEGREES):
    """Vertex 0 a full hub row, vertices 1.. the ``degrees``, the rest of
    degree 1–4; distinct neighbours, random biases (+ fractions in fp)."""
    rng = np.random.default_rng(seed + 3 * base_log2 + fp)
    deg = rng.integers(1, 5, V)
    deg[0] = C
    deg[1:1 + len(degrees)] = degrees
    src = np.repeat(np.arange(V), deg).astype(np.int32)
    dst = np.concatenate([rng.permutation(V)[:d] for d in deg]).astype(np.int32)
    w = rng.integers(1, 1 << bits, src.size).astype(np.int32)
    if fp:
        w = w.astype(np.float32) + rng.random(src.size).astype(np.float32)
    cfg = tdg.BingoConfig(num_vertices=V, capacity=C, bias_bits=bits,
                          base_log2=base_log2, fp_bias=fp, lam=4.0)
    st = tdg.from_edges(cfg, src, dst, w, device="cuda")
    assert st.deg[1:1 + len(degrees)].tolist() == list(degrees)
    return st, cfg


def _wide_rows(B, V, seed, n=len(DEGREES)):
    """Half the walkers on the hub row 0, the rest over the ``n`` rows
    of the listed degrees and then anywhere."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    rows = torch.randint(0, V, (B,), generator=g, device="cuda",
                         dtype=torch.int32)
    rows[: B // 2] = 0
    rows[B // 2: B // 2 + 4 * n] = torch.arange(
        4 * n, device="cuda", dtype=torch.int32) % n + 1
    return rows


@pytest.mark.parametrize("base_log2,fp", WIDE_MODES)
@pytest.mark.parametrize("kind", ["deepwalk", "ppr", "simple"])
def test_wide_rows_walk_kernel_equals_plain(kind, base_log2, fp):
    st, cfg = _wide_state(fp, base_log2)
    B, L = 700, 16
    starts = _wide_rows(B, cfg.num_vertices, 7)
    kw = dict(base_log2=base_log2, stop_prob=0.1 if kind == "ppr" else 0.0,
              uniform=kind == "simple")
    args = (st.itable.prob, st.itable.alias, st.bias, st.nbr, st.deg,
            st.frac if fp else None, starts)
    before = ops.launch_counts()["walk_fused"]
    got = ops.walk_fused(*args, 4242, length=L, **kw)
    assert ops.launch_counts()["walk_fused"] == before + 1
    want = walk_fused_ref(*args, seed=4242, length=L, **kw)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.parametrize("base_log2,fp", WIDE_MODES)
@pytest.mark.parametrize("kind", ["deepwalk", "ppr", "simple"])
def test_wide_rows_segment_kernel_equals_plain(kind, base_log2, fp):
    """The segment entry on a relay view of the C = 256 state (rows
    0..255 local, the rest remote), start steps spread, free slots."""
    st, cfg = _wide_state(fp, base_log2)
    view = relay_view(st, 0, 256)
    B, L = 700, 16
    g = torch.Generator(device="cuda").manual_seed(9)
    starts = _wide_rows(B, 256, 9)
    starts[-50:] = -1                                   # free slots
    t0 = torch.randint(0, L + 2, (B,), generator=g, device="cuda",
                       dtype=torch.int32)
    t0[: B // 2] = 0
    wid = torch.randperm(B, generator=g, device="cuda").to(torch.int32)
    kw = dict(base_log2=base_log2, stop_prob=0.1 if kind == "ppr" else 0.0,
              uniform=kind == "simple", length=L)
    args = (view.itable.prob, view.itable.alias, view.bias, view.nbr,
            view.deg, view.frac if fp else None, starts, t0)
    before = ops.launch_counts()["walk_segment"]
    got = ops.walk_segment(*args, 99, None, wid, **kw)
    assert ops.launch_counts()["walk_segment"] == before + 1
    want = walk_segment_ref(*args, None, wid, seed=99, **kw)
    torch.cuda.synchronize()
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x.cpu().numpy(), y.cpu().numpy())
    assert bool((got[1][:, 0] >= 0).any())


@pytest.mark.parametrize("in_place", [True, False])
@pytest.mark.parametrize("base_log2,fp", WIDE_MODES)
def test_wide_rows_walk_sample_kernels_equal_plain(base_log2, fp, in_place):
    st, cfg = _wide_state(fp, base_log2)
    B = 3001
    rows = _wide_rows(B, cfg.num_vertices, 11)
    g = torch.Generator(device="cuda").manual_seed(12)
    u = torch.rand((B, 5), generator=g, device="cuda")
    frac = st.frac if fp else None
    tabs = (st.itable.prob, st.itable.alias, st.bias, st.nbr, st.deg)
    if in_place:
        args, kw = tabs, dict(rows=rows)
    else:
        r = rows.long()
        args, kw = tuple(x[r].contiguous() for x in tabs), {}
        frac = None if frac is None else frac[r].contiguous()
    before = dict(ops.launch_counts())
    got = ops.walk_sample(*args, u, frac, base_log2=base_log2, **kw)
    want = walk_sample_ref(*args, u, frac, base_log2=base_log2, **kw)
    got_u = ops.walk_sample_uniform(args[3], args[4], u, **kw)
    want_u = walk_sample_uniform_ref(args[3], args[4], u, **kw)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after["walk_sample"] == before["walk_sample"] + 1
    assert after["walk_sample_uniform"] == before["walk_sample_uniform"] + 1
    for a, b in zip(got + got_u, want + want_u):
        np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())
    assert (got[1][: B // 2] >= 0).all()                # the hub row


@pytest.mark.parametrize("base_log2,fp", [(1, False), (2, True)])
@pytest.mark.parametrize("C", [37, 300, 512, 1024, 2048])
def test_unaligned_and_long_rows_equal_plain(C, base_log2, fp):
    """Capacities the sampler's 16-byte loads cannot take (C = 37: rows
    not 16-byte aligned) and rows past its 256-slot window (C = 300,
    degrees up to 300; C = 512, the serving ladder's regrown width,
    degrees up to 512; C = 1024 and 2048 at 16 bias bits, FULL's widths
    and its capacity-ladder top tier): whole walks (deepwalk, simple), the
    segment entry and the per-step samples (in place and gathered), bit
    for bit."""
    degrees = tuple(d for d in (0, 1, 3, 4, 5, 15, 16, 17, 31, 32, 33, 36,
                                37, 255, 256, 257, 299, 300, 511, 512, 513,
                                1023, 1024, 1025, 2047, 2048)
                    if d <= C)
    st, cfg = _wide_state(fp, base_log2, V=max(640, C + 64), C=C,
                          bits=16 if C >= 1024 else 8, degrees=degrees)
    V, B, L = cfg.num_vertices, 600, 12
    rows = _wide_rows(B, V, 13, n=len(degrees))
    tabs = (st.itable.prob, st.itable.alias, st.bias, st.nbr, st.deg)
    frac = st.frac if fp else None
    for uniform in (False, True):
        kw = dict(base_log2=base_log2, uniform=uniform, length=L)
        got = ops.walk_fused(*tabs, frac, rows, 77, **kw)
        want = walk_fused_ref(*tabs, frac, rows, seed=77, **kw)
        np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    view = relay_view(st, 0, 320)
    vtabs = (view.itable.prob, view.itable.alias, view.bias, view.nbr,
             view.deg, view.frac if fp else None)
    t0 = torch.zeros(B, dtype=torch.int32, device="cuda")
    starts = rows % 320
    got = ops.walk_segment(*vtabs, starts, t0, 78, length=L,
                           base_log2=base_log2)
    want = walk_segment_ref(*vtabs, starts, t0, length=L,
                            base_log2=base_log2, seed=78)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x.cpu().numpy(), y.cpu().numpy())
    u = torch.rand((B, 5), generator=torch.Generator(device="cuda")
                   .manual_seed(14), device="cuda")
    r = rows.long()
    for args, fr, kw in ((tabs, frac, dict(rows=rows)),
                         (tuple(x[r].contiguous() for x in tabs),
                          None if frac is None else frac[r].contiguous(), {})):
        got = ops.walk_sample(*args, u, fr, base_log2=base_log2, **kw)
        want = walk_sample_ref(*args, u, fr, base_log2=base_log2, **kw)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())
    torch.cuda.synchronize()


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


def _same_stats(s_ref, s_got):
    for a, b in zip(s_ref[:4], s_got[:4]):
        np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())


@pytest.mark.parametrize("C", [37, 256, 300, 512, 1024, 2048])
@pytest.mark.parametrize("adaptive,fp,base_log2", UPDATE_CONFIGS)
def test_update_kernel_unaligned_and_wide_rows(C, adaptive, fp, base_log2):
    """Mixed rounds at a capacity that is not a multiple of 32, at the
    main path's 256, past it, at the regrown 512 (fewer rows a block) and
    at FULL's 1024 and its top tier's 2048 with 16 bias bits; rows of
    degree up to C // 2 + a round."""
    V = 24
    st, cfg = _state(V, C, fp, base_log2, adaptive=adaptive, seed=C,
                     bits=16 if C >= 1024 else 6)
    ref = _clone(st)
    rng = np.random.default_rng(C + base_log2 * 7 + fp * 3 + adaptive)
    nbr = st.nbr.cpu().numpy()
    edges = [(u, int(v)) for u in range(V) for v in nbr[u][nbr[u] >= 0]]
    for _ in range(2):
        batch = [torch.from_numpy(x).cuda()
                 for x in make_round(rng, V, edges, 3 * C, "mixed", fp)]
        ref, s_ref = batched_update(ref, cfg, *batch)
        st, s_got = ops.update_fused(st, cfg, *batch)
        assert_same(ref, st)
        _same_stats(s_ref, s_got)


@pytest.mark.parametrize("C", STREAMED_CAPACITIES)
@pytest.mark.parametrize("adaptive,fp,base_log2", UPDATE_CONFIGS)
def test_update_kernel_after_streaming_equals_plain(C, adaptive, fp,
                                                    base_log2):
    st, cfg = streamed_state(C, adaptive, fp, base_log2, seed=C + base_log2)
    assert stale_lists(st, cfg)     # full and empty rows, stale lists
    ref = _clone(st)
    rng = np.random.default_rng(C)
    nbr = st.nbr.cpu().numpy()
    edges = [(u, int(v)) for u in range(16) for v in nbr[u][nbr[u] >= 0]]
    ins, uu, vv, ww = make_round(rng, 16, edges, 64, "mixed", fp)
    uu[:24] = np.repeat(np.arange(8), 3)         # every streamed row
    batch = [torch.from_numpy(x).cuda() for x in (ins, uu, vv, ww)]
    ref, s_ref = batched_update(ref, cfg, *batch)
    st, s_got = ops.update_fused(st, cfg, *batch)
    assert_same(ref, st)
    _same_stats(s_ref, s_got)
    assert int(s_got.transitions.sum()) > 0


@pytest.mark.parametrize("adaptive,fp,base_log2", UPDATE_CONFIGS)
def test_update_plan_kernels_equal_plain(adaptive, fp, base_log2):
    """The prep kernels against plan_round's torch ops on the CPU."""
    from repro_torch.kernels.update_fused import plan_round
    V = 24
    st, cfg = _state(V, 32, fp, base_log2, adaptive=adaptive, seed=4)
    rng = np.random.default_rng(9)
    nbr = st.nbr.cpu().numpy()
    edges = [(u, int(v)) for u in range(V) for v in nbr[u][nbr[u] >= 0]]
    ins, uu, vv, ww = make_round(rng, V, edges, 300, "mixed", fp)
    uu[:20] = rng.integers(-3, V + 3, 20)        # out-of-range lanes
    vv[20:30] = -1
    act = rng.random(300) < 0.9
    lanes = [torch.from_numpy(x) for x in (ins, uu, vv, ww, act)]
    want = plan_round(cfg, *lanes)
    got = plan_round(cfg, *[x.cuda() for x in lanes])
    for f, a, b in zip(want._fields, got, want):
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a.cpu().numpy(), b.numpy(), err_msg=f)


def test_update_round_makes_no_host_sync():
    st, cfg = _state(64, 37, True, 2, seed=3)
    rng = np.random.default_rng(2)
    nbr = st.nbr.cpu().numpy()
    edges = [(u, int(v)) for u in range(64) for v in nbr[u][nbr[u] >= 0]]
    batch = [torch.from_numpy(x).cuda()
             for x in make_round(rng, 64, edges, 500, "mixed", True)]
    ops.update_fused(_clone(st), cfg, *batch)   # built and loaded
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ops.update_fused(st, cfg, *batch)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def _guard_round(V, C, seed):
    """A state with full rows and a dirty round on the card: out-of-range
    lanes, zero weights, absent deletes, deletes of same-round inserts,
    capacity overflows."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, C + 1, V)
    deg[:4] = C
    src = np.repeat(np.arange(V), deg).astype(np.int32)
    dst = rng.integers(0, 16, src.size).astype(np.int32)
    w = rng.integers(1, 64, src.size).astype(np.int32)
    cfg = tdg.BingoConfig(num_vertices=V, capacity=C, bias_bits=6)
    st = tdg.from_edges(cfg, src, dst, w, device="cuda")
    B = 2048
    ins = rng.random(B) < 0.6
    uu = rng.integers(-2, V + 2, B).astype(np.int32)
    uu[:256] = rng.integers(0, 4, 256)
    vv = rng.integers(-1, 17, B).astype(np.int32)
    ww = rng.integers(0, 64, B).astype(np.int32)
    lanes = [torch.from_numpy(x).cuda() for x in (ins, uu, vv, ww)]
    return st, cfg, lanes


@pytest.mark.parametrize("dup", [False, True])
def test_guard_classifier_on_the_card_equals_cpu_and_never_syncs(dup):
    """The guard's classifier on CUDA tensors: reasons equal the same
    torch ops on the CPU (themselves held to JAX in
    ``tests/test_torch_guard.py``), the state is unchanged, and a
    deferred guarded ingest (classifier, update round, reason tally)
    runs under ``set_sync_debug_mode("error")``."""
    from repro_torch.serve import DynamicWalkEngine, GuardPolicy
    from repro_torch.serve.guard import make_classifier
    st, cfg, lanes = _guard_round(256, 64, seed=5 + dup)
    policy = GuardPolicy(reject_duplicates=dup)
    before = _clone(st)
    got = make_classifier(cfg, policy)(st, *lanes)
    cpu = tdg.BingoState(*[None if x is None else
                           (type(x)(*[y.cpu() for y in x])
                            if isinstance(x, tuple) else x.cpu())
                           for x in st])
    want = make_classifier(cfg, policy)(cpu, *[x.cpu() for x in lanes])
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    assert len(set(want.tolist())) >= 4
    assert_same(before, st)
    eng = DynamicWalkEngine(st, cfg, guard=policy, defer_guard=True)
    eng.ingest(*lanes)                              # built and loaded
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng.ingest(*lanes)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert eng.drain_guard() == 2
    eng.guard.check_conservation()


def _cpu_state(st):
    return tdg.BingoState(*[None if x is None else
                            (type(x)(*[y.cpu() for y in x])
                             if isinstance(x, tuple) else x.cpu())
                            for x in st])


def _rows(st, lo, hi):
    return tdg.BingoState(*[None if x is None else
                            (type(x)(*[y[lo:hi] for y in x])
                             if isinstance(x, tuple) else x[lo:hi])
                            for x in st])


@pytest.mark.parametrize("dup", [False, True])
def test_shard_classifier_on_the_card_equals_cpu(dup):
    """A shard's classifier (rows 64..127 of 256, no group): on CUDA
    tensors the codes equal the same torch ops on the CPU; lanes the
    shard does not own are R_OK, out-of-range ones R_VERTEX."""
    from repro_torch.core.updates import R_OK, R_VERTEX
    from repro_torch.serve import GuardPolicy
    from repro_torch.serve.guard import make_classifier, valid_lanes
    st, cfg, lanes = _guard_round(256, 64, seed=7 + dup)
    lanes[1][256:512] = torch.randint(64, 128, (256,), device="cuda",
                                      dtype=torch.int32)
    policy = GuardPolicy(reject_duplicates=dup)
    shard = _rows(st, 64, 128)
    fn = make_classifier(cfg, policy, offset=64, rows=64)
    got = fn(shard, *lanes)
    want = fn(_cpu_state(shard), *[x.cpu() for x in lanes])
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    u = lanes[1].cpu()
    own = (u >= 64) & (u < 128) & valid_lanes(cfg, u, lanes[2].cpu())
    whole = make_classifier(cfg, policy)(_cpu_state(st),
                                         *[x.cpu() for x in lanes])
    np.testing.assert_array_equal(want[own].numpy(), whole[own].numpy())
    assert bool((want[~own & (whole != R_VERTEX)] == R_OK).all())
    assert len(set(want[own].tolist())) >= 3


@pytest.fixture(scope="module")
def nccl_group(tmp_path_factory):
    """A one-rank NCCL process group on the card (module-scoped, so it is
    set up before the autouse check; it skips on its own)."""
    import datetime
    import torch.distributed as dist
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: NCCL runs on the card")
    d = tmp_path_factory.mktemp("nccl")
    dist.init_process_group(
        "nccl", store=dist.FileStore(str(d / "store"), 1), rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=60),
        device_id=torch.device("cuda", 0))
    yield dist.group.WORLD
    dist.destroy_process_group()


@pytest.mark.parametrize("dup", [False, True])
def test_sharded_guarded_ingest_over_nccl_never_syncs(nccl_group, dup):
    """A sharded engine on a one-rank NCCL group: its classifier (with the
    ``all_reduce`` of the codes) equals the single-device classifier, and
    a deferred guarded ingest — classifier, owner mask, update round,
    summed stats, fill max — runs under ``set_sync_debug_mode("error")``,
    its state and books equal to a single-device engine's."""
    from repro_torch.serve import DynamicWalkEngine, GuardPolicy
    from repro_torch.serve.guard import make_classifier
    st, cfg, lanes = _guard_round(256, 64, seed=5 + dup)
    policy = GuardPolicy(reject_duplicates=dup)
    got = make_classifier(cfg, policy, offset=0, rows=256,
                          group=nccl_group)(st, *lanes)
    want = make_classifier(cfg, policy)(st, *lanes)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    one = DynamicWalkEngine(_clone(st), cfg, guard=policy, defer_guard=True)
    eng = DynamicWalkEngine(st, cfg, guard=policy, defer_guard=True,
                            group=nccl_group)
    for e in (one, eng):
        e.ingest(*lanes)                            # built and loaded
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng.ingest(*lanes)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    one.ingest(*lanes)
    assert eng.drain_guard() == one.drain_guard() == 2
    eng.guard.check_conservation()
    assert eng.guard.snapshot() == one.guard.snapshot()
    assert_same(one.state, eng.state)


@pytest.mark.parametrize("fed", [True, False])
@pytest.mark.parametrize("base_log2,fp", WIDE_MODES)
@pytest.mark.parametrize("kind", ["deepwalk", "ppr", "simple"])
def test_segment_kernel_at_512_equals_plain(kind, base_log2, fp, fed):
    """The segment entry at C = 512 (the relay's rows after the serving
    ladder's regrow; degrees up to 512) on a relay view, with start steps
    spread over [0, L+1], free slots and a permuted slot → walker id
    map."""
    degrees = (0, 1, 3, 31, 32, 33, 255, 256, 257, 300, 511, 512)
    st, cfg = _wide_state(fp, base_log2, V=640, C=512, degrees=degrees)
    view = relay_view(st, 0, 320)
    B, L = 800, 12
    g = torch.Generator(device="cuda").manual_seed(31)
    starts = _wide_rows(B, 320, 31, n=len(degrees))
    starts[-60:] = -1                                   # free slots
    t0 = torch.randint(0, L + 2, (B,), generator=g, device="cuda",
                       dtype=torch.int32)
    t0[: B // 2] = 0
    wid = torch.randperm(B, generator=g, device="cuda").to(torch.int32)
    u = torch.rand((L, B, 6), generator=g, device="cuda") if fed else None
    kw = dict(base_log2=base_log2, stop_prob=0.1 if kind == "ppr" else 0.0,
              uniform=kind == "simple", length=L)
    args = (view.itable.prob, view.itable.alias, view.bias, view.nbr,
            view.deg, view.frac if fp else None, starts, t0)
    before = ops.launch_counts()["walk_segment"]
    got = ops.walk_segment(*args, 512, u, wid, **kw)
    assert ops.launch_counts()["walk_segment"] == before + 1
    want = walk_segment_ref(*args, u, wid, seed=512, **kw)
    torch.cuda.synchronize()
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x.cpu().numpy(), y.cpu().numpy())
    assert bool((got[1][:, 0] >= 0).any())


def test_async_checkpoint_takes_the_generation_it_was_called_at(tmp_path):
    """``AsyncCheckpointer.save`` copies the card's tables to the host
    before it returns: in-place rounds launched right after it do not
    reach the snapshot."""
    from repro_torch.serve import DynamicWalkEngine
    from repro_torch.train.checkpoint import (AsyncCheckpointer,
                                              restore_checkpoint)
    st, cfg, lanes = _guard_round(4096, 64, seed=7)
    eng = DynamicWalkEngine(st, cfg)
    want = _clone(eng.state)
    ck = AsyncCheckpointer(str(tmp_path))
    ck.save(0, eng.state)
    for _ in range(3):
        eng.ingest(*lanes)
    ck.wait()
    got = restore_checkpoint(str(tmp_path), 0,
                             like=tdg.empty_state(cfg, "meta"),
                             device="cuda")
    assert_same(want, got)
    assert not torch.equal(eng.state.nbr, got.nbr)


@pytest.mark.parametrize("C", [8, 37, 256])
@pytest.mark.parametrize("K", [1, 4, 16, 31, 32])
def test_radix_hist_kernel_equals_plain(K, C):
    """4,099 rows (the last warp's rows part full): each listed degree in
    every lane position, C = 37 unaligned rows."""
    bias, deg = hist_inputs(np.random.default_rng(K * C), 4099, C, K)
    before = ops.launch_counts()["radix_hist"]
    got = ops.radix_hist(bias, deg, num_k=K)
    assert ops.launch_counts()["radix_hist"] == before + 1
    want = radix_hist_ref(bias, deg, K)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())


def test_radix_hist_kernel_on_a_power_law_state():
    """R-MAT scale 12 degrees (hub rows at C = 256 beside many short
    ones): the kernel equals the state's own counters and the plain
    version."""
    from repro_torch.graph.rmat import degree_bias, rmat_edges
    V = 1 << 12
    src, dst = rmat_edges(12, 8, seed=3)
    cfg = tdg.BingoConfig(num_vertices=V, capacity=256, bias_bits=16)
    st = tdg.from_edges(cfg, src, dst, degree_bias(src, dst, V, bias_bits=16),
                        device="cuda")
    assert int(st.deg.max()) > 32 and bool((st.deg <= 32).any())
    before = ops.launch_counts()["radix_hist"]
    got = ops.radix_hist(st.bias, st.deg, num_k=cfg.num_radix)
    assert ops.launch_counts()["radix_hist"] == before + 1
    want = radix_hist_ref(st.bias, st.deg, cfg.num_radix)
    torch.cuda.synchronize()
    for a, b, c in zip(got, want, (st.digitsum, st.gsize)):
        np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())
        np.testing.assert_array_equal(a.cpu().numpy(), c.cpu().numpy())


def _uniform_inputs(B, ucols, in_place, seed):
    """A C = 64 state with degree-0 rows; walker rows with a degree-0 row
    at positions 0, 5, 10 and 15 (each residue of four) and last; the
    (nbr, deg) tables and keyword arguments of the in-place or gathered
    entry."""
    st, cfg = _state(300, 64, False, 1, seed=seed)
    st.deg[::9] = 0
    g = torch.Generator(device="cuda").manual_seed(seed)
    rows = torch.randint(0, cfg.num_vertices, (B,), generator=g,
                         device="cuda", dtype=torch.int32)
    for b in (0, 5, 10, 15, B - 1):
        if b < B:
            rows[b] = 9
    u = torch.rand((B, ucols), generator=g, device="cuda")
    if in_place:
        return (st.nbr, st.deg), u, {"rows": rows}
    r = rows.long()
    return (st.nbr[r].contiguous(), st.deg[r].contiguous()), u, {}


@pytest.mark.parametrize("in_place", [True, False])
@pytest.mark.parametrize("ucols", [1, 3, 5])
@pytest.mark.parametrize("B", [1, 3, 4, 5, 262_147])
def test_walk_sample_uniform_kernel_equals_plain(B, ucols, in_place):
    """Batches from one walker to a last part-full block, one or several
    uniform columns, rows read in place or gathered."""
    (nbr, deg), u, kw = _uniform_inputs(B, ucols, in_place, B + ucols)
    before = ops.launch_counts()["walk_sample_uniform"]
    got = ops.walk_sample_uniform(nbr, deg, u, **kw)
    assert ops.launch_counts()["walk_sample_uniform"] == before + 1
    want = walk_sample_uniform_ref(nbr, deg, u, **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())
    d = deg[kw["rows"].long()] if in_place else deg
    assert (got[1][d == 0] == -1).all() and bool((d == 0).any())


@pytest.mark.parametrize("K", ALIAS_KS)
def test_alias_build_kernel_equals_plain(K):
    rng = np.random.default_rng(K)
    w = torch.from_numpy(alias_weights(rng, 4097, K)).cuda()
    before = ops.launch_counts()["alias_build"]
    got = ops.alias_build(w)
    assert ops.launch_counts()["alias_build"] == before + 1
    want = alias_build_ref(w)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())


@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "-".join(
    str(x) for x in c))
def test_flash_attention_kernel_equals_plain(case):
    """The kernel of the case's type (f32: CUDA cores, bf16: wgmma) within
    its limit: entry by entry against the plain version in f32, row by
    row against the all-f32 algorithm in bf16."""
    B, H, Hkv, S, T, D, dtype, causal, window = case
    q, k, v = flash_inputs(case, S + T + H)
    route = flash_route(dtype)
    before = ops.launch_counts()[route]
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert ops.launch_counts()[route] == before + 1
    plain, ref32 = flash_refs(q, k, v, causal, window)
    torch.cuda.synchronize()
    assert got.dtype == q.dtype and got.shape == q.shape
    assert flash_limit(got, plain, ref32) <= 1


@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "-".join(
    str(x) for x in c))
def test_flash_attention_limit_rejects_a_tile_shift(case):
    """The limit is tight enough to fail the kernel one KV tile off at the
    band's edge."""
    B, H, Hkv, S, T, D, dtype, causal, window = case
    q, k, v = flash_inputs(case, S + T + H)
    fault = ops.flash_attention(q, k, v, causal=causal,
                                window=shifted_window(T, window))
    plain, ref32 = flash_refs(q, k, v, causal, window)
    assert flash_limit(fault, plain, ref32) > 1


def test_flash_attention_declines_what_the_card_has_no_kernel_for():
    """D > 512 and types other than float32, bfloat16 and float16 raise
    ``ValueError`` naming the limit."""
    q = torch.zeros((1, 2, 64, 513), device="cuda")
    with pytest.raises(ValueError, match="head dim .* 1..512"):
        ops.flash_attention(q, q, q)
    q = torch.zeros((1, 2, 64, 64), device="cuda", dtype=torch.float64)
    with pytest.raises(ValueError, match="float64"):
        ops.flash_attention(q, q, q)


def test_cuda_tensors_never_take_the_plain_path():
    """A CUDA state goes to the kernels: the launch counters move."""
    st, cfg = _state(16, 32, False, 1)
    ops.reset_launch_counts()
    ops.update_fused(st, cfg, *[torch.from_numpy(x).cuda() for x in (
        np.array([True]), np.array([0], np.int32), np.array([3], np.int32),
        np.array([5], np.int32))])
    for uniform in (False, True):          # tiles, and a thread a walker
        ops.walk_fused(st.itable.prob, st.itable.alias, st.bias, st.nbr,
                       st.deg, None,
                       torch.zeros(4, dtype=torch.int32, device="cuda"), 1,
                       length=4, uniform=uniform)
    ops.walk_sample(st.itable.prob, st.itable.alias, st.bias, st.nbr, st.deg,
                    torch.rand((4, 3), device="cuda"),
                    rows=torch.zeros(4, dtype=torch.int32, device="cuda"))
    ops.walk_sample_uniform(st.nbr, st.deg, torch.rand((4, 1), device="cuda"),
                            rows=torch.zeros(4, dtype=torch.int32,
                                             device="cuda"))
    zeros = torch.zeros(4, dtype=torch.int32, device="cuda")
    ops.walk_segment(st.itable.prob, st.itable.alias, st.bias, st.nbr, st.deg,
                     None, zeros, zeros, 1, length=4)
    ops.radix_hist(st.bias, st.deg, num_k=cfg.num_radix)
    ops.alias_build(st.itable.prob)
    for D in (64, 80):                      # 80: zero-padded to 128
        q = torch.randn((1, 2, 8, D), device="cuda")
        ops.flash_attention(q, q[:, :1].contiguous(), q[:, :1].contiguous())
        q = q.to(torch.bfloat16)
        ops.flash_attention(q, q[:, :1].contiguous(), q[:, :1].contiguous())
    assert ops.launch_counts() == {"walk_fused": 2, "walk_segment": 1,
                                   "update_fused": 1, "walk_sample": 1,
                                   "walk_sample_uniform": 1, "radix_hist": 1,
                                   "alias_build": 1, "flash_attention": 2,
                                   "flash_attention_sm90": 2}


@pytest.mark.parametrize("fed", [True, False])
@pytest.mark.parametrize("kind", ["deepwalk", "ppr", "simple"])
def test_segment_kernel_under_walker_partition(kind, fed):
    """The relay's segment launches on a (2, 2) mesh: vertex shard v of
    walker group g walks its slots of the group's walkers, whose ids are
    ``g·W/2 +`` local ids (``wid_base`` 0 and W/2), the fed uniforms
    gathered from the global (L, W, 6) columns of those ids, on the view
    of its rows; bit for bit the plain version."""
    st, cfg = _state(40, 64, False, 1)
    Vs, W, L = 20, 2000, 12
    Wg = W // 2
    g = torch.Generator(device="cuda").manual_seed(17)
    u = torch.rand((L, W, 6), generator=g, device="cuda") if fed else None
    kw = dict(base_log2=1, stop_prob=0.15 if kind == "ppr" else 0.0,
              uniform=kind == "simple", length=L)
    for gidx in range(2):
        for sidx in range(2):
            view = relay_view(st, sidx * Vs, Vs)
            Wl = 700                           # slots of a group's shard
            wid = gidx * Wg + torch.randperm(Wg, generator=g,
                                             device="cuda")[:Wl]
            wid = wid.to(torch.int32)
            free = torch.rand(Wl, generator=g, device="cuda") < 0.2
            wid[free] = -1
            starts = torch.where(wid >= 0, torch.randint(
                0, Vs, (Wl,), generator=g, device="cuda",
                dtype=torch.int32), -1).to(torch.int32)
            t0 = torch.randint(0, L + 1, (Wl,), generator=g, device="cuda",
                               dtype=torch.int32)
            u_slots = None if u is None else \
                u[:, wid.clamp(min=0).long()].contiguous()
            args = (view.itable.prob, view.itable.alias, view.bias,
                    view.nbr, view.deg, None, starts, t0)
            before = ops.launch_counts()["walk_segment"]
            got = ops.walk_segment(*args, 4242, u_slots, wid, **kw)
            assert ops.launch_counts()["walk_segment"] == before + 1
            want = walk_segment_ref(*args, u_slots, wid, seed=4242, **kw)
            torch.cuda.synchronize()
            for x, y in zip(got, want):
                np.testing.assert_array_equal(x.cpu().numpy(),
                                              y.cpu().numpy())
            assert bool((got[1][:, 0] >= 0).any())     # some walkers exit


BASELINES = ["AliasBaseline", "ITSBaseline", "RejectionBaseline",
             "ReservoirBaseline"]


def _baseline_chi_square_ok(nxt, want):
    from scipy import stats
    counts = np.bincount(nxt, minlength=len(want))
    exp = want * counts.sum()
    mask = exp > 0
    assert counts[~mask].sum() == 0, "a draw of probability 0"
    stat = float(((counts[mask] - exp[mask]) ** 2 / exp[mask]).sum())
    return stat < stats.chi2.ppf(0.9999, max(1, int(mask.sum()) - 1))


@pytest.mark.parametrize("name", BASELINES)
def test_baselines_draw_in_distribution_on_the_card(name):
    """``tests/test_baselines.py``'s rows on CUDA tensors: row 2 ->
    {1: 5, 4: 4, 5: 3}; after inserting (2, 3, 3) and deleting (2, 1);
    after inserting (2, 6, 10); 30,000 draws each from a CUDA
    generator."""
    from repro_torch.core import baselines as tb
    base = getattr(tb, name).build(tb.adj_from_edges(
        8, 8, [2, 2, 2], [1, 4, 5], [5.0, 4.0, 3.0], device="cuda"))
    assert base.adj.nbr.is_cuda
    u = torch.full((30000,), 2, dtype=torch.int32, device="cuda")
    steps = [(lambda b: b, {1: 5, 4: 4, 5: 3}),
             (lambda b: b.insert(2, 3, 3.0).delete(2, 1), {4: 4, 5: 3, 3: 3}),
             (lambda b: b.insert(2, 6, 10.0), {4: 4, 5: 3, 3: 3, 6: 10})]
    for i, (update, row) in enumerate(steps):
        base = update(base)
        want = np.zeros(8)
        for v, w in row.items():
            want[v] = w
        gen = torch.Generator(device="cuda").manual_seed(i)
        nxt = base.sample(u, gen)
        assert nxt.is_cuda
        assert _baseline_chi_square_ok(nxt.cpu().numpy(), want / want.sum())


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_model_on_the_card_equals_the_cpu(arch):
    cfg = smoke_config(arch)
    cpu = init_model(cfg, torch.Generator().manual_seed(3))
    dev = _to_card(cpu)
    g = torch.Generator().manual_seed(4)
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=g)
    batch = {"inputs": tokens}
    if cfg.frontend != "none":
        batch["embeddings"] = torch.randn((2, 16, cfg.d_model), generator=g)
    want = forward(cpu, cfg, batch)[0]
    got = forward(dev, cfg, {k: v.cuda() for k, v in batch.items()})[0]
    assert got.is_cuda
    assert float((got.cpu() - want).abs().max()) <= lm_cpu_limit(arch, want)
    got = lm_logits_decode(dev, cfg, tokens.cuda())
    want = lm_logits_decode(cpu, cfg, tokens)
    assert float((got.cpu() - want).abs().max()) <= lm_cpu_limit(arch, want)


def _to_card(tree):
    if isinstance(tree, dict):
        return {k: _to_card(v) for k, v in tree.items()}
    return tree.cuda()


def test_decode_engine_answers_on_the_card():
    cfg = smoke_config("qwen2-0.5b")
    cpu = init_model(cfg, torch.Generator().manual_seed(6))
    outs = []
    for device, params in (("cuda", _to_card(cpu)), ("cpu", cpu)):
        eng = DecodeEngine(cfg, params, slots=3, max_len=32, device=device)
        for i in range(5):
            eng.submit(ServeRequest(rid=i, prompt=list(range(i, 3 * i + 1)),
                                    max_new_tokens=4 + i))
        outs.append([(r.rid, r.output) for r in eng.run()])
        assert eng.cache["slot0"]["k"].device.type == device
    assert outs[0] == outs[1]
    assert sorted(len(o) for _, o in outs[0]) == [4, 5, 6, 7, 8]


# ---------------------------------------------------------------------------
# training (no kernel on the model path; the pipeline's walks and the
# driver's update rounds run B1 and B2)
# ---------------------------------------------------------------------------

def _smoke_batch(cfg, seed, B=2, S=16):
    g = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=g)
    batch = {"inputs": toks[:, :-1], "targets": toks[:, 1:]}
    if cfg.frontend != "none":
        batch["embeddings"] = torch.randn((B, S, cfg.d_model), generator=g)
    return batch


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_loss_and_grads_on_the_card_equal_the_cpu(arch):
    train_smoke_arch(arch, ARCHS.index(arch))


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "qwen2-0.5b"])
def test_remat_and_microbatches_on_the_card(arch):
    """remat against the plain step; microbatches against the full batch.
    The MoE arch's microbatches run with ``router_aux_coef=0``: its aux
    loss is a per-call statistic of the routing (a microbatch's is not a
    quarter of the batch's, in either package), while the cross entropy
    is a mean over equal microbatches, so a fault in dispatching a
    microbatch's tokens to the experts shows in the gradients."""
    from repro_torch.train.train_step import value_and_grad
    cfg = smoke_config(arch)
    params = _to_card(init_model(cfg, torch.Generator().manual_seed(13)))
    batch = _to_card(_smoke_batch(cfg, 14, B=4, S=32))
    ln, _, gn = value_and_grad(params, cfg, batch, remat="none")
    for remat in ("full", "dots"):
        lr, _, gr = value_and_grad(params, cfg, batch, remat=remat)
        assert float(lr) == float(ln)
        assert grad_excess(gr, gn, TRAIN_GRAD_TOL)[0] <= 1.0, remat
    if cfg.num_experts:
        cfg = dataclasses.replace(cfg, router_aux_coef=0.0)
        ln, _, gn = value_and_grad(params, cfg, batch, remat="none")
    l4, m4, g4 = value_and_grad(params, cfg, batch, remat="none",
                                microbatches=4)
    assert m4 == {} and tree_excess(g4, gn, TRAIN_GRAD_TOL) <= 1.0
    assert abs(float(l4) - float(ln)) <= 1e-5 * abs(float(ln))


def test_pipeline_batches_on_the_card_equal_the_cpu():
    from repro_torch.data import WalkCorpusPipeline
    from repro_torch.graph.rmat import degree_bias, rmat_edges
    V = 1 << 12
    src, dst = rmat_edges(12, 8, seed=0)
    w = degree_bias(src, dst, V, bias_bits=10)
    cfg = tdg.BingoConfig(num_vertices=V, capacity=256, bias_bits=10)
    out = {}
    for device in ("cpu", "cuda"):
        state = tdg.from_edges(cfg, src, dst, w, device=device)
        pipe = WalkCorpusPipeline(state, cfg, walkers_per_round=512,
                                  seq_len=128, batch_size=8, seed=21)
        ops.reset_launch_counts()
        out[device] = [next(pipe) for _ in range(12)]
        assert ops.launch_counts()["walk_fused"] == \
            (pipe.rounds if device == "cuda" else 0)
        assert all(b["inputs"].device.type == device for b in out[device])
    for a, b in zip(out["cpu"], out["cuda"]):
        for k in ("inputs", "targets"):
            assert torch.equal(a[k], b[k].cpu())


def test_bf16_moment_checkpoint_round_trip_on_the_card(tmp_path):
    bf16_checkpoint_check(str(tmp_path))


def test_launch_train_on_the_card(tmp_path):
    train_driver_check({}, str(tmp_path))


# ---------------------------------------------------------------------------
# the dry run: fake tensors launch nothing, real ones always launch
# ---------------------------------------------------------------------------

def _wrapper_call(name, st, cfg):
    """One call of kernel wrapper ``name`` (B1, B3, B4a or B2) on ``st``;
    returns its output tensors."""
    dev = st.nbr.device
    zeros = torch.zeros(4, dtype=torch.int32, device=dev)
    if name == "walk_fused":
        return (ops.walk_fused(st.itable.prob, st.itable.alias, st.bias,
                               st.nbr, st.deg, None, zeros, 1, length=4),)
    if name == "walk_segment":
        return ops.walk_segment(st.itable.prob, st.itable.alias, st.bias,
                                st.nbr, st.deg, None, zeros, zeros, 1,
                                length=4)
    if name == "walk_sample":
        return ops.walk_sample(st.itable.prob, st.itable.alias, st.bias,
                               st.nbr, st.deg,
                               torch.zeros((4, 3), device=dev), rows=zeros)
    lanes = (torch.ones(4, dtype=torch.bool, device=dev), zeros,
             zeros + 3, zeros + 5)
    _, stats = ops.update_fused(st, cfg, *lanes)
    return tuple(stats[:4])


@pytest.mark.parametrize("name", ["walk_fused", "walk_segment", "walk_sample",
                                  "update_fused"])
def test_wrappers_launch_on_real_tensors_and_never_on_fake(name):
    """On CUDA tensors each wrapper of the dry run's path launches once; on
    fake copies of the same tensors it launches nothing and returns the
    kernel's output shapes."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    st, cfg = _state(16, 32, False, 1)
    ops.reset_launch_counts()
    real = _wrapper_call(name, _clone(st), cfg)
    torch.cuda.synchronize()
    assert ops.launch_counts()[name] == 1
    mode = FakeTensorMode()
    fake_st = tdg.BingoState(*[
        None if x is None else
        (type(x)(*[mode.from_tensor(y) for y in x]) if isinstance(x, tuple)
         else mode.from_tensor(x)) for x in st])
    with mode:
        fake = _wrapper_call(name, fake_st, cfg)
    assert ops.launch_counts()[name] == 1
    assert [(f.shape, f.dtype) for f in fake] == \
        [(r.shape, r.dtype) for r in real]


def test_rank_cells_hold_their_dry_run(nccl_group, tmp_path):
    """Phase 3k's checks: one rank's share of each walk cell through the
    dry run (a subprocess) and for real on the card."""
    from chip_smoke import dryrun_cli, rank_cell_checks
    from repro_torch.launch.walk_cell import one_rank_share
    docs = dryrun_cli(tmp_path, "--arch-filter", "bingo-walk", "--mesh",
                      "1x1", "--sizing", "rank")
    out = {}
    launches = rank_cell_checks(out, docs, one_rank_share(), "card")
    assert all(launches.get(k, 0) > 0 for k in (
        "walk_fused", "walk_segment", "walk_sample", "update_fused"))


def test_lm_rank_cells_hold_their_dry_run(nccl_group, tmp_path):
    """Phase 3l's checks: qwen2-0.5b's three LM cells at one rank's share
    through the dry run (a subprocess) and for real on the card, through
    the same function as the smoke."""
    from chip_smoke import LM_ARCH, dryrun_cli, lm_rank_cell_checks
    docs = dryrun_cli(tmp_path, "--arch-filter", LM_ARCH, "--mesh", "1x1",
                      "--sizing", "rank")
    out = {}
    lm_rank_cell_checks(out, docs, "card")
    assert sorted(out["lm_cells"]) == ["decode_32k", "prefill_32k",
                                       "train_4k"]
