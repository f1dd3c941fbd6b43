#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--scale 20] [--report PATH] [--profile DIR]

Phases (any failure exits non-zero and prints no result line):

1. Build the CUDA kernels from ``src/repro_torch/csrc`` (one nvcc per
   source, in parallel) and print the build time, ptxas's register and
   spill lines and the card's name and power limit; census of the two
   attention libraries (``sm90_census``): no spill stores, and tensor-core
   (HGMMA or HMMA) and TMA (UTMALDG) instructions in their SASS; census of
   the walk kernels' six instantiations (``walk_census``): registers, no
   spill stores, and the resident blocks per SM (what the persistent grids
   are sized by); census of ``update_fused.cu``, ``alias_build.cu`` and
   ``radix_hist.cu`` (``table_census``): every kernel with a 0-byte stack
   and no spills.
2. Hold each kernel against its plain PyTorch version on the card, bit
   for bit: ``walk_fused`` over deepwalk/ppr/simple × base 2/4 × fp on/off
   × fed/hashed uniforms at C = 128 and 512 (``WALK_CAPACITIES``; 512 is
   the serving ladder's regrown width); ``walk_segment`` (the relay's segment entry)
   over the same sweep at both capacities, with start steps spread over [0, L+1], free slots,
   remote neighbours encoded -(g+2) and a permuted slot → walker id map;
   ``update_fused`` over insert/delete/mixed × five config rows, plus a
   batch wider than 2·C, and on ``streamed_state``'s states (through
   ``stream_updates`` first: a full row, an emptied row, stale member
   lists, a DENSE -> ONE rebuild) at C = 37, 256, 300 and 512 × the five
   rows,
   with its prep kernels against ``plan_round``'s torch ops; ``walk_sample`` and ``walk_sample_uniform`` over
   base 2/4 × fp on/off × gathered rows / in-place ``rows``, on batches
   holding degree-0 rows; ``radix_hist`` over K 4/16/31/32 × C 8/37/256
   (``hist_inputs``: degrees on both sides of its 32-slot short rows) and
   ``alias_build`` over ``ALIAS_KS`` (K 1 to 64; all-zero, single-entry, equal and near-1e-30 rows); ``flash_attention`` over ``FLASH_CASES``, each case
   through the kernel of its type (float32: ``flash_attention.cu``, 3xTF32
   wgmma, bfloat16: ``flash_attention_sm90.cu``, the launch counters show
   which),
   at its limit (``flash_limit``: float32 entry by entry within 2e-5 of
   the plain version; bfloat16 row by row against the all-f32
   ``flash_attention_ref32``, at most twice the plain bf16 algorithm's
   error plus 2^-7 of the row's largest value, ``FLASH_ROW``), and the
   kernel one tile off at the band's edge (``shifted_window``) against the
   same limit, which must reject it: GQA 4:1 at Mixtral 8x7B's widths with
   its 4096 window at S = T = 8192 in bf16, D = 64 causal in f32 and
   bf16, S = 512 < T = 8192 in both, a ragged S = T = 1000 in bf16, a
   non-causal batch of two in both, in f32 a ragged S = 1000 < T = 3000 at
   D = 80, a ragged window at D = 128 and a ragged non-causal S < T at
   D = 64, and in both types hubert-xlarge's D = 80 (MHA, non-causal; its
   own width in f32, zero-padded to 128 in bf16) and the head dims run
   zero-padded, 16 and 8 (the SMOKE configs'), the last with a window.
3. The main path at full size, through ``DynamicWalkEngine.run_stream``:
   an R-MAT graph of 2^20 vertices (edge factor 8) with degree biases,
   ``BingoConfig(2**20, capacity=256, bias_bits=16)``, 10 mixed rounds of
   100,000 updates, 262,144 deepwalk walkers of length 80 after each
   round, then one ppr batch (max 400, stop 1/80) and one simple batch.
   Launch counters are zeroed just before and read just after (the
   update's prep kernels too, ``plan_round.launches``: one a round).
   Round 1's state is held against ``batched_update`` on a copy; round 10
   is replayed on a copy of round 9's state: its prepass against
   ``plan_round``'s torch ops, then through ``batched_update`` and, under
   ``torch.cuda.set_sync_debug_mode("error")`` (any host sync raises),
   through ``ops.update_fused`` (``no_sync_round``), both equal to the
   main path's state and stats.
3d. Right after the main path, on its final state, the counters zeroed
   just before and read just after: ``radix_hist(state.bias, state.deg,
   num_k=16)`` must equal ``(state.digitsum, state.gsize)`` and
   ``alias_build(group_weights(state.digitsum))`` must equal
   ``state.itable`` (written by ``update_fused`` in ten rounds), bit for
   bit, and so must the plain versions; times (median of 3) and bounds;
   the rows by degree (0, 1-8, 9-32, 33-255, 256: ``radix_hist.cu``
   counts a row of degree up to 32 in one lane, a longer one by 8).
3b. The per-step paths on the main path's final state, each with the
   counters zeroed just before and read just after: a node2vec batch
   (``WalkParams("node2vec", 80, p=0.5, q=2.0)``), a per-step deepwalk and
   a per-step simple batch (``whole_walk=False``), all through
   ``DynamicWalkEngine.walk`` from the same 262,144 starts; then 2,000
   mixed single-edge updates through ``stream_updates``, held against a
   host simulation of the same sequence and against a rebuild of the
   touched vertices.  Each batch is checked as the main path's are, and
   the per-step deepwalk and node2vec batches against their exact
   next-vertex distributions (TV bound derived from the sample count).
   node2vec, per-step deepwalk and per-step simple then run once more
   untimed in one ``torch.profiler`` session (``sample_launches``): the walkers in
   each ``walk_sample`` (``walk_sample_uniform`` on the simple path)
   launch, its kernel's device time, and their sums on each path.  Then
   each per-step kernel samples every walker once with fed uniforms,
   against its plain version: ``walk_sample`` at the starts,
   ``walk_sample_uniform`` at the starts and at the simple walk's
   frontier (its paths' column ``FRONTIER_STEP``, clamped at 0 as
   ``scan_walk`` clamps it), with the one uniform column its path
   passes; beside the uniform pick's word bound, the bytes it moves at
   32 bytes a sector (``uniform_sectors``).
3c. The sharded path, before the streaming updates: the parent writes the
   graph, the 10-round stream, SHA-256 digests of the 4 vertex slices of
   the main path's final state, its per-round ``UpdateStats`` and digests
   of single-device whole walks (deepwalk 262,144 × 80, ppr, simple) to a
   temporary directory, then spawns 4 ranks on the one card over gloo.
   Each builds the state, keeps its slice, replays the 10 rounds through
   ``DynamicWalkEngine(group=...)`` (slice and summed stats must equal the
   single-device ones) and walks the three batches through the relay
   (deepwalk overlapped through the engine and again bulk, ppr and simple
   overlapped), its home blocks equal to the single-device paths bit for
   bit, the counters zeroed just before each batch and read just after.
   Then each gloo rank replays the four batches through a backend that
   records the work of each segment launch and its time on the card
   alone, without the wrapper's host work (``SegmentWork``), giving a
   bound per launch beside the times of the same launch.  Then one rank over NCCL runs the same deepwalk batch,
   and times the whole-walk and the segment kernels on it in turns.
3f. After the streaming updates, the main path's engine freed: the
   serving layer at full width (``serving_phase``).  A fresh engine on the
   main path's initial edges, ``BingoConfig(2**20, capacity=256,
   bias_bits=16, capacity_ladder=(256, 512))``, deepwalk 80,
   ``guard=GuardPolicy(retry_batch=65536)``, ``walk_buckets=(16384, 65536,
   262144)``, behind ``ServingScheduler(update_lanes=100_000,
   max_update_delay=4, guard_drain_rounds=8, regrow_watermark=0.95)`` with
   unbounded queues, takes seeded open-loop bursts of 1-3 requests a tick:
   the main path's 10 mixed rounds, then four insert-only windows of
   100,000 edges that a capacity-256 build drops from rows of degree at
   most 512 (``growth_edges``), and 40 walk requests of 1-65,536 starts.
   ``ServingProbe`` times each window (host ingest; the classifier by CUDA
   events beside its bytes bound), each drain and the migration (beside
   old tables read once + new written once at 3.35 TB/s), and pins the
   migrated state.  Checks: (a) a fresh engine replaying the admission
   trace returns every cohort's rows and ends in the live state (SHA-256
   ``digest``s) and guard books; (b) the migrated state's digest equals
   ``from_edges`` at 512 over its edges in row order; (c) both
   conservation laws, no ``R_CAPACITY`` quarantine before the regrow and
   each later one at a full row; (d) ``audit(pressure=True)`` at both
   tiers with every corruption rule zero (``at_capacity`` counts the full
   rows exactly while inserts wait) and ``check_state`` on ~4,096 seeded
   rows; (e) window ``NO_SYNC_WINDOW`` runs under
   ``torch.cuda.set_sync_debug_mode("error")``; (f) with the counters
   zeroed just before the run and read just after, ``walk_fused``
   launches equal the cohorts and ``update_fused`` launches the windows
   plus the retry rounds.  Then ``recovery_phase`` at 2^17 vertices, the
   same widths: ``RecoverableEngine(checkpoint_every=3)`` over 10 guarded
   rounds and walks, a regrow record logged and the engine dropped before
   it migrates; ``restore`` + WAL replay must give the uninterrupted run's
   state digest and next walk batch.  Prints cohort latency p50/p99, walk
   steps/s and updates/s over the phase, snapshot and restore times.
3g. After recovery: the sharded serving layer.  Phase 3f hands over its
   traffic, admission trace, per-request path digests, guard books,
   regrow counts, the digests of the 4 vertex slices of its final state
   and a single-device whole walk of that state (65,536 deepwalk starts,
   ``CHAOS_SEED``).  4 gloo ranks on the one card build their slices in
   turn and run phase 3f's bursts through a ``ServingScheduler`` over
   ``DynamicWalkEngine(group=..., guard=GuardPolicy(retry_batch=65536),
   walk_buckets=..., relay_overlap=False)`` at the ladder 256 -> 512 (bulk
   relays: the faster schedule on gloo).  Each rank must admit phase 3f's
   trace op for op (the harvest blocks on a sharded engine; if phase 3f's
   own dispatch ever met ``max_inflight``, its trace is replayed instead)
   and give every request's paths, the guard books, the regrow counts and
   its final slice as phase 3f did; launches equal the relay rounds and
   the windows plus retry rounds; the summed ``audit`` has no corruption.
   Then, on the grown state, ``run_chaos_relay`` with dup 0.2 + delay 0.2
   must give the single-device walk with no walker lost, and drop 0.01
   and a transport killed at round 3 must raise ``RelayIntegrityError``
   on every rank.  Last, one NCCL rank runs phase 3f's second window on a
   sharded engine under ``set_sync_debug_mode("error")`` (gloo stages
   every collective through the host, so a gloo rank cannot).  Prints
   request latency, rates, drains, migrations and the classifier's ms a
   rank, relay rounds per cohort, the chaos reports and the phase's
   seconds, each beside the card's name and power limit.
3e. Last, attention at Mixtral 8x7B's widths (32 query heads, 8 KV heads,
   D = 128) over one 32,768-token sequence (``prefill_32k``): in bf16 the
   4096 window and full causal, in f32 the window; and at hubert-xlarge's
   (16 heads, MHA, D = 80, non-causal) in bf16 (zero-padded to 128 by the
   wrapper) and f32 (the 80-wide instantiation); the counters zeroed just before and read just after;
   256 query rows of each output held
   against the dense ``attention_ref`` in f32 and the whole output
   against the plain version, at the limits of phase 2, which must reject
   the planted fault at this size; kernel times (median of 3), the FLOP
   bound (bf16 at the dense tensor-core rate; f32 three TF32 products at
   the dense TF32 rate, with the old bound at the float32 CUDA-core rate
   printed for the record),
   and ``scaled_dot_product_attention`` on the same tensors as the
   library yardstick (a boolean mask for the window).
4. Times on the card (CUDA events): each kernel at the main path's shapes
   and its plain version, whose outputs are held against the main path's
   whole batches (deepwalk, ppr and simple paths; the state after round
   10; a per-step sample of all 262,144 walkers); each kernel's bound
   from the work this run's data needs; the wall time of each walk batch
   and of each streaming update.  Prints a ``{"kernels": [...]}`` line
   and, last, ``{"ok": true, "device": {...}}``.

Needs one card, the CUDA toolkit (nvcc) and nothing from the network.
The sharded phase spawns its ranks with the ``spawn`` start method and
stops them all, whatever happens.  Each phase's seconds and the total
are printed before the result lines.  ``--scale`` cuts the graph for a
quicker run (phase 3f's growth windows then shrink to the hub-row edges
there are);
``--report`` writes every number measured to a JSON file;
``--profile DIR`` adds, after the per-step paths, one profiled round
(``torch.profiler``; the ingest's host ops, device events and host syncs
by ``trace_counts``) and one profiled batch of each per-step path, and
writes the round's trace there.
"""

import argparse
import dataclasses
import datetime
import gc
import hashlib
import json
import math
import pickle
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
from functools import partial
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
OPS_PER_S = 67e12                  # H100 SXM float32 outside the tensor cores
TC_BF16_FLOPS = 989e12             # H100 SXM dense bf16 tensor-core rate
TC_TF32_FLOPS = 494.7e12           # H100 SXM dense TF32 tensor-core rate
WALK_LEN, PPR_LEN, PPR_STOP = 80, 400, 1.0 / 80.0
FRONTIER_STEP = 40                 # B4b timed on this column of simple paths
N2V_P, N2V_Q = 0.5, 2.0
CHECK_WALKERS = 4096
STREAM_UPDATES = 2000
SHARDS = 4                         # ranks of the sharded phase, on one card
SHARD_TIMEOUT_S = 420              # the sharded phase's ranks, all together
RELAY_SEEDS = {"deepwalk": 101, "ppr": 102, "simple": 103}
# (B, H, Hkv, S, T, D, dtype, causal, window): flash_attention vs plain
FLASH_CASES = [
    (1, 32, 8, 8192, 8192, 128, "bfloat16", True, 4096),    # Mixtral widths
    (1, 8, 2, 2048, 2048, 64, "float32", True, 0),
    (1, 8, 2, 512, 8192, 128, "float32", True, 0),          # S < T
    (1, 4, 2, 1000, 1000, 64, "bfloat16", True, 300),       # ragged
    (2, 4, 1, 1536, 1536, 128, "float32", False, 0),        # non-causal
    (2, 4, 1, 1536, 1536, 128, "bfloat16", False, 0),       # non-causal
    (1, 8, 2, 512, 8192, 128, "bfloat16", True, 0),         # S < T
    (1, 8, 2, 2048, 2048, 64, "bfloat16", True, 0),         # D = 64 causal
    # head dims without a kernel of their own, run zero-padded to the
    # route's next width (bf16 64 / 128; f32 64 / 80 / 128)
    (1, 16, 16, 1024, 1024, 80, "bfloat16", False, 0),      # hubert-xlarge
    (1, 16, 16, 1024, 1024, 80, "float32", False, 0),       # f32: its own width
    (1, 4, 2, 600, 600, 16, "bfloat16", True, 0),           # xlstm SMOKE
    (1, 4, 2, 600, 600, 16, "float32", True, 0),
    (2, 8, 8, 512, 512, 8, "bfloat16", True, 128),          # SMOKE configs
    (2, 8, 8, 512, 512, 8, "float32", True, 128),
    # f32: ragged S < T at D = 80, a ragged window, ragged non-causal S < T
    (1, 8, 2, 1000, 3000, 80, "float32", True, 0),
    (1, 4, 2, 777, 777, 128, "float32", True, 300),
    (2, 4, 4, 333, 1000, 64, "float32", False, 0),
]
# float32: |kernel - plain| <= atol + rtol * |plain|, entry by entry, to
# the accumulation order.  The bfloat16 entry is the limit of the CUDA-core
# bf16 kernel this repository had before the tensor-core one; it is read
# for the record only
FLASH_TOL = {"float32": (2e-5, 0.0), "bfloat16": (2e-5, 2.0 ** -7)}
# bfloat16, row by row against the all-float32 algorithm (ref32): for each
# query row, max_d |kernel - ref32| <= k * max_d |plain16 - ref32| + step *
# max_d |ref32|: no less accurate than the plain bf16 algorithm (P rounded
# to bf16, as the tensor cores take it) twice over, plus one bf16 output
# step at the row's scale
FLASH_ROW = (2.0, 2.0 ** -7)
# phase 3e: Mixtral 8x7B's attention (configs/mixtral_8x7b.py) over one
# prefill_32k sequence (configs/shapes.py)
ATTN_HEADS, ATTN_KV_HEADS, ATTN_DIM = 32, 8, 4096 // 32
ATTN_SEQ, ATTN_WINDOW = 32768, 4096
# and hubert-xlarge's (configs/hubert_xlarge.py: 16 heads, MHA, d_model
# 1280, non-causal), the same sequence
HUBERT_HEADS, HUBERT_DIM = 16, 1280 // 16


class SmokeFailure(RuntimeError):
    pass


def need(cond, what):
    if not cond:
        raise SmokeFailure(what)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=3, setup=None):
    """``(median device ms, last result)`` of ``fn()`` over ``reps`` runs
    (CUDA events; ``setup()`` runs untimed before each and its result is
    passed to ``fn``).  A spin kernel of about 1 ms runs before the first
    event, so the host enqueues ``fn``'s launches while the card is busy
    and a kernel shorter than its wrapper's host work is timed on the
    card alone."""
    import torch
    times, out = [], None
    for _ in range(reps):
        arg = setup() if setup else None
        out = None
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        a.record()
        out = fn(arg) if setup else fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2], out


def clone_state(st):
    from repro_torch.core.alias import AliasTable
    return st._replace(**{f: (None if getattr(st, f) is None
                              else getattr(st, f).clone())
                          for f in st._fields if f != "itable"},
                       itable=AliasTable(st.itable.prob.clone(),
                                         st.itable.alias.clone()))


def state_diff(a, b, what):
    """Max abs difference over every leaf of two states; fails the run
    unless they are bit-equal, so a returned value is 0.0."""
    import torch
    worst, bad = 0.0, []
    for name, x, y in zip(a._fields, a, b):
        if name == "itable":
            pairs = [("prob", x.prob, y.prob), ("alias", x.alias, y.alias)]
        else:
            pairs = [(name, x, y)]
        for n, p, q in pairs:
            if p is None:
                need(q is None, f"{what}: state leaf {n} None on one side only")
                continue
            if not torch.equal(p, q):
                d = (p.double() - q.double()).abs().max().item()
                worst = max(worst, d if d == d else float("inf"))
                bad.append(n)
    need(not bad, f"{what}: state leaves {bad} differ (max abs {worst})")
    return worst


def path_diff(got, want, what):
    """Max abs difference of two path tensors; fails unless equal."""
    err = float((got.long() - want.long()).abs().max())
    need(err == 0.0, f"{what}: kernel paths != plain (max abs {err}, "
         f"{int((got != want).sum())} entries differ)")
    return err


def random_graph(rng, V, C, bits):
    deg = rng.integers(1, C + 1, V)
    src = np.repeat(np.arange(V), deg).astype(np.int32)
    dst = rng.integers(0, V, src.size).astype(np.int32)
    w = rng.integers(1, 1 << bits, src.size).astype(np.int32)
    return src, dst, w


# ---------------------------------------------------------------- phase 2
WALK_CAPACITIES = (128, 512)        # phase 2's walk sweep; 512 is the
                                    # serving ladder's regrown width


def check_walk_kernel(rng):
    V, bits, B, L = 4096, 12, 2048, 24
    n = 0
    for C in WALK_CAPACITIES:
        src, dst, w = random_graph(rng, V, C, bits)
        keep = rng.random(V) >= 0.02                   # some dead ends
        keep = keep[src]
        n += walk_sweep(rng, V, C, bits, B, L, src[keep], dst[keep],
                        w[keep])
    return n


def walk_sweep(rng, V, C, bits, B, L, src, dst, w):
    """``walk_fused`` == plain over deepwalk/ppr/simple × base 2/4 × fp
    on/off × fed/hashed uniforms on one graph of capacity C."""
    import torch
    from repro_torch.core import dyngraph as dg
    from repro_torch.kernels import ops
    from repro_torch.kernels.walk_fused import walk_fused_ref
    n = 0
    for base_log2 in (1, 2):
        for fp in (False, True):
            wv = w.astype(np.float32) + rng.random(w.size).astype(np.float32) \
                if fp else w
            cfg = dg.BingoConfig(num_vertices=V, capacity=C, bias_bits=bits,
                                 base_log2=base_log2, fp_bias=fp, lam=4.0)
            st = dg.from_edges(cfg, src, dst, wv, device="cuda")
            starts = torch.from_numpy(rng.integers(0, V, B).astype(np.int32)).cuda()
            for kind in ("deepwalk", "ppr", "simple"):
                for fed in (True, False):
                    u = torch.from_numpy(rng.random((L, B, 6)).astype(
                        np.float32)).cuda() if fed else None
                    kw = dict(base_log2=base_log2, uniform=kind == "simple",
                              stop_prob=0.15 if kind == "ppr" else 0.0)
                    args = (st.itable.prob, st.itable.alias, st.bias, st.nbr,
                            st.deg, st.frac if fp else None, starts)
                    seed = int(rng.integers(0, 2**31 - 1))
                    got = ops.walk_fused(*args, seed, u, length=L, **kw)
                    want = walk_fused_ref(*args, u, seed=seed, length=L, **kw)
                    torch.cuda.synchronize()
                    need(torch.equal(got, want),
                         f"walk_fused != plain ({kind}, C={C}, base "
                         f"2^{base_log2}, fp={fp}, fed={fed})")
                    n += 1
    return n


def check_segment_kernel(rng):
    """The segment entry == ``walk_segment_ref``, bit for bit, at each of
    ``WALK_CAPACITIES`` (512: the relay's rows after the serving ladder's
    regrow)."""
    V, bits = 4096, 12
    n = 0
    for C in WALK_CAPACITIES:
        src, dst, w = random_graph(rng, V, C, bits)
        keep = (rng.random(V) >= 0.02)[src]            # some dead ends
        n += segment_sweep(rng, V, C, bits, src[keep], dst[keep], w[keep])
    return n


def segment_sweep(rng, V, C, bits, src, dst, w):
    """``walk_segment`` == plain over deepwalk/ppr/simple × base 2/4 × fp
    on/off × fed/hashed uniforms on one graph of capacity C, on a relay
    view (remote neighbours encoded -(g+2)) with start steps spread over
    [0, L+1], free slots and a permuted slot → walker id map."""
    import torch
    from repro_torch.core import dyngraph as dg
    from repro_torch.distributed.relay import relay_view
    from repro_torch.kernels import ops
    from repro_torch.kernels.walk_fused import walk_segment_ref
    B, L = 2048, 24
    lo, Vs = 1024, 2048                                # this view's shard
    n = 0
    for base_log2 in (1, 2):
        for fp in (False, True):
            wv = w.astype(np.float32) + rng.random(w.size).astype(np.float32) \
                if fp else w
            cfg = dg.BingoConfig(num_vertices=V, capacity=C, bias_bits=bits,
                                 base_log2=base_log2, fp_bias=fp, lam=4.0)
            view = relay_view(dg.from_edges(cfg, src, dst, wv, device="cuda"),
                              lo, Vs)
            need(bool((view.nbr <= -2).any()), "no remote neighbours")
            starts = torch.from_numpy(rng.integers(-1, Vs, B).astype(np.int32)).cuda()
            t0 = torch.from_numpy(rng.integers(0, L + 2, B).astype(np.int32)).cuda()
            t0[:2] = torch.tensor([L, L + 1], dtype=torch.int32)
            wid = torch.from_numpy(rng.permutation(B).astype(np.int32)).cuda()
            args = (view.itable.prob, view.itable.alias, view.bias, view.nbr,
                    view.deg, view.frac if fp else None, starts, t0)
            for kind in ("deepwalk", "ppr", "simple"):
                for fed in (True, False):
                    u = torch.from_numpy(rng.random((L, B, 6)).astype(
                        np.float32)).cuda() if fed else None
                    kw = dict(length=L, base_log2=base_log2,
                              uniform=kind == "simple",
                              stop_prob=0.15 if kind == "ppr" else 0.0)
                    seed = int(rng.integers(0, 2**31 - 1))
                    got = ops.walk_segment(*args, seed, u, wid, **kw)
                    want = walk_segment_ref(*args, u, wid, seed=seed, **kw)
                    torch.cuda.synchronize()
                    what = (f"{kind}, C={C}, base 2^{base_log2}, fp={fp}, "
                            f"fed={fed}")
                    need(all(torch.equal(a, b) for a, b in zip(got, want)),
                         f"walk_segment != plain ({what})")
                    need(bool((got[1][:, 0] >= 0).any()),
                         f"walk_segment: no frontier exit ({what})")
                    n += 1
    return n


def check_sample_kernels(rng):
    """Both per-step kernels == their plain versions, bit for bit, over
    base 2/4 × fp on/off × gathered / in-place rows (and 3 or 5 uniform
    columns on the base-2 integer path); every batch holds degree-0 rows."""
    import torch
    from repro_torch.core import dyngraph as dg
    from repro_torch.kernels import ops
    from repro_torch.kernels.walk_sample import (walk_sample_ref,
                                                walk_sample_uniform_ref)
    V, C, bits, B = 4096, 128, 12, 8192
    src, dst, w = random_graph(rng, V, C, bits)
    keep = (rng.random(V) >= 0.05)[src]                # degree-0 rows
    src, dst, w = src[keep], dst[keep], w[keep]
    n = 0
    for base_log2 in (1, 2):
        for fp in (False, True):
            wv = w.astype(np.float32) + rng.random(w.size).astype(np.float32) \
                if fp else w
            cfg = dg.BingoConfig(num_vertices=V, capacity=C, bias_bits=bits,
                                 base_log2=base_log2, fp_bias=fp, lam=4.0)
            st = dg.from_edges(cfg, src, dst, wv, device="cuda")
            tabs = (st.itable.prob, st.itable.alias, st.bias, st.nbr, st.deg)
            rows = torch.from_numpy(rng.integers(0, V, B).astype(np.int32)).cuda()
            need(bool((st.deg[rows.long()] == 0).any()), "no degree-0 rows")
            for in_place in (True, False):
                if in_place:
                    args, frac, kw = tabs, st.frac if fp else None, {"rows": rows}
                else:
                    r = rows.long()
                    args = tuple(x[r].contiguous() for x in tabs)
                    frac, kw = (st.frac[r].contiguous() if fp else None), {}
                for ncols in ((3, 5) if base_log2 == 1 and not fp else (5,)):
                    u = torch.from_numpy(rng.random((B, ncols)).astype(
                        np.float32)).cuda()
                    got = ops.walk_sample(*args, u, frac, base_log2=base_log2,
                                          **kw)
                    want = walk_sample_ref(*args, u, frac, base_log2=base_log2,
                                           **kw)
                    got_u = ops.walk_sample_uniform(args[3], args[4], u, **kw)
                    want_u = walk_sample_uniform_ref(args[3], args[4], u, **kw)
                    torch.cuda.synchronize()
                    what = (f"base 2^{base_log2}, fp={fp}, in_place={in_place}, "
                            f"u (B, {ncols})")
                    for name, g, x in (("walk_sample", got, want),
                                       ("walk_sample_uniform", got_u, want_u)):
                        need(all(torch.equal(a, b) for a, b in zip(g, x)),
                             f"{name} != plain ({what})")
                    n += 1
    return n


# (adaptive, fp_bias, base_log2): the update kernel's five config rows
UPDATE_CONFIGS = [(True, False, 1), (False, False, 1), (True, True, 1),
                  (True, False, 2), (True, True, 2)]
STREAMED_CAPACITIES = (37, 256, 300, 512)   # not a multiple of 32, the
                                            # main path's, past it, the
                                            # serving ladder's regrown width
ALIAS_KS = (1, 2, 5, 16, 17, 31, 32, 33, 63, 64)


def streamed_inputs(C, fp, seed):
    """The numpy inputs of ``streamed_state``: the graph ``(src, dst, w)``
    of 16 vertices (degrees 1..C/2, 6-bit biases) and a stream ``(ins, u,
    v, w)`` of single-edge updates: row 0 filled to C (two inserts
    rejected), row 1 emptied, row 2 a group 0 turned DENSE by an insert
    (its list left stale) and emptied by deletes (DENSE -> EMPTY keeps the
    list), row 3 a group 0 DENSE -> ONE (a rebuild), row 4 the same as row
    2 with a two-entry stale list, appended to once (ONE, an entry past
    gsize), then 60 random updates on rows 5-7.  Member bias 1 has digit 1
    in group 0 only; bias 0 is in no group; in fp mode a bias b is given
    as (b + 0.5) / 4 (lam 4), the same integer part."""
    V = 16
    rng = np.random.default_rng(seed)
    deg = rng.integers(1, C // 2 + 1, V)
    src = np.repeat(np.arange(V), deg).astype(np.int32)
    dst = rng.integers(0, V, src.size).astype(np.int32)
    w = rng.integers(1, 64, src.size).astype(np.int32)
    nbr = [dst[src == r] for r in range(V)]
    seq = [(True, 0, 1000 + i, int(rng.integers(1, 60)))
           for i in range(C - deg[0] + 2)]
    for r in (1, 2, 3, 4):
        seq += [(False, r, int(x), 0) for x in nbr[r]]
    seq += [(True, 2, 50, 0), (True, 2, 51, 0), (True, 2, 52, 1),
            (True, 2, 53, 1)] + [(False, 2, 50 + i, 0) for i in range(4)]
    seq += [(True, 3, 60, 1), (True, 3, 61, 0), (True, 3, 62, 0)]
    seq += [(True, 4, 70 + i, int(i >= 3)) for i in range(6)]
    seq += [(False, 4, 70 + i, 0) for i in range(6)]
    seq += [(True, 4, 80 + i, 0) for i in range(3)] + [(True, 4, 90, 1)]
    for _ in range(60):
        r = int(rng.integers(5, 8))
        if rng.random() < 0.55:
            seq.append((True, r, int(rng.integers(0, 8)),
                        int(rng.choice([0, 1, 2, 3, 5, 7]))))
        else:
            seq.append((False, r, int(rng.integers(0, 8)), 0))
    ins, uu, vv, ww = (np.array(x) for x in zip(*seq))
    uu, vv = uu.astype(np.int32), vv.astype(np.int32)
    if fp:
        w = ((w + 0.5) / 4.0).astype(np.float32)
        ww = ((ww + 0.5) / 4.0).astype(np.float32)
    else:
        ww = ww.astype(np.int32)
    return (src, dst, w), (ins, uu, vv, ww)


def streamed_config(C, adaptive, fp, base_log2):
    """``streamed_state``'s configuration: its keyword arguments of
    ``BingoConfig``."""
    return dict(num_vertices=16, capacity=C, bias_bits=6, base_log2=base_log2,
                fp_bias=fp, lam=4.0, adaptive=adaptive)


def streamed_state(C, adaptive, fp, base_log2, seed, device="cuda"):
    """A state that went through ``stream_updates`` after ``from_edges``
    (``streamed_inputs``), and its config."""
    import torch
    from repro_torch.core import dyngraph as dg
    from repro_torch.core.updates import stream_updates
    cfg = dg.BingoConfig(**streamed_config(C, adaptive, fp, base_log2))
    graph, stream = streamed_inputs(C, fp, seed)
    st = dg.from_edges(cfg, *graph, device=device)
    st, _ = stream_updates(st, cfg, *[torch.from_numpy(x).to(device)
                                      for x in stream])
    return st, cfg


def stale_lists(st, cfg):
    """Whether ``streamed_state`` left what it promises: row 0 full, row
    1 empty, and (adaptive mode) member lists that gsize and gtype do not
    describe: row 2's EMPTY group 0 with an entry, row 4's ONE group 0
    with an entry past gsize."""
    from repro_torch.core import dyngraph as dg
    gm, gt, gs = (x.cpu().numpy() for x in (st.gmem, st.gtype, st.gsize))
    return (int(st.deg[0]) == cfg.capacity and int(st.deg[1]) == 0
            and (not cfg.adaptive
                 or (gt[2, 0] == dg.EMPTY and gm[2, 0, 0] >= 0
                     and gt[4, 0] == dg.ONE and gs[4, 0] == 1
                     and gm[4, 0, 1] >= 0)))


def alias_weights(rng, V, K):
    """Weight rows (V, K) for ``alias_build``: random rows, an all-zero
    row, single-entry rows (first and last entry), equal weights, and
    totals near the 1e-30 floor of the scaled weights."""
    w = (rng.random((V, K)) * rng.integers(1, 100, (V, K))).astype(np.float32)
    w[0] = 0.0
    w[1, 1:] = 0.0
    w[2, :-1] = 0.0
    w[3] = 7.0
    w[4] = 1e-30 / K
    w[5] = rng.random(K).astype(np.float32) * 1e-31
    w[6, ::2] = 1e-30
    return w


def check_update_kernel(rng):
    import torch
    from repro_torch.core import dyngraph as dg
    from repro_torch.core.updates import batched_update
    from repro_torch.kernels import ops
    n = 0

    def round_of(V, edges, Bn, mode, fp):
        ins = {"insert": np.ones(Bn, bool), "delete": np.zeros(Bn, bool),
               "mixed": rng.random(Bn) < 0.5}[mode]
        uu = rng.integers(0, V, Bn).astype(np.int32)
        vv = rng.integers(0, V, Bn).astype(np.int32)
        hit = ~ins & (rng.random(Bn) < 0.8)
        pick = rng.integers(0, len(edges[0]), Bn)
        uu[hit], vv[hit] = edges[0][pick[hit]], edges[1][pick[hit]]
        ww = rng.integers(1, 64, Bn).astype(np.int32)
        if fp:
            ww = ww.astype(np.float32) + rng.random(Bn).astype(np.float32)
        return [torch.from_numpy(x).cuda() for x in (ins, uu, vv, ww)]

    def compare(st_k, st_p, cfg, batch, what):
        st_p, s_p = batched_update(st_p, cfg, *batch)
        st_k, s_k = ops.update_fused(st_k, cfg, *batch)
        torch.cuda.synchronize()
        state_diff(st_p, st_k, what)
        for name, a, b in zip(s_p._fields[:4], s_p, s_k):
            need(torch.equal(a, b), f"update stats {name} differ ({what})")
        return st_k, st_p

    V, C, Bn = 4096, 64, 4096
    for adaptive, fp, base_log2 in UPDATE_CONFIGS:
        src, dst, w = random_graph(rng, V, C // 2, 6)
        wv = w.astype(np.float32) + rng.random(w.size).astype(np.float32) \
            if fp else w
        cfg = dg.BingoConfig(num_vertices=V, capacity=C, bias_bits=6,
                             adaptive=adaptive, fp_bias=fp,
                             base_log2=base_log2)
        for mode in ("insert", "delete", "mixed"):
            st_k = dg.from_edges(cfg, src, dst, wv, device="cuda")
            st_p = clone_state(st_k)
            for _ in range(2):
                st_k, st_p = compare(st_k, st_p, cfg,
                                     round_of(V, (src, dst), Bn, mode, fp),
                                     f"{mode}, adaptive={adaptive}, fp={fp}, "
                                     f"base 2^{base_log2}")
                n += 1
    # one batch much wider than 2·C, concentrated on a few rows
    V, C, Bn = 64, 8, 2048
    src, dst, w = random_graph(rng, V, C // 2, 5)
    cfg = dg.BingoConfig(num_vertices=V, capacity=C, bias_bits=5)
    st_k = dg.from_edges(cfg, src, dst, w, device="cuda")
    st_p = clone_state(st_k)
    batch = round_of(4, (src[src < 4], dst[src < 4]), Bn, "mixed", False)
    compare(st_k, st_p, cfg, batch, "B > 2C")
    n += 1
    # states that went through stream_updates (stale member lists, full
    # and emptied rows), then a round touching every streamed row; and
    # the prep kernels against plan_round's torch ops on the CPU
    from repro_torch.kernels.update_fused import plan_round
    for C in STREAMED_CAPACITIES:
        for adaptive, fp, base_log2 in UPDATE_CONFIGS:
            what = (f"after streaming, C={C}, adaptive={adaptive}, fp={fp}, "
                    f"base 2^{base_log2}")
            st_k, cfg = streamed_state(C, adaptive, fp, base_log2,
                                       seed=C + base_log2)
            need(stale_lists(st_k, cfg), f"{what}: not the streamed state "
                 "promised")
            nbr = st_k.nbr.cpu().numpy()
            live = nbr >= 0
            edges = (np.nonzero(live)[0].astype(np.int32), nbr[live])
            batch = round_of(16, edges, 64, "mixed", fp)
            batch[1][:24] = torch.arange(8, dtype=torch.int32,
                                         device="cuda").repeat_interleave(3)
            want = plan_round(cfg, *[x.cpu() for x in batch])
            got = plan_round(cfg, *batch)
            for f, a, b in zip(want._fields, got, want):
                need(a.dtype == b.dtype and torch.equal(a.cpu(), b),
                     f"{what}: plan_round field {f} != its torch ops")
            compare(st_k, clone_state(st_k), cfg, batch, what)
            n += 1
    return n


# degrees on both sides of the histogram kernel's 32-slot short rows (a
# lane a row up to 32, 8 lanes a row past it) and its 16-byte words
HIST_DEGREES = (0, 1, 3, 4, 5, 7, 8, 9, 15, 16, 17, 31, 32, 33, 63, 64, 65,
                127, 128, 129, 255, 256)


def hist_inputs(rng, V, C, K):
    """``radix_hist`` inputs on the card: (V, C) biases below 2^K (K = 32:
    every int32) and degrees 0..C, each of ``HIST_DEGREES`` below C and C
    itself in every lane position of a warp's 32 rows."""
    import torch
    bias = rng.integers(0, 1 << K, (V, C), dtype=np.uint64).astype(
        np.uint32).view(np.int32)
    deg = rng.integers(0, C + 1, V).astype(np.int32)
    listed = np.array([x for x in HIST_DEGREES if x < C] + [C], np.int32)
    i = np.arange(32 * len(listed))
    deg[i] = listed[(i + i // 32) % len(listed)]
    return torch.from_numpy(bias).cuda(), torch.from_numpy(deg).cuda()


def check_table_kernels(rng):
    """``radix_hist`` and ``alias_build`` == their plain versions, bit for
    bit: K 4/16/31/32 × C 8/37/256 on ``hist_inputs``' 4,097 rows; K over
    ``ALIAS_KS`` on ``alias_weights``' rows, 4,097 of them (a last warp
    part full)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.alias_build import alias_build_ref
    from repro_torch.kernels.radix_hist import radix_hist_ref
    V, n = 4096, 0
    for K in (4, 16, 31, 32):
        for C in (8, 37, 256):
            bias, deg = hist_inputs(rng, V + 1, C, K)
            got = ops.radix_hist(bias, deg, num_k=K)
            want = radix_hist_ref(bias, deg, K)
            torch.cuda.synchronize()
            need(all(torch.equal(a, b) for a, b in zip(got, want)),
                 f"radix_hist != plain (K={K}, C={C})")
            n += 1
    for K in ALIAS_KS:
        w = torch.from_numpy(alias_weights(rng, V + 1, K)).cuda()
        got = ops.alias_build(w)
        want = alias_build_ref(w)
        torch.cuda.synchronize()
        need(all(torch.equal(a, b) for a, b in zip(got, want)),
             f"alias_build != plain (K={K})")
        n += 1
    return n


def flash_excess(got, want, dtype):
    """Largest ``|got - want| / (atol + rtol * |want|)`` over the entries,
    at ``FLASH_TOL[dtype]``: the limit holds where it is at most 1."""
    atol, rtol = FLASH_TOL[dtype]
    want = want.float()
    return float(((got.float() - want).abs() / (atol + rtol * want.abs())).max())


def flash_row_excess(got, plain, ref32):
    """Largest share of the bf16 limit ``FLASH_ROW`` over the query rows:
    ``max_d |got - ref32|`` over ``k * max_d |plain - ref32| + step *
    max_d |ref32|``; the limit holds where it is at most 1."""
    k, step = FLASH_ROW
    r = ref32.float()
    err = (got.float() - r).abs().amax(-1)
    lim = k * (plain.float() - r).abs().amax(-1) + step * r.abs().amax(-1)
    return float((err / lim.clamp_min(1e-30)).max())


def flash_refs(q, k, v, causal, window):
    """``(plain, ref32)``: the plain version of the kernel of q's type and,
    for bfloat16, the all-float32 algorithm (None for float32)."""
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention_ref,
                                                     flash_attention_ref32)
    plain = flash_attention_ref(q, k, v, causal=causal, window=window)
    ref32 = flash_attention_ref32(q, k, v, causal=causal, window=window) \
        if q.dtype == torch.bfloat16 else None
    return plain, ref32


def flash_limit(got, plain, ref32):
    """Share of its limit that ``got`` reaches: entry by entry at
    ``FLASH_TOL`` against the plain version in float32 (``ref32`` None),
    row by row at ``FLASH_ROW`` against ``ref32`` in bfloat16."""
    if ref32 is None:
        return flash_excess(got, plain, "float32")
    return flash_row_excess(got, plain, ref32)


def flash_route(dtype):
    """The launch counter of the kernel that takes ``dtype`` (a
    ``FLASH_CASES`` type name)."""
    return "flash_attention_sm90" if dtype == "bfloat16" else "flash_attention"


def shifted_window(T, window):
    """The window of a planted fault: the band's lower edge one 64-key tile
    off (``window + 64``) or, with no window, the first tile cut from the
    last rows (``T - 64``).  The limit must reject its output."""
    return window + 64 if window else T - 64


def flash_inputs(case, seed):
    """q, k and v of a ``FLASH_CASES`` entry on the card, from ``seed``."""
    import torch
    B, H, Hkv, S, T, D, dtype, _, _ = case
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn(shape, generator=g, device="cuda").to(
        getattr(torch, dtype)) for shape in
        ((B, H, S, D), (B, Hkv, T, D), (B, Hkv, T, D)))


def check_flash_kernel(rng):
    """``flash_attention`` over ``FLASH_CASES``, each case through the
    kernel of its type (the launch counters show which), held at its limit
    (``flash_limit``), and a planted fault (the kernel at
    ``shifted_window``) against the same limit, which must reject it.
    Returns, per case, the max abs difference from the plain version, the
    share of the limit, the fault's two, and in bf16 the readings of the
    old entry-by-entry ``FLASH_TOL`` (kernel, fault) against the plain
    version."""
    import torch
    from repro_torch.kernels import ops
    errs = []
    for case in FLASH_CASES:
        B, H, Hkv, S, T, D, dtype, causal, window = case
        q, k, v = flash_inputs(case, int(rng.integers(2**31)))
        route = flash_route(dtype)
        before = ops.launch_counts()
        got = ops.flash_attention(q, k, v, causal=causal, window=window)
        fault = ops.flash_attention(q, k, v, causal=causal,
                                    window=shifted_window(T, window))
        after = ops.launch_counts()
        need(after[route] == before[route] + 2
             and sum(after.values()) == sum(before.values()) + 2,
             f"flash_attention ({case}): launches {before} -> {after}")
        plain, ref32 = flash_refs(q, k, v, causal, window)
        err = float((got.float() - plain.float()).abs().max())
        fault_err = float((fault.float() - plain.float()).abs().max())
        excess = flash_limit(got, plain, ref32)
        fault_excess = flash_limit(fault, plain, ref32)
        need(got.dtype == q.dtype and bool(torch.isfinite(got).all())
             and excess <= 1,
             f"flash_attention != plain ({case}): max abs {err}, "
             f"{excess:.3f} of the limit")
        need(fault_excess > 1, f"flash_attention ({case}): the limit passes a "
             f"kernel one tile off ({fault_excess:.3f} of it)")
        old = None if ref32 is None else (flash_excess(got, plain, dtype),
                                          flash_excess(fault, plain, dtype))
        errs.append({"case": list(case), "max_abs_err": err, "excess": excess,
                     "fault_max_abs_err": fault_err,
                     "fault_excess": fault_excess, "old_tol_excess": old})
    return errs


def kernel_resources(name):
    """Per kernel function of the library of ``csrc/<name>.cu``: ptxas's
    registers, stack frame and spill stores (from this run's build log;
    from ``cuobjdump -res-usage``'s REG, STACK and LOCAL when the library
    was built before), in the order ptxas reports them."""
    import re
    from repro_torch.kernels import _build
    log = _build.BUILD_LOG.get(name)
    if log is not None:
        out, fn = [], None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                fn = {"function": m.group(1)}
                out.append(fn)
            elif fn is not None and "spill stores" in line:
                fn["spill_stores"] = int(re.search(r"(\d+) bytes spill stores",
                                                   line).group(1))
                fn["stack"] = int(re.search(r"(\d+) bytes stack frame",
                                            line).group(1))
            elif fn is not None and "Used" in line and "registers" in line:
                fn["registers"] = int(re.search(r"Used (\d+) registers",
                                                line).group(1))
        return out
    res = subprocess.run(
        [str(Path(_build._nvcc()).parent / "cuobjdump"), "-res-usage",
         str(_build._lib_path(name))], capture_output=True, text=True,
        timeout=300, check=True).stdout
    return [{"function": f, "registers": int(r), "stack": int(sk),
             "spill_stores": int(lo)}
            for f, r, sk, lo in re.findall(
                r"Function ([^:\s]+):\s*REG:(\d+) STACK:(\d+) SHARED:\d+ "
                r"LOCAL:(\d+)", res)]


def table_census():
    """Every kernel function of ``update_fused.cu`` (the round and its two
    prep kernels and the mark of U), ``alias_build.cu`` (its row widths)
    and ``radix_hist.cu``: registers, stack frame and spill stores
    (``kernel_resources``); no stack and no spills, so nothing of the
    warp-wide Vose row or of the histogram's bit planes and 16-byte row
    words lives in local memory."""
    out = {}
    for name in ("update_fused", "alias_build", "radix_hist"):
        res = kernel_resources(name)
        for x in res:
            print(f"{name} census: {x['function'][-60:]}: "
                  f"{x.get('registers')} registers, {x.get('stack')} bytes "
                  f"stack, {x.get('spill_stores')} bytes spill stores",
                  flush=True)
        need(res and all(x.get("stack") == 0 and x.get("spill_stores") == 0
                         for x in res), f"{name}: stack or spills {res}")
        out[name] = res
    return out


def sm90_census():
    """What nvcc made of the two attention libraries (bf16
    ``flash_attention_sm90``, f32 ``flash_attention``): per instantiation,
    registers and spill stores (``kernel_resources``), all spills 0; and
    in ``cuobjdump -sass`` of each library the count of HGMMA (wgmma),
    HMMA (mma.sync) and UTMALDG (TMA load) instructions: tensor-core
    instructions (HGMMA, or HMMA) and TMA loads present."""
    from repro_torch.kernels import _build
    out = {}
    for name in ("flash_attention_sm90", "flash_attention"):
        res = kernel_resources(name)
        sass = subprocess.run(
            [str(Path(_build._nvcc()).parent / "cuobjdump"), "-sass",
             str(_build._lib_path(name))],
            capture_output=True, text=True, timeout=300, check=True).stdout
        census = {"registers": [x.get("registers") for x in res],
                  "spill_stores": [x.get("spill_stores") for x in res],
                  "HGMMA": sass.count("HGMMA"), "HMMA": sass.count("HMMA"),
                  "UTMALDG": sass.count("UTMALDG")}
        print(f"{name} census: {census}", flush=True)
        need(res and all(x.get("spill_stores") == 0 for x in res),
             f"{name}: spill stores {census}")
        need(census["HGMMA"] + census["HMMA"] > 0 and census["UTMALDG"] > 0,
             f"{name}: no tensor-core instruction or no TMA load in the "
             f"SASS {census}")
        out[name] = census
    return out


def walk_census():
    """The walk kernels' six instantiations (whole walk and segment, each
    a tile of lanes a biased walker and a thread a simple one; the per-step
    sample and uniform pick): registers and spill stores
    (``kernel_resources``), no spills; and the resident blocks of 256
    threads per SM (the libraries' occupancy entries, what the persistent
    grids are sized by), as warps and as a share of the SM's 64.  The
    segment's preparation kernel (``segment_prep_kernel``) is not counted
    here."""
    import re
    from repro_torch.kernels import _build
    fused, sample = _build.library("walk_fused"), _build.library("walk_sample")
    rows = []
    for name in ("walk_fused", "walk_sample"):
        for x in kernel_resources(name):
            f = x["function"]
            m = re.search(r"walk_fused_kernelILb(\d)ELi(\d+)E", f)
            if m:
                seg, lanes = int(m.group(1)), int(m.group(2))
                label = (f"walk_fused<{'segment' if seg else 'whole'}, "
                         f"{lanes} lane{'s' if lanes > 1 else ''}>")
                blocks = fused.walk_fused_occupancy(seg, int(lanes == 1))
            elif "walk_sample_kernel" in f:
                label, blocks = "walk_sample", sample.walk_sample_occupancy()
            elif "walk_sample_uniform_kernel" in f:
                label, blocks = "walk_sample_uniform", None
            else:
                continue
            rows.append(dict(x, kernel=label, blocks_per_sm=blocks,
                             warps_per_sm=None if blocks is None else 8 * blocks,
                             occupancy=None if blocks is None else blocks / 8))
    for r in rows:
        occ = "" if r["blocks_per_sm"] is None else (
            f", {r['blocks_per_sm']} blocks/SM = {r['warps_per_sm']} warps "
            f"({100 * r['occupancy']:.1f} % of 64)")
        print(f"walk census: {r['kernel']}: {r.get('registers')} registers, "
              f"{r.get('spill_stores')} bytes spill stores{occ}", flush=True)
    need(len(rows) == 6 and all(r.get("spill_stores") == 0 for r in rows),
         f"walk kernels: census {rows}")
    return rows


# ---------------------------------------------------------------- phase 3
def check_paths(name, p, st, starts, cfg):
    """A walk batch is real: column 0 equals the starts, vertices in range,
    no walker revives after -1, and every hop of the first
    ``CHECK_WALKERS`` walkers is an edge of ``st``."""
    import torch
    V = cfg.num_vertices
    need(tuple(p.shape) == (len(starts), p.shape[1]), f"{name}: path shape")
    need(torch.equal(p[:, 0], starts), f"{name}: column 0 != starts")
    need(bool(((p >= -1) & (p < V)).all()), f"{name}: vertex out of range")
    dead = p[:, :-1] < 0
    need(not bool((dead & (p[:, 1:] >= 0)).any()), f"{name}: revived walker")
    a, b = p[:CHECK_WALKERS, :-1].long(), p[:CHECK_WALKERS, 1:].long()
    hop = (a >= 0) & (b >= 0)
    rows = st.nbr[a[hop]]
    ok = ((rows == b[hop][:, None])
          & (torch.arange(cfg.capacity, device=p.device)[None, :]
             < st.deg[a[hop]][:, None])).any(1)
    need(bool(ok.all()), f"{name}: a hop that is not an edge")


def tv_bound(probs, n, delta=1e-6):
    """A TV distance a correct sampler exceeds with probability < delta at
    ``n`` samples: E[TV] <= ½ Σ sqrt(p(1-p)/n), plus McDiarmid's
    sqrt(ln(1/delta) / 2n) (one sample moves TV by at most 1/n)."""
    import torch
    p = probs[probs > 0].double()
    return (0.5 * float(torch.sqrt(p * (1 - p) / n).sum())
            + math.sqrt(math.log(1 / delta) / (2 * n)))


def check_distribution(name, nxt, want, V):
    """TV of the empirical next-vertex distribution of ``nxt`` against
    ``want`` (V,), within ``tv_bound``; returns ``(tv, bound, n)``."""
    import torch
    n = nxt.numel()
    need(n > 0, f"{name}: no samples")
    emp = torch.bincount(nxt, minlength=V).double() / n
    tv = 0.5 * float((emp - want.double()).abs().sum())
    b = tv_bound(want, n)
    print(f"{name}: TV {tv:.4f} over {n} samples, bound {b:.4f}", flush=True)
    need(tv < b, f"{name}: TV {tv:.4f} >= bound {b:.4f}")
    return {"tv": tv, "tv_bound": b, "samples": n}


def bound(nbytes, nops):
    """``(bound_ms, bound_by)``: the larger of bytes over the memory rate
    and 32-bit operations over the float32 rate outside the tensor cores
    (the published table has no separate integer rate)."""
    t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, nops / OPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def walk_work(path, deg, uniform):
    """The work this run's walks need, each input word read once.

    A step is drawn at every live column t < L; it reads ``deg[cur]`` and,
    when the walker moves on, one prob and one alias entry and the bias
    row ``bias[cur, 0:deg]`` (the group's members are found by their
    digits: two operations per bias word), and the picked nbr word.
    Counted over distinct vertices (deg, prob/alias, bias rows) and
    distinct (vertex, next) hops (nbr words), plus the starts read and the
    (B, L+1) path written.  ``step_bytes`` is what the steps read if no
    row were ever reused from cache: 32-byte sectors for each scattered
    word, the bias row in sectors, per step.
    """
    import torch
    B, L1 = path.shape
    cur, nxt = path[:, :-1].long(), path[:, 1:].long()
    drawn, moved = cur >= 0, nxt >= 0
    x_drawn = torch.unique(cur[drawn])
    x_moved = torch.unique(cur[moved])
    hops = torch.unique(cur[moved] * deg.shape[0] + nxt[moved]).numel()
    d_moved = deg[cur[moved]].long()
    words = B + B * L1 + x_drawn.numel() + hops
    steps, moves = int(drawn.sum()), int(moved.sum())
    sectors = steps + moves                        # deg, nbr
    ops = 0
    if not uniform:
        words += 2 * x_moved.numel() + int(deg[x_moved].long().sum())
        sectors += 2 * moves + int(((d_moved + 7) // 8).sum())
        ops = 2 * int(d_moved.sum())
    return {"bytes": 4 * words, "ops": ops, "alive_steps": steps,
            "moves": moves, "distinct_rows": x_moved.numel(),
            "step_bytes": 32 * sectors + 4 * (B + B * L1)}


def update_work(plan, old, new, cfg):
    """The work the round needs, each word read or written once.

    Per affected row: read deg and the nbr/bias (and, in fp mode, frac)
    slots below the old degree; write deg and those rows below
    max(old, new degree); write each group's member list up to the
    larger of its old and new kept length (ginv below max degree in
    baseline mode); write the O(K) counters and the Kin alias row.  Per
    lane the kernel reads its sorted insert or delete lane (value and
    rank); per row its five segment words.  Operations: the
    rebuild's digit extract, test and add per group and slot, one compare
    per delete lane and slot, Kin^2 Vose steps.
    """
    import torch
    from repro_torch.core.dyngraph import DENSE
    V, C, K, Cg, Kin = (cfg.num_vertices, cfg.capacity, cfg.num_radix,
                        cfg.group_capacity, cfg.num_inter)
    real = plan.U < V
    U = plan.U[real].long()
    d0, d1 = old.deg[U].long(), new.deg[U].long()
    dmax = torch.maximum(d0, d1)
    cols = 3 if cfg.fp_bias else 2               # nbr, bias (, frac)

    def kept(st):
        gs = st.gsize[U].long().clamp(max=Cg)
        return gs.masked_fill(st.gtype[U] == DENSE, 0) if cfg.adaptive else gs

    n_ins = (plan.ins_hi - plan.ins_lo)[real].long()
    n_del = (plan.del_hi - plan.del_lo)[real].long()
    rows = U.numel()
    words = (2 * rows + cols * int(d0.sum()) + cols * int(dmax.sum())
             + int(torch.maximum(kept(old), kept(new)).sum())
             + (0 if cfg.adaptive else K * int(dmax.sum()))
             + rows * (2 * K + 1 + 2 * Kin) + 5 * rows
             + cols * int(n_ins.sum()) + 2 * int(n_del.sum()))
    nbytes = 4 * words + rows * K                                  # gtype
    post = (d0 + n_ins).clamp(max=C)
    ops = (3 * K * int(d1.sum()) + int((n_del * post).sum())
           + rows * Kin * Kin)
    return {"bytes": nbytes, "ops": ops, "affected_rows": rows}


def main_path(args, report):
    import torch
    from repro_torch.core import dyngraph as dg
    from repro_torch.core.updates import batched_update
    from repro_torch.core.walks import WalkParams, ppr, random_walk
    from repro_torch.graph.rmat import degree_bias, rmat_edges
    from repro_torch.graph.streams import make_update_stream
    from repro_torch.kernels import ops
    from repro_torch.kernels.update_fused import launch_round, plan_round
    from repro_torch.kernels.walk_fused import walk_fused_ref
    from repro_torch.serve import DynamicWalkEngine

    scale, rounds = args.scale, 10
    V = 1 << scale
    t0 = time.perf_counter()
    src, dst = rmat_edges(scale, 8, seed=0)
    w = degree_bias(src, dst, V, bias_bits=16)
    batch = min(100_000, len(src) // (4 * rounds))
    stream = make_update_stream(src, dst, w, batch_size=batch, rounds=rounds,
                                mode="mixed", seed=0)
    report["host_data_s"] = time.perf_counter() - t0
    cfg = dg.BingoConfig(num_vertices=V, capacity=256, bias_bits=16)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = dg.from_edges(cfg, stream.init_src, stream.init_dst,
                          stream.init_w, device="cuda")
    torch.cuda.synchronize()
    report["from_edges_s"] = time.perf_counter() - t0
    report["state_gib"] = sum(
        x.numel() * x.element_size() for x in
        [state.nbr, state.bias, state.frac, state.deg, state.gmem,
         state.gsize, state.digitsum, state.wdec, state.gtype,
         state.itable.prob, state.itable.alias]) / 2**30
    print(f"main path: V=2^{scale}, {len(stream.init_src)} initial edges, "
          f"{rounds} rounds x {batch} updates, state "
          f"{report['state_gib']:.2f} GiB, from_edges "
          f"{report['from_edges_s']:.2f} s", flush=True)

    def dev_round(r):
        return [torch.from_numpy(np.ascontiguousarray(a[r])).cuda()
                for a in (stream.is_insert, stream.u, stream.v, stream.w)]

    # round 1 through the plain version, on a copy
    plain1, _ = batched_update(clone_state(state), cfg, *dev_round(0))
    engine = DynamicWalkEngine(state, cfg, WalkParams("deepwalk", WALK_LEN),
                               seed=0)
    starts = torch.arange(0, V, 4, dtype=torch.int32, device="cuda")
    pre_last = None
    round_ms = []
    round_stats = []
    applied = 0
    upd_err = 0.0
    ops.reset_launch_counts()
    plan_round.launches = 0
    torch.cuda.synchronize()
    t_main = time.perf_counter()
    t_r = t_main
    for r, stats, paths in engine.run_stream(stream, starts):
        torch.cuda.synchronize()
        now = time.perf_counter()
        round_ms.append((now - t_r) * 1e3)
        need(int(stats.ins_applied) + int(stats.del_applied)
             + int(stats.rejected.sum()) == batch,
             f"round {r}: applied + rejected != {batch}")
        need(int(stats.rejected[1]) == 0, f"round {r}: vertex rejects")
        applied += int(stats.ins_applied) + int(stats.del_applied)
        round_stats.append(stats_list(stats))
        need(tuple(paths.shape) == (len(starts), WALK_LEN + 1),
             f"round {r}: path shape {tuple(paths.shape)}")
        if r == 0:
            upd_err = state_diff(plain1, engine.state, "round 1 vs batched_update")
            del plain1
        if r == rounds - 2:
            pre_last = clone_state(engine.state)
        last_paths, last_seed = paths, engine.last_seed
        torch.cuda.synchronize()
        t_r = time.perf_counter()
    t_stream = time.perf_counter() - t_main
    ppr_paths = ppr(engine.state, cfg, starts, 1234, max_length=PPR_LEN,
                    stop_prob=PPR_STOP)
    simple_paths = random_walk(engine.state, cfg, starts, 4321,
                               WalkParams("simple", WALK_LEN))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    report["launches"] = counts
    print(f"main path launches: {counts}; update prep kernels (plan_round) "
          f"{plan_round.launches} rounds", flush=True)
    need(counts["update_fused"] == rounds, "update_fused launches != rounds")
    need(plan_round.launches == rounds, "plan_round's kernels != rounds")
    need(counts["walk_fused"] == rounds + 2, "walk_fused launches != walks")

    # outputs: the paths are real walks on the current state
    st = engine.state
    for name, p in (("deepwalk", last_paths), ("ppr", ppr_paths),
                    ("simple", simple_paths)):
        check_paths(name, p, st, starts, cfg)
    ppr_len = float((ppr_paths[:, 1:] >= 0).sum(1).float().mean())
    report.update(round_ms=round_ms, round_stats=round_stats,
                  round_median_ms=statistics.median(round_ms),
                  round_mean_ms=statistics.mean(round_ms), stream_s=t_stream,
                  updates_applied=applied, ppr_mean_hops=ppr_len)
    print(f"run_stream: {t_stream:.3f} s for {rounds} rounds (per round ms "
          f"{[round(x, 2) for x in round_ms]}; median "
          f"{report['round_median_ms']:.2f}, mean {report['round_mean_ms']:.2f}); "
          f"ppr mean hops {ppr_len:.2f}", flush=True)

    # ---- phase 4: times at the main path's shapes; the plain versions'
    # outputs are held against the main path's, whole batches
    args_w = (st.itable.prob, st.itable.alias, st.bias, st.nbr, st.deg, None,
              starts)
    walks = {}
    for kind, got, seed, kw in (
            ("deepwalk", last_paths, last_seed, dict(length=WALK_LEN)),
            ("ppr", ppr_paths, 1234, dict(length=PPR_LEN, stop_prob=PPR_STOP)),
            ("simple", simple_paths, 4321, dict(length=WALK_LEN, uniform=True))):
        ms, _ = cuda_ms(lambda: ops.walk_fused(*args_w, seed, **kw))
        plain_ms, want = cuda_ms(lambda: walk_fused_ref(*args_w, seed=seed,
                                                        **kw), reps=1)
        err = path_diff(got, want, f"main path {kind}")
        del want
        work = walk_work(got, st.deg, kind == "simple")
        b_ms, b_by = bound(work["bytes"], work["ops"])
        walks[kind] = dict(work, ms=ms, plain_ms=plain_ms, max_abs_err=err,
                           bound_ms=b_ms, bound_by=b_by,
                           step_bytes_ms=work["step_bytes"] / HBM_BYTES_PER_S * 1e3,
                           steps_per_s=work["alive_steps"] / ms * 1e3)
        print(f"walk_fused {kind}: {ms:.3f} ms, {work['alive_steps']} alive "
              f"steps ({work['alive_steps'] / ms / 1e3:.1f} M steps/s); "
              f"plain {plain_ms:.1f} ms, equal on all {len(starts)} walkers; "
              f"needs {work['bytes'] / 1e9:.4f} GB over {work['distinct_rows']} "
              f"distinct rows and {work['ops'] / 1e9:.3f} G ops -> bound "
              f"{b_ms:.4f} ms ({b_by}); per-step bytes with no reuse "
              f"{work['step_bytes'] / 1e9:.3f} GB -> "
              f"{walks[kind]['step_bytes_ms']:.3f} ms", flush=True)

    last = dev_round(rounds - 1)
    plan = plan_round(cfg, *last)
    plain_plan = plan_round(cfg, *[x.cpu() for x in last])
    for f, a, b in zip(plan._fields, plan, plain_plan):
        need(a.dtype == b.dtype and torch.equal(a.cpu(), b),
             f"round 10: plan_round field {f} != its torch ops")
    del plain_plan
    plan_ms, _ = cuda_ms(lambda: plan_round(cfg, *last))
    upd_ms, _ = cuda_ms(lambda s: launch_round(s, cfg, plan),
                        setup=lambda: clone_state(pre_last))
    round_wrapper_ms, _ = cuda_ms(lambda s: ops.update_fused(s, cfg, *last),
                                  setup=lambda: clone_state(pre_last))
    upd_plain_ms, (plain_last, _) = cuda_ms(
        lambda s: batched_update(s, cfg, *last), reps=1,
        setup=lambda: clone_state(pre_last))
    upd_err = max(upd_err, state_diff(plain_last, st, "round 10 vs batched_update"))
    del plain_last
    no_sync_round(pre_last, cfg, last, st, round_stats[-1])
    uwork = update_work(plan, pre_last, st, cfg)
    u_ms, u_by = bound(uwork["bytes"], uwork["ops"])
    dw = walks["deepwalk"]
    kernels = [
        {"name": "walk_fused", "route": "cuda",
         "source": "src/repro_torch/csrc/walk_fused.cu",
         "replaces": "src/repro/kernels/walk_fused.py:444",
         "launches": counts["walk_fused"],
         "max_abs_err": max(w["max_abs_err"] for w in walks.values()),
         "ms": dw["ms"], "plain_ms": dw["plain_ms"],
         "bound_ms": dw["bound_ms"], "bound_by": dw["bound_by"],
         "library_ms": None},
        {"name": "update_fused", "route": "cuda",
         "source": "src/repro_torch/csrc/update_fused.cu",
         "replaces": "src/repro/kernels/update_fused.py:452",
         "launches": counts["update_fused"], "max_abs_err": upd_err,
         "ms": upd_ms, "plain_ms": upd_plain_ms,
         "bound_ms": u_ms, "bound_by": u_by, "library_ms": None},
    ]
    report.update(
        walks=walks,
        update=dict(uwork, kernel_ms=upd_ms, round_ms=round_wrapper_ms,
                    plan_ms=plan_ms,
                    plain_ms=upd_plain_ms, bound_ms=u_ms, bound_by=u_by,
                    batch=batch, updates_per_s=batch / round_wrapper_ms * 1e3),
        kernels=kernels)
    print(f"update_fused: kernel {upd_ms:.4f} ms, prepass (plan_round) "
          f"{plan_ms:.4f} ms, whole round "
          f"{round_wrapper_ms:.4f} ms ({batch / round_wrapper_ms * 1e3:.0f} "
          f"updates/s), {uwork['affected_rows']} rows; plain {upd_plain_ms:.1f} "
          f"ms, states equal after rounds 1 and 10 (and the prepass to its "
          f"torch ops); needs "
          f"{uwork['bytes'] / 1e9:.4f} GB and {uwork['ops'] / 1e9:.3f} G ops "
          f"-> bound {u_ms:.4f} ms ({u_by})", flush=True)
    profile = None
    if args.profile:
        def profile():
            try:    # a diagnostic: a profiler fault does not fail the smoke
                report["profile"] = profile_round(pre_last, cfg, last, starts,
                                                  args.profile)
            except Exception as e:          # noqa: BLE001
                traceback.print_exc()
                print(f"profiled round: failed ({e!r})", flush=True)
                report["profile"] = {"error": repr(e)}
    return kernels, engine, cfg, starts, stream, (src, dst, w), profile


def no_sync_round(pre, cfg, lanes, want, want_stats):
    """The main path's last round once more through ``ops.update_fused``
    under ``torch.cuda.set_sync_debug_mode("error")``: any host sync in
    the round raises; its state and stats must equal the main path's."""
    import torch
    from repro_torch.kernels import ops
    st = clone_state(pre)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        st, stats = ops.update_fused(st, cfg, *lanes)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    state_diff(want, st, "round 10 under sync debug mode")
    need(stats_list(stats) == want_stats,
         "round 10 under sync debug mode: stats != the main path's")
    print("update_fused: round 10 again under set_sync_debug_mode('error'): "
          "no host sync, state and stats equal", flush=True)


def stats_list(stats):
    """An ``UpdateStats``' counters as nested lists (JSON)."""
    return [x.tolist() for x in stats[:4]]


# --------------------------------------------------------------- phase 3d
def degree_histogram(deg, C):
    """Rows by degree (clamped to C): 0, 1-8, 9-32 (``radix_hist.cu``
    counts a row up to 32 in its own lane), 33 to C-1 (8 lanes a row) and
    C (full rows)."""
    d = deg.clamp(min=0, max=C)
    return {f"{lo}-{hi}" if lo < hi else str(lo): int(((d >= lo) & (d <= hi)).sum())
            for lo, hi in ((0, 0), (1, 8), (9, 32), (33, C - 1), (C, C))}


def table_phase(engine, cfg, report):
    """Phase 3d: ``radix_hist`` and ``alias_build`` on the main path's
    final state, through ``ops``, the counters zeroed just before and read
    just after; their outputs and the plain versions' must equal the
    tables the state keeps.  Returns the two kernels' lines."""
    import torch
    from repro_torch.core.radix import group_weights
    from repro_torch.kernels import ops
    from repro_torch.kernels.alias_build import alias_build_ref
    from repro_torch.kernels.radix_hist import radix_hist_ref
    st = engine.state
    need(not cfg.fp_bias and cfg.base_log2 == 1,
         "phase 3d expects a base-2 integer state")
    K = cfg.num_radix
    V, C = st.bias.shape
    gw = group_weights(st.digitsum, cfg.base_log2)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    ds, gs = ops.radix_hist(st.bias, st.deg, num_k=K)
    prob, alias = ops.alias_build(gw)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    print(f"tables on the final state, launches: {counts}", flush=True)
    need(counts["radix_hist"] == counts["alias_build"] == 1
         and sum(counts.values()) == 2, f"phase 3d launches {counts}")

    def same_hist(got, what):
        need(torch.equal(got[0], st.digitsum) and torch.equal(got[1], st.gsize),
             f"{what} on the final state != (digitsum, gsize)")

    def same_itable(got, what):
        need(torch.equal(got[0], st.itable.prob)
             and torch.equal(got[1], st.itable.alias),
             f"{what} on the final state != state.itable")

    same_hist((ds, gs), "radix_hist")
    same_itable((prob, alias), "alias_build")
    del ds, gs, prob, alias
    hist = degree_histogram(st.deg, C)
    report["degree_histogram"] = hist
    print(f"rows by degree on the final state: {hist}", flush=True)
    edges = int(st.deg.clamp(max=C).sum())
    lines = []
    for name, fn, ref, same, nbytes, nops, replaces in (
            ("alias_build", lambda: ops.alias_build(gw),
             lambda: alias_build_ref(gw), same_itable, 4 * 3 * V * K,
             V * (K * K + 3 * K), "src/repro/kernels/alias_build.py:67"),
            ("radix_hist", lambda: ops.radix_hist(st.bias, st.deg, num_k=K),
             lambda: radix_hist_ref(st.bias, st.deg, K), same_hist,
             4 * (V + edges + 2 * V * K), 4 * K * edges,
             "src/repro/kernels/radix_hist.py:48")):
        ms, got = cuda_ms(fn)
        same(got, name)
        plain_ms, want = cuda_ms(ref, reps=1)
        same(want, f"{name} plain")
        del got, want
        b_ms, b_by = bound(nbytes, nops)
        report[name] = {"ms": ms, "plain_ms": plain_ms, "bytes": nbytes,
                        "ops": nops, "bound_ms": b_ms, "bound_by": b_by,
                        "launches": counts[name], "edges": edges}
        print(f"{name}: {ms:.4f} ms on the final state ({V} rows, K={K}, "
              f"{edges} edges); plain {plain_ms:.2f} ms; both equal to the "
              f"state's tables; needs {nbytes / 1e6:.1f} MB and "
              f"{nops / 1e6:.1f} M ops -> bound {b_ms:.4f} ms ({b_by})",
              flush=True)
        lines.append({"name": name, "route": "cuda",
                      "source": f"src/repro_torch/csrc/{name}.cu",
                      "replaces": replaces, "launches": counts[name],
                      "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
    return lines


# --------------------------------------------------------------- phase 3b
def sample_work(rows, nxt, deg, ucols, uniform):
    """The work one per-step sample of every walker needs, each word read
    once, counted as ``walk_work`` counts a step: per distinct row its deg
    word and, for the biased sample of a row with edges, one prob and one
    alias entry and its bias row (deg words, two operations each); one
    nbr word per distinct (row, next) hop; the rows and ``ucols`` uniform
    columns read and the (nxt, slot) pair written per walker."""
    import torch
    r = rows.long()
    B, V = r.numel(), deg.shape[0]
    live = nxt >= 0
    words = (torch.unique(r).numel()
             + torch.unique(r[live] * V + nxt[live].long()).numel()
             + B * (1 + ucols + 2))
    ops = 0
    if not uniform:
        d = deg[r].long()
        xm = torch.unique(r[d > 0])
        words += 2 * xm.numel() + int(deg[xm].long().sum())
        ops = 2 * int(d.sum())
    return {"bytes": 4 * words, "ops": ops, "walkers": B}


def n2v_probs(st, cfg, prev, cur, p, q):
    """Exact node2vec P(v | prev, cur) ∝ w(cur, v)·f(prev, v) by vertex:
    f = 1/p for v == prev, 1 for v ∈ N(prev), 1/q otherwise (Eq. 1)."""
    import torch
    d, dp = int(st.deg[cur]), int(st.deg[prev])
    nb = st.nbr[cur, :d].long()
    w = st.bias[cur, :d].float() + st.frac[cur, :d]
    f = torch.where(nb == prev, 1.0 / p,
                    torch.where(torch.isin(nb, st.nbr[prev, :dp].long()),
                                1.0, 1.0 / q))
    probs = torch.zeros(cfg.num_vertices, dtype=torch.float64,
                        device=nb.device).index_add_(0, nb, (w * f).double())
    return probs / probs.sum()


def first_order_probs(st, cfg, v):
    """Eq. 2 next-vertex distribution out of ``v`` (``transition_probs``)."""
    import torch
    from repro_torch.core.sampler import transition_probs
    d = int(st.deg[v])
    p = transition_probs(st, cfg, torch.tensor([v], device=st.deg.device))[0]
    return torch.zeros(cfg.num_vertices, dtype=torch.float64,
                       device=p.device).index_add_(
        0, st.nbr[v, :d].long(), p[:d].double())


def launch_events(runs, trace):
    """Run each ``(fn, kernel)`` of ``runs`` once, in order, in one
    ``torch.profiler`` session (device activity only), each ``ops.<kernel>``
    call (``walk_sample`` or ``walk_sample_uniform``: the per-step paths
    reach the kernels through them) counting its walkers.  Returns, a run
    each, the walkers of its launches and the device ms of the trace's
    ``<kernel>_kernel`` events that fall to it: a kernel's events in time
    order, handed out to its runs by their launch counts (each run is
    synchronized before the next starts).  Checks nothing: a trace may
    hold fewer events than launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ops
    walkers = [[] for _ in runs]

    def counted(inner, i):
        def call(*args, **kw):
            out = inner(*args, **kw)
            walkers[i].append(out[0].shape[0])
            return out
        return call
    trace.parent.mkdir(parents=True, exist_ok=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i, (fn, kernel) in enumerate(runs):
            inner = getattr(ops, kernel)
            setattr(ops, kernel, counted(inner, i))
            try:
                fn()
                torch.cuda.synchronize()
            finally:
                setattr(ops, kernel, inner)
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text()).get("traceEvents", [])
    trace.unlink()
    ms = {kernel: [float(e.get("dur", 0)) / 1e3 for e in sorted(
        (e for e in events if e.get("cat") == "kernel"
         and f"{kernel}_kernel" in e.get("name", "")),
        key=lambda e: float(e["ts"]))] for _, kernel in runs}
    out = []
    for (_, kernel), w in zip(runs, walkers):
        out.append((w, ms[kernel][:len(w)]))
        ms[kernel] = ms[kernel][len(w):]
    return out


def sample_launches(runs, trace):
    """``launch_events`` of ``runs``, each run's launches all in the trace
    or the smoke fails: per run the walkers and the device ms of each of
    its launches, for an untimed replay of a batch.  One session for all
    runs: a later profiler session in a process has lost kernel events
    (PERF.md §7)."""
    res = []
    for (_, kernel), (walkers, ms) in zip(runs, launch_events(runs, trace)):
        need(0 < len(ms) == len(walkers), f"sample_launches: {len(ms)} "
             f"{kernel} kernel events for {len(walkers)} launches")
        res.append({"launches": len(ms), "walkers": walkers, "ms": ms,
                    "walkers_sum": sum(walkers), "kernel_ms_sum": sum(ms),
                    "walkers_max": max(walkers),
                    "walkers_median": statistics.median(walkers)})
    return res


def per_step_paths(engine, cfg, starts, report, profile_dir=None):
    """node2vec, per-step deepwalk and per-step simple batches through
    ``DynamicWalkEngine.walk`` on the final state, each with the launch
    counters zeroed just before and read just after; the whole-walk
    deepwalk batch's wall time beside them.  With ``profile_dir`` each
    batch runs once more under ``torch.profiler``.  Returns the kernels'
    lines."""
    import torch
    from repro_torch.core import walks
    from repro_torch.core.walks import WalkParams
    from repro_torch.kernels import ops
    from repro_torch.kernels.walk_sample import (walk_sample_ref,
                                                walk_sample_uniform_ref)
    from repro_torch.serve import DynamicWalkEngine
    st = engine.state
    V = cfg.num_vertices
    out, engines = {}, {}
    cases = (
        ("whole deepwalk", WalkParams("deepwalk", WALK_LEN), None),
        ("node2vec", WalkParams("node2vec", WALK_LEN, p=N2V_P, q=N2V_Q), None),
        ("per-step deepwalk", WalkParams("deepwalk", WALK_LEN), False),
        ("per-step simple", WalkParams("simple", WALK_LEN), False))
    for i, (name, params, whole) in enumerate(cases):
        eng = DynamicWalkEngine(st, cfg, params, whole_walk=whole, seed=10 + i)
        for k in walks.N2V_COUNTS:
            walks.N2V_COUNTS[k] = 0
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        p = eng.walk(starts)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        counts = ops.launch_counts()
        check_paths(name, p, st, starts, cfg)
        alive = int((p[:, 1:] >= 0).sum())
        out[name] = {"wall_ms": wall, "launches": counts,
                     "alive_steps": alive, "seed": eng.last_seed,
                     "n2v": dict(walks.N2V_COUNTS)}
        print(f"{name}: {wall:.2f} ms wall, {alive} alive steps, launches "
              f"{counts}" + (f", node2vec {walks.N2V_COUNTS}"
                             if name == "node2vec" else ""), flush=True)
        if name == "whole deepwalk":
            need(counts["walk_fused"] == 1, f"{name}: walk_fused launches")
        elif name == "node2vec":
            need(counts["walk_sample"] == walks.N2V_COUNTS["trials"] > 0,
                 f"{name}: walk_sample launches != proposal trials")
            need(counts["walk_fused"] == counts["walk_sample_uniform"] == 0,
                 f"{name}: launches of other kernels")
            a, b, c = (p[:, :-2].long(), p[:, 1:-1].long(), p[:, 2:].long())
            ok = (a >= 0) & (b >= 0) & (c >= 0)
            keys, cnt = torch.unique(a[ok] * V + b[ok], return_counts=True)
            key = int(keys[torch.argmax(cnt)])
            prev, cur = key // V, key % V
            sel = ok & (a == prev) & (b == cur)
            out[name]["dist"] = dict(
                check_distribution(f"{name} from (prev {prev}, cur {cur})",
                                   c[sel], n2v_probs(st, cfg, prev, cur,
                                                     N2V_P, N2V_Q), V),
                prev=prev, cur=cur)
        elif name == "per-step deepwalk":
            need(counts["walk_sample"] == WALK_LEN, f"{name}: walk_sample "
                 f"launches {counts['walk_sample']} != {WALK_LEN}")
            need(counts["walk_fused"] == 0, f"{name}: walk_fused launched")
            a, b = p[:, :-1].long(), p[:, 1:].long()
            hop = (a >= 0) & (b >= 0)
            v0 = int(torch.argmax(torch.bincount(a[hop], minlength=V)))
            out[name]["dist"] = dict(
                check_distribution(f"{name} out of vertex {v0}",
                                   b[hop & (a == v0)],
                                   first_order_probs(st, cfg, v0), V),
                vertex=v0)
        else:
            need(counts["walk_sample_uniform"] == WALK_LEN,
                 f"{name}: walk_sample_uniform launches "
                 f"{counts['walk_sample_uniform']} != {WALK_LEN}")
            need(counts["walk_fused"] == counts["walk_sample"] == 0,
                 f"{name}: launches of other kernels")
            # a frontier of the per-step simple walk, as scan_walk clamps it
            frontier = p[:, FRONTIER_STEP].clamp(min=0).to(
                torch.int32).contiguous()
        del p
        engines[name] = eng
    # B4a's and B4b's time on the paths, which the kernel queue ranks by:
    # the three per-step paths replayed in one profiler session, the
    # process's first; a trace that misses a launch fails the smoke
    replays = [(name, "walk_sample_uniform" if name == "per-step simple"
                else "walk_sample") for name in engines
               if name != "whole deepwalk"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as d:
        sls = sample_launches(
            [(partial(engines[name].walk, starts), kernel)
             for name, kernel in replays], Path(d) / "trace.json")
    for (name, kernel), sl in zip(replays, sls):
        print(f"{name} replay, {kernel}: {sl['launches']} "
              f"launches, {sl['walkers_sum']} walkers (median "
              f"{sl['walkers_median']}, max {sl['walkers_max']} a "
              f"launch), kernel {sl['kernel_ms_sum']:.3f} ms in all "
              f"(profiler)", flush=True)
        out[name][kernel] = sl
    # profiled last: a profiler run before sample_launches' has cost
    # that trace kernel events
    for name, eng in engines.items() if profile_dir is not None else ():
        try:        # a diagnostic: a profiler fault does not fail the smoke
            out[name]["profile"] = profiled(
                lambda: eng.walk(starts),
                profile_dir / f"{name.replace(' ', '_')}_trace.json", name,
                keep=False)
        except Exception as e:              # noqa: BLE001
            traceback.print_exc()
            out[name]["profile"] = {"error": repr(e)}
    report["per_step"] = out

    # one per-step sample of every walker, kernel vs plain, with the
    # uniforms fed: B4a at the starts; B4b at the starts and at the simple
    # walk's frontier, with the one uniform column its path passes
    g = torch.Generator(device="cuda").manual_seed(5)
    u = torch.rand((len(starts), 3), generator=g, device="cuda")
    u1 = u[:, :1].contiguous()
    tabs = (st.itable.prob, st.itable.alias, st.bias, st.nbr, st.deg)
    lines = []
    for name, where, rows, uu in (
            ("walk_sample", "starts", starts, u),
            ("walk_sample_uniform", "starts", starts, u1),
            ("walk_sample_uniform", "frontier", frontier, u1)):
        uniform = name == "walk_sample_uniform"
        if uniform:
            fn = partial(ops.walk_sample_uniform, st.nbr, st.deg, uu, rows=rows)
            ref = partial(walk_sample_uniform_ref, st.nbr, st.deg, uu, rows=rows)
        else:
            fn = partial(ops.walk_sample, *tabs, uu, rows=rows)
            ref = partial(walk_sample_ref, *tabs, uu, rows=rows)
        ms, got = cuda_ms(fn, reps=5)
        plain_ms, want = cuda_ms(ref, reps=1)
        err = max(path_diff(x, y, f"{name} on all walkers ({where})")
                  for x, y in zip(got, want))
        work = sample_work(rows, got[0], st.deg, uu.shape[1], uniform)
        b_ms, b_by = bound(work["bytes"], work["ops"])
        launches = sum(out[k]["launches"][name] for k in out)
        sectors = ""
        if uniform:
            work["sector_bytes"] = uniform_sectors(
                rows, got[1], st.nbr.shape[1], uu.shape[1])
            work["sector_ms"] = work["sector_bytes"] / HBM_BYTES_PER_S * 1e3
            sectors = (f"; at 32 B a sector {work['sector_bytes'] / 1e6:.3f} MB "
                       f"-> {work['sector_ms']:.5f} ms")
        print(f"{name}: {ms:.4f} ms for {len(rows)} walkers in place at the "
              f"{where}, u (B, {uu.shape[1]}); plain {plain_ms:.2f} ms, equal "
              f"on all walkers; needs {work['bytes'] / 1e6:.3f} MB and "
              f"{work['ops'] / 1e6:.3f} M ops -> bound {b_ms:.5f} ms "
              f"({b_by}){sectors}; launches on the per-step paths {launches}",
              flush=True)
        rec = dict(work, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                   bound_by=b_by, launches=launches)
        if where == "frontier":
            report[name]["frontier"] = rec
            continue
        report[name] = rec
        lines.append({"name": name, "route": "cuda",
                      "source": "src/repro_torch/csrc/walk_sample.cu",
                      "replaces": "src/repro/kernels/walk_sample.py:"
                                  + ("249" if uniform else "218"),
                      "launches": launches, "max_abs_err": err, "ms": ms,
                      "plain_ms": plain_ms, "bound_ms": b_ms,
                      "bound_by": b_by, "library_ms": None})
    return lines


def uniform_sectors(rows, slot, C, ucols):
    """The bytes one uniform pick of every walker moves at 32 bytes a
    sector: each distinct sector of the deg and nbr words it reads (a
    random word brings its whole sector), the sectors of ``u`` holding
    column 0 of a (B, ucols) layout, and the rows read and nxt and slot
    written as streams.  A diagnostic beside the word bound, which counts
    each word once."""
    import torch
    r = rows.long()
    B, live = r.numel(), slot >= 0
    deg_s = torch.unique(r // 8).numel()
    nbr_s = torch.unique((r[live] * C + slot[live].long()) // 8).numel()
    u_s = torch.unique(torch.arange(B, device=r.device) * ucols // 8).numel()
    return 32 * (deg_s + nbr_s + u_s + 3 * ((B + 7) // 8))


# ---------------------------------------------------------------- phase 3c
def digest(tensors, block_bytes=1 << 26):
    """SHA-256 over the SHA-256 of each block of rows (about
    ``block_bytes``) of the tensors, in order (None leaves skipped).  The
    blocks are copied to the host and hashed on a pool of threads, so a
    20 GiB state takes seconds; equal tensors of equal shapes give equal
    digests."""
    from concurrent.futures import ThreadPoolExecutor
    blocks = []
    for x in tensors:
        if x is None or x.shape[0] == 0:
            continue
        row = max(1, x[0].numel() * x.element_size())
        step = max(1, block_bytes // row)
        blocks += [x[i:i + step] for i in range(0, x.shape[0], step)]

    def one(b):
        return hashlib.sha256(b.contiguous().cpu().numpy()).digest()
    h = hashlib.sha256()
    with ThreadPoolExecutor(max_workers=8) as pool:
        for d in pool.map(one, blocks):
            h.update(d)
    return h.hexdigest()


def state_leaves(st):
    return list(st[:-1]) + list(st.itable)


def slice_digest(st, lo, hi):
    """Digest of rows [lo, hi) of every leaf of a state."""
    return digest([None if x is None else x[lo:hi] for x in state_leaves(st)])


def segment_work(path, frontier, deg, uniform):
    """The work one segment launch needs, counted as ``walk_work`` counts a
    whole walk, with each frontier exit counted as a hop that read its row
    and picked an nbr word (to the remote vertex), plus the t0, wid and
    frontier words."""
    import torch
    B, L1 = path.shape
    cur, nxt = path[:, :-1].long(), path[:, 1:].long().clone()
    ex = frontier[:, 0] >= 0
    rows = torch.nonzero(ex).squeeze(1)
    nxt[rows, frontier[ex, 1].long() - 1] = deg.shape[0] + frontier[ex, 0].long()
    drawn, moved = cur >= 0, nxt >= 0
    x_drawn = torch.unique(cur[drawn])
    x_moved = torch.unique(cur[moved])
    hops = torch.unique(cur[moved] * (1 << 32) + nxt[moved]).numel()
    words = 5 * B + B * L1 + x_drawn.numel() + hops
    ops = 0
    if not uniform:
        words += 2 * x_moved.numel() + int(deg[x_moved].long().sum())
        ops = 2 * int(deg[cur[moved]].long().sum())
    return {"bytes": 4 * words, "ops": ops, "alive_steps": int(drawn.sum()),
            "exits": int(ex.sum())}


class SegmentWork:
    """A backend that launches each relay segment through ``bk`` and then
    records the work the launch needed (``segment_work``, with host
    syncs), its live slots (start >= 0, 0 <= t0 <= L: the walkers it hands
    to tiles) beside its alive steps and exits, and the launch's time on
    the card (CUDA events behind a spin
    kernel of about 1 ms, so the wrapper's host work is not counted, as
    in ``cuda_ms``): for a replay of a relay batch outside its timed run,
    whose launches are the timed run's, one for one."""

    def __init__(self, bk, uniform):
        self.bk, self.uniform, self.works, self.events = bk, uniform, [], []

    def __getattr__(self, name):
        return getattr(self.bk, name)

    def sample_walk_segment(self, state, cfg, starts, t0, seed, params,
                            u=None, wid=None):
        import torch
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        torch.cuda._sleep(2_000_000)
        a.record()
        path, frontier = self.bk.sample_walk_segment(
            state, cfg, starts, t0, seed, params, u=u, wid=wid)
        b.record()
        self.events.append((a, b))
        work = segment_work(path, frontier, state.deg, self.uniform)
        L = path.shape[1] - 1
        work["live"] = int(((starts >= 0) & (t0 >= 0) & (t0 <= L)).sum())
        self.works.append(work)
        return path, frontier


def relay_batches(cfg):
    """The sharded phase's walk batches: (name, params, overlap)."""
    from repro_torch.core.walks import WalkParams
    return (("deepwalk", WalkParams("deepwalk", WALK_LEN), True),
            ("deepwalk bulk", WalkParams("deepwalk", WALK_LEN), False),
            ("ppr", WalkParams("ppr", PPR_LEN, stop_prob=PPR_STOP), True),
            ("simple", WalkParams("simple", WALK_LEN), True))


def sharded_path(engine, cfg, starts, stream, report):
    """Phase 3c: write the inputs and the single-device results, run the
    4 gloo ranks and then one NCCL rank, check every rank's result.
    Returns the segment kernel's line."""
    import torch
    from repro_torch.core.walks import random_walk
    st = engine.state
    V, W = cfg.num_vertices, len(starts)
    Vs, Wb = V // SHARDS, W // SHARDS
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_shards_"))
    try:
        np.savez(tmp / "inputs.npz", **stream._asdict(),
                 starts=starts.cpu().numpy())
        expect = {"V": V, "shards": SHARDS,
                  "round_stats": report["round_stats"],
                  "slices": [slice_digest(st, r * Vs, (r + 1) * Vs)
                             for r in range(SHARDS)],
                  "state": slice_digest(st, 0, V), "walks": {}}
        for name, params, _ in relay_batches(cfg):
            kind = name.split()[0]
            seed = RELAY_SEEDS[kind]
            if kind not in expect["walks"]:
                p = random_walk(st, cfg, starts, seed, params)
                expect["walks"][kind] = {
                    "seed": seed, "all": digest([p]),
                    "blocks": [digest([p[r * Wb:(r + 1) * Wb]])
                               for r in range(SHARDS)]}
                del p
        (tmp / "expect.json").write_text(json.dumps(expect))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        gloo = spawn_ranks(tmp, "gloo", SHARDS)
        t_gloo = time.perf_counter() - t0
        nccl = spawn_ranks(tmp, "nccl", 1)
        t_nccl = time.perf_counter() - t0 - t_gloo
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    out = {"gloo_s": t_gloo, "nccl_s": t_nccl, "batches": {}}
    launches = 0
    for name, _, _ in relay_batches(cfg):
        per = [g["batches"][name] for g in gloo]
        need(len({(b["rounds"], b["overflow"], b["peak_slots"])
                  for b in per}) == 1, f"relay {name}: ranks disagree")
        seg = sorted(x for b in per for x in b["segment_ms"])
        rep = sorted(x for b in per for x in b["replay_ms"])
        lb = sorted(x for b in per for x in b["bound_ms"])
        exch = sorted(x for b in per for x in b["exchange_ms"])
        red = sorted(x for b in per for x in b["reduce_ms"])
        live = sorted(x for b in per for x in b["live"])
        steps = sorted(x for b in per for x in b["alive_steps"])
        b0 = per[0]
        launches += sum(b["launches"] for b in per)
        out["batches"][name] = dict(
            rounds=b0["rounds"], overflow=b0["overflow"],
            peak_slots=b0["peak_slots"], wall_s=max(b["wall_s"] for b in per),
            launches=sum(b["launches"] for b in per),
            segment_ms_median=seg[len(seg) // 2], segment_ms_max=seg[-1],
            segment_ms_sum=sum(seg), replay_ms_median=rep[len(rep) // 2],
            replay_ms_sum=sum(rep), bound_ms_median=lb[len(lb) // 2],
            bound_ms_sum=sum(lb),
            over_1ms=[x for x in seg if x >= 1.0],
            pairs=[list(zip(b["segment_ms"], b["bound_ms"])) for b in per],
            live_median=live[len(live) // 2], live_max=live[-1],
            live_sum=sum(live), alive_steps_median=steps[len(steps) // 2],
            alive_steps_sum=sum(steps),
            exchange_ms_median=exch[len(exch) // 2],
            exchange_ms_mean=statistics.mean(exch),
            reduce_ms_median=red[len(red) // 2],
            reduce_ms_mean=statistics.mean(red))
        o = out["batches"][name]
        print(f"relay {name} (S={SHARDS}, gloo): {o['rounds']} rounds, "
              f"overflow {o['overflow']}, peak slots {o['peak_slots']}, wall "
              f"{o['wall_s']:.3f} s; walk_segment {o['launches']} launches, "
              f"median {o['segment_ms_median']:.4f} ms (max "
              f"{o['segment_ms_max']:.3f}, sum {o['segment_ms_sum']:.2f}; "
              f"{len(o['over_1ms'])} launches of 1 ms or more, sum "
              f"{sum(o['over_1ms']):.2f}); on the card alone (replay) median "
              f"{o['replay_ms_median']:.4f} ms (sum {o['replay_ms_sum']:.2f}); "
              f"bound per launch median "
              f"{o['bound_ms_median']:.5f} ms (sum {o['bound_ms_sum']:.3f}); "
              f"live slots per launch median {o['live_median']} (max "
              f"{o['live_max']}, sum {o['live_sum']}), alive steps median "
              f"{o['alive_steps_median']} (sum {o['alive_steps_sum']}); "
              f"exchange per round median "
              f"{o['exchange_ms_median']:.2f} ms, mean "
              f"{o['exchange_ms_mean']:.2f} ms; closing all-reduce median "
              f"{o['reduce_ms_median']:.2f} ms, mean {o['reduce_ms_mean']:.2f} "
              f"ms; home blocks equal to the single-device paths", flush=True)
    batches = out["batches"].values()
    gap = sum(o["segment_ms_sum"] - o["bound_ms_sum"] for o in batches)
    gap_med = sum(o["launches"] * (o["segment_ms_median"] - o["bound_ms_median"])
                  for o in batches)
    gap_rep = sum(o["launches"] * (o["replay_ms_median"] - o["bound_ms_median"])
                  for o in batches)
    out["segment_gap_ms"], out["segment_gap_median_ms"] = gap, gap_med
    out["segment_gap_replay_ms"] = gap_rep
    print(f"walk_segment over the {launches} gloo relay launches: sum of "
          f"(ms - bound) per launch {gap:.2f} ms; launches x (median ms - "
          f"median bound), by batch, {gap_med:.2f} ms; the same on the card "
          f"alone (replay medians) {gap_rep:.2f} ms", flush=True)
    n1 = nccl[0]["batches"]["deepwalk"]
    launches += n1["launches"]
    out["nccl_deepwalk"] = n1
    w1 = nccl[0]["whole"]
    print(f"relay deepwalk (S=1, nccl): {n1['rounds']} round(s), wall "
          f"{n1['wall_s']:.3f} s, paths equal to the single-device paths; "
          f"on all {W} walkers, in turns in that rank: walk_fused "
          f"{w1['walk_fused_ms']:.3f} ms, walk_segment "
          f"{w1['walk_segment_ms']:.3f} ms, paths equal", flush=True)
    t = gloo[0]["timing"]
    print(f"walk_segment on rank 0's round-1 slots ({t['slots']} slots, "
          f"{t['work']['alive_steps']} steps, {t['work']['exits']} exits): "
          f"{t['ms']:.4f} ms; plain {t['plain_ms']:.1f} ms, equal; needs "
          f"{t['work']['bytes'] / 1e6:.2f} MB and {t['work']['ops'] / 1e6:.2f} "
          f"M ops -> bound {t['bound_ms']:.5f} ms ({t['bound_by']}); ranks "
          f"gloo {t_gloo:.1f} s, nccl {t_nccl:.1f} s", flush=True)
    out["timing"] = t
    report["sharded"] = out
    return {"name": "walk_segment", "route": "cuda",
            "source": "src/repro_torch/csrc/walk_fused.cu",
            "replaces": "src/repro/kernels/walk_fused.py:444",
            "launches": launches, "max_abs_err": t["max_abs_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None}


def spawn_ranks(tmp, backend, n, target=None, timeout=SHARD_TIMEOUT_S):
    """Run ``target`` (default ``shard_rank``) on ``n`` ranks (``spawn``
    start method), stop them all, fail unless every rank exited 0 with a
    result; returns the results by rank."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target or shard_rank,
                         args=(r, n, backend, str(tmp))) for r in range(n)]
    for p in procs:
        p.start()
    end = time.monotonic() + timeout
    try:        # until all exit, one fails, or the time is up
        while (time.monotonic() < end and any(p.is_alive() for p in procs)
               and not any(p.exitcode for p in procs)):
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    need(codes == [0] * n, f"{backend} ranks exited {codes}")
    return [json.loads((tmp / f"result_{backend}_{r}.json").read_text())
            for r in range(n)]


def shard_rank(rank, n, backend, tmp):
    """One rank of the sharded phase (runs in its own process)."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import dyngraph as dg
    from repro_torch.core.backend import get_backend
    from repro_torch.core.walks import WalkParams
    from repro_torch.distributed.relay import make_relay
    from repro_torch.kernels import ops
    from repro_torch.serve import DynamicWalkEngine
    tmp = Path(tmp)
    torch.cuda.set_device(0)
    dist.init_process_group(
        backend, store=dist.FileStore(str(tmp / f"store_{backend}"), n),
        rank=rank, world_size=n, timeout=datetime.timedelta(seconds=120),
        device_id=torch.device("cuda", 0) if backend == "nccl" else None)
    group = dist.group.WORLD
    try:
        exp = json.loads((tmp / "expect.json").read_text())
        data = np.load(tmp / "inputs.npz")
        V = exp["V"]
        Vs = V // n
        cfg = dg.BingoConfig(num_vertices=V, capacity=256, bias_bits=16)
        for r in range(n):           # build in turn: one whole state at a time
            if r == rank:
                st = dg.from_edges(cfg, data["init_src"], data["init_dst"],
                                   data["init_w"], device="cuda")
                engine = DynamicWalkEngine(
                    st, cfg, WalkParams("deepwalk", WALK_LEN), group=group)
                del st
                torch.cuda.empty_cache()
            dist.barrier()
        for r, want in enumerate(exp["round_stats"]):
            lanes = [torch.from_numpy(np.ascontiguousarray(data[k][r])).cuda()
                     for k in ("is_insert", "u", "v", "w")]
            got = stats_list(engine.ingest(*lanes))
            need(got == want, f"rank {rank}: round {r + 1} stats {got} != "
                 f"single-device {want}")
        want = exp["slices"][rank] if n == exp["shards"] else exp["state"]
        need(slice_digest(engine.state, 0, Vs) == want,
             f"rank {rank}: state slice after the rounds != single device")
        starts = torch.from_numpy(data["starts"]).cuda()
        W = len(starts)
        Wb = W // n
        batches = relay_batches(cfg) if n == exp["shards"] else \
            relay_batches(cfg)[:1]
        res = {"batches": {}}
        bk = get_backend("fused")
        for name, params, overlap in batches:
            kind = name.split()[0]
            seed = exp["walks"][kind]["seed"]
            trace = []
            ops.reset_launch_counts()
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            if name == "deepwalk":       # through the engine
                engine.relay_trace = trace
                home = engine.walk(starts, seed)
                rounds, ovf, peak = (engine.last_relay[k] for k in
                                     ("rounds", "overflow", "peak_slots"))
            else:
                run = make_relay(bk, cfg, params, group, overlap=overlap,
                                 diagnostics=True)
                home, rounds, ovf, peak = run(engine.state, starts, seed,
                                              trace=trace)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = ops.launch_counts()
            need(counts["walk_segment"] == rounds and
                 sum(counts.values()) == rounds,
                 f"rank {rank} {name}: launches {counts}, rounds {rounds}")
            want = exp["walks"][kind]["blocks"][rank] if n == exp["shards"] \
                else exp["walks"][kind]["all"]
            need(tuple(home.shape) == (Wb, params.length + 1) and
                 digest([home]) == want,
                 f"rank {rank} {name}: home block != single-device paths")
            res["batches"][name] = {
                "rounds": rounds, "overflow": ovf, "peak_slots": peak,
                "wall_s": wall, "launches": counts["walk_segment"],
                "segment_ms": [a.elapsed_time(b) for a, b in
                               (x["segment"] for x in trace)],
                "exchange_ms": [1e3 * x["exchange_s"] for x in trace],
                "reduce_ms": [1e3 * x["reduce_s"] for x in trace]}
            del home
        if n == exp["shards"]:      # each launch's bound, on a replay
            for name, params, overlap in batches:
                kind = name.split()[0]
                rec = SegmentWork(bk, kind == "simple")
                home = make_relay(rec, cfg, params, group, overlap=overlap)(
                    engine.state, starts, exp["walks"][kind]["seed"])[0]
                b = res["batches"][name]
                need(len(rec.works) == b["launches"] and digest([home]) ==
                     exp["walks"][kind]["blocks"][rank],
                     f"rank {rank} {name}: the replay differs")
                b["bound_ms"] = [bound(w["bytes"], w["ops"])[0]
                                 for w in rec.works]
                for key in ("live", "alive_steps", "exits"):
                    b[key] = [w[key] for w in rec.works]
                b["replay_ms"] = [x.elapsed_time(y) for x, y in rec.events]
                del home
        if rank == 0 and n > 1:
            res["timing"] = segment_timing(engine.state, starts, Vs, n)
        elif n == 1:
            res["whole"] = whole_vs_segment(engine.state, starts)
        dist.barrier()
        (tmp / f"result_{backend}_{rank}.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


def whole_vs_segment(st, starts):
    """On one shard (the whole state, no remote neighbour): the whole-walk
    kernel and the segment kernel with every ``t0 = 0`` and ``wid = b`` on
    the deepwalk batch, timed in turns (whole, segment, segment, whole);
    their paths must be equal."""
    import torch
    from repro_torch.kernels import ops
    tabs = (st.itable.prob, st.itable.alias, st.bias, st.nbr, st.deg, None,
            starts)
    zeros = torch.zeros_like(starts)
    seed = RELAY_SEEDS["deepwalk"]
    times = {"walk_fused_ms": [], "walk_segment_ms": []}
    for name in ("walk_fused_ms", "walk_segment_ms", "walk_segment_ms",
                 "walk_fused_ms"):
        if name == "walk_fused_ms":
            ms, whole = cuda_ms(lambda: ops.walk_fused(*tabs, seed,
                                                       length=WALK_LEN))
        else:
            ms, (seg, fr) = cuda_ms(lambda: ops.walk_segment(
                *tabs, zeros, seed, length=WALK_LEN))
        times[name].append(ms)
    path_diff(seg, whole, "walk_segment on one shard vs walk_fused")
    need(bool((fr == -1).all()), "walk_segment on one shard: a frontier exit")
    return {k: statistics.median(v) for k, v in times.items()}


def segment_timing(st, starts, Vs, n):
    """The segment kernel and its plain version on rank 0's round-1 slots
    of the deepwalk batch (its residents in walker order, the other slots
    free): times, equality and the bound."""
    import torch
    from repro_torch.distributed.relay import relay_view, slot_count
    from repro_torch.kernels import ops
    from repro_torch.kernels.walk_fused import walk_segment_ref
    view = relay_view(st, 0, Vs)
    W = len(starts)
    Wl = slot_count(W, n)
    res = torch.nonzero((starts >= 0) & (starts < Vs)).squeeze(1)[:Wl]
    slot_start = torch.full((Wl,), -1, dtype=torch.int32, device="cuda")
    slot_wid = slot_start.clone()
    slot_start[:len(res)] = starts[res]
    slot_wid[:len(res)] = res.to(torch.int32)
    t0 = torch.zeros(Wl, dtype=torch.int32, device="cuda")
    args = (view.itable.prob, view.itable.alias, view.bias, view.nbr,
            view.deg, None, slot_start, t0)
    kw = dict(length=WALK_LEN, seed=RELAY_SEEDS["deepwalk"], wid=slot_wid)
    ms, got = cuda_ms(lambda: ops.walk_segment(*args, **kw))
    plain_ms, want = cuda_ms(lambda: walk_segment_ref(*args, **kw), reps=1)
    err = max(path_diff(a, b, "walk_segment round 1") for a, b in
              zip(got, want))
    work = segment_work(got[0], got[1], view.deg, False)
    b_ms, b_by = bound(work["bytes"], work["ops"])
    return {"slots": Wl, "ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
            "bound_ms": b_ms, "bound_by": b_by, "work": work}


def host_counts(fn):
    """Host-side work of one call of ``fn()`` under ``torch.profiler``:
    aten operator calls, kernel launches and stream synchronizations."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    counts = {"aten_calls": 0, "launches": 0, "syncs": 0}
    for e in prof.key_averages():
        if e.key.startswith("aten::"):
            counts["aten_calls"] += e.count
        elif e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC"):
            counts["launches"] += e.count
        elif e.key == "cudaStreamSynchronize":
            counts["syncs"] += e.count
    return counts


def host_insert(row, v, w, C):
    if len(row) >= C:
        return False
    row.append((v, w))
    return True


def host_delete(row, v):
    """The earliest slot holding ``v`` goes; the tail slot fills it."""
    for i, (x, _) in enumerate(row):
        if x == v:
            row[i] = row[-1]
            row.pop()
            return True
    return False


def streaming(engine, cfg, report, rng):
    """``STREAM_UPDATES`` mixed single-edge updates through
    ``stream_updates``, one call per update with a sync after each (its
    latency on the host clock): deletes of edges present at the time,
    inserts of new edges with degree biases.  The touched vertices' rows
    are held against a host simulation of the same sequence, and their
    counters, group types and alias rows against a rebuild from the rows."""
    import torch
    from repro_torch.core.dyngraph import build_itable_rows, build_vertex_groups
    from repro_torch.core.updates import stream_updates
    from repro_torch.kernels import ops
    st = engine.state
    V, C = cfg.num_vertices, cfg.capacity
    deg = st.deg.cpu().numpy()
    indeg = torch.bincount(st.nbr[st.nbr >= 0].long(), minlength=V).cpu().numpy()
    live = np.flatnonzero(deg > 0)
    del_verts = rng.choice(live, 400, replace=False)
    ins_verts = rng.integers(0, V, 400)
    touched = np.unique(np.concatenate([del_verts, ins_verts]))
    tt = torch.from_numpy(touched).cuda()
    nbr_h, bias_h = st.nbr[tt].cpu().numpy(), st.bias[tt].cpu().numpy()
    sim = {int(u): list(zip(nbr_h[i, :deg[u]].tolist(),
                            bias_h[i, :deg[u]].tolist()))
           for i, u in enumerate(touched)}
    seq, want_ok = [], []
    for _ in range(STREAM_UPDATES):
        if rng.random() < 0.5:
            u = int(rng.choice(del_verts))
            if sim[u]:
                v = sim[u][rng.integers(len(sim[u]))][0]
                seq.append((False, u, v, 0))
                want_ok.append(host_delete(sim[u], v))
                continue
        u, v = int(rng.choice(ins_verts)), int(rng.integers(V))
        w = int(np.clip(indeg[v], 1, (1 << cfg.bias_bits) - 1))
        seq.append((True, u, v, w))
        want_ok.append(host_insert(sim[u], v, w, C))
    ins, uu, vv, ww = (np.array(x) for x in zip(*seq))
    lat, oks = [], []
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t_all = time.perf_counter()
    for i in range(len(seq)):
        t0 = time.perf_counter()
        _, ok = stream_updates(st, cfg, ins[i:i + 1], uu[i:i + 1],
                               vv[i:i + 1], ww[i:i + 1])
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
        oks.append(ok)
    total = time.perf_counter() - t_all
    need(all(v == 0 for v in ops.launch_counts().values()),
         "streaming updates launched a kernel")
    got_ok = torch.cat(oks).cpu().numpy().tolist()
    need(got_ok == want_ok, "stream_updates ok flags != host simulation")
    deg2 = st.deg[tt].cpu().numpy()
    nbr2, bias2 = st.nbr[tt].cpu().numpy(), st.bias[tt].cpu().numpy()
    for i, u in enumerate(touched):
        row = sorted(zip(nbr2[i, :deg2[i]].tolist(), bias2[i, :deg2[i]].tolist()))
        need(row == sorted(sim[int(u)]), f"vertex {u}: row != host simulation")
        need((nbr2[i, deg2[i]:] == -1).all(), f"vertex {u}: padding")
    ttl = tt.long()
    _, _, gsize, digitsum, gtype, wdec = build_vertex_groups(
        cfg, st.bias[ttl], st.frac[ttl], st.deg[ttl])
    itab = build_itable_rows(cfg, digitsum, wdec)
    for name, a, b in (("gsize", gsize, st.gsize[ttl]),
                       ("digitsum", digitsum, st.digitsum[ttl]),
                       ("gtype", gtype, st.gtype[ttl]),
                       ("itable.prob", itab.prob, st.itable.prob[ttl]),
                       ("itable.alias", itab.alias, st.itable.alias[ttl])):
        need(torch.equal(a, b), f"streaming: {name} != rebuild from the rows")
    try:    # a diagnostic: a profiler fault does not fail the smoke
        u0 = int(touched[0])
        v0 = int(st.nbr[u0, 0]) if int(st.deg[u0]) else 0
        ops_ins = host_counts(lambda: stream_updates(st, cfg, [True], [u0],
                                                     [v0], [1]))
        ops_del = host_counts(lambda: stream_updates(st, cfg, [False], [u0],
                                                     [v0], [0]))
        print(f"streaming host work per update: insert {ops_ins}, delete "
              f"{ops_del}", flush=True)
    except Exception as e:                  # noqa: BLE001
        traceback.print_exc()
        ops_ins = ops_del = {"error": repr(e)}
    lat_s = sorted(lat)
    res = {"updates": len(seq), "insert_host_work": ops_ins,
           "delete_host_work": ops_del, "inserts": int(ins.sum()),
           "applied": int(sum(got_ok)), "touched_vertices": len(touched),
           "median_ms": statistics.median(lat),
           "p99_ms": lat_s[min(len(lat_s) - 1, int(0.99 * len(lat_s)))],
           "mean_ms": statistics.mean(lat), "total_s": total}
    report["streaming"] = res
    print(f"streaming: {res['updates']} updates ({res['inserts']} inserts, "
          f"{res['applied']} applied) on {len(touched)} vertices in "
          f"{total:.2f} s; per update median {res['median_ms']:.3f} ms, p99 "
          f"{res['p99_ms']:.3f} ms; rows equal to the host simulation, "
          f"counters and alias rows equal to a rebuild", flush=True)


# --------------------------------------------------------------- phase 3f
SERVE_SEED = 20
SERVE_LADDER = (256, 512)
SERVE_WALK_BUCKETS = (16384, 65536, 262144)
SERVE_RETRY_BATCH = 65536
SERVE_WALKS, SERVE_MAX_REQ = 40, 65536
GROWTH_WINDOWS = 4
NO_SYNC_WINDOW = 1                 # this window runs under sync debug "error"
CHECK_VERTICES = 4096
RECOVERY_SCALE = 17
# phase 3g: the sharded serving layer (4 gloo ranks on the one card)
CHAOS_SEED, CHAOS_WALKERS = 2, 65536
CHAOS_KILL_ROUNDS = 8               # the killed relay's round bound
SERVE_SHARD_TIMEOUT_S = 300         # phase 3g's ranks, all together


def growth_edges(src, dst, w, V, C, n, rng):
    """Up to ``n`` edges, in a seeded order, that a capacity-``C`` build of
    the whole graph drops (rank >= C in row order) from rows whose degree
    in the whole graph is at most 2C: growth traffic on hub rows that fits
    the next rung (scale 20 has 402,402 such edges; a smaller graph fewer,
    and its growth windows are cut to what there is)."""
    order = np.argsort(src, kind="stable")
    s = src[order]
    first = np.r_[True, s[1:] != s[:-1]]
    idx = np.arange(len(s))
    rank = idx - np.maximum.accumulate(np.where(first, idx, -1))
    deg = np.bincount(src, minlength=V)
    pick = order[(rank >= C) & (deg[s] <= 2 * C)]
    need(len(pick) >= GROWTH_WINDOWS, f"growth traffic: {len(pick)} dropped "
         f"edges on rows of degree <= {2 * C}")
    pick = rng.permutation(pick)[:n]
    return src[pick], dst[pick], w[pick]


def serving_events(rng, n_updates, n_walks, V, max_req):
    """Open-loop bursts of 1-3 requests a tick (as ``benchmarks/
    bench_serving.py:_events``): the updates in order, ``n_walks`` walk
    requests of 1..``max_req`` random starts, in a seeded order."""
    kinds = rng.permutation(np.array([0] * n_updates + [1] * n_walks))
    bursts, i, nxt = [], 0, 0
    while i < len(kinds):
        burst = []
        for kind in kinds[i:i + int(rng.integers(1, 4))]:
            if kind == 0:
                burst.append(("update", nxt))
                nxt += 1
            else:
                n = int(rng.integers(1, max_req + 1))
                burst.append(("walk", rng.integers(0, V, n).astype(np.int32)))
            i += 1
        bursts.append(burst)
    return bursts


def row_edges(st):
    """The state's edges in row order as host arrays ``(src, dst, bias)``
    (integer mode)."""
    import torch
    live = (torch.arange(st.nbr.shape[1], device=st.nbr.device)[None, :]
            < st.deg[:, None])
    src = torch.repeat_interleave(
        torch.arange(st.nbr.shape[0], dtype=torch.int32,
                     device=st.nbr.device), st.deg.long())
    return (src.cpu().numpy(), st.nbr[live].cpu().numpy(),
            st.bias[live].cpu().numpy())


class ServingProbe:
    """The instruments of phase 3f's live run, wrapped around one engine:
    per window the ingest's host time and the classifier's device time
    (CUDA events) with the bytes its lanes need, the drains' host time,
    the migration's time and its pins (the state right after it, by
    digest, and the edges in row order for ``from_edges`` at C'), the
    audits at both tiers, and each ``R_CAPACITY`` quarantine checked
    against its row.  Time spent in the pins is kept in ``paused`` and
    left out of the scheduler's clock and the phase's rates."""

    def __init__(self, engine):
        self.engine = engine
        self.paused = 0.0
        self.windows, self.classify_log, self.drains = [], [], []
        self.migration = None
        self.audits = []
        self.capacity_quarantines = 0
        self._in_window = None
        engine.ingest = self.wrap_ingest(engine.ingest)
        engine.drain_guard = self.wrap_drain(engine.drain_guard)
        engine._migrate = self.wrap_migrate(engine._migrate)
        self.wrap_guard()

    def clock(self):
        return time.monotonic() - self.paused

    def pause(self, t0):
        self.paused += time.perf_counter() - t0

    def wrap_guard(self):
        g = self.engine.guard
        inner, settle, regrow = g.classify, g.settle_retry, g.regrow
        V = self.engine.cfg.num_vertices

        def classify(state, ins, u, v, w):
            import torch
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            r = inner(state, ins, u, v, w)
            b.record()
            dele = ~ins & (u >= 0) & (u < V) & (v >= 0) & (v < V)
            slots = torch.where(dele, state.deg[u.clamp(0, V - 1).long()],
                                0).sum()
            self.classify_log.append((self._in_window, a, b, u.shape[0],
                                      slots))
            return r

        def settle_retry(rnd, entries, reasons):
            import torch
            from repro_torch.core.updates import R_CAPACITY
            q0 = len(g.quarantine)
            n = settle(rnd, entries, reasons)
            t0 = time.perf_counter()
            new = [q.u for q in g.quarantine[q0:] if q.reason == R_CAPACITY]
            if new:
                eng = self.engine
                need(eng.tier > 0, "an R_CAPACITY quarantine before the "
                     "regrow")
                deg = eng.state.deg[torch.tensor(new, device="cuda")]
                need(bool((deg == eng.cfg.capacity).all()),
                     "an R_CAPACITY quarantine names a row below capacity")
                self.capacity_quarantines += len(new)
            self.pause(t0)
            return n

        def regrow_(cfg_next):
            regrow(cfg_next)
            self.wrap_guard()

        g.classify, g.settle_retry, g.regrow = classify, settle_retry, regrow_

    def wrap_ingest(self, inner):
        def ingest(*a, **k):
            import torch
            i = len(self.windows)
            self._in_window = i
            t0 = time.perf_counter()
            if i == NO_SYNC_WINDOW:
                torch.cuda.set_sync_debug_mode("error")
            try:
                out = inner(*a, **k)
            finally:
                if i == NO_SYNC_WINDOW:
                    torch.cuda.set_sync_debug_mode(0)
                self._in_window = None
            self.windows.append({"ingest_ms": (time.perf_counter() - t0) * 1e3,
                                 "lanes": int(k.get("n_valid") or len(a[1]))})
            return out
        return ingest

    def wrap_drain(self, inner):
        def drain_guard():
            t0 = time.perf_counter()
            n = inner()
            if n:
                self.drains.append({"rounds": n, "tier": self.engine.tier,
                                    "ms": (time.perf_counter() - t0) * 1e3})
            return n
        return drain_guard

    def audit(self):
        """``audit(pressure=True)``: every corruption rule zero, and
        ``at_capacity`` the rows at deg == C exactly when inserts wait."""
        import torch
        from repro_torch.core.invariants import DEVICE_RULES
        eng = self.engine
        t0 = time.perf_counter()
        a = eng.audit(pressure=True)
        ms = (time.perf_counter() - t0) * 1e3
        full = int((eng.state.deg == eng.cfg.capacity).sum()) \
            if a["pending_depth"] else 0
        bad = {r: a[r] for r in DEVICE_RULES if r != "at_capacity" and a[r]}
        need(not bad, f"audit at tier {eng.tier}: {bad}")
        need(a["at_capacity"] == full, f"audit at tier {eng.tier}: "
             f"at_capacity {a['at_capacity']} != {full} full rows")
        self.audits.append(dict(a, ms=ms))
        return a

    def wrap_migrate(self, inner):
        def migrate():
            import torch
            from repro_torch.core.updates import R_CAPACITY
            eng = self.engine
            t0 = time.perf_counter()
            need(not any(q.reason == R_CAPACITY for q in eng.guard.quarantine),
                 "an R_CAPACITY quarantine before the regrow")
            self.audit()
            old = sum(x.numel() * x.element_size() for x in
                      state_leaves(eng.state) if x is not None)
            torch.cuda.synchronize()
            self.pause(t0)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            t1 = time.perf_counter()
            a.record()
            inner()
            b.record()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t1) * 1e3
            t0 = time.perf_counter()
            new = sum(x.numel() * x.element_size() for x in
                      state_leaves(eng.state) if x is not None)
            self.migration = {
                "ms": a.elapsed_time(b), "wall_ms": wall,
                "old_bytes": old, "new_bytes": new,
                "bound_ms": (old + new) / HBM_BYTES_PER_S * 1e3,
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                "digest": digest(state_leaves(eng.state)),
                "edges": row_edges(eng.state),
                "pin_s": None}
            self.migration["pin_s"] = time.perf_counter() - t0
            self.pause(t0)
        return migrate

    def window_report(self, trace):
        """Per window: its kind, lanes, host ingest ms, classifier device
        ms beside its bytes bound; and the retry rounds' classifier ms."""
        from repro_torch.serve.scheduler import UpdateOp
        cls = {}
        retry = []
        for w, a, b, B, slots in self.classify_log:
            nbytes = B * (1 + 4 + 4 + 4 + 4 + 4) + 4 * int(slots)
            row = {"ms": a.elapsed_time(b), "bytes": nbytes,
                   "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
            (retry.append(row) if w is None else cls.__setitem__(w, row))
        ops_ = [op for op in trace if isinstance(op, UpdateOp)]
        for i, (win, op) in enumerate(zip(self.windows, ops_)):
            win.update(kind="growth" if i >= len(ops_) - GROWTH_WINDOWS
                       else "mixed", classify=cls[i])
        return retry


def serving_phase(args, report, graph, stream, handoff):
    """Phase 3f: the serving layer at full width (module docstring).
    Fills ``handoff`` with what phase 3g holds the sharded engine to."""
    import torch
    from repro_torch.core import dyngraph as dg
    from repro_torch.core.invariants import check_state
    from repro_torch.core.walks import WalkParams, random_walk
    from repro_torch.kernels import ops
    from repro_torch.kernels.update_fused import plan_round
    from repro_torch.serve import DynamicWalkEngine, GuardPolicy
    from repro_torch.serve.scheduler import (DrainOp, RegrowOp,
                                             SchedulerConfig,
                                             ServingScheduler, UpdateOp,
                                             WalkOp, replay_admission_trace)
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    src, dst, w = graph
    V = 1 << args.scale
    rounds, batch = stream.is_insert.shape
    cfg = dg.BingoConfig(num_vertices=V, capacity=SERVE_LADDER[0],
                         bias_bits=16, capacity_ladder=SERVE_LADDER)
    rng = np.random.default_rng(SERVE_SEED)
    gsrc, gdst, gw = growth_edges(src, dst, w, V, cfg.capacity,
                                  GROWTH_WINDOWS * batch, rng)
    updates = [tuple(a[r] for a in (stream.is_insert, stream.u, stream.v,
                                    stream.w)) for r in range(rounds)]
    gwin = len(gsrc) // GROWTH_WINDOWS
    for k in range(GROWTH_WINDOWS):
        sl = slice(k * gwin, (k + 1) * gwin)
        updates.append((np.ones(gwin, bool), gsrc[sl], gdst[sl], gw[sl]))
    bursts = serving_events(rng, len(updates), SERVE_WALKS, V,
                            min(SERVE_MAX_REQ, V))
    params = WalkParams("deepwalk", WALK_LEN)
    sched_cfg = SchedulerConfig(
        update_lanes=batch, max_update_delay=4, max_walk_queue=1 << 40,
        max_update_queue=1 << 40, guard_drain_rounds=8,
        regrow_watermark=0.95)

    def make_engine():
        st = dg.from_edges(cfg, stream.init_src, stream.init_dst,
                           stream.init_w, device="cuda")
        return DynamicWalkEngine(
            st, cfg, params, seed=SERVE_SEED,
            guard=GuardPolicy(retry_batch=SERVE_RETRY_BATCH),
            walk_buckets=SERVE_WALK_BUCKETS)

    # ---- the live run
    engine = make_engine()
    probe = ServingProbe(engine)
    probe.audit()                                   # tier 0, before traffic
    sched = ServingScheduler(engine, sched_cfg, clock=probe.clock)
    capped = []             # ticks whose dispatch stopped at max_inflight
    dispatch = sched._dispatch_walks

    def dispatch_():
        dispatch()
        if sched._walk_queue and len(sched._inflight) >= sched_cfg.max_inflight:
            capped.append(sched.tick_count)
    sched._dispatch_walks = dispatch_
    results = {}
    ops.reset_launch_counts()
    plan_round.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for burst in bursts:
        for kind, x in burst:
            if kind == "update":
                need(sched.submit_update(*updates[x]), "update refused")
            else:
                need(sched.submit_walk(x) is not None, "walk refused")
        sched.tick()
        results.update((r.rid, r) for r in sched.poll())
    results.update((r.rid, r) for r in sched.close())
    torch.cuda.synchronize()
    live_s = time.perf_counter() - t0 - probe.paused
    counts = ops.launch_counts()
    trace = sched.trace
    n_walk_ops = sum(isinstance(op, WalkOp) for op in trace)
    n_upd_ops = sum(isinstance(op, UpdateOp) for op in trace)
    regrows = [i for i, op in enumerate(trace) if isinstance(op, RegrowOp)]
    print(f"serving: {len(bursts)} ticks, {n_upd_ops} update windows "
          f"({engine.retry_rounds} retry rounds), {n_walk_ops} walk cohorts "
          f"for {len(results)} requests, "
          f"{sum(isinstance(op, DrainOp) for op in trace)} drains, regrow at "
          f"trace ops {regrows}; launches {counts}", flush=True)
    # (f) the kernels ran on the card, once a cohort / window / retry round
    need(counts["walk_fused"] == n_walk_ops,
         f"serving: walk_fused launches {counts['walk_fused']} != "
         f"{n_walk_ops} cohorts")
    need(counts["update_fused"] == n_upd_ops + engine.retry_rounds
         == plan_round.launches,
         f"serving: update_fused launches {counts['update_fused']} != "
         f"{n_upd_ops} windows + {engine.retry_rounds} retry rounds")
    need(len(regrows) == 1 and engine.tier == 1 and probe.migration,
         f"serving: expected one regrow to {SERVE_LADDER[1]}, got {regrows}")
    need(len(results) == SERVE_WALKS, "serving: a walk request was lost")
    # (c) conservation
    engine.guard.check_conservation()
    sched.check_conservation()
    # (d) invariants at the new tier, and the full check on seeded rows
    probe.audit()
    deg = engine.state.deg.cpu().numpy()
    crng = np.random.default_rng(SERVE_SEED + 1)
    wide = np.flatnonzero(deg > SERVE_LADDER[0])
    verts = np.unique(np.concatenate([
        crng.choice(V, CHECK_VERTICES // 2, replace=False),
        crng.choice(wide, min(len(wide), CHECK_VERTICES // 2),
                    replace=False)]))
    t1 = time.perf_counter()
    check_state(engine.state, engine.cfg, vertices=verts)
    check_s = time.perf_counter() - t1
    retry = probe.window_report(trace)
    lat = sorted(r.latency_s for r in results.values())
    steps = sum(int((r.paths[:, 1:] >= 0).sum()) for r in results.values())
    lanes = sum(op.n_valid for op in trace if isinstance(op, UpdateOp))
    guard_books = engine.guard.snapshot()
    t1 = time.perf_counter()
    live_digest = digest(state_leaves(engine.state))
    digest_s = time.perf_counter() - t1
    live_paths = {rid: r.paths for rid, r in results.items()}
    pin = probe.migration
    out = {
        "ticks": len(bursts), "windows": probe.windows, "drains": probe.drains,
        "retry_rounds": engine.retry_rounds, "retry_classify": retry,
        "walk_cohorts": n_walk_ops, "launches": counts,
        "migration": {k: v for k, v in pin.items()
                      if k not in ("digest", "edges")},
        "audits": probe.audits, "check_state_vertices": len(verts),
        "check_state_s": check_s, "digest_s": digest_s,
        "latency_p50_ms": lat[len(lat) // 2] * 1e3,
        "latency_p99_ms": lat[min(len(lat) - 1,
                                  int(math.ceil(0.99 * len(lat))) - 1)] * 1e3,
        "walk_steps": steps, "walk_steps_per_s": steps / live_s,
        "updates": lanes, "updates_per_s": lanes / live_s,
        "live_s": live_s, "paused_s": probe.paused,
        "guard": {k: guard_books[k] for k in
                  ("ingested", "accepted", "quarantined", "retried",
                   "reason_counts")},
        "pending": len(guard_books["pending"]),
        "capacity_quarantines": probe.capacity_quarantines}
    del sched, probe, results, engine, dispatch, dispatch_
    gc.collect()                  # the probe's wrappers and the engine
    torch.cuda.empty_cache()      # reference each other
    need(torch.cuda.memory_allocated() < base + 2**30,
         "serving: the live engine's tables were not freed")
    for i, win in enumerate(out["windows"]):
        c = win["classify"]
        print(f"  window {i} ({win['kind']}, {win['lanes']} lanes): ingest "
              f"{win['ingest_ms']:.3f} ms host; classifier {c['ms']:.4f} ms "
              f"(bound {c['bound_ms']:.4f} ms, {c['bytes'] / 1e6:.2f} MB)"
              + (" [under set_sync_debug_mode('error')]"
                 if i == NO_SYNC_WINDOW else ""), flush=True)
    for d in out["drains"]:
        print(f"  drain of {d['rounds']} rounds at tier {d['tier']}: "
              f"{d['ms']:.1f} ms host", flush=True)
    m = out["migration"]
    print(f"  regrow 256 -> 512: migration {m['ms']:.2f} ms (CUDA events; "
          f"{m['wall_ms']:.2f} ms host), bound {m['bound_ms']:.3f} ms "
          f"({(m['old_bytes'] + m['new_bytes']) / 2**30:.2f} GiB: old tables "
          f"read once, new written once), peak {m['peak_gib']:.1f} GiB; "
          f"{out['retry_rounds']} retry rounds, classifier "
          f"{sum(r['ms'] for r in retry):.3f} ms in them", flush=True)
    print(f"  audits (pressure=True): "
          + "; ".join(f"tier {a['tier']} {a['ms']:.1f} ms, at_capacity "
                      f"{a['at_capacity']}, pending {a['pending_depth']}"
                      for a in out["audits"])
          + f"; check_state on {len(verts)} rows {check_s:.1f} s", flush=True)
    print(f"  cohort latency p50 {out['latency_p50_ms']:.1f} ms, p99 "
          f"{out['latency_p99_ms']:.1f} ms; {steps} walk steps "
          f"({out['walk_steps_per_s'] / 1e6:.1f} M steps/s), {lanes} updates "
          f"({out['updates_per_s'] / 1e6:.3f} M updates/s) over "
          f"{live_s:.2f} s (pins {out['paused_s']:.1f} s left out); guard "
          f"{out['guard']}, pending {out['pending']}, R_CAPACITY quarantines "
          f"{out['capacity_quarantines']} (each at a full row after the "
          f"regrow)", flush=True)

    # (b) the regrow pin: the migrated state is from_edges at C' over its
    # edges in row order (digests: no third full state is held)
    t1 = time.perf_counter()
    built = dg.from_edges(cfg.tier_config(1), *pin["edges"], device="cuda")
    need(digest(state_leaves(built)) == pin["digest"],
         "serving: the migrated state != from_edges at C' = 512")
    del built, pin
    torch.cuda.empty_cache()
    out["regrow_pin_s"] = time.perf_counter() - t1

    # (a) live == replay: a fresh engine replays the admission trace
    t1 = time.perf_counter()
    fresh = make_engine()
    replayed = iter(replay_admission_trace(fresh, trace))
    for op in trace:
        if isinstance(op, WalkOp):
            rep = next(replayed)
            off = np.cumsum([0] + list(op.sizes))
            for j, rid in enumerate(op.rids):
                need(np.array_equal(live_paths[rid], rep[off[j]:off[j + 1]]),
                     f"serving: request {rid} != its replay")
    need(fresh.tier == 1 and fresh.guard.snapshot() == guard_books,
         "serving: the replay's tier or guard books differ")
    need(digest(state_leaves(fresh.state)) == live_digest,
         "serving: the replay's final state != the live one")
    out["replay_s"] = time.perf_counter() - t1
    # what phase 3g's sharded engine must give: this run's traffic, trace,
    # requests, books, regrows and final slices, and a whole walk of the
    # final state for its chaos relay
    t1 = time.perf_counter()
    Vs = V // SHARDS
    chaos_starts = torch.from_numpy(np.random.default_rng(CHAOS_SEED).integers(
        0, V, CHAOS_WALKERS).astype(np.int32)).cuda()
    chaos = random_walk(fresh.state, fresh.cfg, chaos_starts, CHAOS_SEED,
                        params)
    Wb = CHAOS_WALKERS // SHARDS
    handoff.update(
        init=(stream.init_src, stream.init_dst, stream.init_w),
        updates=updates, bursts=bursts, sched_cfg=dataclasses.asdict(sched_cfg),
        trace=[op_digest(op) for op in trace],
        timing_free=not capped, capped_ticks=capped,
        paths={rid: array_digest(p) for rid, p in live_paths.items()},
        guard=books_digest(guard_books), regrow_counts=fresh.regrow_counts,
        retry_rounds=out["retry_rounds"], tier=fresh.tier,
        slices=[slice_digest(fresh.state, r * Vs, (r + 1) * Vs)
                for r in range(SHARDS)],
        chaos={"starts": chaos_starts.cpu().numpy(), "seed": CHAOS_SEED,
               "blocks": [digest([chaos[r * Wb:(r + 1) * Wb]])
                          for r in range(SHARDS)]},
        trace_ops=trace,
        windows=[op for op in trace if isinstance(op, UpdateOp)][:2],
        migration_ms=out["migration"]["ms"],
        latency=(out["latency_p50_ms"], out["latency_p99_ms"]))
    del chaos
    out["handoff_s"] = time.perf_counter() - t1
    del fresh, replayed, live_paths
    torch.cuda.empty_cache()
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"serving: live == replay on all {n_walk_ops} cohorts and the final "
          f"state (digest {live_digest[:16]}); regrow pin equal "
          f"({out['regrow_pin_s']:.1f} s); replay {out['replay_s']:.1f} s; "
          f"peak {out['peak_gib']:.1f} GiB; phase {out['phase_s']:.1f} s",
          flush=True)
    report["serving"] = out


def recovery_phase(args, report):
    """Phase 3f, recovery: crash and restore at 2^``RECOVERY_SCALE``
    vertices with the serving widths (C 256 -> 512, 16-bit biases)."""
    import shutil
    import tempfile
    import torch
    from repro_torch.core import dyngraph as dg
    from repro_torch.core.walks import WalkParams
    from repro_torch.graph.rmat import degree_bias, rmat_edges
    from repro_torch.graph.streams import make_update_stream
    from repro_torch.serve import (DynamicWalkEngine, GuardPolicy,
                                   RecoverableEngine)
    from repro_torch.train import checkpoint as ckpt
    t_phase = time.perf_counter()
    scale = min(args.scale, RECOVERY_SCALE)
    V, rounds = 1 << scale, 10
    src, dst = rmat_edges(scale, 8, seed=1)
    w = degree_bias(src, dst, V, bias_bits=16)
    batch = min(100_000 >> (20 - scale), len(src) // (4 * rounds))
    stream = make_update_stream(src, dst, w, batch_size=batch, rounds=rounds,
                                mode="mixed", seed=1)
    cfg = dg.BingoConfig(num_vertices=V, capacity=SERVE_LADDER[0],
                         bias_bits=16, capacity_ladder=SERVE_LADDER)
    params = WalkParams("deepwalk", WALK_LEN)
    guard = GuardPolicy(retry_batch=SERVE_RETRY_BATCH)
    starts = torch.arange(0, V, 8, dtype=torch.int32, device="cuda")

    def engine():
        st = dg.from_edges(cfg, stream.init_src, stream.init_dst,
                           stream.init_w, device="cuda")
        return DynamicWalkEngine(st, cfg, params, seed=SERVE_SEED,
                                 guard=guard)

    def drive(e):
        for r in range(rounds):
            e.ingest(stream.is_insert[r], stream.u[r], stream.v[r],
                     stream.w[r])
            e.walk(starts)

    twin = engine()                           # the uninterrupted run
    drive(twin)
    need(len(twin.guard.pending) > 0, "recovery: no capacity spill to regrow")
    twin.regrow()
    want = digest(state_leaves(twin.state))
    want_paths = twin.walk(starts).cpu()
    del twin
    torch.cuda.empty_cache()

    tmp = tempfile.mkdtemp(prefix="smoke_recovery_")
    writes, copies = [], []
    save = ckpt.save_checkpoint

    def timed_write(*a, **k):
        t = time.perf_counter()
        out = save(*a, **k)
        writes.append(time.perf_counter() - t)
        return out
    ckpt.save_checkpoint = timed_write
    try:
        rec = RecoverableEngine(engine(), ckpt_dir=tmp, checkpoint_every=3,
                                keep=2)
        take = rec.ckpt.save

        def timed_copy(*a, **k):
            rec.ckpt.wait()
            t = time.perf_counter()
            take(*a, **k)
            copies.append(time.perf_counter() - t)
        rec.ckpt.save = timed_copy
        drive(rec)
        rec.wal.append_regrow(rec.engine.tier + 1)   # logged, not applied
        rec.wait()
        gen = ckpt.latest_step(tmp)
        del rec                                      # the crash
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        rec2 = RecoverableEngine.restore(tmp, cfg, params, guard=guard,
                                         device="cuda")
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t
        need(rec2.engine.tier == 1, "recovery: the logged regrow did not run")
        need(digest(state_leaves(rec2.engine.state)) == want,
             "recovery: restored state != the uninterrupted run's")
        need(torch.equal(rec2.walk(starts).cpu(), want_paths),
             "recovery: the next walk batch != the uninterrupted run's")
        del rec2
    finally:
        ckpt.save_checkpoint = save
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    snap_gib = sum(x.numel() * x.element_size() for x in state_leaves(
        dg.empty_state(cfg, "meta")) if x is not None) / 2**30
    out = {"scale": scale, "rounds": rounds, "batch": batch,
           "snapshot_gib": snap_gib, "snapshot_copy_s": copies,
           "snapshot_write_s": writes, "restored_from_generation": gen,
           "restore_s": restore_s,
           "phase_s": time.perf_counter() - t_phase}
    report["recovery"] = out
    print(f"recovery: 2^{scale} vertices, {rounds} guarded rounds of {batch} "
          f"and walks through RecoverableEngine(checkpoint_every=3), a regrow "
          f"record logged and the engine dropped before it migrates: restore "
          f"from generation {gen} + WAL replay {restore_s:.2f} s, state and "
          f"next walk batch equal to the uninterrupted run; snapshots "
          f"({snap_gib:.2f} GiB) host copy {[round(x, 3) for x in copies]} s, "
          f"write {[round(x, 3) for x in writes]} s; phase "
          f"{out['phase_s']:.1f} s", flush=True)


# --------------------------------------------------------------- phase 3g
def array_digest(a):
    """SHA-256 of an array's bytes (its shape and type too)."""
    a = np.ascontiguousarray(a)
    return hashlib.sha256(f"{a.shape}{a.dtype}".encode()
                          + a.tobytes()).hexdigest()


def op_digest(op):
    """An admission-trace op as one digest (the same for equal ops)."""
    name = type(op).__name__
    if name == "UpdateOp":
        return name + ":" + hashlib.sha256("".join(
            array_digest(x) for x in op[:4]).encode()
            + str(op.n_valid).encode()).hexdigest()
    if name == "WalkOp":
        return name + ":" + array_digest(op.starts) + str(op.rids) \
            + str(op.sizes)
    return f"{name}:{op[0]}"


def books_digest(snap):
    """SHA-256 of a guard ``snapshot()``."""
    return hashlib.sha256(json.dumps(snap, sort_keys=True).encode()) \
        .hexdigest()


def sharded_serving_phase(report, handoff, card):
    """Phase 3g: phase 3f's traffic through a guarded 4-rank engine on
    gloo, chaos relays on its grown state, then one NCCL rank's deferred
    window under ``set_sync_debug_mode("error")`` (module docstring).
    Returns the phase's launches by kernel."""
    import torch
    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_serve_"))
    try:
        (tmp / "handoff.pkl").write_bytes(pickle.dumps(handoff))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        gloo = spawn_ranks(tmp, "gloo", SHARDS, serve_rank,
                           SERVE_SHARD_TIMEOUT_S)
        t_gloo = time.perf_counter() - t0
        nccl = spawn_ranks(tmp, "nccl", 1, serve_rank, SERVE_SHARD_TIMEOUT_S)
        t_nccl = time.perf_counter() - t0 - t_gloo
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for key in ("rounds_per_cohort", "regrows", "chaos_rounds"):
        need(len({json.dumps(g[key]) for g in gloo}) == 1,
             f"sharded serving: ranks disagree on {key}")
    g0 = gloo[0]
    lat = sorted(x for g in gloo for x in g["latency_ms"])
    out = {"gloo_s": t_gloo, "nccl_s": t_nccl, "ranks": gloo,
           "nccl": nccl[0], "live": g0["live"]}
    if lat:
        out["latency_p50_ms"] = lat[len(lat) // 2]
        out["latency_p99_ms"] = lat[min(len(lat) - 1,
                                        int(math.ceil(0.99 * len(lat))) - 1)]
    live_s = max(g["live_s"] for g in gloo)
    out["walk_steps_per_s"] = g0["walk_steps"] / live_s
    out["updates_per_s"] = g0["updates"] / live_s
    cls = [g["classify_ms"] for g in gloo]
    med = [statistics.median(c) for c in cls]
    print(f"{card}: sharded serving (S={SHARDS}, gloo; "
          f"{'live scheduler, trace equal to phase 3f' if g0['live'] else 'phase 3f trace replayed (3f dispatch met max_inflight)'}): "
          f"{g0['windows']} update windows, {g0['retry_rounds']} retry rounds, "
          f"{len(g0['rounds_per_cohort'])} cohorts, regrow counts "
          f"{g0['regrows']}; requests, guard books, regrow counts, slices "
          f"equal to phase 3f's single device", flush=True)
    if lat:
        print(f"{card}: sharded serving request latency p50 "
              f"{out['latency_p50_ms']:.1f} ms, p99 {out['latency_p99_ms']:.1f} "
              f"ms (single device {handoff['latency'][0]:.1f} / "
              f"{handoff['latency'][1]:.1f})", flush=True)
    print(f"{card}: sharded serving {out['walk_steps_per_s'] / 1e6:.2f} M walk "
          f"steps/s, {out['updates_per_s'] / 1e6:.3f} M updates/s over "
          f"{live_s:.2f} s (slowest rank, host clock)", flush=True)
    for r, g in enumerate(gloo):
        m = g["migration"]
        print(f"{card}: rank {r}: drains "
              + ", ".join(f"{d['rounds']} rounds at tier {d['tier']} "
                          f"{d['ms']:.1f} ms" for d in g["drains"])
              + f"; migration 256 -> 512 {m['ms']:.2f} ms (CUDA events; "
              f"{m['wall_ms']:.2f} ms host; single device "
              f"{handoff['migration_ms']:.2f} ms); classifier with its "
              f"all_reduce median {med[r]:.3f} ms a window (min "
              f"{min(cls[r]):.3f}, max {max(cls[r]):.3f}; host median "
              f"{statistics.median(g['classify_host_ms']):.3f} ms)",
              flush=True)
    print(f"{card}: sharded serving relay rounds per cohort "
          f"{g0['rounds_per_cohort']} (bulk rounds; walk_segment launches "
          f"{g0['launches']['walk_segment']} a rank, update_fused "
          f"{g0['launches']['update_fused']})", flush=True)
    for name, rep in g0["chaos"].items():
        print(f"{card}: chaos {name}: {rep}", flush=True)
    n1 = nccl[0]
    print(f"{card}: S=1 over NCCL: deferred guarded window of "
          f"{n1['lanes']} lanes under set_sync_debug_mode('error'), its "
          f"classifier, all_reduces and update round: no host sync; "
          f"{n1['ms']:.3f} ms (CUDA events), books conserved", flush=True)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"{card}: sharded serving phase {out['phase_s']:.1f} s (gloo ranks "
          f"{t_gloo:.1f} s, nccl rank {t_nccl:.1f} s)", flush=True)
    report["sharded_serving"] = out
    launches = {"walk_segment": 0, "update_fused": 0}
    for g in gloo + nccl:
        for k in launches:
            launches[k] += g["launches"].get(k, 0) \
                + g.get("chaos_launches", {}).get(k, 0)
    return launches


def serve_rank(rank, n, backend, tmp):
    """One rank of phase 3g (runs in its own process)."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import dyngraph as dg
    from repro_torch.core.walks import WalkParams
    from repro_torch.serve import DynamicWalkEngine, GuardPolicy
    tmp = Path(tmp)
    torch.cuda.set_device(0)
    dist.init_process_group(
        backend, store=dist.FileStore(str(tmp / f"store_{backend}"), n),
        rank=rank, world_size=n, timeout=datetime.timedelta(seconds=120),
        device_id=torch.device("cuda", 0) if backend == "nccl" else None)
    group = dist.group.WORLD
    try:
        h = pickle.loads((tmp / "handoff.pkl").read_bytes())
        cfg = dg.BingoConfig(num_vertices=h["V"], capacity=SERVE_LADDER[0],
                             bias_bits=16, capacity_ladder=SERVE_LADDER)
        engine = None
        for r in range(n):           # build in turn: one whole state at a time
            if r == rank:
                st = dg.from_edges(cfg, *h["init"], device="cuda")
                engine = DynamicWalkEngine(
                    st, cfg, WalkParams("deepwalk", WALK_LEN),
                    seed=SERVE_SEED,
                    guard=GuardPolicy(retry_batch=SERVE_RETRY_BATCH),
                    walk_buckets=SERVE_WALK_BUCKETS, group=group,
                    relay_overlap=False)
                del st
                torch.cuda.empty_cache()
            dist.barrier()
        res = nccl_window(engine, h) if backend == "nccl" else \
            gloo_serving(engine, h, rank, n, group)
        dist.barrier()
        (tmp / f"result_{backend}_{rank}.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


def nccl_window(engine, h):
    """Phase 3f's first two windows on a sharded engine of one NCCL rank,
    deferred; the second under ``set_sync_debug_mode("error")``, with the
    classifier's and the stats' ``all_reduce``s in place."""
    import torch
    from repro_torch.kernels import ops
    engine.defer_guard = True
    first, second = h["windows"]
    engine.ingest(first.is_insert, first.u, first.v, first.w,
                  n_valid=first.n_valid)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda.set_sync_debug_mode("error")
    try:
        engine.ingest(second.is_insert, second.u, second.v, second.w,
                      n_valid=second.n_valid)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    b.record()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    need(counts["update_fused"] == 1, f"nccl window: launches {counts}")
    need(engine.drain_guard() == 2, "nccl window: backlog")
    engine.guard.check_conservation()
    return {"ms": a.elapsed_time(b), "lanes": int(second.n_valid),
            "launches": counts}


def gloo_serving(engine, h, rank, n, group):
    """Phase 3f's traffic through the scheduler on this rank's engine (or,
    if phase 3f's dispatch met ``max_inflight``, its trace replayed), the
    checks against phase 3f's digests, then the chaos relays."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.backend import get_backend
    from repro_torch.core.invariants import DEVICE_RULES
    from repro_torch.core.walks import WalkParams
    from repro_torch.distributed.chaos import (ChaosSchedule,
                                               RelayIntegrityError,
                                               run_chaos_relay)
    from repro_torch.kernels import ops
    from repro_torch.serve.scheduler import (SchedulerConfig,
                                             ServingScheduler, UpdateOp,
                                             WalkOp, replay_admission_trace)
    res = {"classify_ms": [], "classify_host_ms": [], "drains": [],
           "rounds_per_cohort": [], "live": h["timing_free"]}
    g = engine.guard

    def wrap_classify():
        inner, regrow = g.classify, g.regrow

        def classify(*a):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            e0.record()
            r = inner(*a)
            e1.record()
            res["classify_host_ms"].append((time.perf_counter() - t0) * 1e3)
            events.append((e0, e1))
            return r

        def regrow_(cfg_next):
            regrow(cfg_next)
            wrap_classify()
        g.classify, g.regrow = classify, regrow_
    events = []
    wrap_classify()
    walk, drain, migrate = engine.walk, engine.drain_guard, engine._migrate

    def walk_(*a, **k):
        out = walk(*a, **k)
        res["rounds_per_cohort"].append(engine.last_relay["rounds"])
        return out

    def drain_():
        t0 = time.perf_counter()
        k = drain()
        if k:
            res["drains"].append({"rounds": k, "tier": engine.tier,
                                  "ms": (time.perf_counter() - t0) * 1e3})
        return k

    def migrate_():
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        migrate()
        b.record()
        torch.cuda.synchronize()
        res["migration"] = {"ms": a.elapsed_time(b),
                            "wall_ms": (time.perf_counter() - t0) * 1e3}
    engine.walk, engine.drain_guard, engine._migrate = walk_, drain_, migrate_

    ops.reset_launch_counts()
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    if h["timing_free"]:
        sched = ServingScheduler(engine, SchedulerConfig(**h["sched_cfg"]))
        results = {}
        for burst in h["bursts"]:
            for kind, x in burst:
                if kind == "update":
                    need(sched.submit_update(*h["updates"][x]),
                         "update refused")
                else:
                    need(sched.submit_walk(x) is not None, "walk refused")
            sched.tick()
            results.update((r.rid, r) for r in sched.poll())
        results.update((r.rid, r) for r in sched.close())
        trace = sched.trace
        need([op_digest(op) for op in trace] == h["trace"],
             f"rank {rank}: admission trace != phase 3f's")
        sched.check_conservation()
        paths = {rid: r.paths for rid, r in results.items()}
        res["latency_ms"] = [r.latency_s * 1e3 for r in results.values()]
    else:
        trace = h["trace_ops"]
        paths = {}
        for op, rows in zip([op for op in trace if isinstance(op, WalkOp)],
                            replay_admission_trace(engine, trace)):
            off = np.cumsum([0] + list(op.sizes))
            for j, rid in enumerate(op.rids):
                paths[rid] = rows[off[j]:off[j + 1]]
        res["latency_ms"] = []
    torch.cuda.synchronize()
    res["live_s"] = time.perf_counter() - t0
    counts = ops.launch_counts()
    n_upd = sum(isinstance(op, UpdateOp) for op in trace)
    need(counts["walk_segment"] == sum(res["rounds_per_cohort"]) and
         counts["update_fused"] == n_upd + engine.retry_rounds and
         sum(counts.values()) == counts["walk_segment"]
         + counts["update_fused"],
         f"rank {rank}: launches {counts}")
    need(paths.keys() == h["paths"].keys() and all(
        array_digest(p) == h["paths"][rid] for rid, p in paths.items()),
         f"rank {rank}: a request's paths != phase 3f's")
    g.check_conservation()
    need(books_digest(g.snapshot()) == h["guard"],
         f"rank {rank}: guard books != phase 3f's")
    need(list(engine.regrow_counts) == list(h["regrow_counts"]) and
         engine.tier == h["tier"] and engine.retry_rounds == h["retry_rounds"],
         f"rank {rank}: regrows {engine.regrow_counts}, retry rounds "
         f"{engine.retry_rounds}")
    Vs = engine.shard_size
    need(slice_digest(engine.state, 0, Vs) == h["slices"][rank],
         f"rank {rank}: final slice != phase 3f's")
    audit = engine.audit(pressure=True)
    need(not any(audit[k] for k in DEVICE_RULES if k != "at_capacity"),
         f"rank {rank}: audit {audit}")
    torch.cuda.synchronize()
    res["classify_ms"] = [a.elapsed_time(b) for a, b in events]
    res.update(windows=n_upd, retry_rounds=engine.retry_rounds,
               regrows=list(engine.regrow_counts), launches=counts,
               walk_steps=sum(int((p[:, 1:] >= 0).sum())
                              for p in paths.values()),
               updates=sum(op.n_valid for op in trace
                           if isinstance(op, UpdateOp)))

    # chaos on the grown state
    bk = get_backend("fused")
    params = WalkParams("deepwalk", WALK_LEN)
    c = h["chaos"]
    starts = torch.from_numpy(c["starts"]).cuda()
    Wb = len(starts) // n
    res["chaos"], res["chaos_rounds"] = {}, []
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    p, rep = run_chaos_relay(bk, engine.cfg, params, group, engine.state,
                             starts, c["seed"],
                             ChaosSchedule(seed=2, dup=0.2, delay=0.2))
    need(digest([p[rank * Wb:(rank + 1) * Wb]]) == c["blocks"][rank] and
         rep.lost == 0 and rep.duplicated > 0 and rep.delayed > 0,
         f"rank {rank}: chaos dup+delay {rep}")
    res["chaos"]["dup=0.2 delay=0.2"] = dict(dataclasses.asdict(rep),
                                             wall_s=time.perf_counter() - t0)
    res["chaos_rounds"].append(rep.rounds)
    del p
    for name, sched, max_rounds, what in (
            ("drop=0.01", ChaosSchedule(seed=3, drop=0.01), None, "lost"),
            ("kill_round=3", ChaosSchedule(seed=4, kill_round=3),
             CHAOS_KILL_ROUNDS, "pending_at_exit")):
        t0 = time.perf_counter()
        try:
            run_chaos_relay(bk, engine.cfg, params, group, engine.state,
                            starts, c["seed"], sched, max_rounds=max_rounds)
            need(False, f"rank {rank}: chaos {name} did not raise")
        except RelayIntegrityError as e:
            need(getattr(e.report, what) > 0,
                 f"rank {rank}: chaos {name}: {e.report}")
            res["chaos"][name] = dict(dataclasses.asdict(e.report),
                                      wall_s=time.perf_counter() - t0)
            res["chaos_rounds"].append(e.report.rounds)
    torch.cuda.synchronize()
    res["chaos_launches"] = ops.launch_counts()
    need(res["chaos_launches"]["walk_segment"] == sum(res["chaos_rounds"]),
         f"rank {rank}: chaos launches {res['chaos_launches']}")
    return res


# --------------------------------------------------------------- phase 3e
def attention_pairs(S, T, causal, window):
    """Unmasked (query, key) pairs of one head: query row i at i + T - S."""
    qpos = np.arange(S, dtype=np.int64) + (T - S)
    hi = np.minimum(T, qpos + 1) if causal else np.full(S, T, np.int64)
    lo = np.maximum(0, qpos - window + 1) if window else np.zeros(S, np.int64)
    return int(np.maximum(hi - lo, 0).sum())


def sdpa_ms(q, k, v, **kw):
    """``(ms, output)`` of one ``scaled_dot_product_attention`` call on the
    same tensors (``enable_gqa``: KV not repeated), restricted to its fused
    backends (its math backend would hold the whole (H, S, T) logits)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    fused = [SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
             SDPBackend.EFFICIENT_ATTENTION]
    with sdpa_kernel(fused):
        return cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, enable_gqa=True, **kw))


def attention_phase(report):
    """Phase 3e: flash attention at full width over one 32,768-token
    sequence: Mixtral 8x7B's widths in bf16 windowed and full causal (the
    bf16 wgmma kernel), then f32 windowed (the 3xTF32 wgmma kernel); then
    hubert-xlarge's (16 heads, MHA, D = 80, non-causal) in bf16
    (zero-padded to D = 128) and f32 (80 wide).  Returns the two kernels'
    lines (bf16: Mixtral's full-causal case beside SDPA's ``is_causal``;
    f32: the window beside SDPA with a mask, which no fused backend
    takes)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention_ref,
                                                     flash_attention_ref32)
    S = ATTN_SEQ
    g = torch.Generator(device="cuda").manual_seed(11)

    def inputs(H, Hkv, D):
        return tuple(torch.randn(shape, generator=g, device="cuda").to(
            torch.bfloat16) for shape in ((1, H, S, D), (1, Hkv, S, D),
                                          (1, Hkv, S, D)))
    mix = inputs(ATTN_HEADS, ATTN_KV_HEADS, ATTN_DIM)
    hub = inputs(HUBERT_HEADS, HUBERT_HEADS, HUBERT_DIM)
    wide = {id(mix): tuple(x.float() for x in mix),
            id(hub): tuple(x.float() for x in hub)}
    # (name, inputs, causal, window, float32)
    cases = (("window", mix, True, ATTN_WINDOW, False),
             ("causal", mix, True, 0, False),
             ("window f32", mix, True, ATTN_WINDOW, True),
             ("hubert", hub, False, 0, False),
             ("hubert f32", hub, False, 0, True))

    def qkv(x, f32):
        return wide[id(x)] if f32 else x
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    outs = {name: ops.flash_attention(*qkv(x, f), causal=c, window=w)
            for name, x, c, w, f in cases}
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    print(f"attention S=T={S}, launches: {counts}", flush=True)
    need(counts["flash_attention_sm90"] == 3 and counts["flash_attention"] == 2
         and sum(counts.values()) == 5, f"phase 3e launches {counts}")
    blocks = [min(a, S - 64) for a in           # 4 x 64 rows
              (0, ATTN_WINDOW - 32, S // 2 + 320, S - 64)]

    def dense_excess(o, plain, x, causal, w):
        """``o``'s 256 sampled rows against the dense ``attention_ref`` in
        f32: entry by entry in f32, row by row (with ``plain``) in bf16."""
        qf, kf, vf = wide[id(x)]
        worst = 0.0
        for a in blocks:
            rows = slice(a, a + 64)
            dense = attention_ref(qf[:, :, rows], kf, vf, causal=causal,
                                  window=w, q_offset=a)
            worst = max(worst, flash_excess(o[:, :, rows], dense, "float32")
                        if o.dtype == torch.float32 else flash_row_excess(
                            o[:, :, rows], plain[:, :, rows], dense))
        return worst

    out = {}
    for name, x, causal, w, f32 in cases:
        q, k, v = qkv(x, f32)
        H, D = q.shape[1], q.shape[3]
        o = outs.pop(name)
        need(o.shape == q.shape and o.dtype == q.dtype
             and bool(torch.isfinite(o).all()), f"attention {name}: output")
        fault = ops.flash_attention(q, k, v, causal=causal,
                                    window=shifted_window(S, w))
        ms, _ = cuda_ms(lambda: ops.flash_attention(q, k, v, causal=causal,
                                                    window=w))
        plain_ms, plain = cuda_ms(lambda: flash_attention_ref(
            q, k, v, causal=causal, window=w), reps=1)
        ref32 = flash_attention_ref32(q, k, v, causal=causal, window=w) \
            if q.dtype == torch.bfloat16 else None
        dense, dense_fault = dense_excess(o, plain, x, causal, w), \
            dense_excess(fault, plain, x, causal, w)
        need(dense <= 1 < dense_fault, f"attention {name}: 256 rows vs "
             f"attention_ref at {dense:.3f} of the limit, the planted fault "
             f"at {dense_fault:.3f}")
        err = float((o.float() - plain.float()).abs().max())
        fault_err = float((fault.float() - plain.float()).abs().max())
        excess = flash_limit(o, plain, ref32)
        fault_excess = flash_limit(fault, plain, ref32)
        old = None if ref32 is None else (
            flash_excess(o, plain, "bfloat16"),
            flash_excess(fault, plain, "bfloat16"))
        del plain, ref32, fault
        need(excess <= 1 < fault_excess, f"attention {name}: kernel at "
             f"{excess:.3f} of the limit (max abs vs plain {err}), the "
             f"planted fault at {fault_excess:.3f}")
        is16 = q.dtype == torch.bfloat16
        pairs = H * attention_pairs(S, S, causal, w)
        flops = 4 * D * pairs
        nbytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
        # f32 to f32 accuracy on the tensor cores is three TF32 products
        work, rate = (flops, TC_BF16_FLOPS) if is16 else \
            (3 * flops, TC_TF32_FLOPS)
        b_ms = max(work / rate, nbytes / HBM_BYTES_PER_S) * 1e3
        b_by = "operations" if work / rate >= nbytes / HBM_BYTES_PER_S \
            else "bytes"
        old_b_ms = None if is16 else max(
            flops / OPS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
        try:        # the yardstick: a library fault does not fail the smoke
            if w:
                pos = torch.arange(S, device="cuda")
                mask = ((pos[None, :] <= pos[:, None])
                        & (pos[None, :] > pos[:, None] - w))
                lib_ms, lib = sdpa_ms(q, k, v, attn_mask=mask)
                del mask
            else:
                lib_ms, lib = sdpa_ms(q, k, v, is_causal=causal)
            lib_err, how = float((lib.float() - o.float()).abs().max()), "ok"
            del lib
        except Exception as e:              # noqa: BLE001
            traceback.print_exc()
            lib_ms, lib_err, how = None, None, f"no time: {e!r}"[:300]
        out[name] = {"window": w, "causal": causal, "heads": H,
                     "kv_heads": k.shape[1], "head_dim": D,
                     "dtype": str(q.dtype), "ms": ms,
                     "plain_ms": plain_ms, "max_abs_err": err,
                     "excess": excess, "fault_max_abs_err": fault_err,
                     "fault_excess": fault_excess, "old_tol_excess": old,
                     "dense_rows_excess": dense,
                     "dense_rows_fault_excess": dense_fault,
                     "pairs": pairs, "flops": flops, "bytes": nbytes,
                     "bound_ms": b_ms, "bound_by": b_by,
                     "cuda_core_bound_ms": old_b_ms,
                     "share_of_bound": b_ms / ms, "library_ms": lib_ms,
                     "library": how, "library_vs_kernel_err": lib_err,
                     "tflops": flops / ms / 1e9}
        print(f"flash_attention {name} (S=T={S}, H={H}, Hkv={k.shape[1]}, "
              f"D={D}, {'bf16' if is16 else 'f32'}, "
              f"{'causal' if causal else 'non-causal'}, window {w}): "
              f"{ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s, "
              f"{100 * b_ms / ms:.1f} % of the bound), {pairs / 1e9:.3f} G "
              f"pairs -> bound {b_ms:.3f} ms ({b_by}, {work / 1e12:.3f} "
              f"TFLOP at {rate / 1e12:.1f} TFLOP/s"
              + ("" if old_b_ms is None else f"; at the f32 CUDA-core rate "
                 f"{old_b_ms:.3f} ms, for the record")
              + f"); plain {plain_ms:.1f} ms, "
              f"max abs {err:.5f}; share of the limit {excess:.3f} (planted "
              f"fault: max abs {fault_err:.5f}, {fault_excess:.1f} of the "
              f"limit), 256 rows vs dense attention_ref {dense:.3f} (fault "
              f"{dense_fault:.1f})"
              + ("" if old is None else f"; old FLASH_TOL vs plain (record "
                 f"only) {old[0]:.3f}, fault {old[1]:.1f}")
              + f"; sdpa "
              f"{'not timed' if lib_ms is None else f'{lib_ms:.3f} ms'} "
              f"({how}, vs kernel {lib_err})", flush=True)
        del o
    report["attention"] = out

    def line(name, source, pipe, case):
        c = out[case]
        names = [n for n, _, _, _, f in cases if f == (name == "flash_attention")]
        return {"name": name, "route": "cuda", "pipe": pipe,
                "source": source,
                "replaces": "src/repro/kernels/flash_attention.py:102",
                "launches": counts[name],
                "max_abs_err": max(out[n]["max_abs_err"] for n in names),
                "ms": c["ms"], "plain_ms": c["plain_ms"],
                "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
                "library_ms": c["library_ms"]}
    return [line("flash_attention_sm90",
                 "src/repro_torch/csrc/flash_attention_sm90.cu", "wgmma",
                 "causal"),
            line("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
                 "wgmma 3xtf32", "window f32")]


def profiled(fn, trace, what, keep=True):
    """Run ``fn()`` once under ``torch.profiler``: its host wall time, the
    device's busy time (union of kernel, copy and set intervals) and the
    device time by kernel name.  Writes the Chrome trace to ``trace`` and
    keeps it if ``keep``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    trace.parent.mkdir(parents=True, exist_ok=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text()).get("traceEvents", [])
    if not keep:
        trace.unlink()
    dev = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                  e.get("name", "?")) for e in events
                 if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, end = 0.0, float("-inf")
    by_name = {}
    for a, b, name in dev:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
        by_name[name[:60]] = by_name.get(name[:60], 0.0) + (b - a) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    out = {"wall_ms": wall_ms, "device_events": len(dev),
           "device_busy_ms": busy / 1e3,
           "busy_share": busy / 1e3 / wall_ms if dev else None,
           "device_ms_by_name": dict(top)}
    if dev:
        print(f"profiled {what}: {wall_ms:.2f} ms wall, device busy "
              f"{busy / 1e3:.2f} ms ({100 * busy / 1e3 / wall_ms:.1f} %) in "
              f"{len(dev)} device events; by name (ms): "
              f"{', '.join(f'{k} {v:.3f}' for k, v in top)}", flush=True)
    else:
        print(f"profiled {what}: {wall_ms:.2f} ms wall; the profiler saw no "
              f"device events (device time not measured)", flush=True)
    return out


def trace_counts(events, span=None):
    """What a ``torch.profiler`` Chrome trace holds: top-level host ops,
    device events (kernels, memsets, memcpys) and host syncs (count and
    ms waiting), the host span and the device's busy ms and idle share
    over its own span.  With ``span`` (t0, t1) in the trace's µs: only
    host calls inside it and the device events they launched."""
    t0, t1 = span if span else (float("-inf"), float("inf"))
    inside = [e for e in events if t0 <= float(e.get("ts", 0)) <= t1]
    host = sorted((e for e in inside if e.get("cat") == "cpu_op"),
                  key=lambda e: float(e["ts"]))
    top, end = [], float("-inf")
    for e in host:
        if float(e["ts"]) >= end:
            top.append(e)
            end = float(e["ts"]) + float(e.get("dur", 0))
    rt = [e for e in inside if e.get("cat") == "cuda_runtime"]
    corr = {e.get("args", {}).get("correlation") for e in rt}
    dev = sorted((e for e in events
                  if e.get("cat") in ("kernel", "gpu_memset", "gpu_memcpy")
                  and e.get("args", {}).get("correlation") in corr),
                 key=lambda e: float(e["ts"]))
    syncs = [e for e in rt if "Synchronize" in e.get("name", "")]
    busy, last = 0.0, float("-inf")
    for e in dev:
        a, b = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))
        busy += max(0.0, b - max(a, last))
        last = max(last, b)
    dspan = (last - float(dev[0]["ts"])) if dev else 0.0
    return {"host_ops": len(top),
            "device_events": len(dev),
            "kernels": sum(e["cat"] == "kernel" for e in dev),
            "memsets": sum(e["cat"] == "gpu_memset" for e in dev),
            "memcpys": sum(e["cat"] == "gpu_memcpy" for e in dev),
            "syncs": len(syncs),
            "sync_ms": sum(float(e.get("dur", 0)) for e in syncs) / 1e3,
            "host_ms": ((max(float(e["ts"]) + float(e.get("dur", 0))
                             for e in top) - float(top[0]["ts"])) / 1e3
                        if top else 0.0),
            "device_busy_ms": busy / 1e3,
            "device_idle_share": 1 - busy / dspan if dspan else None}


def annotation_span(events, name):
    """(t0, t1) of the first ``record_function(name)`` span of a trace, in
    its µs, or None."""
    ann = [e for e in events if e.get("name") == name
           and e.get("cat") == "user_annotation"]
    if not ann:
        return None
    t0 = float(ann[0]["ts"])
    return t0, t0 + float(ann[0]["dur"])


def profile_round(state, cfg, lanes, starts, out_dir):
    """One serving round (``ingest`` of the last round's lanes, then a
    deepwalk batch) under ``torch.profiler``, after a warm-up round; the
    ingest's own counts (``trace_counts`` over its ``record_function``
    span) beside the round's."""
    import torch
    from repro_torch.core.walks import WalkParams
    from repro_torch.serve import DynamicWalkEngine
    eng = DynamicWalkEngine(clone_state(state), cfg,
                            WalkParams("deepwalk", WALK_LEN), seed=1)
    eng.ingest(*lanes)
    eng.walk(starts)
    eng = DynamicWalkEngine(state, cfg, WalkParams("deepwalk", WALK_LEN),
                            seed=1)

    def round_():
        with torch.profiler.record_function("ingest"):
            eng.ingest(*lanes)
        eng.walk(starts)
    trace = out_dir / "round_trace.json"
    out = profiled(round_, trace, "round")
    events = json.loads(trace.read_text()).get("traceEvents", [])
    span = annotation_span(events, "ingest")
    if span:
        out["ingest"] = trace_counts(events, span)
        print(f"profiled round, ingest of {int(lanes[0].shape[0])} updates: "
              f"{out['ingest']}", flush=True)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=20,
                    help="log2 of the vertex count of the main path's graph")
    ap.add_argument("--report", type=Path, default=None,
                    help="write every number measured to this JSON file")
    ap.add_argument("--profile", type=Path, default=None,
                    help="after the main path, profile one round and write "
                         "its trace into this directory")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    report = {"scale": args.scale}

    t_start = time.perf_counter()
    phase_s = report["phase_s"] = {}

    def timed(name, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        phase_s[name] = time.perf_counter() - t
        return out

    # ---- phase 1: build and report
    secs = _build.build_all()
    report["build_s"] = secs
    print(f"built {list(_build.SOURCES)} in {secs:.1f} s", flush=True)
    for name, log in _build.BUILD_LOG.items():
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln
                or "spill" in ln]
        print(f"  {name}: {'; '.join(regs)}", flush=True)
    report["sm90"] = sm90_census()
    report["walk_census"] = walk_census()
    report["table_census"] = table_census()
    card = card_line()
    report["card"] = card
    torch.cuda.init()
    phase_s["1 build and census"] = time.perf_counter() - t_start

    # ---- phase 2: kernel == plain on the card
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    nw = check_walk_kernel(rng)
    ng = check_segment_kernel(rng)
    nu = check_update_kernel(rng)
    ns = check_sample_kernels(rng)
    rng_new = np.random.default_rng(1)       # rng's stream stays as it was
    nt = check_table_kernels(rng_new)
    fa_errs = check_flash_kernel(rng_new)
    report["check_s"] = phase_s["2 kernel == plain"] = \
        time.perf_counter() - t0
    report["flash_check_errs"] = fa_errs
    print(f"kernel == plain, bit-exact: walk_fused {nw} cases, walk_segment "
          f"{ng} cases, update_fused {nu} rounds, walk_sample and "
          f"walk_sample_uniform {ns} cases each, radix_hist and alias_build "
          f"{nt} cases; flash_attention {len(fa_errs)} cases within "
          f"its limit ({report['check_s']:.1f} s)", flush=True)
    for e in fa_errs:
        old = e["old_tol_excess"]
        print(f"  flash_attention {e['case']}: max abs vs plain "
              f"{e['max_abs_err']:.2e}, {e['excess']:.3f} of the limit; "
              f"planted fault {e['fault_max_abs_err']:.2e}, "
              f"{e['fault_excess']:.1f} of it"
              + ("" if old is None else f"; old FLASH_TOL (record only): "
                 f"{old[0]:.3f}, fault {old[1]:.1f}"), flush=True)

    # ---- phases 3 and 4: the main path, then the times
    kernels, engine, cfg, starts, stream, graph, profile = timed(
        "3/4 main path and times", main_path, args, report)
    # ---- phase 3d: the table kernels on the final state
    tables = timed("3d table kernels", table_phase, engine, cfg, report)
    # ---- phase 3b: the per-step paths
    kernels += timed("3b per-step paths", per_step_paths, engine, cfg,
                     starts, report, args.profile)
    if profile is not None:         # after the profiler-counted replays
        timed("profiled round", profile)
        profile = None              # frees the round's saved state
    # ---- phase 3c: the sharded path, then the streaming updates
    kernels.insert(1, timed("3c sharded path", sharded_path, engine, cfg,
                            starts, stream, report))
    timed("streaming updates", streaming, engine, cfg, report, rng)
    kernels += tables
    del engine
    torch.cuda.empty_cache()
    # ---- phase 3f: the serving layer at full width, then recovery
    peak = torch.cuda.max_memory_allocated()
    handoff = {"V": 1 << args.scale}
    timed("3f serving", serving_phase, args, report, graph, stream, handoff)
    timed("3f recovery", recovery_phase, args, report)
    peak = max(peak, torch.cuda.max_memory_allocated())
    # ---- phase 3g: the sharded serving layer, phase 3f's traffic
    more = timed("3g sharded serving", sharded_serving_phase, report, handoff,
                 card)
    del handoff
    for k in kernels:
        k["launches"] += more.get(k["name"], 0)
    del graph
    torch.cuda.empty_cache()
    # ---- phase 3e: attention at full width
    torch.cuda.reset_peak_memory_stats()
    kernels += timed("3e attention", attention_phase, report)
    report["attention_s"] = phase_s["3e attention"]
    print(f"attention phase: {report['attention_s']:.1f} s", flush=True)
    phase_s["total"] = time.perf_counter() - t_start
    print("phase seconds: " + ", ".join(f"{k} {v:.1f}"
                                         for k, v in phase_s.items()),
          flush=True)
    report["peak_gib"] = max(peak, torch.cuda.max_memory_allocated()) / 2**30
    if args.report:
        args.report.parent.mkdir(parents=True, exist_ok=True)
        args.report.write_text(json.dumps(report, indent=1))
    print(f"peak device memory {report['peak_gib']:.1f} GiB", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
