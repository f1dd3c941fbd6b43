#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--scale 20] [--report PATH] [--profile DIR]

Phases (any failure exits non-zero and prints no result line):

1. Build the CUDA kernels from ``src/repro_torch/csrc`` (one nvcc per
   source, in parallel) and print the build time and the card's name and
   power limit.
2. Hold each kernel against its plain PyTorch version on the card, bit
   for bit: ``walk_fused`` over deepwalk/ppr/simple × base 2/4 × fp on/off
   × fed/hashed uniforms; ``update_fused`` over insert/delete/mixed × five
   config rows, plus a batch wider than 2·C.
3. The main path at full size, through ``DynamicWalkEngine.run_stream``:
   an R-MAT graph of 2^20 vertices (edge factor 8) with degree biases,
   ``BingoConfig(2**20, capacity=256, bias_bits=16)``, 10 mixed rounds of
   100,000 updates, 262,144 deepwalk walkers of length 80 after each
   round, then one ppr batch (max 400, stop 1/80) and one simple batch.
   Launch counters are zeroed just before and read just after.  Round 1's
   state is held against ``batched_update`` on a copy.
4. Times on the card (CUDA events): each kernel at the main path's shapes
   and its plain version, whose outputs are held against the main path's
   whole batches (deepwalk, ppr and simple paths; the state after round
   10); each kernel's bound from the work this run's data needs.  Prints a
   ``{"kernels": [...]}`` line and, last, ``{"ok": true, "device": {...}}``.

Needs one card, the CUDA toolkit (nvcc) and nothing from the network.
``--scale`` cuts the graph for a quicker run; ``--report`` writes every
number measured to a JSON file; ``--profile DIR`` adds one profiled round
(``torch.profiler``) and writes its trace there.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
OPS_PER_S = 67e12                  # H100 SXM float32 outside the tensor cores
WALK_LEN, PPR_LEN, PPR_STOP = 80, 400, 1.0 / 80.0
CHECK_WALKERS = 4096


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
    passed to ``fn``)."""
    import torch
    times, out = [], None
    for _ in range(reps):
        arg = setup() if setup else None
        out = None
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
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
def check_walk_kernel(rng):
    import torch
    from repro_torch.core import dyngraph as dg
    from repro_torch.kernels import ops
    from repro_torch.kernels.walk_fused import walk_fused_ref
    V, C, bits, B, L = 4096, 128, 12, 2048, 24
    src, dst, w = random_graph(rng, V, C, bits)
    keep = rng.random(V) >= 0.02                       # some dead ends
    keep = keep[src]
    src, dst, w = src[keep], dst[keep], w[keep]
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
                         f"walk_fused != plain ({kind}, base 2^{base_log2}, "
                         f"fp={fp}, fed={fed})")
                    n += 1
    return n


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
    for adaptive, fp, base_log2 in [(True, False, 1), (False, False, 1),
                                    (True, True, 1), (True, False, 2),
                                    (True, True, 2)]:
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
    return n + 1


# ---------------------------------------------------------------- phase 3
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
    lane the kernel reads its sorted insert or delete lane and writes
    the delete flag; per row its five segment words.  Operations: the
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
             + cols * int(n_ins.sum()) + 3 * int(n_del.sum()))
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
    applied = 0
    upd_err = 0.0
    ops.reset_launch_counts()
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
    print(f"main path launches: {counts}", flush=True)
    need(counts["update_fused"] == rounds, "update_fused launches != rounds")
    need(counts["walk_fused"] == rounds + 2, "walk_fused launches != walks")

    # outputs: the paths are real walks on the current state
    st = engine.state
    for name, p in (("deepwalk", last_paths), ("ppr", ppr_paths),
                    ("simple", simple_paths)):
        need(torch.equal(p[:, 0], starts), f"{name}: column 0 != starts")
        need(bool(((p >= -1) & (p < V)).all()), f"{name}: vertex out of range")
        dead = p[:, :-1] < 0
        need(not bool((dead & (p[:, 1:] >= 0)).any()), f"{name}: revived walker")
        a, b = p[:CHECK_WALKERS, :-1].long(), p[:CHECK_WALKERS, 1:].long()
        hop = (a >= 0) & (b >= 0)
        rows = st.nbr[a[hop]]
        ok = ((rows == b[hop][:, None])
              & (torch.arange(cfg.capacity, device="cuda")[None, :]
                 < st.deg[a[hop]][:, None])).any(1)
        need(bool(ok.all()), f"{name}: a hop that is not an edge")
    ppr_len = float((ppr_paths[:, 1:] >= 0).sum(1).float().mean())
    report.update(round_ms=round_ms,
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
    plan = plan_round(pre_last, cfg, *last)
    upd_ms, _ = cuda_ms(lambda s: launch_round(s, cfg, plan),
                        setup=lambda: clone_state(pre_last))
    round_wrapper_ms, _ = cuda_ms(lambda s: ops.update_fused(s, cfg, *last),
                                  setup=lambda: clone_state(pre_last))
    upd_plain_ms, (plain_last, _) = cuda_ms(
        lambda s: batched_update(s, cfg, *last), reps=1,
        setup=lambda: clone_state(pre_last))
    upd_err = max(upd_err, state_diff(plain_last, st, "round 10 vs batched_update"))
    del plain_last
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
                    plain_ms=upd_plain_ms, bound_ms=u_ms, bound_by=u_by,
                    batch=batch, updates_per_s=batch / round_wrapper_ms * 1e3),
        kernels=kernels)
    print(f"update_fused: kernel {upd_ms:.3f} ms, whole round "
          f"{round_wrapper_ms:.3f} ms ({batch / round_wrapper_ms * 1e3:.0f} "
          f"updates/s), {uwork['affected_rows']} rows; plain {upd_plain_ms:.1f} "
          f"ms, states equal after rounds 1 and 10; needs "
          f"{uwork['bytes'] / 1e9:.4f} GB and {uwork['ops'] / 1e9:.3f} G ops "
          f"-> bound {u_ms:.4f} ms ({u_by})", flush=True)
    if args.profile:
        try:        # a diagnostic: a profiler fault does not fail the smoke
            report["profile"] = profile_round(clone_state(pre_last), cfg,
                                              last, starts, args.profile)
        except Exception as e:              # noqa: BLE001
            traceback.print_exc()
            print(f"profiled round: failed ({e!r})", flush=True)
            report["profile"] = {"error": repr(e)}
    return kernels


def profile_round(state, cfg, lanes, starts, out_dir):
    """One serving round (``ingest`` of the last round's lanes, then a
    deepwalk batch) under ``torch.profiler``, after a warm-up walk: its
    host wall time, the device's busy time (union of kernel, copy and set
    intervals) and the device time by kernel name.  Writes the Chrome
    trace to ``out_dir/round_trace.json``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.walks import WalkParams
    from repro_torch.serve import DynamicWalkEngine
    eng = DynamicWalkEngine(state, cfg, WalkParams("deepwalk", WALK_LEN), seed=1)
    out_dir.mkdir(parents=True, exist_ok=True)
    trace = out_dir / "round_trace.json"
    eng.walk(starts)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.ingest(*lanes)
        eng.walk(starts)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text()).get("traceEvents", [])
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
        print(f"profiled round: {wall_ms:.2f} ms wall, device busy "
              f"{busy / 1e3:.2f} ms ({100 * busy / 1e3 / wall_ms:.1f} %) in "
              f"{len(dev)} device events; by name (ms): "
              f"{', '.join(f'{k} {v:.3f}' for k, v in top)}", flush=True)
    else:
        print(f"profiled round: {wall_ms:.2f} ms wall; the profiler saw no "
              f"device events (device time not measured)", flush=True)
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

    # ---- phase 1: build and report
    secs = _build.build_all()
    report["build_s"] = secs
    print(f"built {list(_build.SOURCES)} in {secs:.1f} s", flush=True)
    for name, log in _build.BUILD_LOG.items():
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"  {name}: {'; '.join(regs)}", flush=True)
    card = card_line()
    report["card"] = card
    torch.cuda.init()

    # ---- phase 2: kernel == plain on the card
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    nw = check_walk_kernel(rng)
    nu = check_update_kernel(rng)
    report["check_s"] = time.perf_counter() - t0
    print(f"kernel == plain, bit-exact: walk_fused {nw} cases, update_fused "
          f"{nu} rounds ({report['check_s']:.1f} s)", flush=True)

    # ---- phases 3 and 4: the main path, then the times
    kernels = main_path(args, report)
    report["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
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
