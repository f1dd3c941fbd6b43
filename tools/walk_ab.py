#!/usr/bin/env python3
"""Time this tree's walk kernels against other trees' on one GPU.

    python3 tools/walk_ab.py [--tree NAME=DIR ...] [--scale 20] [--flash]
                             [--update] [--alias] [--hist] [--uniform]
                             [--out PATH]

Builds ``walk_fused.cu`` and ``walk_sample.cu`` of this tree's ``csrc``
and of each ``--tree`` (another tree's ``csrc`` directory, for example a
parent commit unpacked with ``git archive`` into a gitignored directory
such as ``build/parent``), whose entry points must take this tree's
arguments.  Then it builds the state of ``chip_smoke.py``'s main path
(R-MAT 2^scale, edge factor 8, degree biases, ``BingoConfig(2**scale,
capacity=256, bias_bits=16)``, its 10 mixed update rounds of 100,000) and
times, after one untimed pass, in four turns (each tree in order, then in
reverse, twice; ``chip_smoke.cuda_ms``, median of 3 each turn): the
whole-walk kernel on the main path's deepwalk (262,144 × 80), ppr (max
400, stop 1/80) and simple batches; the segment entry on the deepwalk
batch as one shard (every ``t0 = 0``) and on relay-shaped launches of
shard 0 of 4 (98,304 slots): round 1's (deepwalk and simple), later
rounds' with one slot in twelve live (deepwalk and simple), one in a
hundred, 5 % live at scattered slots with scattered start steps (``t0 =
L`` among them), and all free (also at ppr's length, beside one PyTorch
``fill_`` of as many words, the write rate's yardstick); the per-step
sample of all 262,144 walkers in place, of 16,384 of them (a late
node2vec trial's size), and of 262,144 walkers all on full hub rows
(degree 256).  Every tree's output must equal this tree's, bit for bit,
and its deepwalk, samples and round-1, late-round and 5 % segments must
equal the plain versions.  A tree whose segment entry predates its
scratch argument (``work``) is called without it.  With ``--flash``,
each tree whose
``flash_attention.cu`` has the 80-wide float32 instantiation
(``Geometry<80>``) is built too, and its float32 attention is timed in the
same turns at hubert-xlarge's widths (16 heads, D = 80, non-causal),
Mixtral 8x7B's (32 heads over 8 KV heads, D = 128, window 4096) and
Gemma 2 9B's (16 heads over 8 KV heads, D = 256, window 4096) over 8,192
tokens, each tree's output within ``chip_smoke.FLASH_TOL`` of the plain
version.  With ``--update``, each tree's own ``repro_torch``
package (the ``src`` directory above its ``csrc``, imported beside this
tree's, each building its own sources) runs the main path's round 10 on
a copy of the state after round 9 in the same turns: the whole round
(``ops.update_fused``), its prepass (``plan_round``) and its kernel
alone (``launch_round`` on a prepared plan); the states and stats after
the round must equal this tree's, bit for bit, and the plain version's;
then one profiled round a tree (``chip_smoke.trace_counts`` over its
``record_function`` span: host ops, device events, host syncs; the
traces next to ``--out``).  With ``--alias``, each tree's
``ops.alias_build`` on the state's group weights, equal to this tree's
and to ``state.itable``.  With ``--hist``, each tree's ``radix_hist.cu``
is built too and ``ops.radix_hist`` runs on it over the state's bias
rows (K = 16), equal to this tree's and to the state's ``digitsum`` and
``gsize``; the rows by degree are printed.  With ``--uniform``, each
tree's uniform pick (``ops.walk_sample_uniform``) on all 262,144 walkers:
at the starts with (B, 3) uniforms (the biased sample's layout) and with
(B, 1), and at the per-step simple walk's frontier (its column
``chip_smoke.FRONTIER_STEP``, clamped at 0) with (B, 1), as the path
calls it; equal to the plain version, with the 32-byte sector figure
beside the word bound; then one per-step simple walk a tree, all in
one ``torch.profiler`` session (``chip_smoke.sample_launches``: the kernel's launches
and device time on the path), its paths equal across trees.  Prints one
line per case and, with ``--out``,
writes every time and each tree's registers (``cuobjdump -res-usage``)
and resident blocks per SM to a JSON file.
"""

import argparse
import contextlib
import ctypes
import importlib
import inspect
import json
import re
import statistics
import subprocess
import sys
import time
from functools import partial
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

SOURCES = ("walk_fused", "walk_sample")


def takes_work(csrc):
    """Whether a tree's segment entry takes the scratch argument ``work``."""
    return "int* work" in (csrc / "walk_fused.cu").read_text()


def takes_d80(csrc):
    """Whether a tree's float32 attention has an 80-wide instantiation."""
    return "Geometry<80>" in (csrc / "flash_attention.cu").read_text()


def build(trees, build_dir, flash=False, hist=False):
    """One nvcc per (tree, source), all at once (``flash_attention.cu``
    too where ``flash`` and ``takes_d80``, ``radix_hist.cu`` where
    ``hist``); returns the libraries by tree, loaded with the entry
    points' signatures (a segment entry without ``work`` with one pointer
    fewer), and their paths."""
    from repro_torch.kernels import _build
    procs = []
    for name, csrc in trees.items():
        extra = ("flash_attention",) if flash and takes_d80(csrc) else ()
        extra += ("radix_hist",) if hist else ()
        for src in SOURCES + extra:
            out = build_dir / name / f"lib{src}.so"
            out.parent.mkdir(parents=True, exist_ok=True)
            cmd = [_build._nvcc(), *_build._flags(src), "-o", str(out),
                   str(csrc / f"{src}.cu")]
            procs.append((name, src, out, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    libs, paths = {}, {}
    for name, src, out, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}/{src}:\n{log}")
        lib = ctypes.CDLL(str(out))
        for fn, (argtypes, restype) in _build._SIGNATURES[src].items():
            f = getattr(lib, fn)
            if fn == "walk_segment_launch" and not takes_work(trees[name]):
                argtypes = argtypes[:12] + argtypes[13:]
            f.argtypes, f.restype = argtypes, restype
        err = lib.kernels_error_string
        err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
        libs.setdefault(name, {})[src] = lib
        paths.setdefault(name, {})[src] = out
    return libs, paths


def _ours(name):
    return name == "repro_torch" or name.startswith("repro_torch.")


def load_package(src):
    """Another tree's ``repro_torch`` package imported from ``src`` (its
    modules by name), leaving this tree's in ``sys.modules``."""
    saved = {k: m for k, m in sys.modules.items() if _ours(k)}
    for k in saved:
        del sys.modules[k]
    sys.path.insert(0, str(src))
    try:
        for mod in ("kernels.ops", "kernels.update_fused", "kernels._build",
                    "kernels.alias_build", "core.dyngraph"):
            importlib.import_module(f"repro_torch.{mod}")
        return {k: m for k, m in sys.modules.items() if _ours(k)}
    finally:
        sys.path.remove(str(src))
        for k in [k for k in sys.modules if _ours(k)]:
            del sys.modules[k]
        sys.modules.update(saved)


@contextlib.contextmanager
def using(package):
    """Run with ``package``'s modules as ``repro_torch`` (the lazy imports
    inside its functions resolve to them); None: this tree's, as they
    are."""
    if package is None:
        yield
        return
    saved = {k: m for k, m in sys.modules.items() if _ours(k)}
    for k in saved:
        del sys.modules[k]
    sys.modules.update(package)
    try:
        yield
    finally:
        for k in [k for k in sys.modules if _ours(k)]:
            del sys.modules[k]
        sys.modules.update(saved)


def flat(state, stats=None):
    """A state's tensors (and a round's four stats), in order, as a tuple."""
    out = [x for f, x in zip(state._fields, state)
           if f != "itable" and x is not None]
    out += [state.itable.prob, state.itable.alias]
    return tuple(out) + (tuple(stats[:4]) if stats is not None else ())


def round_cases(packages, pre, cfg, lanes, clone):
    """The ``--update`` cases of each tree's package: whole round,
    prepass and kernel alone, each returning the state after the round
    (and the round's stats where the entry returns them)."""
    cases = {}
    for name, pkg in packages.items():
        upd, ops_ = pkg["repro_torch.kernels.update_fused"], \
            pkg["repro_torch.kernels.ops"]
        takes_state = "state" in inspect.signature(upd.plan_round).parameters

        def plan(upd=upd, takes_state=takes_state):
            return (upd.plan_round(pre, cfg, *lanes) if takes_state
                    else upd.plan_round(cfg, *lanes))

        def whole(s, ops_=ops_):
            s, stats = ops_.update_fused(s, cfg, *lanes)
            return flat(s, stats)

        def kernel(arg, upd=upd):
            s, p = arg
            upd.launch_round(s, cfg, p)
            return flat(s)
        cases[name] = {
            "update round (ops.update_fused)": (whole, clone),
            "update prepass (plan_round)": (plan, None),
            "update kernel (launch_round)": (kernel, lambda plan=plan: (
                clone(), plan())),
        }
    return cases


def res_usage(path):
    """Registers and local-memory bytes per kernel function of a library."""
    from repro_torch.kernels import _build
    text = subprocess.run(
        [str(Path(_build._nvcc()).parent / "cuobjdump"), "-res-usage",
         str(path)], capture_output=True, text=True, timeout=300,
        check=True).stdout
    found = re.findall(r"Function ([^:\s]+):\s*REG:(\d+) STACK:(\d+) "
                       r"SHARED:(\d+) LOCAL:(\d+)", text)
    return {f: {"registers": int(r), "stack": int(st), "local": int(lo)}
            for f, r, st, _, lo in found}


def main_state(scale, keep_last=False):
    """The state after chip_smoke.py's main path's 10 update rounds; with
    ``keep_last`` also a copy of the state after round 9 and round 10's
    lanes."""
    import torch
    from repro_torch.core import dyngraph as dg
    from repro_torch.graph.rmat import degree_bias, rmat_edges
    from repro_torch.graph.streams import make_update_stream
    from repro_torch.kernels import ops
    V, rounds = 1 << scale, 10
    src, dst = rmat_edges(scale, 8, seed=0)
    w = degree_bias(src, dst, V, bias_bits=16)
    batch = min(100_000, len(src) // (4 * rounds))
    stream = make_update_stream(src, dst, w, batch_size=batch, rounds=rounds,
                                mode="mixed", seed=0)
    cfg = dg.BingoConfig(num_vertices=V, capacity=256, bias_bits=16)
    st = dg.from_edges(cfg, stream.init_src, stream.init_dst, stream.init_w,
                       device="cuda")
    pre = None
    for r in range(rounds):
        lanes = [torch.from_numpy(np.ascontiguousarray(a[r])).cuda()
                 for a in (stream.is_insert, stream.u, stream.v, stream.w)]
        if keep_last and r == rounds - 1:
            from chip_smoke import clone_state
            pre = clone_state(st)
        st, _ = ops.update_fused(st, cfg, *lanes)
    torch.cuda.synchronize()
    return (st, cfg, pre, lanes) if keep_last else (st, cfg)


def walk_segment(lib, work, prob, alias, bias, nbr, deg, starts, t0, seed,
                 wid, length, uniform=False):
    """``ops.walk_segment`` (hashed uniforms, integer biases, base 2) on a
    tree's library, passing the scratch ``work`` (zeroed once, int32, at
    least B + 3) only to an entry that takes it (``work`` not None);
    returns ``(path, frontier)``."""
    import torch
    from repro_torch.kernels import _build
    B, (V, C) = starts.shape[0], nbr.shape
    Kin = 1 if uniform else prob.shape[1]
    if uniform:
        prob = alias = bias = None
    dev = nbr.device
    path = torch.empty((B, length + 1), dtype=torch.int32, device=dev)
    frontier = torch.empty((B, 2), dtype=torch.int32, device=dev)
    ptrs = [_build.ptr(x) for x in (prob, alias, bias, nbr, deg, None, starts,
                                    t0, wid, None, path, frontier)
            + (() if work is None else (work,))]
    err = lib.walk_segment_launch(
        *ptrs, B, V, C, Kin, length, 1, ctypes.c_float(0.0), int(uniform), 0,
        0, int(seed), ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err != 0:
        raise RuntimeError(f"walk_segment launch failed: {err}")
    return path, frontier


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", default=[],
                    metavar="NAME=DIR", help="another tree's csrc directory")
    ap.add_argument("--scale", type=int, default=20)
    ap.add_argument("--flash", action="store_true",
                    help="also time the trees' float32 attention")
    ap.add_argument("--update", action="store_true",
                    help="also time each tree's update round (its own "
                         "package)")
    ap.add_argument("--alias", action="store_true",
                    help="also time each tree's alias_build")
    ap.add_argument("--hist", action="store_true",
                    help="also build and time each tree's radix_hist")
    ap.add_argument("--uniform", action="store_true",
                    help="also time each tree's uniform pick at the starts "
                         "and at a frontier, and profile it on the "
                         "per-step simple walk")
    ap.add_argument("--out", type=Path, default=None,
                    help="write every time, register count and occupancy "
                         "to this JSON file")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("walk_ab: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import (FRONTIER_STEP, WALK_LEN,
                            PPR_LEN, PPR_STOP, annotation_span, bound,
                            card_line, clone_state, cuda_ms,
                            degree_histogram, flash_excess, sample_launches,
                            sample_work, trace_counts, uniform_sectors)
    from repro_torch.kernels.flash_attention import flash_attention_ref32
    from repro_torch.launch import hw
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.walk_fused import walk_fused_ref, walk_segment_ref
    from repro_torch.kernels.walk_sample import (walk_sample_ref,
                                                walk_sample_uniform_ref)
    trees = {"tree": _build.CSRC}
    for spec in args.tree:
        name, _, path = spec.partition("=")
        trees[name] = Path(path).resolve()
    t0 = time.perf_counter()
    libs, paths = build(trees, ROOT / "build" / "walk_ab", args.flash,
                        args.hist)
    _build._LIBS.update(libs["tree"])
    report = {"card": card_line(), "build_s": time.perf_counter() - t0,
              "trees": {}}
    print(f"{report['card']}; built {list(trees)} in "
          f"{report['build_s']:.1f} s", flush=True)
    for name in trees:
        fl, sl = libs[name]["walk_fused"], libs[name]["walk_sample"]
        occ = {"whole biased": fl.walk_fused_occupancy(0, 0),
               "whole uniform": fl.walk_fused_occupancy(0, 1),
               "segment biased": fl.walk_fused_occupancy(1, 0),
               "segment uniform": fl.walk_fused_occupancy(1, 1),
               "sample": sl.walk_sample_occupancy()}
        regs = {src: res_usage(path) for src, path in paths[name].items()}
        report["trees"][name] = {"blocks_per_sm": occ, "res_usage": regs}
        print(f"{name}: blocks/SM {occ}; registers (local bytes) by kernel "
              + "; ".join(f"{src} " + ", ".join(
                  f"{v['registers']} ({v['local']})" for v in r.values())
                  for src, r in regs.items()), flush=True)

    packages = {}
    if args.update or args.alias:
        packages = {name: (load_package(csrc.parent.parent) if name != "tree"
                           else {k: m for k, m in sys.modules.items()
                                 if _ours(k)})
                    for name, csrc in trees.items()}
    st, cfg, pre, last = main_state(args.scale, keep_last=True)
    V = cfg.num_vertices
    starts = torch.arange(0, V, 4, dtype=torch.int32, device="cuda")
    tabs = (st.itable.prob, st.itable.alias, st.bias, st.nbr, st.deg)
    args_w = tabs + (None, starts)
    zeros = torch.zeros_like(starts)
    g = torch.Generator(device="cuda").manual_seed(5)
    u = torch.rand((len(starts), 3), generator=g, device="cuda")
    hubs = torch.nonzero(st.deg == cfg.capacity).squeeze(1).to(torch.int32)
    hub_rows = hubs[torch.randint(0, len(hubs), (len(starts),), generator=g,
                                  device="cuda")]
    few = starts[: 16384].contiguous()
    # relay-shaped segment launches on shard 0 of 4 (a neighbour past
    # V / 4 is remote): round 1's 98,304 slots (its walkers start at
    # step 0, a third of the slots free); later rounds' (one slot in
    # twelve, or in a hundred, live at steps 1..L-1); 5 % live at
    # scattered slots with start steps over 0..L; and none live
    from repro_torch.distributed import relay_view
    view = relay_view(st, 0, V // 4)
    vtabs = (view.itable.prob, view.itable.alias, view.bias, view.nbr,
             view.deg)
    slots = 98_304
    local = starts[starts < V // 4]
    seg1 = torch.full((slots,), -1, dtype=torch.int32, device="cuda")
    seg1[: len(local)] = local
    perm = torch.randperm(slots, generator=g, device="cuda")
    seg2, seg3, seg5 = (torch.full_like(seg1, -1) for _ in range(3))
    for seg, live in ((seg2, perm[: slots // 12]), (seg3, perm[: slots // 100]),
                      (seg5, perm[-slots // 20:])):
        seg[live] = torch.randint(0, V // 4, (len(live),), generator=g,
                                  device="cuda", dtype=torch.int32)
    t02 = torch.randint(1, WALK_LEN, (slots,), generator=g, device="cuda",
                        dtype=torch.int32)
    t05 = torch.randint(0, WALK_LEN + 1, (slots,), generator=g, device="cuda",
                        dtype=torch.int32)
    t05[perm[-slots // 20:][::50]] = WALK_LEN
    t01 = torch.zeros_like(seg1)
    free = torch.full_like(seg1, -1)
    wid = torch.arange(slots, dtype=torch.int32, device="cuda")
    wid_all = torch.arange(len(starts), dtype=torch.int32, device="cuda")
    current = {}          # the tree in turn: its library, takes work
    scratch = {}          # (tree, slots) -> its segment entry's zeroed work

    def seg(tabs_, s_, t_, seed, w_, uniform=False, length=WALK_LEN):
        work = None
        if current["work"]:
            work = scratch.setdefault(
                (current["name"], len(s_)),
                torch.zeros(len(s_) + 3, dtype=torch.int32, device="cuda"))
        return walk_segment(current["lib"], work, *tabs_, s_, t_, seed, w_,
                            length, uniform)
    segments = {          # case: (starts, t0, uniform, length), shard view
        "walk_segment round 1": (seg1, t01, False, WALK_LEN),
        "walk_segment late round": (seg2, t02, False, WALK_LEN),
        "walk_segment sparse round": (seg3, t02, False, WALK_LEN),
        "walk_segment 5% live": (seg5, t05, False, WALK_LEN),
        "walk_segment all free": (free, t01, False, WALK_LEN),
        "walk_segment all free, ppr length": (free, t01, False, PPR_LEN),
        "walk_segment simple round 1": (seg1, t01, True, WALK_LEN),
        "walk_segment simple late round": (seg2, t02, True, WALK_LEN),
    }
    # the yardstick of an all-free ppr launch: one PyTorch fill of as many
    # int32 words as its path block (timed here, used nowhere in the port)
    block = torch.empty(slots * (PPR_LEN + 1), dtype=torch.int32,
                        device="cuda")
    cases = {
        "walk_fused deepwalk": lambda: ops.walk_fused(*args_w, 7, length=WALK_LEN),
        "walk_fused ppr": lambda: ops.walk_fused(
            *args_w, 8, length=PPR_LEN, stop_prob=PPR_STOP),
        "walk_fused simple": lambda: ops.walk_fused(
            *args_w, 9, length=WALK_LEN, uniform=True),
        "walk_segment deepwalk": lambda: seg(tabs, starts, zeros, 7,
                                             wid_all)[0],
        **{case: (lambda a=a: seg(vtabs, a[0], a[1], 7, wid, a[2], a[3]))
           for case, a in segments.items()},
        "fill -1, ppr path block (torch fill_)": lambda: block.fill_(-1),
        "walk_sample 262144": lambda: ops.walk_sample(*tabs, u, rows=starts),
        "walk_sample 16384": lambda: ops.walk_sample(
            *tabs, u[: 16384].contiguous(), rows=few),
        "walk_sample hubs": lambda: ops.walk_sample(*tabs, u, rows=hub_rows),
    }
    per_tree = {}         # case: {tree: (fn, setup)}, run in its package
    if args.update:
        for name, tc in round_cases(packages, pre, cfg, last,
                                    lambda: clone_state(pre)).items():
            for case, fs in tc.items():
                per_tree.setdefault(case, {})[name] = fs
    if args.alias:
        from repro_torch.core.radix import group_weights
        gw = group_weights(st.digitsum, cfg.base_log2)
        per_tree["alias_build (ops.alias_build)"] = {
            name: (lambda ops_=pkg["repro_torch.kernels.ops"]:
                   ops_.alias_build(gw), None)
            for name, pkg in packages.items()}
    for case, fs in per_tree.items():
        cases[case] = fs
    if args.hist:
        report["degree_histogram"] = degree_histogram(st.deg, cfg.capacity)
        print(f"rows by degree: {report['degree_histogram']}", flush=True)
        cases["radix_hist (ops.radix_hist)"] = lambda: ops.radix_hist(
            st.bias, st.deg, num_k=cfg.num_radix)
    picks = {}            # case: (rows, u) of the uniform pick
    if args.uniform:
        from repro_torch.core.walks import WalkParams
        from repro_torch.serve import DynamicWalkEngine
        simple = DynamicWalkEngine(st, cfg, WalkParams("simple", WALK_LEN),
                                   whole_walk=False)
        frontier = simple.walk(starts, seed=13)[:, FRONTIER_STEP].clamp(
            min=0).to(torch.int32).contiguous()
        u1 = u[:, :1].contiguous()
        picks = {"walk_sample_uniform starts, u (B, 3)": (starts, u),
                 "walk_sample_uniform starts, u (B, 1)": (starts, u1),
                 "walk_sample_uniform frontier, u (B, 1)": (frontier, u1)}
        for case, (rows, uu) in picks.items():
            cases[case] = (lambda rows=rows, uu=uu: ops.walk_sample_uniform(
                st.nbr, st.deg, uu, rows=rows))
    flash = {}            # case: (q, k, v, causal, window), float32
    if args.flash:
        from repro_torch.kernels.flash_attention import flash_attention_f32
        for case, (H, Hkv, D, causal, window) in (
                ("flash f32 hubert 8k", (16, 16, 80, False, 0)),
                ("flash f32 window 8k", (32, 8, 128, True, 4096)),
                ("flash f32 gemma window 8k", (16, 8, 256, True, 4096))):
            flash[case] = tuple(torch.randn(
                (1, h, 8192, D), generator=g, device="cuda")
                for h in (H, Hkv, Hkv)) + (causal, window)
            cases[case] = (lambda a=flash[case]: flash_attention_f32(
                *a[:3], causal=a[3], window=a[4],
                scale=a[0].shape[-1] ** -0.5))
    # one untimed pass over every tree first (clocks, caches), then the
    # timed turns
    order = list(trees) + 2 * (list(trees) + list(trees)[::-1])
    times = {c: {n: [] for n in trees
                 if c not in flash or "flash_attention" in libs[n]}
             for c in cases}
    first, outs = {}, {}
    for k, name in enumerate(order):
        _build._LIBS.update(libs[name])
        current.update(name=name, lib=libs[name]["walk_fused"],
                       work=takes_work(trees[name]))
        for case, fn in cases.items():
            if name not in times[case]:
                continue
            if case in per_tree:
                f, setup = fn[name]
                with using(None if name == "tree" else packages[name]):
                    ms, out = cuda_ms(f, setup=setup)
                if case.startswith("update prepass"):
                    out = None       # the trees' plans differ in layout
            else:
                ms, out = cuda_ms(fn)
            if case in flash:        # held to the limit, not to the first tree
                if k >= len(trees):
                    times[case][name].append(ms)
                outs[(case, name)] = out
                continue
            if k >= len(trees):
                times[case][name].append(ms)
            if out is None:
                continue
            if case not in first:
                first[case] = out
            else:
                same = all(torch.equal(a, b) for a, b in zip(out, first[case])) \
                    if isinstance(out, tuple) else torch.equal(out, first[case])
                if not same:
                    raise SystemExit(f"{case}: {name} differs from {order[0]}")
    # this tree against the plain versions (the rest equal it)
    if args.update:
        from repro_torch.core.updates import batched_update
        s, stats = batched_update(clone_state(pre), cfg, *last)
        want = flat(s, stats)
        for case in ("update round (ops.update_fused)",
                     "update kernel (launch_round)"):
            got = first[case]
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise SystemExit(f"{case} != plain (batched_update)")
        del s, want
        report["update_profile"] = {}
        out_dir = args.out.parent if args.out else ROOT / "build" / "walk_ab"
        out_dir.mkdir(parents=True, exist_ok=True)
        for name, pkg in packages.items():
            trace = out_dir / f"update_round_{name}.json"
            s = clone_state(pre)
            torch.cuda.synchronize()
            with using(None if name == "tree" else pkg), \
                    torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                with torch.profiler.record_function("round"):
                    pkg["repro_torch.kernels.ops"].update_fused(s, cfg, *last)
                torch.cuda.synchronize()
            prof.export_chrome_trace(str(trace))
            events = json.loads(trace.read_text())["traceEvents"]
            counts = trace_counts(events, annotation_span(events, "round"))
            report["update_profile"][name] = counts
            print(f"update round profiled, {name}: {counts}", flush=True)
            del s
    if args.alias:
        got = first["alias_build (ops.alias_build)"]
        if not (torch.equal(got[0], st.itable.prob)
                and torch.equal(got[1], st.itable.alias)):
            raise SystemExit("alias_build != state.itable")
    want = walk_fused_ref(*args_w, seed=7, length=WALK_LEN)
    if not torch.equal(first["walk_fused deepwalk"], want):
        raise SystemExit("walk_fused deepwalk != plain")
    for case in ("walk_segment round 1", "walk_segment late round",
                 "walk_segment 5% live", "walk_segment simple late round"):
        s_, t_, uniform, length = segments[case]
        want = walk_segment_ref(*vtabs, None, s_, t_, None, wid, seed=7,
                                length=length, uniform=uniform)
        if not all(torch.equal(a, b) for a, b in zip(first[case], want)):
            raise SystemExit(f"{case} != plain")
    for case, rows, uu in (("walk_sample 262144", starts, u),
                           ("walk_sample hubs", hub_rows, u)):
        want = walk_sample_ref(*tabs, uu, rows=rows)
        if not all(torch.equal(a, b) for a, b in zip(first[case], want)):
            raise SystemExit(f"{case} != plain")
    if args.hist:
        got = first["radix_hist (ops.radix_hist)"]
        if not (torch.equal(got[0], st.digitsum)
                and torch.equal(got[1], st.gsize)):
            raise SystemExit("radix_hist != (state.digitsum, state.gsize)")
    report["uniform"] = {}
    for case, (rows, uu) in picks.items():
        got = first[case]
        want = walk_sample_uniform_ref(st.nbr, st.deg, uu, rows=rows)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise SystemExit(f"{case} != plain")
        work = sample_work(rows, got[0], st.deg, uu.shape[1], True)
        b_ms, _ = bound(work["bytes"], work["ops"])
        sb = uniform_sectors(rows, got[1], st.nbr.shape[1], uu.shape[1])
        report["uniform"][case] = dict(work, bound_ms=b_ms, sector_bytes=sb)
        print(f"{case}: word bound {work['bytes'] / 1e6:.3f} MB -> "
              f"{b_ms:.5f} ms; at 32 B a sector {sb / 1e6:.3f} MB -> "
              f"{sb / hw.HBM_BW * 1e3:.5f} ms", flush=True)
    if args.uniform:
        # the kernel on its path: one per-step simple walk a tree, all
        # in one profiler session
        report["uniform_path"], paths = {}, {}
        out_dir = args.out.parent if args.out else ROOT / "build" / "walk_ab"

        def walk_once(name):
            _build._LIBS.update(libs[name])
            paths[name] = simple.walk(starts, seed=14)
        sls = sample_launches([(partial(walk_once, name),
                                "walk_sample_uniform") for name in trees],
                              out_dir / "simple_walks.json")
        for name, sl in zip(trees, sls):
            if not torch.equal(paths[name], paths["tree"]):
                raise SystemExit(f"per-step simple walk: {name} differs")
            report["uniform_path"][name] = sl
            print(f"per-step simple walk, {name}: {sl['launches']} "
                  f"walk_sample_uniform launches, kernel "
                  f"{sl['kernel_ms_sum']:.4f} ms in all (profiler), median "
                  f"{statistics.median(sl['ms']):.4f} a launch", flush=True)
        _build._LIBS.update(libs["tree"])
    report["flash_excess"] = {}
    for case, (q, k, v, causal, window) in flash.items():
        want = flash_attention_ref32(q, k, v, causal=causal, window=window)
        for name in times[case]:
            excess = flash_excess(outs[(case, name)], want, "float32")
            report["flash_excess"][f"{case} {name}"] = excess
            print(f"{case} {name}: {excess:.3f} of the f32 limit", flush=True)
            if excess > 1:
                raise SystemExit(f"{case}: {name} outside the f32 limit")
    report["times_ms"] = times
    report["median_ms"] = {c: {n: statistics.median(v) for n, v in t.items()}
                           for c, t in times.items()}
    report["hub_rows"] = len(hubs)
    for case, t in report["median_ms"].items():
        print(f"{case}: " + ", ".join(f"{n} {v:.4f}" for n, v in t.items())
              + " ms (median of the turns' medians)", flush=True)
    print(f"all trees' walks and samples equal, bit for bit, and equal to "
          f"the plain versions; {len(hubs)} full hub rows"
          + ("; update rounds equal to batched_update" if args.update else "")
          + ("; alias tables equal to state.itable" if args.alias else "")
          + ("; histograms equal to the state's counters" if args.hist
             else "")
          + ("; uniform picks equal to the plain version" if args.uniform
             else ""),
          flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
