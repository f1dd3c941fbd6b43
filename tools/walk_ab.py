#!/usr/bin/env python3
"""Time this tree's walk kernels against other trees' on one GPU.

    python3 tools/walk_ab.py [--tree NAME=DIR ...] [--scale 20] [--out PATH]

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
batch as one shard (every ``t0 = 0``) and on three relay-shaped launches
of shard 0 of 4 (98,304 slots: round 1's, and later rounds' with one slot
in twelve or in a hundred live); the per-step sample of all 262,144
walkers in place, of 16,384 of them (a late node2vec trial's size), and
of 262,144 walkers all on full hub rows (degree 256).  Every tree's
output must equal this tree's, bit for bit, and its deepwalk, samples and
round-1 segment must equal the plain versions.  Prints one line per case
and, with ``--out``, writes every time and each tree's registers
(``cuobjdump -res-usage``) and resident blocks per SM to a JSON file.
"""

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

SOURCES = ("walk_fused", "walk_sample")


def build(trees, build_dir):
    """One nvcc per (tree, source), all at once; returns the libraries by
    tree, loaded with the entry points' signatures, and their paths."""
    from repro_torch.kernels import _build
    procs = []
    for name, csrc in trees.items():
        for src in SOURCES:
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
            f.argtypes, f.restype = argtypes, restype
        err = lib.kernels_error_string
        err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
        libs.setdefault(name, {})[src] = lib
        paths.setdefault(name, {})[src] = out
    return libs, paths


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


def main_state(scale):
    """The state after chip_smoke.py's main path's 10 update rounds."""
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
    for r in range(rounds):
        lanes = [torch.from_numpy(np.ascontiguousarray(a[r])).cuda()
                 for a in (stream.is_insert, stream.u, stream.v, stream.w)]
        st, _ = ops.update_fused(st, cfg, *lanes)
    torch.cuda.synchronize()
    return st, cfg


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", default=[],
                    metavar="NAME=DIR", help="another tree's csrc directory")
    ap.add_argument("--scale", type=int, default=20)
    ap.add_argument("--out", type=Path, default=None,
                    help="write every time, register count and occupancy "
                         "to this JSON file")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("walk_ab: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import WALK_LEN, PPR_LEN, PPR_STOP, card_line, cuda_ms
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.walk_fused import walk_fused_ref, walk_segment_ref
    from repro_torch.kernels.walk_sample import walk_sample_ref
    trees = {"tree": _build.CSRC}
    for spec in args.tree:
        name, _, path = spec.partition("=")
        trees[name] = Path(path).resolve()
    t0 = time.perf_counter()
    libs, paths = build(trees, ROOT / "build" / "walk_ab")
    report = {"card": card_line(), "build_s": time.perf_counter() - t0,
              "trees": {}}
    print(f"{report['card']}; built {list(trees)} in "
          f"{report['build_s']:.1f} s", flush=True)
    for name in trees:
        fl, sl = libs[name]["walk_fused"], libs[name]["walk_sample"]
        occ = {"whole biased": fl.walk_fused_occupancy(0, 0),
               "whole uniform": fl.walk_fused_occupancy(0, 1),
               "segment biased": fl.walk_fused_occupancy(1, 0),
               "sample": sl.walk_sample_occupancy()}
        regs = {src: res_usage(paths[name][src]) for src in SOURCES}
        report["trees"][name] = {"blocks_per_sm": occ, "res_usage": regs}
        print(f"{name}: blocks/SM {occ}; registers (local bytes) by kernel "
              + "; ".join(f"{src} " + ", ".join(
                  f"{v['registers']} ({v['local']})" for v in r.values())
                  for src, r in regs.items()), flush=True)

    st, cfg = main_state(args.scale)
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
    # step 0, a third of the slots free), and later rounds' (one slot in
    # twelve, or in a hundred, live at steps 1..L-1)
    from repro_torch.distributed import relay_view
    view = relay_view(st, 0, V // 4)
    vtabs = (view.itable.prob, view.itable.alias, view.bias, view.nbr,
             view.deg, None)
    slots = 98_304
    local = starts[starts < V // 4]
    seg1 = torch.full((slots,), -1, dtype=torch.int32, device="cuda")
    seg1[: len(local)] = local
    perm = torch.randperm(slots, generator=g, device="cuda")
    seg2, seg3 = torch.full_like(seg1, -1), torch.full_like(seg1, -1)
    for seg, live in ((seg2, perm[: slots // 12]), (seg3, perm[: slots // 100])):
        seg[live] = torch.randint(0, V // 4, (len(live),), generator=g,
                                  device="cuda", dtype=torch.int32)
    t02 = torch.randint(1, WALK_LEN, (slots,), generator=g, device="cuda",
                        dtype=torch.int32)
    t01 = torch.zeros_like(seg1)
    wid = torch.arange(slots, dtype=torch.int32, device="cuda")
    cases = {
        "walk_fused deepwalk": lambda: ops.walk_fused(*args_w, 7, length=WALK_LEN),
        "walk_fused ppr": lambda: ops.walk_fused(
            *args_w, 8, length=PPR_LEN, stop_prob=PPR_STOP),
        "walk_fused simple": lambda: ops.walk_fused(
            *args_w, 9, length=WALK_LEN, uniform=True),
        "walk_segment deepwalk": lambda: ops.walk_segment(
            *args_w, zeros, 7, length=WALK_LEN)[0],
        "walk_segment round 1": lambda: ops.walk_segment(
            *vtabs, seg1, t01, 7, None, wid, length=WALK_LEN),
        "walk_segment late round": lambda: ops.walk_segment(
            *vtabs, seg2, t02, 7, None, wid, length=WALK_LEN),
        "walk_segment sparse round": lambda: ops.walk_segment(
            *vtabs, seg3, t02, 7, None, wid, length=WALK_LEN),
        "walk_sample 262144": lambda: ops.walk_sample(*tabs, u, rows=starts),
        "walk_sample 16384": lambda: ops.walk_sample(
            *tabs, u[: 16384].contiguous(), rows=few),
        "walk_sample hubs": lambda: ops.walk_sample(*tabs, u, rows=hub_rows),
    }
    # one untimed pass over every tree first (clocks, caches), then the
    # timed turns
    order = list(trees) + 2 * (list(trees) + list(trees)[::-1])
    times = {c: {n: [] for n in trees} for c in cases}
    first = {}
    for k, name in enumerate(order):
        _build._LIBS.update(libs[name])
        for case, fn in cases.items():
            ms, out = cuda_ms(fn)
            if k >= len(trees):
                times[case][name].append(ms)
            if case not in first:
                first[case] = out
            else:
                same = all(torch.equal(a, b) for a, b in zip(out, first[case])) \
                    if isinstance(out, tuple) else torch.equal(out, first[case])
                if not same:
                    raise SystemExit(f"{case}: {name} differs from {order[0]}")
    # this tree against the plain versions (the rest equal it)
    want = walk_fused_ref(*args_w, seed=7, length=WALK_LEN)
    if not torch.equal(first["walk_fused deepwalk"], want):
        raise SystemExit("walk_fused deepwalk != plain")
    want = walk_segment_ref(*vtabs, seg1, t01, None, wid, seed=7,
                            length=WALK_LEN)
    if not all(torch.equal(a, b) for a, b in zip(first["walk_segment round 1"],
                                                  want)):
        raise SystemExit("walk_segment round 1 != plain")
    for case, rows, uu in (("walk_sample 262144", starts, u),
                           ("walk_sample hubs", hub_rows, u)):
        want = walk_sample_ref(*tabs, uu, rows=rows)
        if not all(torch.equal(a, b) for a, b in zip(first[case], want)):
            raise SystemExit(f"{case} != plain")
    report["times_ms"] = times
    report["median_ms"] = {c: {n: statistics.median(v) for n, v in t.items()}
                           for c, t in times.items()}
    report["hub_rows"] = len(hubs)
    for case, t in report["median_ms"].items():
        print(f"{case}: " + ", ".join(f"{n} {v:.4f}" for n, v in t.items())
              + " ms (median of the turns' medians)", flush=True)
    print(f"all trees equal, bit for bit, and equal to the plain versions; "
          f"{len(hubs)} full hub rows", flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
