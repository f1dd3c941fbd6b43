#!/usr/bin/env python3
"""Count the kernel events that ``torch.profiler`` sessions lose on one GPU.

    python3 tools/profiler_drops.py [--procs 6] [--sessions 10] [--scale 20]
                                    [--out PATH]

Runs ``--procs`` processes one after another.  Each builds the state of
``chip_smoke.py``'s main path (``tools/walk_ab.main_state``), runs its
node2vec, per-step deepwalk and per-step simple batches (262,144 starts,
80 steps) once unprofiled, then opens ``--sessions`` profiler sessions
through ``chip_smoke.launch_events``: the first replays the three batches
in one session, as ``chip_smoke.sample_launches`` does, every later one
the per-step deepwalk batch alone.  Prints, a session, each batch's
launches and the kernel events its trace holds, then the launches missed
by session index over all processes; with ``--out`` writes them as JSON.
"""

import argparse
import json
import subprocess
import sys
import tempfile
from functools import partial
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def child(scale, sessions):
    import torch
    sys.path[:0] = [str(ROOT), str(ROOT / "tools")]
    from chip_smoke import N2V_P, N2V_Q, WALK_LEN, launch_events
    from repro_torch.core.walks import WalkParams
    from repro_torch.serve import DynamicWalkEngine
    from walk_ab import main_state
    st, cfg = main_state(scale)
    starts = torch.arange(0, cfg.num_vertices, 4, dtype=torch.int32,
                          device="cuda")
    engines = [DynamicWalkEngine(st, cfg, params, whole_walk=whole, seed=i)
               for i, (params, whole) in enumerate((
                   (WalkParams("node2vec", WALK_LEN, p=N2V_P, q=N2V_Q), None),
                   (WalkParams("deepwalk", WALK_LEN), False),
                   (WalkParams("simple", WALK_LEN), False)))]
    for eng in engines:
        eng.walk(starts)
    kernels = ("walk_sample", "walk_sample", "walk_sample_uniform")
    runs = [(partial(e.walk, starts), k) for e, k in zip(engines, kernels)]
    out = []
    with tempfile.TemporaryDirectory(prefix="profiler_drops_") as d:
        for s in range(sessions):
            res = launch_events(runs if s == 0 else runs[1:2],
                                Path(d) / "trace.json")
            out.append([[len(w), len(ms)] for w, ms in res])
            print(f"session {s}: [launches, events] {out[-1]}", flush=True)
    print(json.dumps({"sessions": out}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--procs", type=int, default=6)
    ap.add_argument("--sessions", type=int, default=10)
    ap.add_argument("--scale", type=int, default=20)
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child(args.scale, args.sessions)
    procs = []
    for p in range(args.procs):
        run = subprocess.run(
            [sys.executable, __file__, "--child", "--scale", str(args.scale),
             "--sessions", str(args.sessions)],
            capture_output=True, text=True, timeout=600)
        if run.returncode:
            print(run.stdout, run.stderr, sep="\n", file=sys.stderr)
            return run.returncode
        procs.append(json.loads(run.stdout.strip().splitlines()[-1])["sessions"])
        print(f"process {p}: {procs[-1]}", flush=True)
    by_index = [sum(launches - events for sessions in procs
                    for launches, events in sessions[s])
                for s in range(args.sessions)]
    lossy = [sum(any(launches != events for launches, events in sessions[s])
                 for sessions in procs) for s in range(args.sessions)]
    print(f"launches missed by session index over {args.procs} processes: "
          f"{by_index}; sessions with a miss: {lossy}", flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"procs": procs, "missed": by_index,
                                        "lossy_sessions": lossy}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
