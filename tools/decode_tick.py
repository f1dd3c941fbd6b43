#!/usr/bin/env python3
"""Where a decode tick's time goes, on the card.

    PYTHONPATH=src python3 tools/decode_tick.py [--arch qwen2-0.5b]
        [--layers N] [--ticks 3] [--out build/decode_tick.json]

Builds ``configs.get_config(arch)`` at its full widths (``--layers`` cuts
the depth; random weights from a seed) behind ``DecodeEngine(slots=8,
max_len=64)``, fills every slot with a 16-token prompt, warms up, then
times ``--ticks`` ticks on the host clock (each ends in the tick's host
read) and profiles as many more under ``torch.profiler`` (the process's
first session: a later one loses kernel events, ``profiler_drops.py``).
Prints per tick: the wall ms, the host span, the device's busy ms and
idle share, the kernels, memcpys and host syncs (``chip_smoke.trace_counts``)
and the device ms by kernel name; and the card's name and power limit.
The profiler's Chrome trace is written beside ``--out`` (default
``build/``).  Needs one card.
"""

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0: full)")
    ap.add_argument("--ticks", type=int, default=3)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("decode_tick: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import lm_leaves, card_line, profiled, trace_counts
    from repro_torch.configs import get_config
    from repro_torch.models import init_model
    from repro_torch.serve import DecodeEngine, ServeRequest
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    cfg = get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    params = init_model(cfg, torch.Generator(device="cuda").manual_seed(0))
    eng = DecodeEngine(cfg, params, slots=8, max_len=64, device="cuda")
    g = torch.Generator().manual_seed(1)
    for i in range(8):
        eng.submit(ServeRequest(rid=i, prompt=torch.randint(
            0, cfg.vocab_size, (16,), generator=g).tolist(),
            max_new_tokens=32))
    for _ in range(4):                                   # warm-up
        eng.step()
    torch.cuda.synchronize()
    walls = []
    for _ in range(args.ticks):
        t0 = time.perf_counter()
        eng.step()
        walls.append((time.perf_counter() - t0) * 1e3)
    trace = (args.out.parent if args.out else ROOT / "build") / \
        f"decode_tick_{args.arch}_trace.json"

    def ticks():
        for _ in range(args.ticks):
            eng.step()
    prof = profiled(ticks, trace, f"{args.ticks} ticks of {cfg.name}")
    counts = trace_counts(json.loads(trace.read_text())["traceEvents"])
    n = args.ticks
    per = {k: (v / n if isinstance(v, (int, float)) and k not in (
        "device_idle_share",) else v) for k, v in counts.items()}
    out = {"card": card, "arch": cfg.name, "layers": cfg.num_layers,
           "params": sum(t.numel() for _, t in lm_leaves(params)),
           "wall_ms": walls, "per_tick": per,
           "device_ms_by_name": prof["device_ms_by_name"]}
    print(f"{card}: {cfg.name} at {cfg.num_layers} layers, 8 slots: a tick "
          f"{sorted(walls)[len(walls) // 2]:.2f} ms wall (median of {n}); "
          f"per tick under the profiler: host span {per['host_ms']:.2f} ms, "
          f"{per['host_ops']:.0f} top-level host ops, {per['kernels']:.0f} "
          f"kernels ({per['kernels'] / cfg.num_layers:.1f} a layer), "
          f"{per['memcpys']:.0f} memcpys, {per['syncs']:.0f} host syncs "
          f"({per['sync_ms']:.2f} ms waiting), device busy "
          f"{per['device_busy_ms']:.3f} ms, idle share "
          f"{counts['device_idle_share']:.3f}", flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
