#!/usr/bin/env python3
"""Where a full-width train step's time goes, on the card.

    PYTHONPATH=src python3 tools/train_step.py [--arch qwen2-0.5b]
        [--batch 8] [--seq 512] [--vocab 131073] [--remat none]
        [--steps 3] [--out build/train_step.json]

Builds ``configs.get_config(arch)`` at its full widths with the walk
corpus's vocabulary (``--vocab``; phase 3j of ``chip_smoke.py`` trains it
at 2^17 + 1), random weights from a seed, and runs ``make_train_step``'s
body on random token batches: warms up, times ``--steps`` steps on the
host clock (a sync after each), then profiles one more under
``torch.profiler`` (the process's first session) with the gradient and
the optimizer in ``record_function`` spans.  Prints: ms a step, the
device's busy ms and idle share, kernels and host syncs of the step and
of each span (``chip_smoke.trace_counts``), the device ms by kernel
name, and the card's name and power limit.  The Chrome trace is written
beside ``--out`` (default ``build/``).  Needs one card.
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
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--vocab", type=int, default=(1 << 17) + 1)
    ap.add_argument("--remat", default="none")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("train_step: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import (annotation_span, card_line, lm_leaves, profiled,
                            trace_counts)
    from repro_torch.configs import get_config
    from repro_torch.models import init_model
    from repro_torch.train.optim import OptConfig, adamw_init, adamw_update
    from repro_torch.train.train_step import value_and_grad
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    cfg = dataclasses.replace(get_config(args.arch), vocab_size=args.vocab,
                              frontend="none")
    params = init_model(cfg, torch.Generator(device="cuda").manual_seed(0))
    oc = OptConfig(warmup_steps=10, total_steps=40)
    opt = adamw_init(params, oc)
    g = torch.Generator(device="cuda").manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (args.batch, args.seq + 1),
                         generator=g, device="cuda", dtype=torch.int32)
    batch = {"inputs": toks[:, :-1].contiguous(),
             "targets": toks[:, 1:].contiguous()}

    def step():
        nonlocal params, opt
        with torch.profiler.record_function("gradient"):
            _, _, grads = value_and_grad(params, cfg, batch,
                                         remat=args.remat)
        with torch.profiler.record_function("optimizer"):
            params, opt, _ = adamw_update(params, grads, opt, oc)

    for _ in range(2):                                   # warm-up
        step()
    torch.cuda.synchronize()
    walls = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    trace = (args.out.parent if args.out else ROOT / "build") / \
        f"train_step_{args.arch}_trace.json"
    prof = profiled(step, trace, f"one train step of {cfg.name}")
    events = json.loads(trace.read_text())["traceEvents"]
    spans = {"step": trace_counts(events)}
    for name in ("gradient", "optimizer"):
        spans[name] = trace_counts(events, annotation_span(events, name))
    n_params = sum(t.numel() for _, t in lm_leaves(params))
    out = {"card": card, "arch": cfg.name, "params": n_params,
           "batch": args.batch, "seq": args.seq, "remat": args.remat,
           "wall_ms": walls, "spans": spans,
           "device_ms_by_name": prof["device_ms_by_name"],
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    med = sorted(walls)[len(walls) // 2]
    print(f"{card}: {cfg.name} ({n_params / 1e6:.1f} M params), batch "
          f"{args.batch} x {args.seq}, remat {args.remat}: a step "
          f"{med:.2f} ms wall (median of {args.steps}); peak "
          f"{out['peak_gib']:.2f} GiB", flush=True)
    for name, c in spans.items():
        print(f"  {name}: host span {c['host_ms']:.2f} ms, {c['host_ops']} "
              f"top-level host ops, {c['kernels']} kernels, {c['memcpys']} "
              f"memcpys, {c['syncs']} host syncs, device busy "
              f"{c['device_busy_ms']:.2f} ms, idle share "
              f"{c['device_idle_share']:.3f}", flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
