"""Serving driver: batched decode with continuous batching.

Port of ``repro/launch/serve.py``: the same flags and the same printed
line, on the card unless ``--device cpu``.

  PYTHONPATH=src python -m repro_torch.launch.serve --requests 12 --slots 4
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.models import ModelConfig, init_model
from repro_torch.serve.engine import DecodeEngine, ServeRequest


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = ModelConfig(name="serve-lm", family="dense",
                      num_layers=args.layers, d_model=args.d_model,
                      num_heads=4, num_kv_heads=2, d_ff=args.d_model * 4,
                      vocab_size=1024, dtype="float32")
    dev = torch.device(args.device)
    params = init_model(cfg, torch.Generator(device=dev).manual_seed(0))
    eng = DecodeEngine(cfg, params, slots=args.slots, max_len=128,
                       device=dev)

    rng = torch.Generator().manual_seed(1)
    for i in range(args.requests):
        prompt = torch.randint(0, 1024, (8,), generator=rng).tolist()
        eng.submit(ServeRequest(rid=i, prompt=prompt,
                                max_new_tokens=args.max_new))
    t0 = time.time()
    done = eng.run()
    dt = time.time() - t0
    total_tokens = sum(len(r.output) for r in done)
    print(f"[serve] {len(done)} requests, {total_tokens} tokens in "
          f"{dt:.2f}s ({total_tokens / dt:.1f} tok/s, "
          f"{args.slots} slots, continuous batching)")
    for r in done[:3]:
        print(f"  rid={r.rid} output={r.output}")
    return done


if __name__ == "__main__":
    main()
