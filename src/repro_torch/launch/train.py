"""End-to-end training driver: BINGO walk corpus -> LM, with checkpointing.

Port of ``repro/launch/train.py``: the same flags, defaults and printed
lines, on the card unless ``--device cpu``.  A dynamic graph ingests an
update round every ``--update-every`` steps (one batched-update kernel
launch on the card) while the walk pipeline feeds the trainer (one
whole-walk launch a round); checkpoints commit atomically on a
background thread and training resumes from the latest step after a
restart.

  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch qwen2-0.5b --steps 50 --scale 10 --d-model 128 --layers 4
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from pathlib import Path

import torch

from repro_torch.configs import smoke_config
from repro_torch.core.dyngraph import BingoConfig, from_edges
from repro_torch.core.updates import make_updater
from repro_torch.data.pipeline import WalkCorpusPipeline
from repro_torch.graph.rmat import degree_bias, rmat_edges
from repro_torch.graph.streams import make_update_stream
from repro_torch.models import ModelConfig, init_model
from repro_torch.train.checkpoint import (AsyncCheckpointer, latest_step,
                                          restore_checkpoint)
from repro_torch.train.optim import OptConfig, adamw_init
from repro_torch.train.train_step import make_train_step

# Under this checkout's gitignored build/, beside the kernels, and not
# the reference launcher's /tmp/repro_ckpt: neither package resumes from
# the other's run, and each checkout keeps its own.
DEFAULT_CKPT_DIR = str(Path(__file__).resolve().parents[3] / "build"
                       / "train_ckpt")


def main(argv=None):
    """Train; returns ``{"params", "opt", "start", "losses"}`` (the loss
    of every step run, as device tensors)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="use this arch's smoke config as the LM")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--scale", type=int, default=10)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--update-every", type=int, default=10,
                    help="ingest a graph-update batch every N steps")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    # --- dynamic graph + walk pipeline --------------------------------------
    src, dst = rmat_edges(args.scale, 8, seed=0)
    V = 1 << args.scale
    w = degree_bias(src, dst, V, bias_bits=10)
    bcfg = BingoConfig(num_vertices=V, capacity=256, bias_bits=10)
    state = from_edges(bcfg, src, dst, w, device=dev)
    stream = make_update_stream(src, dst, w, batch_size=256, rounds=10,
                                mode="mixed", seed=1)
    pipe = WalkCorpusPipeline(state, bcfg, walkers_per_round=512,
                              seq_len=args.seq_len, batch_size=args.batch)
    upd = make_updater(bcfg)   # in place: update rounds never copy tables

    # --- LM ------------------------------------------------------------------
    if args.arch:
        cfg = dataclasses.replace(smoke_config(args.arch),
                                  vocab_size=pipe.vocab, frontend="none")
    else:
        cfg = ModelConfig(name="walk-lm", family="dense",
                          num_layers=args.layers, d_model=args.d_model,
                          num_heads=4, num_kv_heads=2,
                          d_ff=args.d_model * 4, vocab_size=pipe.vocab,
                          dtype="float32")
    opt_cfg = OptConfig(lr=args.lr, warmup_steps=10,
                        total_steps=args.steps)
    step_fn = make_train_step(cfg, opt_cfg, remat="none")
    ckpt = AsyncCheckpointer(args.ckpt_dir, keep=2)

    params = init_model(cfg, torch.Generator(device=dev).manual_seed(0))
    opt = adamw_init(params, opt_cfg)
    start = 0
    last = latest_step(args.ckpt_dir)
    if last is not None:
        print(f"[train] restoring from step {last}")
        tree = restore_checkpoint(args.ckpt_dir, last,
                                  {"params": params, "opt": opt})
        params, opt, start = tree["params"], tree["opt"], last
        if start >= args.steps:
            print(f"[train] nothing to train: step {start} >= --steps "
                  f"{args.steps} (pass another --ckpt-dir to start over)")

    def lanes(i):
        return [torch.from_numpy(x[i]).to(dev) for x in (
            stream.is_insert, stream.u, stream.v, stream.w)]

    round_i = 0
    losses = []
    t0 = time.time()
    for step in range(start, args.steps):
        if step and step % args.update_every == 0 and \
                round_i < stream.is_insert.shape[0]:
            state, _ = upd(state, *lanes(round_i))
            pipe.update_graph(state)
            round_i += 1
        batch = next(pipe)
        params, opt, _, m = step_fn(params, opt, None, batch)
        losses.append(m["loss"])
        if step % 10 == 0 or step == args.steps - 1:
            print(f"[train] step {step} loss {float(m['loss']):.4f} "
                  f"lr {float(m['lr']):.2e} "
                  f"({(time.time() - t0):.1f}s)")
        if step and step % args.ckpt_every == 0:
            ckpt.save(step, {"params": params, "opt": opt})
    ckpt.save(args.steps, {"params": params, "opt": opt})
    ckpt.wait()
    if losses:
        print(f"[train] done: {args.steps} steps, final loss "
              f"{float(losses[-1]):.4f}")
    return {"params": params, "opt": opt, "start": start, "losses": losses}


if __name__ == "__main__":
    main()
