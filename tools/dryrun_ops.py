#!/usr/bin/env python3
"""One dry-run cell's counted work, op by op.

    PYTHONPATH=src python3 tools/dryrun_ops.py --arch qwen2-0.5b \
        --shape decode_32k [--mesh 16x16] [--smoke] [--top 25]
        [--device cpu] [--shapes] [--out PATH]

Runs the cell as ``repro_torch.launch.dryrun`` does (rank 0 of a fake
world of the mesh's size, fake tensors on ``dryrun.fake_device()``
unless ``--device`` names another, FULL sizes, or the arch's SMOKE
config with ``--smoke``), under a
``roofline.CostCounter`` that also tallies each aten op's calls, FLOPs
and bytes and each collective's bytes (by op, or with ``--shapes`` by
op and its tensor arguments' shapes), and prints the ``--top`` ops by
FLOPs, by bytes and by collective bytes, the totals and torch's
version.  Two runs (two torch versions, say) are compared
op by op from their ``--out`` JSONs.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch
from torch.utils._pytree import tree_flatten

from repro_torch.configs import smoke_config
from repro_torch.launch import dryrun
from repro_torch.launch import roofline
from repro_torch.launch.mesh import mesh_axes


class OpTally(roofline.CostCounter):
    """A ``CostCounter`` that keeps what each op added, by op (and by its
    tensor arguments' shapes with ``shapes``)."""

    def __init__(self, *a, shapes=False, **kw):
        super().__init__(*a, **kw)
        self.by_op: dict = {}
        self.shapes = shapes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        f0, b0, c0 = self.flops, self.bytes, sum(self.coll.values())
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if out is not NotImplemented and not roofline._PROPAGATING[0]:
            key = str(func)
            if self.shapes:
                key += " " + " ".join(
                    "x".join(map(str, t.shape)) for t in tree_flatten(args)[0]
                    if isinstance(t, torch.Tensor))
            row = self.by_op.setdefault(key, [0, 0.0, 0.0, 0.0])
            row[0] += 1
            row[1] += self.flops - f0
            row[2] += self.bytes - b0
            row[3] += sum(self.coll.values()) - c0
        return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--device", default=dryrun.fake_device(),
                    help="the fake tensors' device (default: the dry "
                         "run's)")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's SMOKE config (the shape's sizes)")
    ap.add_argument("--shapes", action="store_true",
                    help="tally each op by its tensor arguments' shapes too")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dryrun.fake_device = lambda: args.device
    shape = tuple(int(x) for x in args.mesh.split("x"))
    n = 1
    for d in shape:
        n *= d
    made = []

    def counter(*a, **kw):
        made.append(OpTally(*a, shapes=args.shapes, **kw))
        return made[-1]
    dryrun.CostCounter = counter
    with dryrun.fake_world(n):
        from torch.distributed.device_mesh import init_device_mesh
        mesh = init_device_mesh(dryrun.fake_device(), shape,
                                mesh_dim_names=mesh_axes(shape))
        doc = dryrun.run_cell(args.arch, args.shape, mesh=mesh, out_dir=None,
                              cfg=smoke_config(args.arch) if args.smoke
                              else None)
    ops = made[-1].by_op
    total = {"flops": sum(r[1] for r in ops.values()),
             "bytes": sum(r[2] for r in ops.values()),
             "coll": sum(r[3] for r in ops.values())}
    print(f"torch {torch.__version__}, {args.arch} {args.shape} on "
          f"{dryrun.mesh_name(shape)}, fake device {dryrun.fake_device()}: "
          f"FLOPs {doc['flops_per_device']:.6e}, bytes "
          f"{doc['bytes_per_device']:.6e}, collective bytes "
          f"{doc['coll_bytes_per_device']:.6e} (op sums {total['flops']:.6e}"
          f", {total['bytes']:.6e}, {total['coll']:.6e})")
    for col, what in ((1, "FLOPs"), (2, "bytes"), (3, "collective bytes")):
        rows = sorted(ops.items(), key=lambda kv: -kv[1][col])[:args.top]
        print(f"-- top {args.top} ops by {what}")
        for name, (calls, fl, nb, cb) in rows:
            if not (fl, nb, cb)[col - 1]:
                break
            print(f"  {name:70s} calls {calls:6d}  FLOPs {fl:.4e}  "
                  f"bytes {nb:.4e}  coll {cb:.4e}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"torch": torch.__version__, "arch": args.arch,
                       "shape": args.shape, "mesh": list(shape),
                       "doc": doc, "ops": ops}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
