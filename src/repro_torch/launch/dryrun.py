"""Dry run: each LM and walk cell once on fake tensors, as a fake rank 0.

Port of ``repro/launch/dryrun.py``.  Where the reference lowers and
compiles each cell against the production mesh on 512 placeholder host
devices, the port initialises a ``"fake"`` process group of 256 (or 512)
ranks, builds the production ``DeviceMesh`` over it, builds the cell's
arguments under ``FakeTensorMode`` (nothing is allocated) and runs the
cell's function once as rank 0, under ``roofline.CostCounter``: every
aten op on the rank's shards, collective and kernel wrapper is counted
and the live fake storages are tracked.  An LM cell
(``specs.build_cell``: a train step, a prefill or a decode step of an
arch of ``CELLS``) runs on DTensor params, moments, batch and cache; its
recurrences' time loops and its microbatches are costed on
``STEPS_COSTED`` steps and one microbatch (``models/steps.py``).  A walk
cell (``walk_cell.build_walk_cell``) runs the port's walk path; kernel
wrappers launch nothing on fake tensors and the relay runs one round
(``meta["rounds_costed"]``).  Each cell records its argument, output,
alias (written in place and returned) and temp bytes,
``total_nonalias_bytes`` and ``hbm_fit`` against ``hw.HBM_BYTES``, and
the roofline terms on the H100 constants; the JSON lands in
``experiments/dryrun_torch/`` (or ``--out``), and each cell's seconds
are printed.

Fake tensors live on ``cuda`` where torch is built with CUDA, else on
``cpu`` (a CPU-only build cannot index fake CUDA tensors); shapes,
bytes and collectives are the same on either, but for DTensor's choices
of layout, which differ between torch versions on some LM cells.

Usage:
  python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes]
  python -m repro_torch.launch.dryrun --all --arch-filter qwen2-0.5b
  python -m repro_torch.launch.dryrun --arch bingo-walk --shape walk_step
  python -m repro_torch.launch.dryrun --all --mesh 1x1 --sizing rank
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch

from repro_torch.configs import (CELLS, SHAPES, bingo_walk, get_config,
                                 smoke_config)
from repro_torch.launch import hw
from repro_torch.launch.mesh import make_production_mesh, mesh_axes
from repro_torch.launch.roofline import CostCounter, analyze
from repro_torch.launch.specs import build_cell, rank_shape

__all__ = ["OUT_DIR", "WALK_CELLS", "RANK_CELLS", "STEPS_COSTED",
           "fake_device", "fake_world", "build", "run_cell", "todo_cells",
           "main"]

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")

# the reference's --all list of walk cells, the capacity-ladder top tier
# (C' = 2C) tagged so that report.py's mem_deltas gates its GiB/dev
WALK_CELLS = (("walk_step", None), ("walk_whole", None), ("walk_relay", None),
              ("walk_relay_2d", None), ("update_walk", None),
              ("serve_round", None),
              ("update_walk", {"capacity_mult": 2, "tag": "tier2x"}),
              ("walk_relay", {"capacity_mult": 2, "tag": "tier2x"}))

# one rank's share of FULL on a world of one (``--sizing rank``): the
# cells a single rank can run (no walker groups), the serving round's
# walk bucket cut to one rank's share of its 65,536 starts
RANK_CELLS = (("walk_step", None), ("walk_whole", None), ("update_step", None),
              ("update_walk", None), ("walk_relay", None),
              ("serve_round", {"serve_walkers": 65536 // hw.SINGLE_POD_CHIPS}),
              ("update_walk", {"capacity_mult": 2, "tag": "tier2x"}))

# time steps of a recurrence's loop a cell runs (``models.steps``): the
# mamba scan's first chunk, cut to this length, and the sLSTM's first
# steps; the work of the rest is counted as theirs
STEPS_COSTED = 8

SIZINGS = {"full": lambda: bingo_walk.FULL, "smoke": lambda: bingo_walk.SMOKE,
           "rank": lambda: _one_rank()}


def _one_rank():
    from repro_torch.launch.walk_cell import one_rank_share
    return one_rank_share(bingo_walk.FULL, hw.SINGLE_POD_CHIPS)


def fake_device() -> str:
    """The fake tensors' device: ``cuda`` on a CUDA build of torch."""
    return "cuda" if torch.version.cuda else "cpu"


class fake_world:
    """Context: this process as rank 0 of a fake world of ``n`` ranks (a
    ``"fake"`` process group; collectives move nothing); destroyed on
    exit."""

    def __init__(self, n: int):
        self.n = n

    def __enter__(self):
        import torch.distributed as dist
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=self.n)
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist
        dist.destroy_process_group()
        return False


def mesh_name(shape: tuple) -> str:
    return {(16, 16): "pod16x16", (2, 16, 16): "pod2x16x16"}.get(
        tuple(shape), "mesh" + "x".join(map(str, shape)))


def build(arch: str, shape_name: str, mesh, *, overrides=None, wcfg=None,
          cfg=None, lm_shape=None):
    """The cell's ``CellSpec``: a walk cell sized by ``wcfg``, or an LM
    cell of ``cfg`` (default FULL) at ``lm_shape`` (default the named
    shape)."""
    if arch == "bingo-walk":
        from repro_torch.launch.walk_cell import build_walk_cell
        return build_walk_cell(shape_name, mesh, dict(overrides or {}), wcfg)
    cell = build_cell(arch, shape_name, mesh, cfg=cfg, shape=lm_shape)
    cell.meta["cfg_obj"] = cfg or get_config(arch)
    cell.meta["sizing"] = (cfg or get_config(arch)).name
    if lm_shape is not None and lm_shape != SHAPES[shape_name]:
        cell.meta["reduced"] = {"global_batch": lm_shape.global_batch,
                                "seq_len": lm_shape.seq_len}
    return cell


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             overrides: dict | None = None, mesh=None, wcfg=None, cfg=None,
             lm_shape=None, out_dir: str | None = OUT_DIR,
             verbose: bool = True) -> dict:
    """Run one cell on fake tensors over the initialised world and
    record it; ``mesh`` defaults to the production mesh.  Writes the
    JSON into ``out_dir`` (None: nowhere) and returns it."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels import ops
    from repro_torch.models import steps
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod,
                                    device_type=fake_device())
    shape = tuple(mesh.shape)
    name = mesh_name(shape)
    chips = mesh.size()
    overrides = dict(overrides or {})
    t0 = time.time()
    cell = build(arch, shape_name, mesh, overrides=overrides, wcfg=wcfg,
                 cfg=cfg, lm_shape=lm_shape)
    if overrides:
        cell.meta.setdefault("overrides", {}).update(overrides)
    dev = fake_device()
    launches = ops.launch_counts()
    with FakeTensorMode(allow_non_fake_inputs=False) as fm:
        args = cell.args(dev)
    counter = CostCounter(share=cell.meta.pop("kernel_share", None))
    counter.track_args(args, cell.donate)
    with fm, counter, steps.costed(STEPS_COSTED):
        out = cell.fn(*args)
        costed = steps.stats()
    mem = counter.finish(out)
    del out, args
    if ops.launch_counts() != launches:
        raise RuntimeError(f"{shape_name}: a kernel launched on fake tensors")
    t_run = time.time() - t0
    cfg_obj = cell.meta.pop("cfg_obj")
    if costed["steps_total"]:
        cell.meta.update(costed)
    if cell.meta.get("plan", {}).get("microbatches", 1) > 1:
        cell.meta["microbatches_costed"] = 1     # each the same work
    meta = {**cell.meta, "fake_device": dev,
            "kernels": counter.kernels,
            "constants": {k: getattr(hw, k) for k in (
                "PEAK_FLOPS_BF16", "HBM_BW", "HBM_BYTES", "NVLINK_BW",
                "NODE_CARDS", "NET_BW")}}
    rep = analyze(arch=arch, shape=shape_name, mesh_name=name, chips=chips,
                  cost=counter.cost(), mem=mem, cfg=cfg_obj, kind=cell.kind,
                  tokens=cell.meta["tokens"], meta=meta)
    doc = rep.to_json()
    doc["compile_seconds"] = t_run
    doc["hbm_fit"] = mem["total_nonalias_bytes"] <= hw.HBM_BYTES
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        tag = overrides.get("tag", "")
        fname = f"{name}__{arch}__{shape_name}{('__' + tag) if tag else ''}.json"
        with open(os.path.join(out_dir, fname), "w") as f:
            json.dump(doc, f, indent=1)
    if verbose:
        tag = f"[{overrides['tag']}]" if overrides.get("tag") else ""
        print(f"[dryrun] {name} {arch} {shape_name}{tag}: run {t_run:.1f}s "
              f"| mem/dev {mem['total_nonalias_bytes'] / 2**30:.2f} GiB "
              f"(fit={doc['hbm_fit']}) | FLOPs/dev {rep.flops_per_device:.3e} "
              f"| bytes/dev {rep.bytes_per_device:.3e} "
              f"| coll/dev {rep.coll_bytes_per_device:.3e} "
              f"| bottleneck={rep.bottleneck}", flush=True)
        print(f"         terms: compute {rep.t_compute * 1e3:.3f} ms | memory "
              f"{rep.t_memory * 1e3:.3f} ms | collective "
              f"{rep.t_collective * 1e3:.3f} ms | useful "
              f"{rep.useful_ratio:.2f}", flush=True)
    return doc


def todo_cells(*, sizing: str = "full", arch_filter: str = "") -> list:
    """``--all``'s cells, in the reference's order: every LM cell of
    ``CELLS`` not skipped, then the walk cells (``RANK_CELLS`` at one
    rank's share), those whose arch contains ``arch_filter``."""
    lm = [(a, c["shape"].name, None) for a, cs in CELLS.items() for c in cs
          if not c["skip"] and arch_filter in a]
    walk = RANK_CELLS if sizing == "rank" else WALK_CELLS
    return lm + [("bingo-walk", s, ov) for s, ov in walk
                 if arch_filter in "bingo-walk"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--arch-filter", default="",
                    help="with --all: only the archs whose name contains it")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--mesh", default=None,
                    help="another mesh shape, e.g. 2x2 or 1x1, over a fake "
                         "world of its size")
    ap.add_argument("--sizing", default="full", choices=sorted(SIZINGS),
                    help="full (FULL), smoke (SMOKE configs) or rank (one "
                         "rank of 256's share: FULL's vertices and walkers, "
                         "an LM shape's global batch; --all then runs "
                         "RANK_CELLS)")
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args(argv)

    if args.mesh:
        shapes = [tuple(int(x) for x in args.mesh.split("x"))]
    elif args.both_meshes:
        shapes = [(16, 16), (2, 16, 16)]
    else:
        shapes = [(2, 16, 16) if args.multi_pod else (16, 16)]
    wcfg = SIZINGS[args.sizing]()
    todo = (todo_cells(sizing=args.sizing, arch_filter=args.arch_filter)
            if args.all else [(args.arch, args.shape, None)])
    failures = []
    t_all = time.time()
    for shape in shapes:
        n = 1
        for d in shape:
            n *= d
        with fake_world(n):
            from torch.distributed.device_mesh import init_device_mesh
            mesh = init_device_mesh(fake_device(), shape,
                                    mesh_dim_names=mesh_axes(shape))
            for arch, cell, ov in todo:
                lm = arch != "bingo-walk"
                try:
                    run_cell(arch, cell, overrides=ov, mesh=mesh, wcfg=wcfg,
                             cfg=(smoke_config(arch) if lm and
                                  args.sizing == "smoke" else None),
                             lm_shape=(rank_shape(SHAPES[cell]) if lm and
                                       args.sizing == "rank" else None),
                             out_dir=args.out)
                except Exception as e:  # noqa: BLE001 — report, keep going
                    failures.append((shape, arch, cell, repr(e)))
                    print(f"[dryrun] FAIL {arch} {cell} mesh={shape}: {e}",
                          flush=True)
                    traceback.print_exc()
    print(f"[dryrun] {len(todo) * len(shapes)} cells in "
          f"{time.time() - t_all:.1f}s", flush=True)
    if failures:
        raise SystemExit(f"{len(failures)} cells failed: "
                         f"{[(a, s) for _, a, s, _ in failures]}")
    print("[dryrun] all requested cells ran OK", flush=True)


if __name__ == "__main__":
    main()
