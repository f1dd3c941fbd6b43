"""The dry run's roofline table, from ``experiments/dryrun_torch/``'s JSONs.

Port of ``repro/launch/report.py``:

  PYTHONPATH=src python -m repro_torch.launch.report

prints the table of every cell (the LM cells' and the walk cells'; with
``--arch-filter``, those of the archs whose name contains it), the cells
``CELLS`` skips with their reasons, the tagged variants (the
capacity-ladder tiers), the GiB/dev changes against the JSONs committed
at HEAD (``mem_deltas``) and, given bench snapshot files, their
throughput changes against HEAD's (``perf_deltas``, same-stamp and
same-factorisation pairs only).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess

from repro_torch.configs import CELLS

__all__ = ["OUT_DIR", "REPO_ROOT", "load_all", "mem_deltas", "perf_deltas",
           "fmt_row", "HEADER", "main"]

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")
REPO_ROOT = os.path.normpath(os.path.join(OUT_DIR, "..", ".."))


def load_all(out_dir: str = OUT_DIR) -> dict:
    rows = {}
    for f in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(f) as fh:
            d = json.load(fh)
        tag = d.get("meta", {}).get("overrides", {}).get("tag", "")
        rows[(d["mesh"], d["arch"], d["shape"], tag)] = d
    return rows


def _committed(fname: str):
    """The HEAD-committed version of a JSON file (None if new or no
    git)."""
    rel = os.path.relpath(os.path.abspath(fname), REPO_ROOT)
    try:
        out = subprocess.run(["git", "show", f"HEAD:{rel}"],
                             capture_output=True, cwd=REPO_ROOT, timeout=30)
        if out.returncode != 0:
            return None
        return json.loads(out.stdout)
    except (OSError, ValueError, subprocess.SubprocessError):
        return None


def mem_deltas(out_dir: str = OUT_DIR) -> list:
    """(key, old GiB/dev, new GiB/dev, old fit, new fit) for every JSON
    whose memory footprint or fit changed against its committed version;
    a JSON with no committed version comes with ``old = None``."""
    deltas = []

    def gib(d):
        return d["memory_analysis"]["total_nonalias_bytes"] / 2**30

    for f in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(f) as fh:
            new = json.load(fh)
        old = _committed(f)
        key = (new["mesh"], new["arch"], new["shape"])
        if old is None:
            deltas.append((key, None, gib(new), None, new["hbm_fit"]))
            continue
        if abs(gib(new) - gib(old)) < 1e-3 and new["hbm_fit"] == old["hbm_fit"]:
            continue
        deltas.append((key, gib(old), gib(new), old["hbm_fit"],
                       new["hbm_fit"]))
    return deltas


def _snapshots(doc: dict) -> list:
    """Snapshot list of one bench JSON in either layout (a ``snapshots``
    list, or one snapshot)."""
    if not doc:
        return []
    if "snapshots" in doc:
        return list(doc["snapshots"])
    return [doc] if "cases" in doc else []


def _stamp(snap: dict):
    """The comparability stamp: platform, interpret mode, device count
    and sizing.  Two snapshots are diffed only when these all match."""
    return (json.dumps({k: snap.get("env", {}).get(k)
                        for k in ("platform", "interpret",
                                  "device_count")}, sort_keys=True),
            json.dumps(snap.get("sizing", {}), sort_keys=True))


def _mesh_fact(snap: dict, case: str):
    """The (S_v, S_w) factorisation ``case`` was measured under, from its
    ``mesh_sv``/``mesh_sw`` extras (None: unstamped)."""
    ex = snap.get("extras", {})
    sv = ex.get(f"{case}.mesh_sv")
    sw = ex.get(f"{case}.mesh_sw")
    if sv is None and sw is None:
        return None
    return (sv, sw)


def perf_deltas(files, rel_thresh: float = 0.05) -> list:
    """(file, case, metric, old, new) throughput changes of the bench
    JSONs ``files`` (paths under the repository) against HEAD's.

    Snapshots pair by ``_stamp``; a case whose factorisation changed
    (``_mesh_fact``) is refused like a cross-stamp pair; changes under
    ``rel_thresh`` are dropped as timing noise.
    """
    deltas = []
    for fname in files:
        path = os.path.join(REPO_ROOT, fname)
        if not os.path.exists(path):
            continue
        with open(path) as fh:
            new_doc = json.load(fh)
        old_doc = _committed(path)
        if old_doc is None:
            continue
        metric = new_doc.get("metric", "")
        old_by_stamp = {_stamp(s): s for s in _snapshots(old_doc)}
        for snap in _snapshots(new_doc):
            old = old_by_stamp.get(_stamp(snap))
            if old is None:
                continue
            for case, val in sorted(snap.get("cases", {}).items()):
                ov = old.get("cases", {}).get(case)
                if not ov:
                    continue
                if _mesh_fact(snap, case) != _mesh_fact(old, case):
                    continue
                if abs(val - ov) / abs(ov) < rel_thresh:
                    continue
                deltas.append((fname, case, metric, float(ov), float(val)))
    return deltas


def fmt_row(d) -> str:
    tc, tm, tx = d["t_compute"], d["t_memory"], d["t_collective"]
    dom = max(tc, tm, tx)
    frac = tc / max(dom, 1e-12)       # compute / dominant term
    mem_gib = d["memory_analysis"]["total_nonalias_bytes"] / 2**30
    return (f"| {d['arch']} | {d['shape']} | {d['mesh']} "
            f"| {d['flops_per_device']:.2e} | {d['bytes_per_device']:.2e} "
            f"| {d['coll_bytes_per_device']:.2e} "
            f"| {tc * 1e3:.1f} | {tm * 1e3:.1f} | {tx * 1e3:.1f} "
            f"| {d['bottleneck']} | {frac:.2f} | {d['useful_ratio']:.2f} "
            f"| {mem_gib:.2f} | {'Y' if d['hbm_fit'] else 'N'} |")


HEADER = ("| arch | shape | mesh | FLOPs/dev | bytes/dev | coll B/dev "
          "| t_comp ms | t_mem ms | t_coll ms | bottleneck "
          "| roofline-frac | useful | GiB/dev | fit |")
SEP = "|" + "---|" * 14


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=OUT_DIR)
    ap.add_argument("--bench", nargs="*", default=(),
                    help="bench snapshot JSONs to diff against HEAD")
    ap.add_argument("--arch-filter", default="",
                    help="only the archs whose name contains it")
    args = ap.parse_args(argv)
    rows = {k: v for k, v in load_all(args.dir).items()
            if args.arch_filter in k[1]}
    print("## Roofline table (generated by repro_torch.launch.report; "
          "H100 constants of launch/hw.py, predictions)\n")
    print(HEADER)
    print(SEP)
    for key in sorted(rows):
        if not key[3]:
            print(fmt_row(rows[key]))
    skips = [(a, c["shape"].name, c["reason"])
             for a, cs in CELLS.items() for c in cs
             if c["skip"] and args.arch_filter in a]
    if skips:
        print("\n### Skipped cells (DESIGN.md §4 policy)\n")
        for a, sh, r in skips:
            print(f"- {a} × {sh}: {r}")
    tagged = [(k, v) for k, v in rows.items() if k[3]]
    if tagged:
        print("\n### Capacity-ladder and other tagged variants\n")
        print(HEADER)
        print(SEP)
        for k, v in sorted(tagged):
            print(fmt_row(v).replace(f"| {v['shape']} ",
                                     f"| {v['shape']}[{k[3]}] "))
    deltas = [d for d in mem_deltas(args.dir) if args.arch_filter in d[0][1]]
    if deltas:
        print("\n### GiB/dev deltas vs committed snapshots (HEAD)\n")
        print("| mesh | arch | shape | GiB/dev HEAD | GiB/dev now "
              "| delta | fit HEAD→now |")
        print("|" + "---|" * 7)
        for (mesh, arch, shape), g0, g1, f0, f1 in deltas:
            if g0 is None:
                print(f"| {mesh} | {arch} | {shape} | new | {g1:.2f} "
                      f"| — | —→{'Y' if f1 else 'N'} |")
            else:
                print(f"| {mesh} | {arch} | {shape} | {g0:.2f} | {g1:.2f} "
                      f"| {g1 - g0:+.2f} "
                      f"| {'Y' if f0 else 'N'}→{'Y' if f1 else 'N'} |")
    pdeltas = perf_deltas(args.bench)
    if pdeltas:
        print("\n### Throughput deltas vs committed bench JSONs (HEAD, "
              "same-stamp snapshots only)\n")
        print("| file | case | metric | HEAD | now | delta |")
        print("|" + "---|" * 6)
        for fname, case, metric, ov, nv in pdeltas:
            print(f"| {fname} | {case} | {metric} | {ov:.4g} | {nv:.4g} "
                  f"| {(nv - ov) / ov:+.1%} |")


if __name__ == "__main__":
    main()
