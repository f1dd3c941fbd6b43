#!/usr/bin/env python3
"""Counts of one update ingest in a profiled serving round's trace.

    python3 tools/round_trace.py TRACE [--until NAME]

Reads a Chrome trace that ``chip_smoke.py --profile DIR`` wrote
(``DIR/round_trace.json``: one ``ingest`` then one deepwalk batch) and
prints ``chip_smoke.trace_counts`` over the ingest: top-level host ops,
device events (kernels, memsets, memcpys), host syncs and the ms they
waited, the host span, the device's busy ms and idle share.  The ingest
is the trace's ``ingest`` annotation where there is one; in a trace
without it (taken before the annotation existed), the host calls from
the first one up to the launch of the first kernel whose name holds
``--until`` (default ``walk_fused``, the walk after the ingest), less
the host ops of the walk's set-up that precede that launch and follow
the ingest's last op, ``aten::div`` (the fill watermark).  Runs on any
machine: it reads a file.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def ingest_span(events, until):
    """(t0, t1) of the ingest in the trace's µs."""
    from chip_smoke import annotation_span
    span = annotation_span(events, "ingest")
    if span:
        return span
    host = sorted((e for e in events if e.get("cat") == "cpu_op"),
                  key=lambda e: float(e["ts"]))
    kern = sorted((e for e in events if e.get("cat") == "kernel"
                   and until in e.get("name", "")),
                  key=lambda e: float(e["ts"]))
    corr = kern[0]["args"]["correlation"]
    launch = next(e for e in events if e.get("cat") == "cuda_runtime"
                  and e.get("args", {}).get("correlation") == corr)
    div = [e for e in host if e["name"] == "aten::div"
           and float(e["ts"]) < float(launch["ts"])]
    end = div[-1] if div else launch
    return float(host[0]["ts"]), float(end["ts"]) + float(end.get("dur", 0))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trace", type=Path)
    ap.add_argument("--until", default="walk_fused")
    args = ap.parse_args()
    from chip_smoke import trace_counts
    events = json.loads(args.trace.read_text())["traceEvents"]
    print(json.dumps(trace_counts(events, ingest_span(events, args.until))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
