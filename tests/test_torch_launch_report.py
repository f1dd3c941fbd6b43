"""``repro_torch.launch.report`` against ``repro.launch.report``.

``tests/test_report_compare.py``'s three cases replayed on the port
(same-stamp and same-factorisation comparisons only); ``_stamp``,
``_mesh_fact``, ``_snapshots`` and ``fmt_row`` equal the reference's on
the same documents; ``load_all``, ``mem_deltas``, ``perf_deltas`` and
``main`` over a temporary directory, the committed versions stubbed.
"""

import json

import pytest

from repro.launch import report as jrep

from repro_torch.configs import CELLS
from repro_torch.launch import report as rep


def _snap(cases, extras=None, env=None, sizing=None):
    return {"cases": cases, "extras": extras or {},
            "env": env or {"platform": "cpu", "interpret": False,
                           "device_count": 8},
            "sizing": sizing or {"walkers": 64}}


def test_mesh_fact_reads_extras():
    s = _snap({"deepwalk-relay": 1.0},
              extras={"deepwalk-relay.mesh_sv": 8,
                      "deepwalk-relay.mesh_sw": 1,
                      "deepwalk-relay.round_ms": 1.5})
    assert rep._mesh_fact(s, "deepwalk-relay") == (8, 1)
    assert rep._mesh_fact(s, "deepwalk-pallas-fused") is None


def test_cross_factorization_compare_refused():
    old = _snap({"deepwalk-relay": 1.0},
                extras={"deepwalk-relay.mesh_sv": 16,
                        "deepwalk-relay.mesh_sw": 16})
    new = _snap({"deepwalk-relay": 9.0},
                extras={"deepwalk-relay.mesh_sv": 64,
                        "deepwalk-relay.mesh_sw": 4})
    assert rep._stamp(old) == rep._stamp(new)
    assert rep._mesh_fact(old, "deepwalk-relay") \
        != rep._mesh_fact(new, "deepwalk-relay")
    unstamped = _snap({"deepwalk-relay": 1.0})
    assert rep._mesh_fact(unstamped, "deepwalk-relay") \
        != rep._mesh_fact(new, "deepwalk-relay")
    assert rep._mesh_fact(new, "deepwalk-relay") \
        == rep._mesh_fact(_snap({}, extras=dict(new["extras"])),
                          "deepwalk-relay")


def test_snapshots_handles_both_layouts():
    assert rep._snapshots({"snapshots": [_snap({}), _snap({})]}) \
        and len(rep._snapshots({"snapshots": [_snap({})]})) == 1
    assert len(rep._snapshots(_snap({"a": 1.0}))) == 1
    assert rep._snapshots({}) == []


DOCS = [
    _snap({"a": 1.0}, extras={"a.mesh_sv": 4, "a.mesh_sw": 2}),
    _snap({"a": 2.0}, env={"platform": "gpu", "interpret": False,
                           "device_count": 1}, sizing={"walkers": 4096}),
    {"snapshots": [_snap({"b": 3.0}), _snap({"c": 4.0})]},
    {"env": {"platform": "tpu"}}, {},
]


@pytest.mark.parametrize("doc", range(len(DOCS)))
def test_helpers_equal_the_reference(doc):
    d = DOCS[doc]
    assert rep._snapshots(d) == jrep._snapshots(d)
    for s in rep._snapshots(d):
        assert rep._stamp(s) == jrep._stamp(s)
        for case in list(s.get("cases", {})) + ["missing"]:
            assert rep._mesh_fact(s, case) == jrep._mesh_fact(s, case)


def _cell(shape="walk_whole", gib=6.0, fit=True, tag=None, mesh="pod16x16"):
    meta = {"overrides": {"tag": tag}} if tag else {}
    return {"arch": "bingo-walk", "shape": shape, "mesh": mesh,
            "flops_per_device": 3.5e9, "bytes_per_device": 1.6e10,
            "coll_bytes_per_device": 5.9e7, "t_compute": 3.5e-6,
            "t_memory": 4.8e-3, "t_collective": 1.1e-3,
            "bottleneck": "memory", "useful_ratio": 6.6e7,
            "memory_analysis": {"total_nonalias_bytes": int(gib * 2**30)},
            "hbm_fit": fit, "meta": meta}


@pytest.mark.parametrize("fit", [True, False])
def test_fmt_row_equals_the_reference(fit):
    d = _cell(fit=fit)
    assert rep.fmt_row(d) == jrep.fmt_row(d)
    assert rep.HEADER == jrep.HEADER


def _write(tmp_path, docs):
    for d in docs:
        tag = d["meta"].get("overrides", {}).get("tag")
        name = f"{d['mesh']}__{d['arch']}__{d['shape']}" + \
            (f"__{tag}" if tag else "")
        (tmp_path / f"{name}.json").write_text(json.dumps(d))


def test_load_all_and_mem_deltas(tmp_path, monkeypatch):
    _write(tmp_path, [_cell(), _cell("walk_relay", 7.0),
                      _cell("update_walk", 14.6, tag="tier2x")])
    rows = rep.load_all(str(tmp_path))
    assert sorted(rows) == [
        ("pod16x16", "bingo-walk", "update_walk", "tier2x"),
        ("pod16x16", "bingo-walk", "walk_relay", ""),
        ("pod16x16", "bingo-walk", "walk_whole", "")]
    committed = {"walk_whole": _cell(gib=6.0),
                 "walk_relay": _cell("walk_relay", 9.0, fit=False)}

    def old(fname):
        d = json.loads(open(fname).read())
        return None if d["meta"] else committed.get(d["shape"])
    monkeypatch.setattr(rep, "_committed", old)
    deltas = rep.mem_deltas(str(tmp_path))
    assert deltas == [
        (("pod16x16", "bingo-walk", "update_walk"), None, pytest.approx(14.6),
         None, True),
        (("pod16x16", "bingo-walk", "walk_relay"), pytest.approx(9.0),
         pytest.approx(7.0), False, True)]


def test_perf_deltas_pair_same_stamps(tmp_path, monkeypatch):
    new = {"metric": "steps/s", "snapshots": [
        _snap({"a": 2.0, "b": 1.01, "r": 5.0},
              extras={"r.mesh_sv": 64, "r.mesh_sw": 4}),
        _snap({"a": 9.0}, sizing={"walkers": 1})]}
    old = {"snapshots": [_snap({"a": 1.0, "b": 1.0, "r": 1.0},
                               extras={"r.mesh_sv": 16, "r.mesh_sw": 16})]}
    (tmp_path / "BENCH_x.json").write_text(json.dumps(new))
    monkeypatch.setattr(rep, "REPO_ROOT", str(tmp_path))
    monkeypatch.setattr(rep, "_committed", lambda f: old)
    assert rep.perf_deltas(["BENCH_x.json", "BENCH_missing.json"]) == \
        [("BENCH_x.json", "a", "steps/s", 1.0, 2.0)]
    assert rep.perf_deltas([]) == []


def test_main_prints_the_table(tmp_path, monkeypatch, capsys):
    _write(tmp_path, [_cell(), _cell("update_walk", 14.6, tag="tier2x")])
    monkeypatch.setattr(rep, "_committed", lambda f: None)
    rep.main(["--dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert rep.HEADER in out and rep.fmt_row(_cell()) in out
    assert "| walk_whole |" in out and "| update_walk[tier2x] |" in out
    assert "| pod16x16 | bingo-walk | walk_whole | new | 6.00 |" in out


def test_main_prints_lm_rows_skips_and_filters(tmp_path, monkeypatch, capsys):
    lm = dict(_cell(), arch="qwen2-0.5b", shape="train_4k")
    _write(tmp_path, [_cell(), lm])
    monkeypatch.setattr(rep, "_committed", lambda f: None)
    rep.main(["--dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "| qwen2-0.5b | train_4k |" in out and "| walk_whole |" in out
    assert "### Skipped cells" in out
    skips = [(a, c["shape"].name) for a, cs in CELLS.items() for c in cs
             if c["skip"]]
    assert len(skips) == 7
    for a, s in skips:
        assert f"- {a} × {s}: " in out
    rep.main(["--dir", str(tmp_path), "--arch-filter", "qwen2"])
    out = capsys.readouterr().out
    assert "| qwen2-0.5b | train_4k |" in out and "| walk_whole |" not in out
    assert [ln for ln in out.splitlines() if ln.startswith("- ")] == [
        f"- qwen2-0.5b × long_500k: {CELLS['qwen2-0.5b'][3]['reason']}"]
