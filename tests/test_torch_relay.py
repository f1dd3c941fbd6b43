"""The port's walker relay and sharded engine against JAX's.

Shards are ranks of a gloo process group on the CPU: each shard count runs
all its cases in one ``torch.multiprocessing`` spawn (start method
``spawn``), whose ranks meet through a ``FileStore`` under ``tmp_path``
and trade inputs and results through files there.  One shard runs in the
test process, with no group.

* ``exchange_walkers`` (S = 4): every live row is delivered or left on its
  sender, and each (sender, destination) mailbox holds the sender's first
  ``cap`` rows for that destination, in order.
* ``relay_view``, ``slot_count`` and ``round_bound`` equal JAX's.
* The relay at S = 1, 2 and 4, bulk and overlapped, with default mailboxes
  and ``mailbox_cap=1``, deepwalk/ppr/simple, bases 2 and 4, integer and
  fp, fed and hashed uniforms: the stitched paths equal JAX's single-shard
  ``random_walk(..., backend="pallas")`` bit for bit.
* The schedule itself: JAX's ``make_relay`` (reference backend) on 4 fake
  CPU devices, in a subprocess because the test process must keep seeing
  one device, gives the same paths, rounds, mailbox overflow and peak
  slots as the port at S = 4, bulk and overlapped.
* An ``exchange_fn`` hook carries both channels of every round.
* The sharded engine (S = 2): after every ingest the gathered state and
  the summed stats equal the single-device port engine's, and its walk
  equals the single-device whole walk.
"""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.core import dyngraph as jdg
from repro.core import walks as jwalks
from repro.distributed import relay as jrelay
from repro.kernels.ops import seed_from_key
from repro_torch.core import dyngraph as tdg
from repro_torch.core.backend import get_backend
from repro_torch.core.walks import WalkParams
from repro_torch.distributed import relay as trelay
from repro_torch.distributed.walker_exchange import exchange_walkers
from tests.conftest import random_graph
from tests.test_torch_state import assert_state_matches, configs

ROOT = Path(__file__).resolve().parent.parent
V, C, B, L = 32, 16, 24, 10
SPAWN_TIMEOUT_S = 240

# name: (kind, base_log2, fp, fed uniforms, overlapped schedule, mailbox_cap)
CASES = {
    "deepwalk-fed-bulk": ("deepwalk", 1, False, True, False, None),
    "deepwalk-fed-overlap": ("deepwalk", 1, False, True, True, None),
    "deepwalk-hash-overlap": ("deepwalk", 1, False, False, True, None),
    "deepwalk-hash-bulk-cap1": ("deepwalk", 1, False, False, False, 1),
    "deepwalk-fed-overlap-cap1": ("deepwalk", 1, False, True, True, 1),
    "ppr-fed-overlap": ("ppr", 1, False, True, True, None),
    "ppr-base4-fp-fed-bulk": ("ppr", 2, True, True, False, None),
    "simple-hash-overlap": ("simple", 1, False, False, True, None),
    "deepwalk-base4-hash-overlap": ("deepwalk", 2, False, False, True, None),
    "deepwalk-fp-hash-bulk": ("deepwalk", 1, True, False, False, None),
}
# The cases JAX's make_relay runs too (its graph, walkers and uniforms).
SCHEDULE = {False: "deepwalk-fed-bulk", True: "deepwalk-fed-overlap"}


def _params(kind):
    return dict(kind=kind, length=L, stop_prob=0.1 if kind == "ppr" else 0.0)


def _cfg_kw(base_log2, fp):
    return dict(num_vertices=V, capacity=C, bias_bits=6, base_log2=base_log2,
                fp_bias=fp, lam=4.0)


def _graph(fp):
    src, dst, w = random_graph(V, C, max_bias=63, seed=3)
    return src, dst, (w.astype(np.float32) + 0.37 if fp else w)


@pytest.fixture(scope="module")
def inputs():
    """The JAX states by (base_log2, fp) as the port's numpy leaves, the
    walkers, the fed uniforms and the seed (as JAX's relay tests make
    them), and JAX's single-shard pallas whole walk for every case."""
    key = jax.random.key(0)
    u = jax.random.uniform(key, (L, B, 6))
    walkers = jnp.arange(B, dtype=jnp.int32) % V
    states, oracle, jstates = {}, {}, {}
    for name, (kind, base_log2, fp, fed, _, _) in CASES.items():
        mode = (base_log2, fp)
        if mode not in jstates:
            jcfg, tcfg = configs(**_cfg_kw(base_log2, fp))
            jstates[mode] = (jdg.from_edges(jcfg, *_graph(fp)), jcfg)
            states[mode] = tdg.state_to_numpy(
                tdg.state_from_numpy(jstates[mode][0], tcfg, device="cpu"))
        key3 = (kind, mode, fed)
        if key3 not in oracle:
            js, jcfg = jstates[mode]
            oracle[key3] = np.asarray(jwalks.random_walk(
                js, jcfg, walkers, key, jwalks.WalkParams(**_params(kind)),
                backend="pallas", uniforms=u if fed else None))
    return {"states": states, "u": np.asarray(u),
            "walkers": np.asarray(walkers),
            "seed": int(np.asarray(seed_from_key(key))[0]),
            "oracle": {n: oracle[(c[0], (c[1], c[2]), c[3])]
                       for n, c in CASES.items()}}


def _shard(st, rank, S):
    """Rows ``[rank·V/S, (rank+1)·V/S)`` of every leaf of a port state."""
    Vs = st.nbr.shape[0] // S
    return tdg.BingoState(*[None if x is None else x[rank * Vs:(rank + 1) * Vs]
                            for x in st[:-1]],
                          itable=type(st.itable)(*[x[rank * Vs:(rank + 1) * Vs]
                                                   for x in st.itable]))


def _run_case(job, name, group, rank, S):
    """One relay case on this rank: ``(stitched paths, rounds, overflow,
    peak slots)``."""
    kind, base_log2, fp, fed, overlap, cap = CASES[name]
    cfg = tdg.BingoConfig(**_cfg_kw(base_log2, fp))
    st = tdg.state_from_numpy(job["states"][(base_log2, fp)], cfg,
                              device="cpu")
    run = trelay.make_relay(get_backend("fused"), cfg,
                            WalkParams(**_params(kind)), group,
                            mailbox_cap=cap, overlap=overlap,
                            diagnostics=True)
    home, rounds, ovf, peak = run(
        _shard(st, rank, S), torch.tensor(job["walkers"]), job["seed"],
        torch.tensor(job["u"]) if fed else None)
    return trelay.stitch(home, group).numpy(), rounds, ovf, peak


# ---------------------------------------------------------------- the ranks
def _exchange(rank, S, group):
    """Each rank routes 40 rows (dest vertex, sender, index) with 8
    vertices a shard, cap 3, some rows dead or with no owner."""
    rng = np.random.default_rng(rank)
    dest = rng.integers(-1, S * 8 + 3, 40).astype(np.int32)
    pay = np.stack([dest, np.full(40, rank, np.int32),
                    np.arange(40, dtype=np.int32)], 1)
    pay[dest < 0] = -1
    arrived, left, ovf = exchange_walkers(torch.from_numpy(pay), 8, S, group,
                                          cap=3)
    return pay, arrived.numpy(), left.numpy(), int(ovf)


def _engine(job, group, rank, S):
    """The sharded engine on the job's stream: per round the gathered
    state (rank 0) and the stats, then the stitched walk."""
    from repro_torch.distributed.relay import stitch
    from repro_torch.serve import DynamicWalkEngine
    e = job["engine"]
    cfg = tdg.BingoConfig(num_vertices=e["V"], capacity=32, bias_bits=16)
    st = tdg.from_edges(cfg, *e["init"], device="cpu")
    eng = DynamicWalkEngine(st, cfg, WalkParams("deepwalk", L), group=group)
    out = {"states": [], "stats": []}
    for lanes in e["rounds"]:
        stats = eng.ingest(*[torch.from_numpy(x) for x in lanes])
        out["stats"].append([x.numpy() for x in stats[:4]])
        full = eng.gather_state()
        out["states"].append(tdg.state_to_numpy(full) if rank == 0 else None)
    out["fill"] = float(stats.max_fill)
    home = eng.walk(torch.from_numpy(e["starts"]), e["seed"])
    out["walk"] = stitch(home, group).numpy()
    out["relay"] = eng.last_relay
    return out


def _rank_main(rank, S, d):
    """One rank of a spawn: every job of ``d/job.pkl``, results to
    ``d/out_<rank>.pkl``."""
    import torch.distributed as dist
    d = Path(d)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(str(d / "store"), S),
                            rank=rank, world_size=S)
    group = dist.group.WORLD
    try:
        job = pickle.loads((d / "job.pkl").read_bytes())
        out = {"relay": {n: _run_case(job, n, group, rank, S)
                         for n in job["cases"]}}
        if job.get("exchange"):
            out["exchange"] = _exchange(rank, S, group)
        if job.get("engine"):
            out["engine"] = _engine(job, group, rank, S)
        (d / f"out_{rank}.pkl").write_bytes(pickle.dumps(out))
    finally:
        dist.destroy_process_group()


def _spawn(S, job, d):
    (d / "job.pkl").write_bytes(pickle.dumps(job))
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, S, str(d)))
             for r in range(S)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(SPAWN_TIMEOUT_S)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    assert [p.exitcode for p in procs] == [0] * S
    return [pickle.loads((d / f"out_{r}.pkl").read_bytes()) for r in range(S)]


_JAX_SCHEDULE = """
import sys
import numpy as np
import jax, jax.numpy as jnp
from repro.core import walks
from repro.core.backend import get_backend
from repro.core.dyngraph import BingoConfig, from_edges
from repro.distributed.relay import make_relay
from repro.kernels.ops import seed_from_key
from tests.conftest import random_graph
assert len(jax.devices()) == 4
src, dst, w = random_graph(32, 16, max_bias=63, seed=3)
cfg = BingoConfig(num_vertices=32, capacity=16, bias_bits=6, lam=4.0)
st = from_edges(cfg, src, dst, w)
key = jax.random.key(0)
u = jax.random.uniform(key, (10, 24, 6))
walkers = jnp.arange(24, dtype=jnp.int32) % 32
mesh = jax.make_mesh((4,), ("data",))
out = {}
for name, ov in (("bulk", False), ("overlap", True)):
    run = make_relay(get_backend("reference"), cfg,
                     walks.WalkParams(kind="deepwalk", length=10), mesh,
                     overlap=ov, diagnostics=True)
    p, r, o, pk = run(st, walkers, seed_from_key(key), u)
    out[name] = np.asarray(p)
    out[name + "_counts"] = np.array([int(r), int(o), int(pk)])
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def spawn4(inputs, tmp_path_factory):
    """S = 4: every relay case, the schedule's two relays and the
    exchange, beside JAX's relay on 4 fake devices in a subprocess."""
    d = tmp_path_factory.mktemp("relay4")
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "PYTHONPATH": os.pathsep.join([str(ROOT / "src"), str(ROOT)])}
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_SCHEDULE, str(d / "jax.npz")], env=env,
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        out = _spawn(4, dict(inputs, cases=list(CASES), exchange=True), d)
        log, _ = jax_proc.communicate(timeout=SPAWN_TIMEOUT_S)
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
            jax_proc.communicate()
    assert jax_proc.returncode == 0, log
    return out, dict(np.load(d / "jax.npz"))


def test_relay_trace_has_a_span_per_round(inputs):
    """``trace`` gets one record per round: the segment's span (host
    seconds on the CPU) and the exchange and all-reduce seconds."""
    cfg = tdg.BingoConfig(**_cfg_kw(1, False))
    st = tdg.state_from_numpy(inputs["states"][(1, False)], cfg, device="cpu")
    trace = []
    run = trelay.make_relay(get_backend("fused"), cfg,
                            WalkParams(**_params("deepwalk")), None)
    _, rounds, _ = run(st, torch.tensor(inputs["walkers"]), 5, trace=trace)
    assert len(trace) == rounds
    for rec in trace:
        assert rec["segment"] >= 0 and rec["exchange_s"] >= 0
        assert rec["reduce_s"] >= 0


@pytest.mark.parametrize("overlap", [False, True])
def test_relay_exchange_fn_replaces_the_exchange(inputs, overlap):
    """``exchange_fn`` carries both channels of every round, in order, and
    the paths stay the single-shard walk's."""
    cfg = tdg.BingoConfig(**_cfg_kw(1, False))
    st = tdg.state_from_numpy(inputs["states"][(1, False)], cfg, device="cpu")
    calls = []

    def exchange_fn(payload, *, cap, r, channel):
        calls.append((r, channel))
        return (*exchange_walkers(payload, V, 1, None, cap=cap), 0)

    run = trelay.make_relay(get_backend("fused"), cfg,
                            WalkParams(**_params("deepwalk")), None,
                            exchange_fn=exchange_fn, overlap=overlap)
    home, rounds, _ = run(st, torch.tensor(inputs["walkers"]), inputs["seed"],
                          torch.tensor(inputs["u"]))
    np.testing.assert_array_equal(home.numpy(),
                                  inputs["oracle"]["deepwalk-fed-bulk"])
    assert calls == [(r, c) for r in range(rounds) for c in (0, 1)]


def _engine_job():
    """An R-MAT graph of 64 vertices and a 3-round mixed stream of 48
    updates, the walkers and the walk seed of the engine test."""
    from repro_torch.graph import rmat, streams
    src, dst = rmat.rmat_edges(6, 8, seed=0)
    w = rmat.degree_bias(src, dst, 1 << 6)
    s = streams.make_update_stream(src, dst, w, batch_size=48, rounds=3,
                                   mode="mixed", seed=0)
    return {"V": 1 << 6, "init": (s.init_src, s.init_dst, s.init_w),
            "rounds": [tuple(a[r] for a in (s.is_insert, s.u, s.v, s.w))
                       for r in range(3)],
            "starts": np.arange(0, 1 << 6, 2, dtype=np.int32), "seed": 77}


@pytest.fixture(scope="module")
def spawn2(inputs, tmp_path_factory):
    """S = 2: every relay case and the sharded engine."""
    d = tmp_path_factory.mktemp("relay2")
    return _spawn(2, dict(inputs, cases=list(CASES), engine=_engine_job()), d)


# ------------------------------------------------------------------ the tests
@pytest.mark.parametrize("name", list(CASES))
def test_relay_one_shard_matches_single_shard(inputs, name):
    paths, rounds, ovf, peak = _run_case(inputs, name, None, 0, 1)
    np.testing.assert_array_equal(paths, inputs["oracle"][name])
    assert rounds == 1 and ovf == 0 and peak == B    # nothing to relay


@pytest.mark.parametrize("name", list(CASES))
def test_relay_two_shards_matches_single_shard(spawn2, inputs, name):
    outs = [o["relay"][name] for o in spawn2]
    np.testing.assert_array_equal(outs[0][0], inputs["oracle"][name])
    assert all(np.array_equal(o[0], outs[0][0]) and o[1:] == outs[0][1:]
               for o in outs)


@pytest.mark.parametrize("name", list(CASES))
def test_relay_four_shards_matches_single_shard(spawn4, inputs, name):
    out, _ = spawn4
    paths, rounds, ovf, _ = out[0]["relay"][name]
    np.testing.assert_array_equal(paths, inputs["oracle"][name])
    assert rounds > 1
    if CASES[name][5] == 1:
        assert ovf > 0                               # mailboxes overflowed


@pytest.mark.parametrize("overlap", [False, True])
def test_relay_schedule_matches_jax_make_relay(spawn4, overlap):
    """Paths, rounds, overflow and peak slots of the port at S = 4 equal
    JAX's ``make_relay`` on 4 devices, bulk and overlapped."""
    out, jax_out = spawn4
    paths, rounds, ovf, peak = out[0]["relay"][SCHEDULE[overlap]]
    key = "overlap" if overlap else "bulk"
    np.testing.assert_array_equal(paths, jax_out[key])
    assert [rounds, ovf, peak] == jax_out[key + "_counts"].tolist()


def test_exchange_conserves_every_row(spawn4):
    out, _ = spawn4
    sent = [o["exchange"][0] for o in out]
    got = [o["exchange"][1] for o in out] + [o["exchange"][2] for o in out]
    live = np.concatenate(sent)
    live = live[live[:, 0] >= 0]
    back = np.concatenate(got)
    back = back[back[:, 0] >= 0]
    assert sorted(map(tuple, live)) == sorted(map(tuple, back))
    assert [o["exchange"][3] for o in out] == \
        [int((o["exchange"][2][:, 0] >= 0).sum()) for o in out]
    assert sum(o["exchange"][3] for o in out) > 0


def test_exchange_mailboxes_are_fifo(spawn4):
    """Rank d's mailbox from sender s holds s's first 3 live rows bound for
    d, in s's order; rows with no owner (vertex >= 32) stay on s."""
    out, _ = spawn4
    S, cap = len(out), 3
    for d, o in enumerate(out):
        arrived = o["exchange"][1]
        for s, so in enumerate(out):
            pay = so["exchange"][0]
            mine = pay[(pay[:, 0] >= 0) & (pay[:, 0] // 8 == d)]
            box = arrived[s * cap:(s + 1) * cap]
            box = box[box[:, 0] >= 0]
            np.testing.assert_array_equal(box, mine[:cap])
    for o in out:      # the rest stays on the sender, sorted by destination
        pay, left = o["exchange"][0], o["exchange"][2]
        rest = [pay[(pay[:, 0] >= 0) & (pay[:, 0] // 8 == d)][cap:]
                for d in range(S)] + [pay[pay[:, 0] >= S * 8]]
        np.testing.assert_array_equal(left[left[:, 0] >= 0],
                                      np.concatenate(rest))


def test_relay_view_matches_jax(inputs):
    jcfg, tcfg = configs(**_cfg_kw(1, False))
    js = jdg.from_edges(jcfg, *_graph(False))
    ts = tdg.state_from_numpy(js, tcfg, device="cpu")
    for lo, size in ((0, 8), (8, 8), (16, 16), (24, 8)):
        np.testing.assert_array_equal(
            trelay.relay_view(ts, lo, size).nbr.numpy(),
            np.asarray(jrelay.relay_view(js, lo, size).nbr))


def test_slot_count_and_round_bound_match_jax():
    for W, S in ((24, 1), (24, 4), (262144, 4), (4194304, 256), (7, 7)):
        for slack in (None, 0, 5):
            assert trelay.slot_count(W, S, slack) == \
                jrelay.slot_count(W, S, slack)
            for cap, pcap, ov in ((None, None, False), (1, 1, True),
                                  (3, None, True), (None, 2, False)):
                kw = dict(slot_slack=slack, mailbox_cap=cap, path_cap=pcap,
                          overlap=ov)
                assert trelay.round_bound(W, 80, S, **kw) == \
                    jrelay.round_bound(W, 80, S, **kw)
    with pytest.raises(ValueError, match="slack"):
        trelay.slot_count(24, 4, -1)


def test_relay_strict_and_divisibility(inputs):
    cfg = tdg.BingoConfig(**_cfg_kw(1, False))
    st = tdg.state_from_numpy(inputs["states"][(1, False)], cfg, device="cpu")
    walkers = torch.from_numpy(inputs["walkers"])
    run = trelay.make_relay(get_backend("fused"), cfg, WalkParams(**_params(
        "deepwalk")), None, max_rounds=0, strict=True)
    with pytest.raises(trelay.RelayIntegrityError, match="pending"):
        run(st, walkers, 5)
    with pytest.raises(ValueError, match="divide"):
        trelay.relay_local(get_backend("fused"), cfg,
                           WalkParams(**_params("deepwalk")), st,
                           walkers[:23], 5, sidx=0, num_shards=2,
                           shard_size=16)


@pytest.fixture(scope="module")
def single_engine():
    """The single-device port engine on the engine test's stream: the
    stats and state after each round, then the walk."""
    from repro_torch.serve import DynamicWalkEngine
    e = _engine_job()
    cfg = tdg.BingoConfig(num_vertices=e["V"], capacity=32, bias_bits=16)
    eng = DynamicWalkEngine(tdg.from_edges(cfg, *e["init"], device="cpu"),
                            cfg, WalkParams("deepwalk", L))
    rounds = []
    for lanes in e["rounds"]:
        stats = eng.ingest(*[torch.from_numpy(x) for x in lanes])
        # copied: a CPU tensor's .numpy() shares the memory ingest updates
        rounds.append((stats, tdg.state_to_numpy(
            tdg.state_from_numpy(eng.state, cfg, device="cpu"))))
    paths = eng.walk(torch.from_numpy(e["starts"]), e["seed"])
    return rounds, paths.numpy()


def test_sharded_engine_ingest_matches_single_device(spawn2, single_engine):
    rounds, _ = single_engine
    out = spawn2[0]["engine"]
    cfg = tdg.BingoConfig(num_vertices=1 << 6, capacity=32, bias_bits=16)
    for r, (stats, state) in enumerate(rounds):
        for a, b, c in zip(stats[:4], out["stats"][r],
                           spawn2[1]["engine"]["stats"][r]):
            np.testing.assert_array_equal(a.numpy(), b)
            np.testing.assert_array_equal(b, c)
        got = tdg.state_from_numpy(out["states"][r], cfg, device="cpu")
        assert_state_matches(state, got, fp=False)
    assert out["fill"] == float(stats.max_fill)
    assert int(stats.ins_applied) + int(stats.del_applied) > 0


def test_sharded_engine_walk_matches_single_device(spawn2, single_engine):
    out = spawn2[0]["engine"]
    np.testing.assert_array_equal(out["walk"], single_engine[1])
    assert out["relay"]["rounds"] > 1
