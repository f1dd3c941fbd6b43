"""Continuous-serving scheduler: overlapped update/walk streams with
SLO-aware batching (DESIGN.md §12).

Port of ``repro/serve/scheduler.py``: the request-stream front end over a
``DynamicWalkEngine``.

* **Generation-stamped serving.**  Walk cohorts are dispatched against
  the *published* generation ``g`` — CUDA launches are asynchronous, so
  the host enqueues the walk and moves on — while the next update window
  builds generation ``g+1`` in place on the same tables.  Everything runs
  on the current stream, so a walk enqueued against ``g`` executes
  before the in-place update that follows it: no state copy is made and
  no walk reads a half-built generation (the reference gets this order
  from donation; a side stream would let the update race the walk).
  Each cohort's paths are copied to pinned host memory on the same
  stream, and a ``torch.cuda.Event`` recorded after the copy tells the
  harvest when they are there (on the CPU a cohort is ready at once).
  Each served path records the generation it sampled from, and the
  overlapped schedule is **bit-identical to a serial replay** of the same
  admission trace (counter-PRNG whole walks and trace-ordered seeds).
* **Continuous batching into fixed-lane cohorts** padded to the
  engine's ``walk_buckets``.
* **Deadline-driven update coalescing**: queued update batches
  concatenate into one padded §5.2 round when the lane budget fills or
  the oldest queued edge has waited ``max_update_delay`` ticks.
* **Admission control with backpressure**: ``admitted + rejected +
  queued == offered`` at every moment.

The scheduler drives a guarded engine in *deferred* accounting mode
(``DynamicWalkEngine.drain_guard``); drain points and capacity-ladder
escalations are recorded in the admission trace so replay retries and
regrows at the same points.

Over a sharded engine (``DynamicWalkEngine(group=...)``) every rank runs
its own scheduler on the same submissions and ticks.  Each cohort's
paths are the whole rows on every rank (the engine stitches its home
blocks), and the harvest waits for each cohort, so which cohorts are in
flight — the one input of a dispatch that could depend on timing — is
the same on every rank and every rank admits the same trace.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.serve.dynwalk import DynamicWalkEngine

__all__ = ["SchedulerConfig", "WalkResult", "UpdateOp", "WalkOp",
           "DrainOp", "RegrowOp", "ServingScheduler",
           "replay_admission_trace"]


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Serving knobs (DESIGN.md §12).

    ``update_lanes`` is the §5.2 round shape every coalescing
    window pads to; ``max_update_delay`` bounds how many ticks a queued
    edge may wait before a deadline flush (the update-latency SLO);
    ``max_walk_queue`` / ``max_update_queue`` are the admission SLO
    depths (in start vertices / edge lanes) beyond which submissions
    are rejected with backpressure; ``max_inflight`` caps dispatched-
    but-unharvested walk cohorts so device queues stay bounded;
    ``guard_drain_rounds`` is how many guarded rounds may backlog
    before the scheduler takes the one-sync accounting drain;
    ``regrow_watermark`` is the fill fraction (``max(deg)/capacity``)
    past which a drain point escalates the engine's capacity ladder
    (DESIGN.md §14) — pending capacity spills escalate regardless.
    """
    update_lanes: int = 64
    max_update_delay: int = 4
    max_walk_queue: int = 256
    max_update_queue: int = 1024
    max_inflight: int = 8
    guard_drain_rounds: int = 8
    regrow_watermark: float = 0.95


@dataclasses.dataclass
class WalkResult:
    """One served walk query: ``paths`` are the request's rows only
    (pad lanes already sliced off), ``generation`` is the update
    generation the walk sampled from — the staleness stamp — and
    ``latency_s`` is submit→harvest wall time."""
    rid: int
    paths: np.ndarray
    generation: int
    latency_s: float


class UpdateOp(NamedTuple):
    """One flushed coalescing window, exactly as ingested (padded)."""
    is_insert: np.ndarray
    u: np.ndarray
    v: np.ndarray
    w: np.ndarray
    n_valid: int


class WalkOp(NamedTuple):
    """One dispatched walk cohort: concatenated *real* starts (the
    engine re-pads them to the same bucket on replay)."""
    starts: np.ndarray
    rids: tuple
    sizes: tuple


class DrainOp(NamedTuple):
    """A guard-accounting drain point — replay must retry capacity
    spills at the same moments the live schedule did."""
    rounds: int


class RegrowOp(NamedTuple):
    """A capacity-ladder escalation (DESIGN.md §14), recorded at the
    drain point where the live schedule took it — replay regrows at the
    same trace position and never re-derives the trigger, so live and
    replay migrate the same state at the same moment."""
    tier: int        # ladder rung AFTER the escalation


class _QueuedWalk(NamedTuple):
    rid: int
    starts: np.ndarray
    t_submit: float


class _Inflight(NamedTuple):
    paths: torch.Tensor            # host copy (pinned on the card)
    ready: Optional[object]        # CUDA event after the copy; None: ready
    entries: tuple                 # ((rid, offset, size, t_submit), ...)
    generation: int


class ServingScheduler:
    """Continuous-serving front end over one ``DynamicWalkEngine``.

    The engine must be constructed with ``walk_buckets=`` (the fixed
    cohort shapes); a guarded engine is flipped into deferred
    accounting so ingest dispatch never syncs.  That flip MUTATES the
    caller's engine for the scheduler's lifetime: direct
    ``engine.ingest`` calls made while a scheduler is attached also
    defer their guard bookkeeping until the next drain point — call
    ``close()`` to flush and restore the engine's prior mode.  Typical
    loop::

        sched = ServingScheduler(engine)
        ...
        sched.submit_update(ins, u, v, w)      # edge stream
        rid = sched.submit_walk(starts)        # walk queries
        sched.tick()                           # one scheduling quantum
        for res in sched.poll(): ...           # ready results
        ...
        results = sched.close()                # flush + detach engine

    ``sched.trace`` is the admission trace; ``replay_admission_trace``
    re-runs it serially on a fresh engine and must reproduce every
    served path bit-exactly (the §12 staleness contract).
    """

    def __init__(self, engine: DynamicWalkEngine,
                 cfg: SchedulerConfig = SchedulerConfig(), *,
                 clock=time.monotonic):
        if engine.walk_buckets is None:
            raise ValueError(
                "ServingScheduler needs an engine with walk_buckets= "
                "(the fixed-lane cohort shapes)")
        self._prior_defer_guard = engine.defer_guard
        if engine.guard is not None:
            # per-round host syncs would serialize the streams the
            # scheduler exists to overlap (DESIGN.md §12); close()
            # restores the engine's prior accounting mode
            engine.defer_guard = True
        self.engine = engine
        self.cfg = cfg
        self.clock = clock
        self.generation = 0
        self.tick_count = 0
        self.trace: List = []
        # walk side (counted in requests; queue depth in start lanes)
        self._walk_queue: Deque[_QueuedWalk] = deque()
        self._walk_queue_lanes = 0
        self._inflight: Deque[_Inflight] = deque()
        self._completed: List[WalkResult] = []
        self.walks_offered = 0
        self.walks_rejected = 0
        self.walks_admitted = 0      # dispatched to the engine
        self._next_rid = 0
        # update side (counted in edge lanes)
        self._update_queue: Deque[list] = deque()  # [ins, u, v, w, cursor,
        self._update_queue_lanes = 0               #  enqueue_tick]
        self.updates_offered = 0
        self.updates_rejected = 0
        self.updates_admitted = 0    # lanes flushed into the engine

    # -- admission ---------------------------------------------------------
    def submit_walk(self, starts) -> Optional[int]:
        """Admit one walk query (any size up to the largest bucket).

        Returns its request id, or ``None`` when backpressure rejects
        it — queue past the SLO depth, or a query no cohort can hold.
        """
        starts = np.asarray(starts, np.int32)
        n = int(starts.shape[0])
        self.walks_offered += 1
        if (n > self.engine.walk_buckets[-1]
                or self._walk_queue_lanes + n > self.cfg.max_walk_queue):
            self.walks_rejected += 1
            return None
        rid = self._next_rid
        self._next_rid += 1
        self._walk_queue.append(_QueuedWalk(rid, starts, self.clock()))
        self._walk_queue_lanes += n
        return rid

    def submit_update(self, is_insert, u, v, w) -> bool:
        """Admit one batch of edge updates; False = backpressure.

        Weights must safe-cast to the engine's bias dtype (float32 when
        ``cfg.fp_bias``, else int32): the coalescing window packs them
        into a pre-typed pad buffer, so a lossy dtype (float weights on
        an integer-bias engine) raises here, at admission, instead of
        silently truncating at flush time.
        """
        u = np.asarray(u, np.int32)
        w = np.asarray(w)
        w_dtype = np.float32 if self.engine.cfg.fp_bias else np.int32
        if not np.can_cast(w.dtype, w_dtype, casting="same_kind"):
            raise TypeError(
                f"weight dtype {w.dtype} does not safe-cast to the "
                f"engine's {np.dtype(w_dtype)} bias dtype "
                f"(fp_bias={self.engine.cfg.fp_bias}) — cast explicitly "
                "if truncation is intended")
        B = int(u.shape[0])
        self.updates_offered += B
        if self._update_queue_lanes + B > self.cfg.max_update_queue:
            self.updates_rejected += B
            return False
        self._update_queue.append(
            [np.asarray(is_insert, bool), u, np.asarray(v, np.int32),
             w.astype(w_dtype), 0, self.tick_count])
        self._update_queue_lanes += B
        return True

    # -- scheduling --------------------------------------------------------
    def tick(self) -> None:
        """One scheduling quantum: flush due update windows, dispatch
        walk cohorts against the published generation, harvest whatever
        finished — never blocking on device work."""
        self.tick_count += 1
        while self._update_queue_lanes >= self.cfg.update_lanes:
            self._flush_update_window()
        if self._update_queue and (
                self.tick_count - self._update_queue[0][5]
                >= self.cfg.max_update_delay):
            self._flush_update_window()          # deadline flush (padded)
        self._dispatch_walks()
        self._harvest(block=False)
        if (self.engine.defer_guard
                and self.engine.guard_backlog >= self.cfg.guard_drain_rounds):
            self._drain_guard()
            self._maybe_regrow()
        elif (len(self.engine.cfg.ladder) > 1
                and self.tick_count % self.cfg.guard_drain_rounds == 0):
            # unguarded engines never hit the drain branch; give their
            # ladder the same bounded-sync escalation cadence
            self._maybe_regrow()

    def poll(self) -> List[WalkResult]:
        """Harvest without blocking; returns (and clears) ready results."""
        self._harvest(block=False)
        out, self._completed = self._completed, []
        return out

    def drain(self) -> List[WalkResult]:
        """Flush every queue, block until the device catches up, settle
        guard accounting; returns all remaining results."""
        while self._update_queue or self._walk_queue or self._inflight:
            while self._update_queue:
                self._flush_update_window()
            self._dispatch_walks()
            self._harvest(block=True)
        self._drain_guard()
        self._maybe_regrow()
        out, self._completed = self._completed, []
        return out

    def close(self) -> List[WalkResult]:
        """``drain()`` then detach: restore the ``defer_guard`` mode the
        engine had before this scheduler flipped it, so later direct
        ``engine.ingest`` calls account per-round again."""
        out = self.drain()
        self.engine.defer_guard = self._prior_defer_guard
        return out

    # -- bookkeeping / contract --------------------------------------------
    def stats(self) -> dict:
        return {
            "generation": self.generation,
            "ticks": self.tick_count,
            "walks": {"offered": self.walks_offered,
                      "admitted": self.walks_admitted,
                      "rejected": self.walks_rejected,
                      "queued": len(self._walk_queue),
                      "inflight": len(self._inflight),
                      "completed": len(self._completed)},
            "updates": {"offered": self.updates_offered,
                        "admitted": self.updates_admitted,
                        "rejected": self.updates_rejected,
                        "queued_lanes": self._update_queue_lanes},
        }

    def check_conservation(self) -> None:
        """Backpressure conserves requests: admitted + rejected +
        queued == offered, on both streams, or raise."""
        wq = len(self._walk_queue)
        if self.walks_admitted + self.walks_rejected + wq \
                != self.walks_offered:
            raise AssertionError(
                f"walk conservation broken: {self.walks_admitted} + "
                f"{self.walks_rejected} + {wq} != {self.walks_offered}")
        if self.updates_admitted + self.updates_rejected \
                + self._update_queue_lanes != self.updates_offered:
            raise AssertionError(
                f"update conservation broken: {self.updates_admitted} + "
                f"{self.updates_rejected} + {self._update_queue_lanes} "
                f"!= {self.updates_offered}")

    # -- internals ---------------------------------------------------------
    def _flush_update_window(self) -> None:
        """Pack up to ``update_lanes`` queued edges into ONE padded
        §5.2 round, ingest it (async dispatch), bump the generation."""
        lanes = self.cfg.update_lanes
        w_dtype = np.float32 if self.engine.cfg.fp_bias else np.int32
        ins = np.ones(lanes, bool)
        uu = np.zeros(lanes, np.int32)
        vv = np.zeros(lanes, np.int32)
        ww = np.ones(lanes, w_dtype)
        n = 0
        while self._update_queue and n < lanes:
            q = self._update_queue[0]
            take = min(lanes - n, len(q[1]) - q[4])
            sl = slice(q[4], q[4] + take)
            ins[n:n + take] = q[0][sl]
            uu[n:n + take] = q[1][sl]
            vv[n:n + take] = q[2][sl]
            ww[n:n + take] = q[3][sl]
            q[4] += take
            n += take
            if q[4] == len(q[1]):
                self._update_queue.popleft()
        if n == 0:
            return
        self._update_queue_lanes -= n
        self.updates_admitted += n
        op = UpdateOp(ins, uu, vv, ww, n)
        self.trace.append(op)
        self.engine.ingest(op.is_insert, op.u, op.v, op.w,
                           n_valid=op.n_valid)
        self.generation += 1

    def _dispatch_walks(self) -> None:
        """Pack queued walk queries into cohorts (continuous batching)
        and dispatch them against the published generation."""
        max_b = self.engine.walk_buckets[-1]
        while self._walk_queue and len(self._inflight) < self.cfg.max_inflight:
            batch: List[_QueuedWalk] = []
            total = 0
            while self._walk_queue and \
                    total + len(self._walk_queue[0].starts) <= max_b:
                q = self._walk_queue.popleft()
                batch.append(q)
                total += len(q.starts)
            starts = np.concatenate([q.starts for q in batch])
            self._walk_queue_lanes -= total
            self.walks_admitted += len(batch)
            op = WalkOp(starts, tuple(q.rid for q in batch),
                        tuple(len(q.starts) for q in batch))
            self.trace.append(op)
            paths, ready = _to_host(self.engine.walk(starts, stitch=True))
            offs = np.cumsum([0] + list(op.sizes))
            self._inflight.append(_Inflight(
                paths, ready,
                tuple((q.rid, int(offs[i]), len(q.starts), q.t_submit)
                      for i, q in enumerate(batch)),
                self.generation))

    def _harvest(self, *, block: bool) -> None:
        """Collect finished cohorts in dispatch order.  Non-blocking
        mode stops at the first cohort whose device buffer is not
        ready (stream order: later cohorts cannot be ready before it).
        A sharded engine's harvest always blocks (module docstring).
        """
        block = block or self.engine.group is not None
        while self._inflight:
            head = self._inflight[0]
            if head.ready is not None:
                if not block and not head.ready.query():
                    return
                head.ready.synchronize()        # waits only when blocking
            rows = head.paths.numpy()
            t = self.clock()
            self._inflight.popleft()
            for rid, off, size, t_submit in head.entries:
                self._completed.append(WalkResult(
                    rid, rows[off:off + size], head.generation,
                    t - t_submit))

    def _drain_guard(self) -> None:
        if self.engine.guard is None or not self.engine.guard_backlog:
            return
        settled = self.engine.drain_guard()
        self.trace.append(DrainOp(settled))

    def _maybe_regrow(self) -> None:
        """Escalate the capacity ladder when pressure demands it — only
        ever called at drain points, so the ``want_regrow`` host sync
        is bounded by the drain cadence.  Loops: a burst that overshoots
        one tier climbs as many rungs as the pressure justifies.  Each
        escalation lands in the trace AFTER the drain's ``DrainOp``, so
        replay drains then regrows at exactly the same position."""
        eng = self.engine
        if len(eng.cfg.ladder) <= 1:
            return
        while eng.want_regrow(self.cfg.regrow_watermark):
            eng.regrow()
            self.trace.append(RegrowOp(eng.tier))
            self.generation += 1     # the state buffer was re-laid


def _to_host(paths: torch.Tensor):
    """``(host copy, event)``: on the card a non-blocking copy into
    pinned memory and an event recorded after it on the current stream;
    on the CPU a copy and None."""
    if paths.device.type != "cuda":
        return paths.clone(), None
    host = torch.empty(paths.shape, dtype=paths.dtype, pin_memory=True)
    host.copy_(paths, non_blocking=True)
    ready = torch.cuda.Event()
    ready.record()
    return host, ready


def replay_admission_trace(engine: DynamicWalkEngine, trace) -> List[np.ndarray]:
    """Serially replay an admission trace on a FRESH engine.

    The engine must be constructed exactly like the scheduler's (same
    initial state, config, seed, buckets, guard and shard layout).
    Returns the harvested paths of every ``WalkOp`` in trace order —
    the §12 staleness contract pins these bit-identical to what the
    overlapped scheduler served for the same ops.

    A guarded engine is flipped into the same deferred accounting mode
    ``ServingScheduler`` forces on the live engine: capacity-spill
    retries must run ONLY at the recorded ``DrainOp`` points, exactly
    where the live schedule ran them.  In per-round mode the engine
    would retry after every ingest with fresh deletes, mutating state
    between the trace's ops, and the replayed paths would diverge the
    moment a spill met a delete.  Over a sharded engine every rank
    replays the trace and gets the whole rows of every cohort.
    """
    if engine.guard is not None:
        engine.defer_guard = True     # mirror ServingScheduler.__init__
    out: List[np.ndarray] = []
    for op in trace:
        if isinstance(op, UpdateOp):
            engine.ingest(op.is_insert, op.u, op.v, op.w,
                          n_valid=op.n_valid)
        elif isinstance(op, WalkOp):
            out.append(engine.walk(op.starts, stitch=True).cpu().numpy())
        elif isinstance(op, DrainOp):
            engine.drain_guard()
        elif isinstance(op, RegrowOp):
            engine.regrow()          # never re-derive the trigger
        else:
            raise TypeError(f"unknown trace op {op!r}")
    engine.drain_guard()
    return out
