"""Streaming dynamic-walk serving: interleave update rounds with walks.

Port of ``repro/serve/dynwalk.py``.  A ``DynamicWalkEngine`` owns one
``BingoState`` and threads it through alternating batched-update rounds
(``ingest``, one update-kernel launch each on the card) and walk batches
(``walk``): whole walks, one walk-kernel launch each, or with node2vec or
``whole_walk=False`` the per-step path, one per-step kernel launch per
step (per proposal trial for node2vec).  Update rounds mutate the state's
tensors in place — the counterpart of the reference's donated buffers —
so the caller must not keep using the state it passed in; read
``engine.state``.  Everything runs on the current stream, so a walk
dispatched before an in-place ingest reads the state as it was (stream
order does what donation does in the reference).

The serving layer (DESIGN.md §11–14), on one device:

* ``guard=`` (``serve/guard.py``): the classifier runs before each round,
  only OK lanes are applied, rejects go to quarantine and capacity
  overflows to a pending queue, retried after deletes or a regrow
  (``retry_rounds`` counts those update rounds).  ``defer_guard=True``
  parks each round's reason vector in a backlog, with no host sync, and
  ``drain_guard()`` settles a window of them at once.
* the capacity ladder (``cfg.capacity_ladder``): ``want_regrow``,
  ``regrow`` (settle the backlog, migrate the state with
  ``core/dyngraph.regrow_state``, re-target the guard, retry the pending
  inserts), ``tier``, ``max_fill``, ``pressure`` and
  ``audit(pressure=)`` (``core/invariants.check_state_device``).
* ``walk_buckets=``: a walk batch is padded up to the smallest bucket
  holding it (pad lanes start at vertex 0) and the result sliced back;
  whole walks draw per (seed, lane, step), so real lanes are unchanged
  by the padding.  torch keeps no compiled-program cache to count, so
  ``walk_cache_size``/``update_cache_size`` return -1, as the
  reference's contract allows.

**Sharded mode** (``group=``, a ``torch.distributed`` process group of S
ranks, each running one engine): rank r keeps rows ``[r·V/S, (r+1)·V/S)``
of every state table (neighbour ids stay global).  ``ingest`` applies the
lanes whose source vertex the rank owns, with local ids, through one
update round of the shard-local config, and sums the ``UpdateStats`` over
the group; ``walk`` runs the exact walker relay (``distributed/relay.py``,
overlapped rounds by default) and returns this rank's home block of the
paths, rows ``[r·W/S, (r+1)·W/S)`` of the single-device engine's paths for
the same seed, bit for bit (``distributed.stitch`` gathers them).  The
guard, walk buckets, deferred accounting and a capacity ladder of more
than one rung are not ported to the sharded engine yet (ROADMAP A.7):
asking for them with ``group=`` raises ``ValueError``.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

import numpy as np
import torch

from repro_torch.core.alias import AliasTable
from repro_torch.core.backend import get_backend
from repro_torch.core.dyngraph import BingoConfig, BingoState, regrow_state
from repro_torch.core.updates import (NUM_REASONS, R_OK, UpdateStats,
                                      make_updater)
from repro_torch.core.walks import WalkParams, make_walker
from repro_torch.distributed.relay import make_relay, shard_index
from repro_torch.graph.streams import UpdateStream, rounds_on_device, upload
from repro_torch.serve.guard import GuardPolicy, IngestGuard

__all__ = ["DynamicWalkEngine"]

_SEED_HI = (1 << 31) - 1     # walk seeds are drawn in [0, 2^31 - 1)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _map_state(state: BingoState, fn) -> BingoState:
    """``state`` with ``fn`` applied to every tensor leaf."""
    return BingoState(*[None if x is None else fn(x) for x in state[:-1]],
                      itable=AliasTable(*map(fn, state.itable)))


class DynamicWalkEngine:
    """One dynamic graph on one device, or one vertex shard of it, serving
    update rounds and walks.

    ``seed`` seeds the engine's own ``torch.Generator``, from which
    ``walk`` draws a walk seed when the caller gives none.  ``whole_walk``
    is passed to ``random_walk`` (False pins the per-step path).
    ``guard`` (True or a ``GuardPolicy``), ``walk_buckets`` and
    ``defer_guard`` turn on the serving layer (module docstring).
    ``group`` turns on the sharded mode: ``state`` is the whole state, of
    which the engine keeps its rank's rows; ``mailbox_cap`` bounds the
    relay's walker mailboxes and ``relay_overlap`` picks its schedule.
    After a sharded walk ``last_relay`` holds its rounds, mailbox
    overflow and peak slots, and setting ``relay_trace`` to a list
    collects the relay's per-round spans.
    """

    def __init__(self, state: BingoState, cfg: BingoConfig,
                 params: WalkParams = WalkParams(), *,
                 backend: Optional[str] = None,
                 whole_walk: Optional[bool] = None, seed: int = 0,
                 group=None, mailbox_cap: Optional[int] = None,
                 guard=None, walk_buckets=None, defer_guard: bool = False,
                 relay_overlap: bool = True):
        self.cfg = cfg
        self.params = params
        self.group = group
        self._backend = backend
        self._whole_walk = whole_walk
        self.num_shards, self.rank = 1, 0
        self.relay_trace: Optional[list] = None
        self.last_relay: Optional[dict] = None
        self.regrow_counts = [0] * len(cfg.ladder)   # per ladder tier
        if group is None:
            self._state = state
            self._update, self._walk = self._programs(cfg)
        else:
            import torch.distributed as dist
            if params.kind == "node2vec" or whole_walk is False:
                raise ValueError("the sharded engine relays whole walks "
                                 "(deepwalk/ppr/simple) only")
            if guard or walk_buckets or defer_guard or len(cfg.ladder) > 1:
                raise ValueError(
                    "guard=, walk_buckets=, defer_guard= and a capacity "
                    "ladder of more than one rung are not ported to the "
                    "sharded engine yet (ROADMAP A.7, the sharded tier "
                    "half)")
            self.num_shards = dist.get_world_size(group)
            self.rank = shard_index(group)
            self._relay = make_relay(   # validates V % S
                get_backend(cfg.backend if backend is None else backend),
                cfg, params, group, mailbox_cap=mailbox_cap,
                overlap=relay_overlap, diagnostics=True)
            self.shard_size = cfg.num_vertices // self.num_shards
            lo = self.rank * self.shard_size
            self._state = _map_state(
                state, lambda x: x[lo:lo + self.shard_size].clone())
            self._update = make_updater(
                dataclasses.replace(cfg, num_vertices=self.shard_size),
                backend=backend)
        # Fixed-lane walk cohorts (DESIGN.md §12): every walk batch is
        # padded up to the smallest bucket >= its request count.
        self.walk_buckets = None
        if walk_buckets:
            self.walk_buckets = tuple(sorted(int(b) for b in walk_buckets))
            for b in self.walk_buckets:
                if b < 1:
                    raise ValueError(f"walk bucket {b} must be positive")
        # guard=True -> default policy; guard=GuardPolicy(...) -> custom.
        self.guard: Optional[IngestGuard] = None
        if guard:
            policy = guard if isinstance(guard, GuardPolicy) \
                else GuardPolicy()
            self.guard = IngestGuard(cfg, policy)
        # defer_guard=True moves quarantine/retry accounting off the
        # ingest path: rounds park their device-side reason vectors in a
        # backlog and ``drain_guard()`` settles them in one pass.
        self.defer_guard = bool(defer_guard)
        self._guard_backlog: list = []
        self._gen = torch.Generator().manual_seed(seed)
        self.rounds_ingested = 0
        self.updates_applied = 0
        self.walks_served = 0
        self.retry_rounds = 0          # guard retry rounds applied
        self.last_seed: Optional[int] = None   # seed of the latest walk batch

    def _programs(self, cfg: BingoConfig):
        """The ``(update, walk)`` closures at ``cfg``'s capacity tier."""
        return (make_updater(cfg, backend=self._backend),
                make_walker(None, cfg, self.params, backend=self._backend,
                            whole_walk=self._whole_walk))

    @property
    def state(self) -> BingoState:
        """The current sampling space (updated in place by ``ingest``);
        this rank's vertex slice in sharded mode."""
        return self._state

    def gather_state(self) -> BingoState:
        """The whole state: every rank's slice, all-gathered over the
        group in sharded mode (a collective: every rank calls it)."""
        if self.group is None:
            return self._state
        import torch.distributed as dist

        def gather(x):
            parts = [torch.empty_like(x) for _ in range(self.num_shards)]
            dist.all_gather(parts, x.contiguous(), group=self.group)
            return torch.cat(parts)
        return _map_state(self._state, gather)

    @property
    def device(self) -> torch.device:
        return self._state.nbr.device

    def _as(self, x, dtype=None) -> torch.Tensor:
        """``x`` as a tensor on the engine's device; host data is uploaded
        without a host sync (``graph/streams.upload``)."""
        if not isinstance(x, torch.Tensor) or x.device != self.device:
            x = upload(np.asarray(x) if not isinstance(x, torch.Tensor)
                       else x, self.device)
        return x if dtype is None else x.to(dtype)

    # -- serving surface -----------------------------------------------------
    def ingest(self, is_insert, u, v, w, *,
               n_valid: Optional[int] = None) -> UpdateStats:
        """Apply one batched update round; returns its ``UpdateStats``.

        Unguarded, every lane goes to the update pipeline, which rejects
        and counts lanes it cannot apply.  With ``guard=`` the classifier
        runs first: only OK lanes are applied, rejects land in the
        quarantine buffer / pending-overflow queue, and the returned
        ``rejected`` counters carry the guard's reason tally.  Pending
        capacity overflows are retried — one bounded batch — after any
        round whose deletes may have freed slots.

        Lanes ``>= n_valid`` are padding: never applied, never
        classified into the books, never counted.

        With ``defer_guard=True`` the round's reason vector is parked in
        a backlog (the returned stats carry a device-computed reason
        tally; no host sync) and ``drain_guard()`` settles the
        quarantine/retry accounting later.
        """
        B = int(u.shape[0])
        nv = B if n_valid is None else int(n_valid)
        if not 0 <= nv <= B:
            raise ValueError(f"n_valid {nv} outside round of {B} lanes")
        lanes = torch.arange(B, device=self.device) < nv
        ins = self._as(is_insert, torch.bool)
        u = self._as(u, torch.int32)
        v = self._as(v, torch.int32)
        w = self._as(w)
        if self.group is not None:
            # owner-masked lanes with local source ids; the stats sum
            lo = self.rank * self.shard_size
            lanes = lanes & (u >= lo) & (u < lo + self.shard_size)
            u = torch.where(lanes, u - lo, 0)
        if self.guard is None:
            self._state, stats = self._update(self._state, ins, u, v, w,
                                              lanes)
            if self.group is not None:
                stats = self._sum_stats(stats)
            self.rounds_ingested += 1
            self.updates_applied += nv
            return stats._replace(max_fill=self._fill())

        g = self.guard
        rnd = self.rounds_ingested
        reasons = g.classify(self._state, ins, u, v, w)
        self._state, stats = self._update(self._state, ins, u, v, w,
                                          lanes & (reasons == R_OK))
        if self.defer_guard:
            # device-side tally of the rejected lanes (pad and OK lanes add
            # nothing); the host never waits
            tally = torch.zeros(NUM_REASONS, dtype=torch.int32,
                                device=self.device).scatter_add_(
                0, reasons.to(torch.int64),
                (lanes & (reasons != R_OK)).to(torch.int32))
            stats = stats._replace(rejected=stats.rejected + tally)
            self._guard_backlog.append(       # copies: callers may reuse
                (rnd, ins.clone(), u.clone(), v.clone(), w.clone(),
                 reasons, stats.del_applied, nv))
            self.rounds_ingested += 1
            self.updates_applied += nv
            return stats._replace(max_fill=self._fill())
        counts = g.account(rnd, _host(ins)[:nv], _host(u)[:nv],
                           _host(v)[:nv], _host(w)[:nv],
                           _host(reasons)[:nv])
        g.deletes_since_retry += int(stats.del_applied)
        stats = stats._replace(rejected=stats.rejected + torch.as_tensor(
            counts, dtype=torch.int32).to(self.device))
        rstats = self._run_guard_retry(rnd)
        if rstats is not None:
            stats = stats._replace(
                ins_applied=stats.ins_applied + rstats.ins_applied,
                transitions=stats.transitions + rstats.transitions)
        self.rounds_ingested += 1
        self.updates_applied += nv
        return stats._replace(max_fill=self._fill())

    def _sum_stats(self, stats: UpdateStats) -> UpdateStats:
        """``UpdateStats`` summed over the group, in one all-reduce."""
        import torch.distributed as dist
        parts = [x.reshape(-1).to(torch.int64) for x in stats[:4]]
        flat = torch.cat(parts)
        dist.all_reduce(flat, group=self.group)
        out = [p.reshape(x.shape).to(torch.int32) for p, x in
               zip(flat.split([p.numel() for p in parts]), stats[:4])]
        return UpdateStats(*out)

    def _fill(self) -> torch.Tensor:
        """Fill watermark ``max(deg) / capacity`` as a device scalar (the
        largest degree over the group in sharded mode); no host sync."""
        dmax = self._state.deg.max()
        if self.group is not None:
            import torch.distributed as dist
            dmax = dmax.reshape(1).clone()
            dist.all_reduce(dmax, op=dist.ReduceOp.MAX, group=self.group)
            dmax = dmax[0]
        return dmax / self.cfg.capacity

    def _run_guard_retry(self, rnd) -> Optional[UpdateStats]:
        """One bounded pending-overflow retry batch, if deletes (or a
        regrow) since the last retry may have made capacity.  Returns
        the retry round's stats when lanes applied, else None."""
        if not self.guard.want_retry():
            return None
        return self._retry_batch(rnd)

    def _retry_batch(self, rnd) -> Optional[UpdateStats]:
        """One unconditional fixed-shape retry round of pending inserts."""
        g = self.guard
        entries, ru, rv, rw = g.take_retry()
        r_ins = torch.ones(g.policy.retry_batch, dtype=torch.bool,
                           device=self.device)
        ru, rv, rw = self._as(ru), self._as(rv), self._as(rw)
        r_reasons = g.classify(self._state, r_ins, ru, rv, rw)
        self._state, rstats = self._update(self._state, r_ins, ru, rv, rw,
                                           r_reasons == R_OK)
        self.retry_rounds += 1
        applied = g.settle_retry(rnd, entries, _host(r_reasons))
        return rstats if applied else None

    @property
    def guard_backlog(self) -> int:
        """Rounds whose guard accounting awaits ``drain_guard()``."""
        return len(self._guard_backlog)

    def drain_guard(self) -> int:
        """Settle deferred guard accounting for every backlogged round.

        Copies the backlog's reason vectors to the host, routes rejects
        to quarantine / the pending queue (``IngestGuard.account``), then
        runs at most one bounded capacity-retry batch against the
        *current* state (retries happen at drain points, not
        mid-window).  Returns the number of rounds settled.  No-op
        without a guard or with an empty backlog; after it,
        ``guard.check_conservation()`` holds.
        """
        g = self.guard
        if g is None or not self._guard_backlog:
            return 0
        backlog, self._guard_backlog = self._guard_backlog, []
        for rnd, ins, u, v, w, reasons, dels, nv in backlog:
            g.account(rnd, _host(ins)[:nv], _host(u)[:nv], _host(v)[:nv],
                      _host(w)[:nv], _host(reasons)[:nv])
            g.deletes_since_retry += int(dels)
        self._run_guard_retry(self.rounds_ingested)
        return len(backlog)

    def audit(self, *, pressure: bool = False) -> dict:
        """Invariant sweep of the live state (DESIGN.md §11).

        Returns ``{rule: violating-vertex count}`` over
        ``core/invariants.check_state_device`` — all-zero for a healthy
        state; one host sync reads the counts.  ``pressure=True`` feeds
        the guard's pending-insert depth to the ``at_capacity`` rule and
        appends the gauges of ``pressure()`` under non-rule keys.
        """
        from repro_torch.core.invariants import (DEVICE_RULES,
                                                 check_state_device)
        pend = len(self.guard.pending) \
            if (pressure and self.guard is not None) else 0
        counts = check_state_device(self._state, self.cfg, pend).tolist()
        out = dict(zip(DEVICE_RULES, counts))
        if pressure:
            out.update(self.pressure())
        return out

    # -- capacity regrowth (DESIGN.md §14) -----------------------------------
    @property
    def tier(self) -> int:
        """Current rung of the capacity ladder."""
        return self.cfg.tier

    def max_fill(self) -> float:
        """Host-synced fill watermark ``max(deg) / capacity``."""
        return float(self._fill())

    def pressure(self) -> dict:
        """Capacity-pressure gauges: fill watermark, ladder position,
        per-tier regrow counts, pending-insert queue depth."""
        return {
            "max_fill": self.max_fill(),
            "tier": self.tier,
            "capacity": self.cfg.capacity,
            "pending_depth": len(self.guard.pending)
            if self.guard is not None else 0,
            "regrow_counts": list(self.regrow_counts),
        }

    def want_regrow(self, watermark: float = 0.95) -> bool:
        """Should the engine escalate to the next ladder tier?

        True when a next tier exists and either capacity overflows are
        queued (pending inserts) or the fill watermark crossed
        ``watermark``.  One host sync; schedulers call this at drain
        points only.
        """
        if self.tier + 1 >= len(self.cfg.ladder):
            return False
        if self.guard is not None and self.guard.pending:
            return True
        return self.max_fill() >= watermark

    def _migrate(self) -> None:
        """The state and the closures moved to the next tier.  The old
        and the new tables live side by side during ``regrow_state``; the
        engine keeps no other reference to the old ones."""
        t = self.tier
        self._state = regrow_state(self._state, self.cfg,
                                   self.cfg.tier_config(t + 1))
        self.cfg = self.cfg.tier_config(t + 1)
        self.regrow_counts[t + 1] += 1
        self._update, self._walk = self._programs(self.cfg)

    def regrow(self) -> BingoConfig:
        """Escalate the live state to the next capacity tier.

        In the reference's order: (1) settle any deferred guard
        accounting at the old tier; (2) migrate the state
        (``regrow_state``: bit-identical to ``from_edges`` at the new
        capacity); (3) re-target the guard and restore pending retry
        budgets; (4) retry the pending queue against the grown state
        until it empties or a batch applies nothing (entries still over
        the new capacity wait for the next tier or deletes).

        Raises ``ValueError`` at the top of the ladder.
        """
        if self.tier + 1 >= len(self.cfg.ladder):
            raise ValueError(
                f"already at the top tier of capacity ladder "
                f"{self.cfg.ladder}")
        if self.defer_guard:
            self.drain_guard()
        self._migrate()
        g = self.guard
        if g is not None:
            g.regrow(self.cfg)
            while g.pending:
                before = len(g.pending)
                self._retry_batch(self.rounds_ingested)
                if len(g.pending) >= before:
                    break   # survivors exceed even C': wait for the next
                            # tier (or deletes); never quarantine here
        return self.cfg

    def _bucket_for(self, n: int) -> int:
        for b in self.walk_buckets:
            if b >= n:
                return b
        raise ValueError(
            f"walk batch of {n} requests exceeds the largest lane bucket "
            f"{self.walk_buckets[-1]} — split the batch or widen "
            f"walk_buckets")

    def _next_seed(self) -> int:
        """The next walk seed from the engine's generator."""
        return int(torch.randint(0, _SEED_HI, (1,), generator=self._gen))

    def walk(self, starts, seed: Optional[int] = None) -> torch.Tensor:
        """Serve one walk batch; returns ``(B, length+1)`` paths — in
        sharded mode this rank's ``(B/S, length+1)`` home block, and
        ``B`` must divide over the S ranks.

        ``seed`` keys the walk's randomness (the counter-hash stream of a
        whole walk, the generator of the per-step path); when None it is
        drawn from the engine's generator.  ``last_seed`` keeps it, so a
        batch can be replayed.  With ``walk_buckets=`` the batch is
        padded to its bucket (pad lanes start at vertex 0) and the result
        sliced back to the real rows; ``walks_served`` counts real rows.
        """
        starts = self._as(starts, torch.int32).contiguous()
        n = int(starts.shape[0])
        if seed is None:
            seed = self._next_seed()
        self.last_seed = seed
        B = n if self.walk_buckets is None else self._bucket_for(n)
        if B != n:
            starts = torch.cat([starts, torch.zeros(
                B - n, dtype=torch.int32, device=self.device)])
        if self.group is None:
            self._state, paths = self._walk(self._state, starts, seed)
        else:
            paths, rounds, ovf, peak = self._relay(
                self._state, starts, seed, trace=self.relay_trace)
            self.last_relay = {"rounds": rounds, "overflow": ovf,
                               "peak_slots": peak}
        self.walks_served += n
        return paths[:n] if B != n else paths

    def walk_cache_size(self) -> int:
        """Compiled-program count of the walk closures: torch keeps no
        such cache, so -1 ("not exposed", the reference's contract)."""
        return -1

    def update_cache_size(self) -> int:
        """Compiled-program count of the update closures: -1, as
        ``walk_cache_size``."""
        return -1

    def run_stream(self, stream: UpdateStream, starts, *,
                   coalesce: int = 1, prefetch: int = 2,
                   walks_per_round: int = 1) -> Iterable:
        """Drive a full update stream, walking between rounds.

        Yields ``(round_index, UpdateStats, paths)`` per coalesced round;
        ``paths`` stacks ``walks_per_round`` walk batches from
        ``starts``.  Rounds are uploaded ahead of use
        (``graph/streams.rounds_on_device``), so the copies overlap the
        previous round's device work.
        """
        if walks_per_round < 1:
            raise ValueError(
                f"walks_per_round must be >= 1; got {walks_per_round}")
        starts = self._as(starts, torch.int32).contiguous()
        for r, (ins, u, v, w) in enumerate(rounds_on_device(
                stream, prefetch=prefetch, coalesce=coalesce,
                device=self.device)):
            stats = self.ingest(ins, u, v, w)
            paths = [self.walk(starts) for _ in range(walks_per_round)]
            yield r, stats, (torch.stack(paths) if walks_per_round > 1
                             else paths[0])
