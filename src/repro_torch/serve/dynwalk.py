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
  holding it (pad lanes start at vertex 0, or are -1 free relay slots in
  sharded mode) and the result sliced back; whole walks draw per (seed,
  lane, step), so real lanes are unchanged by the padding.  torch keeps
  no compiled-program cache to count, so
  ``walk_cache_size``/``update_cache_size`` return -1, as the
  reference's contract allows.

**Sharded mode** (``group=``, a ``torch.distributed`` process group of S
ranks, each running one engine on the same calls in the same order):
rank r keeps rows ``[r·V/S, (r+1)·V/S)`` of every state table (neighbour
ids stay global).  ``ingest`` applies the lanes whose source vertex the
rank owns, with local ids, through one update round of the shard-local
config, and sums the ``UpdateStats`` over the group; with ``guard=`` the
shard's classifier (``serve/guard.make_classifier``) codes the owned
lanes and one ``all_reduce`` gives every rank the whole round's codes, so
the guard's books are equal on every rank.  ``walk`` runs the exact
walker relay (``distributed/relay.py``, overlapped rounds by default);
it returns this rank's home block of the paths, or with ``stitch=True``
the whole rows.  The ladder regrows every rank's slice in lockstep (the
fill trigger is a max over the group), and ``audit`` and ``pressure``
count the whole state.  node2vec and per-step walks raise
``ValueError``.

**2D mode** (``mesh=``, a ``DeviceMesh``, with ``walker_axes=``, the
reference's vertex × walker mesh): the dims not named in ``walker_axes``
partition the vertices over S_v shards, the walker dims replicate them
over S_w walker groups.  A rank's vertex index, not its global rank,
sets its rows, so the S_w replicas of a shard hold the same rows and
apply the same owned lanes; stats, the classifier's codes and audits sum
over the vertex group only (a sum over every rank would count each lane
S_w times), the fill maximum over every rank.  Walks relay each walker
group's slice over its vertex shards (``make_relay(mesh=...)``); buckets
must divide over S_v·S_w.  ``group=`` with ``walker_axes`` raises the
reference's "not in mesh": a plain group has no named axes.
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
from repro_torch.distributed.relay import make_relay, relay_layout
from repro_torch.distributed.relay import stitch as stitch_blocks
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
    collects the relay's per-round spans.  ``mesh`` and ``walker_axes``
    turn on the 2D mode (module docstring) in place of ``group``.
    ``rank`` is the rank's vertex index (its rows start at ``rank ·
    shard_size``), ``walker_group`` its walker group, ``num_shards`` the
    vertex shards, ``num_groups`` the walker groups and ``root`` whether
    it is vertex shard 0 of walker group 0, the rank that writes
    snapshots and logs.
    """

    def __init__(self, state: BingoState, cfg: BingoConfig,
                 params: WalkParams = WalkParams(), *,
                 backend: Optional[str] = None,
                 whole_walk: Optional[bool] = None, seed: int = 0,
                 group=None, mailbox_cap: Optional[int] = None,
                 guard=None, walk_buckets=None, defer_guard: bool = False,
                 walker_axes=(), relay_overlap: bool = True, mesh=None):
        self.cfg = cfg
        self.params = params
        self.group = group
        self.mesh = mesh
        self.walker_axes = walker_axes
        self._backend = backend
        self._whole_walk = whole_walk
        self._mailbox_cap = mailbox_cap
        self._relay_overlap = relay_overlap
        self.relay_trace: Optional[list] = None
        self.last_relay: Optional[dict] = None
        self.regrow_counts = [0] * len(cfg.ladder)   # per ladder tier
        # the vertex group, the group of every rank, this rank's place;
        # raises for walker_axes on a plain group or not in the mesh
        lay = relay_layout(group, mesh=mesh, walker_axes=walker_axes)
        self.sharded = group is not None or mesh is not None
        if self.sharded and (params.kind == "node2vec"
                             or whole_walk is False):
            raise ValueError("the sharded engine relays whole walks "
                             "(deepwalk/ppr/simple) only")
        self.vertex_group, self.sync_group = lay.group, lay.sync_group
        self.num_shards, self.num_groups = lay.num_shards, lay.num_groups
        self.rank, self.walker_group, self.root = lay.sidx, lay.gidx, lay.root
        self._block = lay.gidx * lay.num_shards + lay.sidx
        self.shard_size = cfg.num_vertices // self.num_shards
        self._update, self._walk = self._programs(cfg)  # validates V % S
        lo = self.rank * self.shard_size
        self._state = state if not self.sharded else _map_state(
            state, lambda x: x[lo:lo + self.shard_size].clone())
        # Fixed-lane walk cohorts (DESIGN.md §12): every walk batch is
        # padded up to the smallest bucket >= its request count; the
        # relay needs each bucket to divide over the shards (S_v·S_w).
        self.walk_buckets = None
        if walk_buckets:
            self.walk_buckets = tuple(sorted(int(b) for b in walk_buckets))
            n = self.num_shards * self.num_groups
            for b in self.walk_buckets:
                if b < 1 or b % n:
                    raise ValueError(
                        f"walk bucket {b} must be a positive multiple of "
                        f"the shard count ({n})")
        # guard=True -> default policy; guard=GuardPolicy(...) -> custom.
        # Sharded, the classifier codes this rank's lanes and sums the
        # codes over the vertex group.
        self.guard: Optional[IngestGuard] = None
        if guard:
            policy = guard if isinstance(guard, GuardPolicy) \
                else GuardPolicy()
            shard = {} if not self.sharded else dict(
                offset=self.rank * self.shard_size, rows=self.shard_size,
                group=self.vertex_group)
            self.guard = IngestGuard(cfg, policy, **shard)
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
        """The ``(update, walk)`` closures at ``cfg``'s capacity tier:
        sharded, the shard-local updater and the relay."""
        if not self.sharded:
            return (make_updater(cfg, backend=self._backend),
                    make_walker(None, cfg, self.params,
                                backend=self._backend,
                                whole_walk=self._whole_walk))
        bk = get_backend(cfg.backend if self._backend is None
                         else self._backend)
        return (make_updater(self._local(cfg), backend=self._backend),
                make_relay(bk, cfg, self.params, self.group, mesh=self.mesh,
                           walker_axes=self.walker_axes,
                           mailbox_cap=self._mailbox_cap,
                           overlap=self._relay_overlap, diagnostics=True))

    def _local(self, cfg: BingoConfig) -> BingoConfig:
        """``cfg`` of this rank's rows (``cfg`` itself on one device)."""
        return dataclasses.replace(cfg, num_vertices=self.shard_size)

    def _owned(self, u, lanes):
        """``(source ids local to this rank, lanes it owns)``; on one
        device ``(u, lanes)``."""
        if not self.sharded:
            return u, lanes
        lo = self.rank * self.shard_size
        lanes = lanes & (u >= lo) & (u < lo + self.shard_size)
        return torch.where(lanes, u - lo, 0), lanes

    @property
    def state(self) -> BingoState:
        """The current sampling space (updated in place by ``ingest``);
        this rank's vertex slice in sharded mode."""
        return self._state

    def gather_state(self, dst: Optional[int] = None) -> BingoState:
        """The whole state: every rank's slice, all-gathered over the
        vertex group in sharded mode (a collective: every rank calls it).
        With ``dst`` only vertex shard ``dst`` of walker group 0 receives
        it (``gather``; the other walker groups hold the same rows and
        take no part) and the others get None."""
        if not self.sharded:
            return self._state
        if self.num_shards == 1:
            return self._state if dst is None or self.root else None
        if dst is not None and self._block >= self.num_shards:
            return None                          # not walker group 0
        import torch.distributed as dist
        S, me = self.num_shards, self.rank

        def gather(x):
            x = x.contiguous()
            if dst is None:
                parts = [torch.empty_like(x) for _ in range(S)]
                dist.all_gather(parts, x, group=self.vertex_group)
                return torch.cat(parts)
            parts = [torch.empty_like(x) for _ in range(S)] \
                if me == dst else None
            dist.gather(x, parts,
                        dst=dist.get_global_rank(self.vertex_group, dst),
                        group=self.vertex_group)
            return torch.cat(parts) if me == dst else x
        out = _map_state(self._state, gather)
        return out if dst is None or me == dst else None

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
        if self.guard is None:
            self._state, stats = self._apply(ins, u, v, w, lanes)
            self.rounds_ingested += 1
            self.updates_applied += nv
            return stats._replace(max_fill=self._fill())

        g = self.guard
        rnd = self.rounds_ingested
        # global ids in, the whole round's codes out (every rank)
        reasons = g.classify(self._state, ins, u, v, w)
        self._state, stats = self._apply(ins, u, v, w,
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

    def _apply(self, ins, u, v, w, lanes):
        """One update round of ``lanes`` (global source ids): sharded,
        the owned lanes with local ids and the stats summed over the
        vertex group (each walker group's replica applies the same
        lanes: they count once)."""
        lu, lanes = self._owned(u, lanes)
        state, stats = self._update(self._state, ins, lu, v, w, lanes)
        if self.vertex_group is not None:
            stats = self._sum_stats(stats)
        return state, stats

    def _sum_stats(self, stats: UpdateStats) -> UpdateStats:
        """``UpdateStats`` summed over the vertex group, in one
        all-reduce."""
        import torch.distributed as dist
        parts = [x.reshape(-1).to(torch.int64) for x in stats[:4]]
        flat = torch.cat(parts)
        dist.all_reduce(flat, group=self.vertex_group)
        out = [p.reshape(x.shape).to(torch.int32) for p, x in
               zip(flat.split([p.numel() for p in parts]), stats[:4])]
        return UpdateStats(*out)

    def _fill(self) -> torch.Tensor:
        """Fill watermark ``max(deg) / capacity`` as a device scalar (the
        largest degree over every rank in sharded mode); no host sync."""
        dmax = self._state.deg.max()
        if self.sync_group is not None:
            import torch.distributed as dist
            dmax = dmax.reshape(1).clone()
            dist.all_reduce(dmax, op=dist.ReduceOp.MAX,
                            group=self.sync_group)
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
        self._state, rstats = self._apply(r_ins, ru, rv, rw,
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
        Sharded, every rule counts rows, so one ``all_reduce`` of the
        counts over the vertex group gives every rank the whole state's
        (each row once: the walker groups' replicas are not summed).
        """
        from repro_torch.core.invariants import (DEVICE_RULES,
                                                 check_state_device)
        pend = len(self.guard.pending) \
            if (pressure and self.guard is not None) else 0
        counts = check_state_device(self._state, self.cfg, pend)
        if self.vertex_group is not None:
            import torch.distributed as dist
            dist.all_reduce(counts, group=self.vertex_group)
        counts = counts.tolist()
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
        engine keeps no other reference to the old ones.  Sharded, each
        rank migrates its rows at the shard-local configs, in lockstep."""
        t = self.tier
        ncfg = self.cfg.tier_config(t + 1)
        self._state = regrow_state(self._state, self._local(self.cfg),
                                   self._local(ncfg))
        self.cfg = ncfg
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

    def walk(self, starts, seed: Optional[int] = None, *,
             stitch: bool = False) -> torch.Tensor:
        """Serve one walk batch of ``n`` starts; returns ``(n, length+1)``
        paths.

        ``seed`` keys the walk's randomness (the counter-hash stream of a
        whole walk, the generator of the per-step path); when None it is
        drawn from the engine's generator.  ``last_seed`` keeps it, so a
        batch can be replayed.  With ``walk_buckets=`` the batch is
        padded to its bucket ``B`` and the result cut back to the real
        rows; ``walks_served`` counts real rows.

        Sharded, every rank passes the same starts, the padded batch
        ``B`` (``n`` without buckets) must divide over the S ranks and pad
        lanes are -1 free relay slots.  Rank r returns its home block:
        rows ``[r·B/S, (r+1)·B/S)`` of the padded batch cut to the real
        rows, i.e. rows ``[r·B/S, min((r+1)·B/S, n))`` of the paths (empty
        past ``n``); on a 2D mesh S = S_v·S_w and r = g·S_v + v for vertex
        shard v of walker group g.  ``stitch=True`` gathers the blocks
        over every rank (a collective) and returns the whole ``(n,
        length+1)`` rows on every rank.
        """
        starts = self._as(starts, torch.int32).contiguous()
        n = int(starts.shape[0])
        if seed is None:
            seed = self._next_seed()
        self.last_seed = seed
        B = n if self.walk_buckets is None else self._bucket_for(n)
        if B != n:
            fill = -1 if self.sharded else 0
            starts = torch.cat([starts, torch.full(
                (B - n,), fill, dtype=torch.int32, device=self.device)])
        self.walks_served += n
        if not self.sharded:
            self._state, paths = self._walk(self._state, starts, seed)
            return paths[:n] if B != n else paths
        home, rounds, ovf, peak = self._walk(self._state, starts, seed,
                                             trace=self.relay_trace)
        self.last_relay = {"rounds": rounds, "overflow": ovf,
                           "peak_slots": peak}
        if stitch:
            return stitch_blocks(home, self.group, mesh=self.mesh,
                                 walker_axes=self.walker_axes)[:n]
        lo = self._block * (B // (self.num_shards * self.num_groups))
        return home[:max(0, min(home.shape[0], n - lo))]

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
