"""Streaming dynamic-walk serving: interleave update rounds with walks.

Port of the single-device path of ``repro/serve/dynwalk.py``.  A
``DynamicWalkEngine`` owns one ``BingoState`` and threads it through
alternating batched-update rounds (``ingest``, one update-kernel launch
each on the card) and walk batches (``walk``): whole walks, one
walk-kernel launch each, or with node2vec or ``whole_walk=False`` the
per-step path, one per-step kernel launch per step (per proposal trial
for node2vec).  Update rounds mutate the state's tensors in place — the
counterpart of the reference's donated buffers — so the caller must not
keep using the state it passed in; read ``engine.state``.

**Sharded mode** (``group=``, a ``torch.distributed`` process group of S
ranks, each running one engine): rank r keeps rows ``[r·V/S, (r+1)·V/S)``
of every state table (neighbour ids stay global).  ``ingest`` applies the
lanes whose source vertex the rank owns, with local ids, through one
update round of the shard-local config, and sums the ``UpdateStats`` over
the group; ``walk`` runs the exact walker relay (``distributed/relay.py``,
overlapped rounds by default) and returns this rank's home block of the
paths, rows ``[r·W/S, (r+1)·W/S)`` of the single-device engine's paths for
the same seed, bit for bit (``distributed.stitch`` gathers them).

The guard, capacity regrowth, walk buckets, deferred guard accounting and
the 2D vertex × walker layout come in later slices of the port.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Iterable, Iterator, Optional

import numpy as np
import torch

from repro_torch.core.alias import AliasTable
from repro_torch.core.backend import get_backend
from repro_torch.core.dyngraph import BingoConfig, BingoState
from repro_torch.core.updates import UpdateStats, make_updater
from repro_torch.core.walks import WalkParams, make_walker
from repro_torch.distributed.relay import make_relay, shard_index
from repro_torch.graph.streams import UpdateStream

__all__ = ["DynamicWalkEngine"]

_SEED_HI = (1 << 31) - 1     # walk seeds are drawn in [0, 2^31 - 1)


def _upload(x: np.ndarray, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(x))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _rounds_on_device(stream: UpdateStream, device, *, prefetch: int = 2,
                      coalesce: int = 1) -> Iterator[tuple]:
    """``(is_insert, u, v, w)`` rounds uploaded ``prefetch`` rounds ahead
    (asynchronous copies from pinned memory on the card), with
    ``coalesce`` consecutive rounds folded into one batch."""
    rounds = stream.is_insert.shape[0]
    if coalesce < 1:
        raise ValueError(f"coalesce must be >= 1; got {coalesce}")

    def host_round(j):
        sl = slice(j * coalesce, min((j + 1) * coalesce, rounds))
        return tuple(_upload(a[sl].reshape(-1), device) for a in
                     (stream.is_insert, stream.u, stream.v, stream.w))

    n = -(-rounds // coalesce)
    queue: deque = deque()
    nxt = 0
    while nxt < n and len(queue) < max(1, prefetch):
        queue.append(host_round(nxt))
        nxt += 1
    while queue:
        if nxt < n:
            queue.append(host_round(nxt))
            nxt += 1
        yield queue.popleft()


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
    ``group`` turns on the sharded mode (module docstring): ``state`` is
    the whole state, of which the engine keeps its rank's rows;
    ``mailbox_cap`` bounds the relay's walker mailboxes and
    ``relay_overlap`` picks its schedule.  After a sharded walk
    ``last_relay`` holds its rounds, mailbox overflow and peak slots, and
    setting ``relay_trace`` to a list collects the relay's per-round
    spans.
    """

    def __init__(self, state: BingoState, cfg: BingoConfig,
                 params: WalkParams = WalkParams(), *,
                 backend: Optional[str] = None,
                 whole_walk: Optional[bool] = None, seed: int = 0,
                 group=None, mailbox_cap: Optional[int] = None,
                 relay_overlap: bool = True):
        self.cfg = cfg
        self.params = params
        self.group = group
        self.num_shards, self.rank = 1, 0
        self.relay_trace: Optional[list] = None
        self.last_relay: Optional[dict] = None
        if group is None:
            self._state = state
            self._update = make_updater(cfg, backend=backend)
            self._walk = make_walker(state, cfg, params, backend=backend,
                                     whole_walk=whole_walk)
        else:
            import torch.distributed as dist
            if params.kind == "node2vec" or whole_walk is False:
                raise ValueError("the sharded engine relays whole walks "
                                 "(deepwalk/ppr/simple) only")
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
        self._gen = torch.Generator().manual_seed(seed)
        self.rounds_ingested = 0
        self.updates_applied = 0
        self.walks_served = 0
        self.last_seed: Optional[int] = None   # seed of the latest walk batch

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
        t = torch.as_tensor(x, device=self.device)
        return t if dtype is None else t.to(dtype)

    def ingest(self, is_insert, u, v, w, *,
               n_valid: Optional[int] = None) -> UpdateStats:
        """Apply one batched update round; returns its ``UpdateStats``.

        Every lane goes to the update pipeline, which rejects and counts
        lanes it cannot apply.  Lanes ``>= n_valid`` are padding: never
        applied and never counted.
        """
        B = int(u.shape[0])
        nv = B if n_valid is None else int(n_valid)
        if not 0 <= nv <= B:
            raise ValueError(f"n_valid {nv} outside round of {B} lanes")
        lanes = torch.arange(B, device=self.device) < nv
        u = self._as(u, torch.int32)
        if self.group is not None:
            # owner-masked lanes with local source ids; the stats sum
            lo = self.rank * self.shard_size
            lanes = lanes & (u >= lo) & (u < lo + self.shard_size)
            u = torch.where(lanes, u - lo, 0)
        self._state, stats = self._update(
            self._state, self._as(is_insert, torch.bool), u,
            self._as(v, torch.int32), self._as(w), lanes)
        if self.group is not None:
            stats = self._sum_stats(stats)
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
        largest degree over the group in sharded mode)."""
        dmax = self._state.deg.max()
        if self.group is not None:
            import torch.distributed as dist
            dmax = dmax.reshape(1).clone()
            dist.all_reduce(dmax, op=dist.ReduceOp.MAX, group=self.group)
            dmax = dmax[0]
        return dmax / self.cfg.capacity

    def walk(self, starts, seed: Optional[int] = None) -> torch.Tensor:
        """Serve one walk batch; returns ``(B, length+1)`` paths — in
        sharded mode this rank's ``(B/S, length+1)`` home block, and
        ``B`` must divide over the S ranks.

        ``seed`` keys the walk's randomness (the counter-hash stream of a
        whole walk, the generator of the per-step path); when None it is
        drawn from the engine's generator.  ``last_seed`` keeps it, so a
        batch can be replayed.
        """
        starts = self._as(starts, torch.int32).contiguous()
        if seed is None:
            seed = int(torch.randint(0, _SEED_HI, (1,), generator=self._gen))
        self.last_seed = seed
        if self.group is None:
            self._state, paths = self._walk(self._state, starts, seed)
        else:
            paths, rounds, ovf, peak = self._relay(
                self._state, starts, seed, trace=self.relay_trace)
            self.last_relay = {"rounds": rounds, "overflow": ovf,
                               "peak_slots": peak}
        self.walks_served += int(starts.shape[0])
        return paths

    def run_stream(self, stream: UpdateStream, starts, *,
                   coalesce: int = 1, prefetch: int = 2,
                   walks_per_round: int = 1) -> Iterable:
        """Drive a full update stream, walking between rounds.

        Yields ``(round_index, UpdateStats, paths)`` per coalesced round;
        ``paths`` stacks ``walks_per_round`` walk batches from
        ``starts``.  Rounds are uploaded ahead of use, so the copies
        overlap the previous round's device work.
        """
        if walks_per_round < 1:
            raise ValueError(
                f"walks_per_round must be >= 1; got {walks_per_round}")
        starts = self._as(starts, torch.int32).contiguous()
        for r, (ins, u, v, w) in enumerate(_rounds_on_device(
                stream, self.device, prefetch=prefetch, coalesce=coalesce)):
            stats = self.ingest(ins, u, v, w)
            paths = [self.walk(starts) for _ in range(walks_per_round)]
            yield r, stats, (torch.stack(paths) if walks_per_round > 1
                             else paths[0])
