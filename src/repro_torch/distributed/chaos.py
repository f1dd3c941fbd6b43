"""Seeded fault injection for the walker relay (DESIGN.md §11).

Port of ``repro/distributed/chaos.py`` on a ``torch.distributed`` group in
place of a mesh.  The relay's conservation claim — no walker is ever
silently dropped, mailbox overflow is re-enqueued, paths stitch bit for
bit at any shard count — holds only if it survives a hostile transport.
A ``ChaosSchedule`` seeds a deterministic fault stream over the mailbox
exchange (``relay_local``'s ``exchange_fn`` hook) that can

  * **drop** payload rows (a lost message — unrecoverable: the relay must
    *detect* it, not paper over it),
  * **duplicate** rows into free payload rows (an at-least-once transport;
    recoverable because a walker's draws are the counter hash of (seed,
    wid, t): both copies walk the same path, the home block keeps the max
    of equal values, and the queues keep the first copy of a wid),
  * **delay** rows by a round (re-queued through the sender's leftover
    buffer, which the relay retries),
  * **cap-starve** the mailboxes (``mailbox_cap=1``: just more rounds),
  * **kill** the transport from a given round on (``kill_round``: nothing
    is delivered again, and the relay runs into ``max_rounds`` with work
    outstanding).

Faults are a pure hash of ``(schedule seed, round, channel, shard, row)``,
bit-equal to the reference's for the same shard count: the same schedule
replays the same faults.  ``run_chaos_relay`` runs the relay with its
census on and enforces the contract — every live walker finishes (a count
of DISTINCT walker ids, so a duplicate cannot mask a drop), nothing is
pending at exit, and the stitched paths pass ``audit_paths`` — and raises
``RelayIntegrityError`` with a ``ChaosReport`` otherwise.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.dyngraph import regrow_state
from repro_torch.distributed.relay import (RelayIntegrityError, make_relay,
                                           shard_index, stitch)
from repro_torch.distributed.walker_exchange import (exchange_walkers,
                                                     merge_into_free)

__all__ = ["ChaosSchedule", "ChaosReport", "RelayIntegrityError",
           "audit_paths", "make_chaos_relay", "run_chaos_relay",
           "run_chaos_across_regrow"]


@dataclasses.dataclass(frozen=True)
class ChaosSchedule:
    """One seeded fault configuration for the relay transport.

    ``drop``/``dup``/``delay`` are per-row fault probabilities applied
    with that precedence (a row suffers at most one fault per round).
    ``path_faults=True`` faults the path-record channel too, not only the
    walker channel.  ``mailbox_cap`` starves the walker mailboxes (None =
    the relay default).  ``kill_round >= 0`` stalls the transport from
    that round on.  Rates near 1.0 with heavy duplication can exceed the
    relay's (W,) queues: the harness is meant for sparse fault streams.
    """
    seed: int = 0
    drop: float = 0.0
    dup: float = 0.0
    delay: float = 0.0
    path_faults: bool = False
    mailbox_cap: Optional[int] = None
    kill_round: int = -1


@dataclasses.dataclass(frozen=True)
class ChaosReport:
    """Census of one chaos run — attached to ``RelayIntegrityError``."""
    walkers: int            # live walkers submitted (starts >= 0)
    finished: int           # DISTINCT wids that reached a terminal step
    lost: int               # walkers - finished
    rounds: int             # relay rounds executed
    pending_at_exit: int    # > 0 iff the relay gave up against max_rounds
    overflow: int           # mailbox-overflow re-enqueues observed
    dropped: int            # injected drops (incl. unplaceable delays)
    duplicated: int         # injected duplicate rows
    delayed: int            # injected one-round delays
    peak_slots: int         # peak per-shard slot occupancy


_M32 = 0xFFFFFFFF


def _u01(x):
    """fmix32-style avalanche of int32 lanes -> float32 uniforms in [0, 1],
    the reference's bit for bit (uint32 arithmetic, spelled in int64
    masked to 32 bits)."""
    x = x.to(torch.int64) & _M32
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & _M32
    x = x ^ (x >> 16)
    return x.to(torch.float32) * (2.0 ** -32)


def _make_chaos_exchange(sched: ChaosSchedule, shard_size: int,
                         num_shards: int, group=None):
    """The faulty ``exchange_fn`` for ``relay_local`` on this rank."""
    sidx = shard_index(group)

    def exchange(payload, *, cap, r, channel):
        live = payload[:, 0] >= 0
        if sched.kill_round >= 0 and r >= sched.kill_round:
            # the transport is dead (on every rank alike): nothing
            # arrives, everything stays on its sender, and the relay runs
            # into max_rounds with the work pending
            n = num_shards * (cap if cap else
                              max(1, payload.shape[0] // num_shards))
            return (torch.full((n,) + tuple(payload.shape[1:]), -1,
                               dtype=payload.dtype, device=payload.device),
                    payload, live.sum(dtype=torch.int32),
                    torch.zeros(3, dtype=torch.int32, device=payload.device))
        if channel == 1 and not sched.path_faults:
            drop = dup = delay = 0.0
        else:
            drop, dup, delay = sched.drop, sched.dup, sched.delay
        # a row draws the hash of (seed, round, channel, shard, row) and
        # suffers at most one fault, in this precedence
        idx = torch.arange(live.shape[0], dtype=torch.int64,
                           device=live.device)
        u = _u01(idx * 40503 + r * 69069 + channel * 97 + sidx * 131071
                 + sched.seed)
        dropped = live & (u < drop)
        duped = live & ~dropped & (u < drop + dup)
        delayed = live & ~dropped & ~duped & (u < drop + dup + delay)
        # inject: blank dropped and delayed rows, copy duplicates into
        # free payload rows, then run the real exchange
        send = torch.where((dropped | delayed)[:, None], -1, payload)
        send, n_dup = merge_into_free(send, payload, duped)
        arrived, leftover, ovf = exchange_walkers(send, shard_size,
                                                  num_shards, group, cap=cap)
        # delayed rows re-enter through the sender's leftover buffer, which
        # the relay re-enqueues next round; one the buffer cannot hold is
        # counted as a forced drop (it never silently vanishes)
        leftover, n_requeued = merge_into_free(leftover, payload, delayed)
        n_drop = (dropped.sum(dtype=torch.int32)
                  + delayed.sum(dtype=torch.int32) - n_requeued)
        return arrived, leftover, ovf, torch.stack([n_drop, n_dup,
                                                    n_requeued])

    return exchange


def _num_shards(group) -> int:
    if group is None:
        return 1
    import torch.distributed as dist
    return dist.get_world_size(group)


def make_chaos_relay(bk, cfg, params, group, sched: ChaosSchedule, *,
                     max_rounds: Optional[int] = None,
                     slot_slack: Optional[int] = None,
                     path_cap: Optional[int] = None,
                     overlap: bool = False):
    """``make_relay`` with the chaotic transport and the census on.

    Returns ``run(state, walkers, seed, u=None) -> (home, rounds,
    overflow, peak_slots, finished, pending_at_exit, faults)``, ``state``
    this rank's vertex slice.  Pass a small ``max_rounds`` for kill-round
    schedules: even the default bound makes a dead transport take a while
    to give up.
    """
    S = _num_shards(group)
    ex = _make_chaos_exchange(sched, cfg.num_vertices // S, S, group)
    return make_relay(bk, cfg, params, group,
                      mailbox_cap=sched.mailbox_cap, max_rounds=max_rounds,
                      slot_slack=slot_slack, path_cap=path_cap,
                      diagnostics=True, exchange_fn=ex, census=True,
                      overlap=overlap)


def audit_paths(paths, starts, *, full_length: bool = False) -> List[str]:
    """Host-side structural audit of stitched relay paths.

    Checks, per walker: column 0 equals the start vertex; no valid column
    after the first -1 (a hole is a lost path segment); and, with
    ``full_length=True`` (graphs where every walk runs its whole length:
    all degrees > 0, no stop probability), no early truncation.  Returns
    a list of findings (empty = sound).
    """
    paths = np.asarray(paths)
    starts = np.asarray(starts)
    problems: List[str] = []
    W, Lp1 = paths.shape
    for wid in range(W):
        row = paths[wid]
        if starts[wid] < 0:
            if (row >= 0).any():
                problems.append(f"walker {wid}: free slot has path data")
            continue
        if row[0] != starts[wid]:
            problems.append(f"walker {wid}: starts at {int(row[0])}, "
                            f"expected {int(starts[wid])}")
        valid = row >= 0
        if (~valid).any():
            gap = int(np.argmax(~valid))
            if valid[gap:].any():
                problems.append(f"walker {wid}: hole at column {gap}")
            elif full_length:
                problems.append(f"walker {wid}: truncated at column "
                                f"{gap}/{Lp1 - 1}")
    return problems


def run_chaos_relay(bk, cfg, params, group, state, walkers, seed,
                    sched: ChaosSchedule, *,
                    max_rounds: Optional[int] = None,
                    slot_slack: Optional[int] = None,
                    path_cap: Optional[int] = None,
                    full_length: bool = False, overlap: bool = False):
    """Run one chaos schedule and enforce the conservation contract.

    Every rank of ``group`` calls it with its vertex slice ``state`` and
    the same ``walkers`` and ``seed``.  Returns ``(paths (W, L+1),
    ChaosReport)`` — the stitched paths, on every rank — when every live
    walker finished, nothing was pending at exit and the paths pass the
    structural audit; raises ``RelayIntegrityError`` (report and audit
    findings attached) on every rank otherwise.
    """
    relay = make_chaos_relay(bk, cfg, params, group, sched,
                             max_rounds=max_rounds, slot_slack=slot_slack,
                             path_cap=path_cap, overlap=overlap)
    home, rounds, ovf, peak, finished, pending, faults = relay(
        state, walkers, seed)
    paths = stitch(home, group)
    starts = walkers.cpu().numpy() if isinstance(walkers, torch.Tensor) \
        else np.asarray(walkers)
    n_live = int((starts >= 0).sum())
    report = ChaosReport(
        walkers=n_live, finished=finished, lost=n_live - finished,
        rounds=rounds, pending_at_exit=pending, overflow=ovf,
        dropped=faults[0], duplicated=faults[1], delayed=faults[2],
        peak_slots=peak)
    problems = audit_paths(paths.cpu().numpy(), starts,
                           full_length=full_length) \
        if report.lost == 0 and report.pending_at_exit == 0 else []
    if report.lost or report.pending_at_exit or problems:
        raise RelayIntegrityError(report, problems)
    return paths, report


def run_chaos_across_regrow(bk, cfg, params, group, state, walkers, seeds,
                            sched: ChaosSchedule, *,
                            max_rounds: Optional[int] = None,
                            slot_slack: Optional[int] = None,
                            path_cap: Optional[int] = None,
                            full_length: bool = False,
                            overlap: bool = False):
    """Drive the chaos transport across a capacity-regrow boundary.

    One chaos relay at ``cfg``'s tier, this rank's slice migrated to the
    next tier (``regrow_state`` at the shard-local configs, as every rank
    of a sharded engine regrows), then a second chaos relay on the grown
    slice; the schedule draws a fresh fault stream per seed of ``seeds``.
    Returns ``(paths0, paths1, report0, report1, grown slice)``; either
    side breaking conservation raises ``RelayIntegrityError`` as
    ``run_chaos_relay`` does.
    """
    if cfg.tier + 1 >= len(cfg.ladder):
        raise ValueError(
            f"no tier above capacity {cfg.capacity} in ladder "
            f"{cfg.ladder}")
    cfg_next = cfg.tier_config(cfg.tier + 1)
    rows = state.nbr.shape[0]
    grown = regrow_state(state, dataclasses.replace(cfg, num_vertices=rows),
                         dataclasses.replace(cfg_next, num_vertices=rows))
    s0, s1 = seeds
    kw = dict(max_rounds=max_rounds, slot_slack=slot_slack,
              path_cap=path_cap, full_length=full_length, overlap=overlap)
    paths0, report0 = run_chaos_relay(bk, cfg, params, group, state,
                                      walkers, s0, sched, **kw)
    paths1, report1 = run_chaos_relay(bk, cfg_next, params, group, grown,
                                      walkers, s1, sched, **kw)
    return paths0, paths1, report0, report1, grown
