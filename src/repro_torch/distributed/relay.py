"""Walker relay: exact cross-shard whole walks, bulk or overlapped.

Port of ``repro/distributed/relay.py`` for the 1D relay.  The graph is
vertex-partitioned over the S ranks of a ``torch.distributed`` process
group (the reference's mesh axis): rank r holds rows ``[r·Vs, (r+1)·Vs)``
of every state table, with neighbour ids still global.  Walkers move
between owners in bulk *super-steps* while the sampling structures never
move.  One round, on every rank:

  1. **place** — a free-list allocator moves queued walkers (a ``(W, 3)``
     queue of ``(vertex, step, wid)`` records) into the ``Wl = W/S +
     slack`` walker slots not pinned by an undelivered path row;
  2. **segment** — one launch of the segment kernel
     (``EngineBackend.sample_walk_segment``) walks every occupied slot
     from its step ``t0``, drawing the ``(seed, wid, t)`` hash stream,
     until the walk ends or samples a remote neighbour (encoded
     ``-(g + 2)`` by ``relay_view``), where it exits with a frontier
     record;
  3. **route walkers** — frontier records ride ``exchange_walkers`` to
     the owner of their vertex and join its queue; mailbox overflow stays
     in the sender's outbox for the next round;
  4. **route paths** — each slot that walked sends its path row to the
     walker's *home* rank (``wid // (W/S)``), which max-merges it into
     its ``(W/S, L+1)`` home block (segment windows are disjoint); rows
     that overflow the path mailbox stay pinned to their slot.

``overlap=True`` (the engine's default) is the reference's overlapped
schedule: the exchanges drain the buffers the *previous* round filled
(the outbox and the pinned path rows), and this round's arrivals join
the queue after the segment's inputs are fixed — one more round per
crossing.  Both exchanges are issued asynchronously before the segment
launch and waited on after it, so the collectives run while the segment
walks; with one segment kernel of well under a millisecond a round there
is little to hide them behind, and the doubled rounds make this schedule
slower end to end than bulk (``PERF.md``).  The loop
runs while any rank has a walker queued, in an outbox or pinned (a sum
over the group, one ``all_reduce`` per round, which is also the loop's
one host sync), bounded by ``round_bound``.  Because the uniforms of
(walker, step) are a pure hash of ``(seed, wid, t)`` — or fed and
gathered per slot — a relayed walk draws what the single-device whole
walk draws: the home blocks stack to the single-device paths bit for
bit, at any shard count and either schedule.

**2D vertex × walker mesh** (``mesh=`` with ``walker_axes=``, the
reference's ``walker_axes``): a ``torch.distributed.device_mesh.DeviceMesh``
whose named dims split into vertex dims (the graph partitioned over S_v
shards) and walker dims (the graph replicated over S_w walker groups).
Each walker group relays its own W/S_w walkers over its S_v vertex
shards: the exchanges run over the group's vertex process group only,
while the loop's pending count, the overflow, the peak and the faults
are reduced over every rank of the mesh, so all groups run the same
rounds and no group's collectives wait on one that finished.  Slot →
wid maps carry ``wid_base + local id``, so the draws stay keyed by the
GLOBAL walker id and any (S_v, S_w) factorisation gives the
single-device paths bit for bit.  ``stitch`` orders the home blocks
walker-group-major, the reference's ``P(walker_axes + vertex_axes)``.

Every sort here is stable (``stable=True``; booleans sort as int32) and
every ``mode="drop"`` scatter of the reference writes its dropped lanes
to one padding row that is sliced off: the FIFO mailboxes and the round
bound rest on both.  Floor division keeps -1 ids at -1.
"""

from __future__ import annotations

import dataclasses
import math
import time

import torch

from repro_torch.distributed.walker_exchange import exchange_walkers, route_tag
from repro_torch.kernels import _fake

__all__ = ["slot_count", "round_bound", "RelayPendingCensus",
           "RelayIntegrityError", "RelayLayout", "relay_layout", "relay_view",
           "relay_local", "make_relay", "stitch"]


@dataclasses.dataclass(frozen=True)
class RelayLayout:
    """Where this rank sits in a relay (``relay_layout``)."""
    num_shards: int         # S_v: vertex shards a walker group relays over
    num_groups: int         # S_w: walker groups (graph replicas)
    sidx: int               # this rank's vertex index: its rows' offset
    gidx: int               # this rank's walker group
    group: object           # the vertex process group (None for one shard)
    sync_group: object      # every rank of the relay (None for one rank)
    blocks: tuple           # sync-group rank holding home block k, in the
                            # stitched (walker-group-major) order
    mesh_index: int         # index over all mesh dims, in the mesh's order

    @property
    def root(self) -> bool:
        """Vertex shard 0 of walker group 0: the rank that writes what
        the relay's ranks hold together."""
        return self.sidx == 0 and self.gidx == 0


_LAYOUTS: dict = {}     # (id(mesh), walker axes) -> (mesh, RelayLayout)


def _axes(walker_axes) -> tuple:
    return (walker_axes,) if isinstance(walker_axes, str) \
        else tuple(walker_axes)


def relay_layout(group=None, *, mesh=None, walker_axes=()) -> RelayLayout:
    """The relay's process groups and this rank's place in them.

    ``group`` — the 1D relay over a plain process group (one shard
    without one): it has no named dims, so ``walker_axes`` must be empty.
    ``mesh`` — a ``DeviceMesh``: the dims named in ``walker_axes`` hold
    walker groups, the others vertex shards.  Every rank of the mesh
    must call this in the same order: the first call for a (mesh,
    walker axes) pair builds the vertex groups (one ``new_group`` per
    walker group, on every rank, when there is more than one vertex
    dim; the mesh's own group of the dim when there is one) and, unless
    the mesh spans the world, a group of all its ranks; later calls
    reuse them.  Raises the reference's ``ValueError``s for a walker axis
    not in the mesh and for walker axes that leave no vertex axis.
    """
    import torch.distributed as dist
    waxes = _axes(walker_axes)
    if mesh is not None and group is not None:
        raise ValueError("pass mesh= or group=, not both")
    if mesh is None:
        for a in waxes:
            raise ValueError(f"walker axis {a!r} not in mesh axes () "
                             f"(a plain process group has no named axes)")
        if group is None:
            return RelayLayout(1, 1, 0, 0, None, None, (0,), 0)
        S, r = dist.get_world_size(group), dist.get_rank(group)
        return RelayLayout(S, 1, r, 0, group, group, tuple(range(S)), r)
    hit = _LAYOUTS.get((id(mesh), waxes))
    if hit is not None and hit[0] is mesh:
        return hit[1]
    axes = tuple(mesh.mesh_dim_names or ())
    for a in waxes:
        if a not in axes:
            raise ValueError(f"walker axis {a!r} not in mesh axes {axes}")
    vaxes = tuple(a for a in axes if a not in waxes)
    if not vaxes:
        raise ValueError(
            "at least one mesh axis must remain a vertex axis "
            f"(walker_axes={waxes} covers all of {axes})")
    grid = mesh.mesh.cpu()
    sizes = dict(zip(axes, grid.shape))
    S_w = math.prod(sizes[a] for a in waxes)
    S_v = math.prod(sizes[a] for a in vaxes)
    by_group = grid.permute([axes.index(a) for a in waxes + vaxes]) \
        .reshape(S_w, S_v).tolist()
    me = dist.get_rank()
    gidx, sidx = next((g, row.index(me)) for g, row in
                      enumerate(by_group) if me in row)
    if any(row != sorted(row) for row in by_group):
        # a process group numbers its ranks in increasing order, and the
        # exchange sends shard d's mailbox to group rank d
        raise ValueError("the mesh's ranks must increase along its vertex "
                         "axes")
    vgroup = None
    if S_v > 1 and len(vaxes) == 1:
        vgroup = mesh.get_group(vaxes[0])
    elif S_v > 1:
        for g, row in enumerate(by_group):      # every rank, in order
            pg = dist.new_group(row)
            if g == gidx:
                vgroup = pg
    ranks = grid.flatten().tolist()
    if len(ranks) == dist.get_world_size():
        sync = dist.group.WORLD
    else:
        sync = dist.new_group(sorted(ranks))
    blocks = tuple(dist.get_group_rank(sync, r)
                   for row in by_group for r in row)
    lay = RelayLayout(S_v, S_w, sidx, gidx, vgroup, sync, blocks,
                      ranks.index(me))
    _LAYOUTS[(id(mesh), waxes)] = (mesh, lay)
    return lay


def slot_count(W: int, num_shards: int, slack: int | None = None) -> int:
    """Compacted slots per shard: ``Wl = min(W, W/S + slack)``.

    The default slack, ``max(8, ceil(W/S / 2))``, absorbs arrival bursts
    of up to 1.5× a uniform resident load; the rest waits in the queue
    (exact, just more rounds).  ``slack=0`` is legal and exact.
    """
    Wb = W // num_shards
    if slack is None:
        slack = max(8, -(-Wb // 2))
    elif slack < 0:
        raise ValueError(f"slot slack must be >= 0; got {slack}")
    return min(W, Wb + slack)


def round_bound(W: int, L: int, num_shards: int, *,
                slot_slack: int | None = None,
                mailbox_cap: int | None = None,
                path_cap: int | None = None,
                overlap: bool = False) -> int:
    """Termination bound of the round loop, the reference's.

    A frontier record waits at most ``ceil(W / c_w)`` rounds in an outbox
    (FIFO mailboxes of ``c_w`` rows per round); a queued walker waits at
    most ``ceil(W / Wl)`` placement waves of ``ceil(Wl / c_p) + 1``
    rounds; a crossing adds 1 round of lag (2 overlapped).  Summed over
    the at most ``L + 1`` segments of a walker, plus a final path drain.
    """
    Wl = slot_count(W, num_shards, slot_slack)
    payload_w = W if overlap else W + Wl
    c_w = mailbox_cap if mailbox_cap else max(1, payload_w // num_shards)
    c_p = path_cap if path_cap else max(1, Wl // num_shards)
    waves = -(-W // Wl)
    drain_p = -(-Wl // c_p)
    lag = 2 if overlap else 1
    per_step = -(-W // c_w) + waves * (drain_p + 1) + lag
    return (L + 1) * per_step + drain_p + 8


@dataclasses.dataclass(frozen=True)
class RelayPendingCensus:
    """What the relay knew when it hit ``max_rounds`` with work left."""
    rounds: int             # rounds executed (== max_rounds)
    pending_at_exit: int    # walkers still queued/in-flight/pinned
    max_rounds: int         # the tripped bound


class RelayIntegrityError(RuntimeError):
    """The relay lost work, stalled, or produced malformed paths.

    Carries a census as ``.report`` — a ``ChaosReport`` from the fault
    harness (``distributed/chaos.py``) or a ``RelayPendingCensus`` from a
    strict-mode ``max_rounds`` trip — and the path-audit findings as
    ``.problems``.  The two census types share only some fields, so the
    message reads them with ``getattr``.
    """

    def __init__(self, report, problems=()):
        self.report = report
        self.problems = list(problems)
        bits = []
        lost = getattr(report, "lost", None)
        if lost is not None:
            bits.append(f"{lost} of {getattr(report, 'walkers', '?')} "
                        f"walker(s) lost")
        pending = getattr(report, "pending_at_exit", 0)
        if pending:
            bits.append(f"{pending} pending at exit "
                        f"after {getattr(report, 'rounds', '?')} rounds")
        if self.problems:
            bits.append(f"{len(self.problems)} malformed path row(s): "
                        + "; ".join(self.problems[:5]))
        super().__init__("relay integrity violated: " + ", ".join(bits)
                         + f" [{report}]")


def relay_view(state, lo: int, shard_size: int):
    """Shard-local adjacency view that *keeps* remote neighbours.

    Owned neighbours ``[lo, lo + shard_size)`` become local row ids;
    remote ones are encoded ``-(g + 2)`` so the segment kernel exits on
    them with a frontier record (-1 padding stays -1).  The other tables
    are shared with ``state``; ``nbr`` is a new tensor.
    """
    nbr = state.nbr
    owned = (nbr >= lo) & (nbr < lo + shard_size)
    enc = torch.where(nbr < 0, nbr, -(nbr + 2))
    return state._replace(nbr=torch.where(owned, nbr - lo, enc))


def _compact_rows(rows, limit: int):
    """Valid rows (field 0 >= 0) first, in order, truncated to ``limit``.
    Callers pass row sets with at most ``limit`` valid rows."""
    order = torch.argsort((rows[:, 0] < 0).to(torch.int32), stable=True)
    return rows[order][:limit]


def _dedup_wid(rows, col: int = 2):
    """Blank all but the first copy of each walker id in a record pool
    (a no-op on a transport that never duplicates)."""
    wid = rows[:, col]
    big = 2 ** 30
    key = torch.where(wid >= 0, wid, big)
    order = torch.argsort(key, stable=True)
    srt = key[order]
    dup_sorted = torch.zeros_like(srt, dtype=torch.bool)
    dup_sorted[1:] = (srt[1:] == srt[:-1]) & (srt[1:] < big)
    dup = torch.empty_like(dup_sorted)
    dup[order] = dup_sorted
    return torch.where(dup[:, None], -1, rows)


def _scatter(n: int, fill, idx, vals, like):
    """A ``(n, ...)`` tensor of ``fill`` with ``vals`` written at ``idx``;
    indices equal to ``n`` are dropped (the reference's ``mode="drop"``)."""
    out = torch.full((n + 1,) + tuple(vals.shape[1:]), fill,
                     dtype=like.dtype, device=like.device)
    out[idx] = vals.to(like.dtype)
    return out[:n]


def _all_reduce(x, group, op: str = "sum"):
    """``x`` summed (or maxed) over ``group`` in place; ``x`` without one."""
    if group is not None:
        import torch.distributed as dist
        dist.all_reduce(x, op=getattr(dist.ReduceOp, op.upper()), group=group)
    return x


def relay_local(bk, lcfg, params, state, walkers, seed: int, u=None, *,
                sidx: int, num_shards: int, shard_size: int, group=None,
                wid_base: int = 0, sync_group=None,
                mailbox_cap: int | None = None,
                max_rounds: int | None = None,
                slot_slack: int | None = None,
                path_cap: int | None = None,
                diagnostics: bool = False, exchange_fn=None,
                census: bool = False, overlap: bool = False,
                strict: bool = False, trace=None):
    """This rank's side of the super-step relay.

    ``bk``/``lcfg``/``params`` — an ``EngineBackend`` with
    ``sample_walk_segment``, the shard-local config (``num_vertices ==
    shard_size``) and the walk params (deepwalk/ppr/simple); ``state`` —
    this rank's vertex slice of the ``BingoState`` (neighbour ids
    global); ``walkers`` (W,) int32 — the start vertices of the walker
    group, the same on each of its ranks (-1 = free slot;
    ``W % num_shards == 0``); ``seed`` — the int32 counter-PRNG seed;
    ``u`` — optional (L, W_global, 6) fed uniforms, gathered per slot
    through the slot → wid map.  ``group`` — the process group of the
    ``num_shards`` vertex shards (None for one shard), over which the
    exchanges run.

    ``wid_base``/``sync_group`` are the 2D mesh's hooks (``make_relay``'s
    ``walker_axes``): ``wid_base`` is the walker group's first global wid
    (slot → wid maps carry ``wid_base + local id``, so the hash PRNG and
    the fed-uniform gathers are keyed by the global wid, and wid's home
    shard is ``(wid - wid_base) // (W/S)``); ``sync_group`` holds every
    rank of every walker group, over which the pending count, overflow,
    peak and faults are reduced, so every group runs the same rounds.
    Its default, ``group``, is the 1D relay.

    The slot arrays hold ``slot_count(W, S, slot_slack)`` walkers;
    ``mailbox_cap`` and ``path_cap`` bound the walker and path-record
    mailboxes per (sender, destination) pair (defaults: the walker
    payload over S, ``Wl // S``).  Overflow waits, never drops.
    ``max_rounds`` defaults to ``round_bound``; ``strict=True`` raises
    ``RelayIntegrityError`` if the loop stops there with work pending.
    ``exchange_fn(payload, *, cap, r, channel) -> (arrived, leftover,
    overflow, faults)`` replaces the mailbox exchange (channel 0 walker
    records, 1 path records; ``faults`` the fault harness's (drop, dup,
    delay) counts of injected events); it runs synchronously.
    ``trace``, a list, receives one dict
    per round: its ``segment`` CUDA event pair (host seconds on the CPU)
    around the segment launch, ``exchange_s`` the host seconds spent
    issuing and waiting on its exchanges and ``reduce_s`` those of its
    closing all-reduce, which waits for the round's device work.

    On fake tensors (the dry run) the loop runs exactly one round, issues
    every collective and reads nothing on the host; ``diagnostics`` and
    ``census`` raise there.

    Returns ``(home (W/S, L+1) int32, rounds, overflow)`` — this rank's
    home block of the stitched paths (vertex ids global; walker wid's row
    lives on vertex shard ``(wid - wid_base) // (W/S)`` of its group), the
    rounds run and the mailbox overflow re-enqueues summed over rounds and
    every rank, both ints — and
    with ``diagnostics=True`` the peak slots in use (residents plus
    pinned path rows) on any rank in any round.  ``census=True``
    appends three more: the number of DISTINCT walker ids that reached a
    terminal step on any rank (a wid bitmap a rank, summed over the vertex
    group once at exit, so a duplicated walker cannot hide a dropped one,
    and the groups' counts summed over the walker groups), the
    work pending at exit (> 0 only against ``max_rounds``) and
    ``exchange_fn``'s fault counts summed over rounds and ranks, a
    ``(drop, dup, delay)`` tuple of ints.  With ``census=False`` nothing
    of it is computed.
    """
    W = walkers.shape[0]
    L = params.length
    if W % num_shards:
        raise ValueError(
            f"walker count {W} must divide over {num_shards} shards "
            f"(pad starts with -1 free slots)")
    if max_rounds is None:
        max_rounds = round_bound(W, L, num_shards, slot_slack=slot_slack,
                                 mailbox_cap=mailbox_cap, path_cap=path_cap,
                                 overlap=overlap)
    if sync_group is None:
        sync_group = group
    Wb = W // num_shards
    Wl = slot_count(W, num_shards, slot_slack)
    lo = sidx * shard_size
    view = relay_view(state, lo, shard_size)
    dev = state.nbr.device
    i32 = torch.int32
    slot_ids = torch.arange(Wl, dtype=i32, device=dev)
    walkers = walkers.to(device=dev, dtype=i32)

    def start_exchange(payload, *, cap, r, channel):
        """Issue one exchange; returns a function that waits for it and
        gives ``(arrived, leftover, overflow)``; ``exchange_fn``'s fault
        counts join the census."""
        if exchange_fn is not None:
            out = exchange_fn(payload, cap=cap, r=r, channel=channel)
            if census:
                faults.add_(torch.as_tensor(out[3], device=dev).to(i32))
            return lambda: out[:3]
        a, left, n, work = exchange_walkers(payload, shard_size, num_shards,
                                            group, cap=cap, async_op=True)
        if work is None:
            return lambda: (a, left, n)

        def finish():
            work.wait()
            return a, left, n
        return finish

    # Initial residents queue at the shard owning their start vertex.
    wid0 = torch.arange(W, dtype=i32, device=dev) + wid_base
    resident0 = (walkers >= 0) & (walkers // shard_size == sidx)
    waiting = torch.stack([torch.where(resident0, walkers, -1),
                           torch.zeros(W, dtype=i32, device=dev),
                           torch.where(resident0, wid0, -1)], -1)
    outbox = torch.full((W, 3), -1, dtype=i32, device=dev)
    pend_path = torch.full((Wl, L + 1), -1, dtype=i32, device=dev)
    pend_wid = torch.full((Wl,), -1, dtype=i32, device=dev)
    acc = torch.full((Wb + 1, L + 1), -1, dtype=i32, device=dev)  # + drop row
    peak = torch.zeros((), dtype=torch.int64, device=dev)
    if census:      # a bitmap of finished wids (+ a drop row), faults
        fin = torch.zeros(W + 1, dtype=torch.bool, device=dev)
        faults = torch.zeros(3, dtype=i32, device=dev)
    # Fake tensors (the dry run) cannot be read on the host: the loop
    # runs exactly one round with every collective issued and nothing
    # read, as the reference's cost analysis counts a while body once.
    fake = _fake.is_fake(state.nbr)
    pending = _all_reduce(resident0.sum().reshape(1), sync_group)
    pending = 1 if fake else int(pending[0])
    rounds = ovf = 0

    def to_home(wid, rows, ok):
        """Max-merge ``rows`` of walkers ``wid`` (where ``ok``) into the
        home block (segment windows are disjoint)."""
        lrow = torch.where(ok, wid - wid_base - sidx * Wb, Wb).to(torch.int64)
        acc.scatter_reduce_(0, lrow[:, None].expand(-1, L + 1),
                            torch.where(ok[:, None], rows, -1), "amax")

    def path_records(has, wid, rows):
        """``(home-tag, wid, slot, path…)`` rows of the slots in ``has``."""
        home = torch.where(has, (wid - wid_base) // Wb, -1)
        return torch.cat([route_tag(home, shard_size)[:, None],
                          torch.where(has, wid, -1)[:, None],
                          torch.where(has, slot_ids, -1)[:, None],
                          torch.where(has[:, None], rows, -1)], 1)

    def repin(spill_p):
        """Path rows that did not leave stay pinned to their slot."""
        s_ok = spill_p[:, 0] >= 0
        s_slot = torch.where(s_ok, spill_p[:, 2], Wl).to(torch.int64)
        return (_scatter(Wl, -1, s_slot, spill_p[:, 3:], pend_path),
                _scatter(Wl, -1, s_slot, spill_p[:, 1], pend_wid))

    while pending > 0 and rounds < max_rounds:
        r = rounds
        ex_s = 0.0
        # -- place: the free-list allocator drains the queue into open
        # slots (a slot stays pinned while it holds an undelivered row).
        free = pend_wid < 0
        forder = torch.argsort((~free).to(i32), stable=True)
        nfree = free.sum()
        ws = _compact_rows(waiting, W)
        k = torch.arange(W, device=dev)
        place = (k < nfree) & (ws[:, 0] >= 0)
        tgt = torch.where(place, forder[torch.clamp(k, max=Wl - 1)], Wl)
        slot_wid = _scatter(Wl, -1, tgt, ws[:, 2], pend_wid)
        slot_cur = _scatter(Wl, -1, tgt, ws[:, 0] - lo, pend_wid)
        slot_t0 = _scatter(Wl, 0, tgt, ws[:, 1], pend_wid)
        waiting = torch.where(place[:, None], -1, ws)
        occupied = slot_wid >= 0
        peak = torch.maximum(peak, occupied.sum() + (~free).sum())

        if overlap:
            # -- in-flight exchanges: drain what the previous round
            # filled, issued now and waited on after the segment launch
            t_x = time.perf_counter()
            walkers_x = start_exchange(outbox, cap=mailbox_cap, r=r,
                                       channel=0)
            paths_x = start_exchange(
                path_records(pend_wid >= 0, pend_wid, pend_path),
                cap=path_cap, r=r, channel=1)
            ex_s += time.perf_counter() - t_x

        # -- segment: one launch over the compacted slots; the slot→wid
        # map keys the hash PRNG (and gathers the fed stream).
        u_slots = None if u is None else \
            u[:, torch.clamp(slot_wid, min=0).to(torch.int64)].contiguous()
        starts = torch.where(occupied, slot_cur, -1)
        seg = _Span(trace is not None, dev)
        paths, frontier = bk.sample_walk_segment(
            view, lcfg, starts, slot_t0, seed, params, u=u_slots,
            wid=slot_wid)
        seg.stop()

        fr_ok = occupied & (frontier[:, 0] >= 0)
        if census:      # an occupied slot with no frontier finished here
            term = occupied & (frontier[:, 0] < 0)
            fin[torch.where(term, slot_wid - wid_base,
                            W).to(torch.int64)] = True
        new_fr = torch.where(
            fr_ok[:, None],
            torch.stack([frontier[:, 0], frontier[:, 1], slot_wid], -1), -1)
        row_path = torch.where(paths >= 0, paths + lo, -1)

        if overlap:
            t_x = time.perf_counter()
            arrived, spill_w, n_spill_w = walkers_x()
            got, spill_p, n_spill_p = paths_x()
            ex_s += time.perf_counter() - t_x
            # -- buffer swap: fresh exits and spills are the next round's
            # outbox; arrivals join the queue only now.
            outbox = _compact_rows(_dedup_wid(torch.cat([spill_w, new_fr])), W)
            waiting = _compact_rows(_dedup_wid(torch.cat([waiting, arrived])),
                                    W)
            # -- fresh home-local rows merge at once, remote ones pin to
            # their slot for the next round's exchange
            frow_wid = torch.where(occupied, slot_wid, -1)
            has_frow = frow_wid >= 0
            fhome = torch.where(has_frow, (frow_wid - wid_base) // Wb, -1)
            to_home(frow_wid, row_path, has_frow & (fhome == sidx))
            to_home(got[:, 1], got[:, 3:], got[:, 0] >= 0)
            pend_path, pend_wid = repin(spill_p)
            fremote = has_frow & (fhome != sidx)
            pend_path = torch.where(fremote[:, None], row_path, pend_path)
            pend_wid = torch.where(fremote, frow_wid, pend_wid)
        else:
            # -- route walkers (bulk): fresh exits and outbox leftovers
            t_x = time.perf_counter()
            arrived, spill_w, n_spill_w = start_exchange(
                torch.cat([outbox, new_fr]), cap=mailbox_cap, r=r,
                channel=0)()
            ex_s += time.perf_counter() - t_x
            outbox = _compact_rows(_dedup_wid(spill_w), W)
            waiting = _compact_rows(_dedup_wid(torch.cat([waiting, arrived])),
                                    W)
            # -- route paths (bulk): every slot that walked, and pinned
            # rows of earlier rounds, toward the walker's home rank
            row_path = torch.where(occupied[:, None], row_path, pend_path)
            row_wid = torch.where(occupied, slot_wid, pend_wid)
            has_row = row_wid >= 0
            home = torch.where(has_row, (row_wid - wid_base) // Wb, -1)
            to_home(row_wid, row_path, has_row & (home == sidx))
            remote = has_row & (home != sidx)
            t_x = time.perf_counter()
            got, spill_p, n_spill_p = start_exchange(
                path_records(remote, row_wid, row_path), cap=path_cap, r=r,
                channel=1)()
            ex_s += time.perf_counter() - t_x
            to_home(got[:, 1], got[:, 3:], got[:, 0] >= 0)
            pend_path, pend_wid = repin(spill_p)

        counts = torch.stack([
            (waiting[:, 0] >= 0).sum() + (outbox[:, 0] >= 0).sum()
            + (pend_wid >= 0).sum(), (n_spill_w + n_spill_p).to(torch.int64)])
        t_x = time.perf_counter()
        counts = _all_reduce(counts, sync_group)
        pending, spilled = (0, 0) if fake else counts.tolist()
        ovf += spilled
        rounds += 1
        if trace is not None:
            trace.append({"segment": seg.result(), "exchange_s": ex_s,
                          "reduce_s": time.perf_counter() - t_x})

    if strict and pending > 0:
        raise RelayIntegrityError(RelayPendingCensus(
            rounds=rounds, pending_at_exit=pending, max_rounds=max_rounds))
    outs = (acc[:Wb], rounds, ovf)
    if fake and (diagnostics or census):
        raise ValueError("a dry run (fake tensors) reads no diagnostics "
                         "or census")
    if diagnostics:
        outs += (int(_all_reduce(peak.reshape(1), sync_group, "max")[0]),)
    if census:
        seen = _all_reduce(fin[:W].to(i32), group) > 0
        n_fin = seen.sum().reshape(1)
        if sync_group is not group:     # the groups' wids are disjoint
            n_fin = _all_reduce(n_fin * (sidx == 0), sync_group)
        outs += (int(n_fin[0]), pending,
                 tuple(_all_reduce(faults, sync_group).tolist()))
    return outs


class _Span:
    """A timed span: a CUDA event pair on the card, the host clock on the
    CPU; inert when ``on`` is False."""

    def __init__(self, on: bool, device):
        self.on, self.cuda = on, device.type == "cuda"
        if on and self.cuda:
            self.a = torch.cuda.Event(enable_timing=True)
            self.b = torch.cuda.Event(enable_timing=True)
            self.a.record()
        elif on:
            self.t = time.perf_counter()

    def stop(self):
        if self.on and self.cuda:
            self.b.record()
        elif self.on:
            self.t = time.perf_counter() - self.t

    def result(self):
        """The event pair (read ``a.elapsed_time(b)`` after a sync), or
        the host seconds."""
        return (self.a, self.b) if self.cuda else self.t


def make_relay(bk, cfg, params, group=None, *, mesh=None, walker_axes=(),
               mailbox_cap: int | None = None,
               max_rounds: int | None = None,
               slot_slack: int | None = None,
               path_cap: int | None = None,
               diagnostics: bool = False, exchange_fn=None,
               census: bool = False, overlap: bool = False,
               strict: bool = False):
    """The relay over the ranks of ``group`` (one shard without one), or
    over a ``DeviceMesh`` with ``walker_axes`` (``relay_layout``).

    Returns ``run(state, walkers, seed, u=None, trace=None) -> (home,
    rounds, overflow[, peak][, finished, pending, faults])`` as
    ``relay_local`` does, ``state`` this rank's vertex slice and
    ``walkers`` the global (W,) starts, the same on every rank; W must
    divide over the S_w walker groups, each of which relays its slice
    ``[g·W/S_w, (g+1)·W/S_w)`` over its S_v vertex shards.
    ``cfg.num_vertices`` must divide over the vertex shards; ``stitch``
    gathers the home blocks into the (W, L+1) paths.  Under
    ``strict=True`` the round bound is that of W/S_w walkers.
    """
    lay = relay_layout(group, mesh=mesh, walker_axes=walker_axes)
    num_shards = lay.num_shards
    if cfg.num_vertices % num_shards:
        raise ValueError(
            f"num_vertices {cfg.num_vertices} must divide over "
            f"{num_shards} shards (pad the vertex space)")
    shard_size = cfg.num_vertices // num_shards
    lcfg = dataclasses.replace(cfg, num_vertices=shard_size)

    def run(state, walkers, seed, u=None, trace=None):
        W = walkers.shape[0]
        if W % lay.num_groups:
            raise ValueError(
                f"walker count {W} must divide over {lay.num_groups} walker "
                f"group(s) (axes {_axes(walker_axes)})")
        Wg = W // lay.num_groups
        return relay_local(
            bk, lcfg, params, state,
            walkers[lay.gidx * Wg:(lay.gidx + 1) * Wg], seed, u,
            sidx=lay.sidx, num_shards=num_shards, shard_size=shard_size,
            group=lay.group, wid_base=lay.gidx * Wg,
            sync_group=lay.sync_group, mailbox_cap=mailbox_cap,
            max_rounds=max_rounds, slot_slack=slot_slack, path_cap=path_cap,
            diagnostics=diagnostics, exchange_fn=exchange_fn,
            census=census, overlap=overlap, strict=strict, trace=trace)

    return run


def stitch(home, group=None, *, mesh=None, walker_axes=()):
    """The (W, L+1) paths from every rank's home block: an all-gather over
    the relay's ranks, the blocks in walker-group-major order (the
    reference's ``P(walker_axes + vertex_axes)``: block ``g·S_v + v`` is
    vertex shard v of walker group g, whatever the mesh's rank order);
    the block itself on one rank."""
    lay = relay_layout(group, mesh=mesh, walker_axes=walker_axes)
    if lay.sync_group is None:
        return home
    import torch.distributed as dist
    parts = [torch.empty_like(home) for _ in lay.blocks]
    dist.all_gather(parts, home.contiguous(), group=lay.sync_group)
    return torch.cat([parts[k] for k in lay.blocks])
