"""Walker routing between vertex shards: fixed-size mailboxes, one all-to-all.

Port of ``repro/distributed/walker_exchange.py`` (``route_tag``,
``exchange_walkers``, ``merge_into_free`` and ``make_walk_step``).  The graph is vertex-partitioned over the ranks of
a ``torch.distributed`` process group (rank r owns vertices ``[r·Vs,
(r+1)·Vs)``); walkers move between owners, the sampling structures never
do.  Payloads are int32 rows keyed by a *destination vertex* in field 0
(-1 marks an empty row); everything after it is opaque freight: the
relay ships walker records ``(vertex, step, wid)`` and path records
``(home-tag, wid, slot, path…)``.

Each rank sorts its rows by destination (stable, so each (sender,
destination) mailbox is FIFO), keeps ``cap`` rows per destination in a
``(S·cap, F)`` mailbox and returns the rest to the caller as ``leftover``:
nothing is dropped.  One equal-split ``all_to_all_single`` over the
caller's group rotates the mailbox, as the reference's one
``all_to_all`` does; ``async_op=True`` hands back its work handle so the
caller can launch device work before it waits.
"""

from __future__ import annotations

import torch

__all__ = ["exchange_walkers", "make_walk_step", "merge_into_free",
           "route_tag"]


def merge_into_free(buf, rows, mask):
    """Scatter ``rows[mask]`` into the free rows of ``buf``.

    ``buf`` (N, F) and ``rows`` (M, F) are record buffers whose field 0
    is >= 0 on live rows; ``mask`` (M,) bool selects rows to place.
    Selected rows land in ``buf``'s free rows (field 0 < 0), first free
    row first, in their order; selection beyond the free rows is dropped.
    Returns ``(buf, placed)``: a new buffer and the int32 count actually
    merged — callers that must not lose rows check ``placed ==
    mask.sum()`` (the chaos harness counts the shortfall as forced
    drops).  Both orders come from stable sorts, so seeded fault
    schedules replay exactly.
    """
    N, M = buf.shape[0], rows.shape[0]
    dev = buf.device
    free = buf[:, 0] < 0
    forder = torch.argsort((~free).to(torch.int32), stable=True)
    rorder = torch.argsort((~mask).to(torch.int32), stable=True)
    k = torch.arange(M, device=dev)
    ok = (k < mask.sum()) & (k < free.sum())
    tgt = torch.where(ok, forder[torch.clamp(k, max=N - 1)], N)
    out = torch.cat([buf, buf.new_full((1,) + tuple(buf.shape[1:]), -1)])
    out[tgt] = rows[rorder]              # unplaced rows land on the pad row
    return out[:N], ok.sum(dtype=torch.int32)


def route_tag(shard, shard_size: int):
    """Destination-vertex tag addressing ``shard`` for payloads routed by
    shard rather than by a real vertex (the relay's path records):
    ``exchange_walkers`` recovers the shard as ``tag // shard_size``.
    Negative shards (invalid rows) stay negative, i.e. unrouted."""
    return torch.where(shard >= 0, shard * shard_size, -1)


def exchange_walkers(payload, shard_size: int, num_shards: int, group=None,
                     cap: int | None = None, async_op: bool = False):
    """Route walker records to their owning shard.

    ``payload`` is (Wl,) int32 global vertex ids or (Wl, F) int32 rows
    whose field 0 is the destination vertex (-1 marks an empty row).
    Each (sender, destination) pair has a mailbox of ``cap`` rows
    (default ``Wl // num_shards``).  ``group`` is the process group of the
    ``num_shards`` ranks; with ``group=None`` there must be one shard,
    whose mailbox is its own arrival.  Returns ``(arrived, leftover,
    overflow)``:

      * ``arrived``  — (num_shards * cap[, F]) rows this rank owns after
        routing, sender s's in rows ``[s·cap, (s+1)·cap)`` in its order
        (-1 gaps);
      * ``leftover`` — same shape as ``payload``: the rows that were NOT
        delivered (mailbox overflow beyond ``cap``, and rows whose
        destination has no owner), kept on the sender, in sorted order;
      * ``overflow`` — int32 scalar count of this rank's leftover rows.

    With ``async_op=True`` a fourth output is the all-to-all's work handle
    (None without a group): ``arrived`` holds the result once it has been
    waited on.
    """
    squeeze = payload.dim() == 1
    if squeeze:
        payload = payload[:, None]
    Wl, F = payload.shape
    if cap is None:
        cap = max(1, Wl // num_shards)
    elif cap < 1:
        raise ValueError(f"mailbox cap must be >= 1; got {cap}")
    if group is None and num_shards != 1:
        raise ValueError(f"{num_shards} shards need a process group")
    dev = payload.device
    v = payload[:, 0]
    dest = torch.where(v >= 0, v // shard_size, num_shards)
    order = torch.argsort(dest, stable=True)
    p_sorted = payload[order]
    d_sorted = dest[order]
    idx = torch.arange(Wl, device=dev)
    first = torch.ones(Wl, dtype=torch.bool, device=dev)
    first[1:] = d_sorted[1:] != d_sorted[:-1]
    rank = idx - torch.cummax(torch.where(first, idx, -1), 0).values
    live = p_sorted[:, 0] >= 0
    routed = live & (d_sorted < num_shards) & (rank < cap)
    slot = torch.where(routed, d_sorted * cap + rank, num_shards * cap)
    mailbox = torch.full((num_shards * cap + 1, F), -1, dtype=payload.dtype,
                         device=dev)             # + a row for unrouted lanes
    mailbox[slot] = p_sorted
    mailbox = mailbox[:-1]
    work = None
    if group is None:
        arrived = mailbox
    else:
        import torch.distributed as dist
        arrived = torch.empty_like(mailbox)
        work = dist.all_to_all_single(arrived, mailbox, group=group,
                                      async_op=async_op)
    spill = live & ~routed
    leftover = torch.where(spill[:, None], p_sorted, -1)
    overflow = spill.sum(dtype=torch.int32)
    if squeeze:
        arrived, leftover = arrived[:, 0], leftover[:, 0]
    return (arrived, leftover, overflow) + ((work,) if async_op else ())


def make_walk_step(sample_local, shard_size: int, num_shards: int,
                   group=None):
    """A distributed walk step that keeps each walker's identity.

    ``sample_local(vertices, key) -> next global vertex`` samples the next
    hop of walkers whose current vertex this rank owns (callers close over
    the rank's vertex slice of the state).  The step state is this rank's
    ``(Wl, 2)`` int32 ``[global vertex, walker id]`` rows (-1 rows are
    empty): the id rides the mailbox with the vertex, so a hop landing on
    another rank still knows which walker it advances.  Returns
    ``step(walkers, key) -> (arrived, leftover, overflow)`` as
    ``exchange_walkers`` gives them over ``group`` — a bare step has no
    next round to retry in, so the leftovers go back to the caller.
    """
    def step(walkers, key):
        nxt = sample_local(walkers[:, 0], key)
        live = (walkers[:, 0] >= 0) & (nxt >= 0)
        payload = torch.stack([torch.where(live, nxt, -1),
                               torch.where(live, walkers[:, 1], -1)], -1)
        return exchange_walkers(payload.to(torch.int32), shard_size,
                                num_shards, group)
    return step
