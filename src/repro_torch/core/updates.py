"""Dynamic graph updates — paper §4.2 (streaming) and §5.2 (batched).

Port of ``repro/core/updates.py``.

Streaming path (low latency, one update at a time — paper principle (i)):
  * ``insert_edge``: append into the adjacency row, push the new slot into
    every radix group whose digit is set, rebuild only the vertex's
    inter-group alias row;
  * ``delete_edge``: locate the edge in each group (inverted index in
    baseline mode, one row compare in adaptive mode), swap-with-tail
    inside each group and on the adjacency row, relabel the moved slot's
    group references, rebuild the alias row;
  * a group-type transition DENSE -> materialized rebuilds the vertex's
    groups (rare, the paper's Table 4).
These are plain torch ops on the touched vertex's rows, updated in place,
and run no kernel (an O(K) touch per update cannot amortize a launch).
The reference scatters with out-of-range indices and ``mode="drop"``;
here each such scatter is a masked row write (``_set_cols``), with a
negative index counting from the end as JAX's indexing does.  One host
sync per update decides whether the rare rebuild runs.

Batched path (high throughput, §5.2): insert → delete → rebuild, the
paper's staging.

  * parallel conflict-free inserts: a stable sort by vertex and segmented
    ranks place each insert at slot ``deg + rank``;
  * parallel deletes: the ``(rank+1)``-th match of each duplicate (vertex,
    value) in the row after this round's inserts, then the paper's
    **two-phase delete-and-swap** per row;
  * one group/alias rebuild per affected vertex.

``batched_update`` is the whole-table plain version: the reference's
oracle for its update kernel, and here the plain version of
``csrc/update_fused.cu`` (``kernels/update_fused.py``), which must equal
it for every batch.  Every update path changes the state's tensors **in
place** (the counterpart of the reference's donated buffers) and returns
the state.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import radix
from repro_torch.core.dyngraph import (DENSE, EMPTY, BingoConfig, BingoState,
                                      _segment_rank, build_itable_rows,
                                      classify, refresh_vertices)

__all__ = ["insert_edge", "delete_edge", "stream_updates",
           "batched_update", "UpdateStats", "two_phase_delete",
           "make_updater", "round_stats",
           "R_OK", "R_VERTEX", "R_DUP", "R_ABSENT", "R_CAPACITY", "R_WEIGHT",
           "NUM_REASONS", "REASON_NAMES"]

# Reject-reason taxonomy (the reference's codes).
R_OK = 0          # applied
R_VERTEX = 1      # endpoint out of range: u outside [0, V) or v < 0
R_DUP = 2         # duplicate insert of a live edge (guard policy)
R_ABSENT = 3      # delete of an edge that is not present
R_CAPACITY = 4    # insert into a full adjacency row (deg == C)
R_WEIGHT = 5      # non-finite / non-positive bias (guard / stream layer)
NUM_REASONS = 6
REASON_NAMES = ("ok", "vertex", "dup", "absent", "capacity", "weight")


class UpdateStats(NamedTuple):
    ins_applied: torch.Tensor    # () int32
    del_applied: torch.Tensor    # () int32
    transitions: torch.Tensor    # (5, 5) int32 group-type transition counts
    rejected: torch.Tensor       # (NUM_REASONS,) int32 per-reason reject counts
    # Capacity-pressure watermark max(deg)/capacity after the round, set
    # by the serving engine; None on the raw update paths.
    max_fill: Optional[torch.Tensor] = None


def _set_cols(rows, cols, vals):
    """``rows[k, cols[k]] = vals[k]`` in place, per row k of ``rows`` (K, n),
    as the reference's scatter with ``mode="drop"``: a negative column
    counts from the end, a column still outside [0, n) writes nothing."""
    n = rows.shape[-1]
    cols = torch.broadcast_to(torch.where(cols < 0, cols + n, cols),
                              rows.shape[:1])
    hit = torch.arange(n, device=rows.device)[None, :] == cols[:, None]
    rows.copy_(torch.where(hit, vals[:, None].to(rows.dtype), rows))


def _set_at(row, idx, val):
    """``row[idx] = val`` in place for the 1-D ``row`` if ``idx`` is in
    range, else nothing (``idx`` a 0-d tensor, never negative here)."""
    _set_cols(row[None], idx.reshape(1),
              torch.as_tensor(val, device=row.device).reshape(1))


def _locate(state: BingoState, cfg: BingoConfig, u: int, slot):
    """Position of adjacency slot ``slot`` in each of u's groups, -1 if
    absent: the inverted index in baseline mode, one compare over the
    (K, Cg) group rows in adaptive mode."""
    if state.ginv is not None:
        return state.ginv[u][:, slot].clone()     # a 0-d index makes a view
    eq = state.gmem[u] == slot                               # (K, Cg)
    pos = torch.argmax(eq.to(torch.int32), dim=-1).to(torch.int32)
    return torch.where(eq.any(-1), pos, -1)


def _set_itable_row(state: BingoState, cfg: BingoConfig, u: int) -> None:
    row = build_itable_rows(cfg, state.digitsum[u:u + 1], state.wdec[u:u + 1])
    state.itable.prob[u] = row.prob[0]
    state.itable.alias[u] = row.alias[0]


def _maybe_rebuild(state, cfg, u, old_type, new_type) -> None:
    """Exact group rebuild of vertex u on a DENSE -> materialized type
    transition (rare; one host sync decides)."""
    need = (old_type == DENSE) & (new_type != DENSE) & (new_type != EMPTY)
    if bool(need.any()):
        refresh_vertices(state, cfg, torch.tensor([u], device=state.deg.device))


def _split_weight(cfg: BingoConfig, w, device):
    """One update's bias as ``(int part, frac part)`` 0-d tensors."""
    if cfg.fp_bias:
        return radix.decompose_fp(
            torch.as_tensor(w, dtype=torch.float32, device=device), cfg.lam)
    return (torch.as_tensor(w, device=device).to(torch.int32),
            torch.zeros((), dtype=torch.float32, device=device))


def insert_edge(state: BingoState, cfg: BingoConfig, u, v, w):
    """Streaming insertion (paper Fig. 5), in place.  Returns ``(state,
    ok)``, ``ok`` a 0-d bool tensor.

    O(K) group appends + the K-entry alias row; a full-row rebuild fires
    only on a DENSE -> materialized type transition.  ``ok`` is False (and
    the state untouched) for a full row or an out-of-range endpoint — u
    outside [0, V), v < 0; v's upper bound is left to the caller, as in
    the reference.
    """
    K, C, Cg, V = (cfg.num_radix, cfg.capacity, cfg.group_capacity,
                   cfg.num_vertices)
    u, v = int(u), int(v)
    dev = state.deg.device
    w_int, w_frac = _split_weight(cfg, w, dev)
    valid = 0 <= u < V and v >= 0
    u = u if valid else 0               # as the reference: a safe row, no-op
    slot = state.deg[u].clone()
    ok = (slot < C) & valid
    slot_idx = torch.where(ok, slot, C)
    _set_at(state.nbr[u], slot_idx, v)
    _set_at(state.bias[u], slot_idx, w_int)
    _set_at(state.frac[u], slot_idx, w_frac)
    state.deg[u] += ok.to(torch.int32)

    ks = torch.arange(K, dtype=torch.int32, device=dev)
    digs = radix.digit_at(w_int, ks, cfg.base_log2)          # (K,)
    member = (digs != 0) & ok
    old_size = state.gsize[u].clone()
    old_type = state.gtype[u].clone()
    state.gsize[u] += member.to(torch.int32)
    state.digitsum[u] += torch.where(ok, digs, 0)
    state.wdec[u] += torch.where(ok, w_frac, 0.0)
    new_type = classify(state.gsize[u], state.deg[u], cfg)

    # intra-group appends (stage (i) of Fig. 5): one masked write over K
    append = member & (old_type != DENSE) & (new_type != DENSE)
    _set_cols(state.gmem[u], torch.where(append & (old_size < Cg), old_size,
                                         Cg), slot.expand(K))
    state.gtype[u] = new_type
    if state.ginv is not None:
        _set_cols(state.ginv[u], torch.where(append, slot, C), old_size)
    _maybe_rebuild(state, cfg, u, old_type, new_type)
    # stage (ii) of Fig. 5: rebuild the K-entry inter-group alias row
    _set_itable_row(state, cfg, u)
    return state, ok


def delete_edge(state: BingoState, cfg: BingoConfig, u, v):
    """Streaming deletion (paper Fig. 6), in place.  Returns ``(state,
    ok)``, ``ok`` a 0-d bool tensor.

    Steps (i)-(iv) of the paper: find the contributing groups, locate the
    slot in each, delete-and-swap inside each materialized group,
    swap-with-tail on the adjacency row (relabelling the group references
    of the moved slot, located after the group deletes), rebuild the alias
    row.  The earliest slot holding ``v`` goes.  ``ok`` is False (and the
    state untouched) for an absent edge or an out-of-range u.
    """
    K, C, Cg, V = (cfg.num_radix, cfg.capacity, cfg.group_capacity,
                   cfg.num_vertices)
    u, v = int(u), int(v)
    dev = state.deg.device
    valid_u = 0 <= u < V
    u = u if valid_u else 0
    ks = torch.arange(K, dtype=torch.int32, device=dev)
    d = state.deg[u].clone()
    matches = (state.nbr[u] == v) & (torch.arange(C, device=dev) < d)
    ok = matches.any() & valid_u
    slot = torch.argmax(matches.to(torch.int32))             # earliest version
    last = d - 1

    w_s = torch.where(ok, state.bias[u, slot], 0)
    f_s = torch.where(ok, state.frac[u, slot], 0.0)
    digs_s = radix.digit_at(w_s, ks, cfg.base_log2)
    member_s = (digs_s != 0) & ok
    old_size = state.gsize[u].clone()
    old_type = state.gtype[u].clone()
    state.gsize[u] -= member_s.to(torch.int32)
    state.digitsum[u] -= digs_s
    state.wdec[u] += -f_s
    state.deg[u] -= ok.to(torch.int32)

    # (i)+(ii)+(iii): per-group delete-and-swap for materialized groups
    mat_s = member_s & (old_type != DENSE)
    pos = _locate(state, cfg, u, slot)                       # (K,)
    tail = old_size - 1
    moved = state.gmem[u].gather(
        1, torch.clamp(tail, 0, Cg - 1).to(torch.int64)[:, None])[:, 0]
    neg = torch.full((K,), -1, dtype=torch.int32, device=dev)
    _set_cols(state.gmem[u], torch.where(mat_s, pos, Cg), moved)
    _set_cols(state.gmem[u], torch.where(mat_s, tail, Cg), neg)
    if state.ginv is not None:
        _set_cols(state.ginv[u], torch.where(mat_s, moved, C), pos)
        _set_cols(state.ginv[u], torch.where(mat_s, slot, C), neg)

    # adjacency swap-with-tail: slot ``last`` moves into the hole at
    # ``slot``, and its group references are relabelled
    do_swap = ok & (slot != last)
    last_c = torch.clamp(last, 0, C - 1)
    w_l = state.bias[u, last_c].clone()
    for tab, fill in ((state.nbr, -1), (state.bias, 0), (state.frac, 0.0)):
        _set_at(tab[u], torch.where(do_swap, slot, C), tab[u, last_c])
        _set_at(tab[u], torch.where(ok, last, C), fill)
    digs_l = radix.digit_at(w_l, ks, cfg.base_log2)
    mat_l = (digs_l != 0) & do_swap & (old_type != DENSE)
    pos2 = _locate(state, cfg, u, last_c)                    # after group delete
    _set_cols(state.gmem[u], torch.where(mat_l, pos2, Cg), slot.expand(K))
    if state.ginv is not None:
        _set_cols(state.ginv[u], torch.where(mat_l, slot, C), pos2)
        _set_cols(state.ginv[u], torch.where(do_swap, last, C), neg)

    new_type = classify(state.gsize[u], state.deg[u], cfg)
    state.gtype[u] = new_type
    _maybe_rebuild(state, cfg, u, old_type, new_type)
    _set_itable_row(state, cfg, u)
    return state, ok


def stream_updates(state: BingoState, cfg: BingoConfig, is_insert, u, v, w):
    """Apply a sequence of updates one at a time (streaming semantics),
    in place.  Returns ``(state, ok (N,) bool)``."""
    def host(x):
        return x.tolist() if hasattr(x, "tolist") else list(x)
    oks = []
    for ins, uu, vv, ww in zip(host(is_insert), host(u), host(v), host(w)):
        if ins:
            state, ok = insert_edge(state, cfg, uu, vv, ww)
        else:
            state, ok = delete_edge(state, cfg, uu, vv)
        oks.append(ok)
    if not oks:
        return state, torch.zeros(0, dtype=torch.bool, device=state.deg.device)
    return state, torch.stack(oks)


def two_phase_delete(vals_tuple, del_mask, d):
    """Paper Fig. 10(b): two-phase parallel delete-and-swap on R rows.

    ``vals_tuple`` holds ``(values (R, C), fill)`` pairs, ``del_mask``
    (R, C) bool, ``d`` (R,) row lengths.  Phase 1 marks the n tail slots;
    tail slots that are themselves deleted die in place.  Phase 2 moves
    the surviving tail slots into the front holes, j-th to j-th.  Returns
    ``(new_vals_tuple, new_len, remap)`` where ``remap[r, i]`` is the new
    position of old slot i (-1 if deleted).
    """
    R, C = del_mask.shape
    dev = del_mask.device
    ar = torch.arange(C, dtype=torch.int64, device=dev)[None, :]
    d = d.to(torch.int64)[:, None]
    in_row = ar < d
    del_mask = del_mask & in_row
    n = del_mask.sum(1, keepdim=True)
    front = d - n
    is_tail = (ar >= front) & in_row
    surv_tail = is_tail & ~del_mask
    hole = del_mask & (ar < front)
    r_surv = torch.cumsum(surv_tail, 1) - 1
    r_hole = torch.cumsum(hole, 1) - 1
    hole_pos = torch.full((R, C + 1), C, dtype=torch.int64, device=dev)
    hole_pos.scatter_(1, torch.where(hole, r_hole, C), ar.expand(R, C))
    tgt = torch.where(surv_tail,
                      hole_pos.gather(1, torch.clamp(r_surv, 0, C - 1)), C)
    new_vals = []
    for vals, fill in vals_tuple:
        buf = torch.cat([vals, vals[:, :1]], dim=1)
        buf.scatter_(1, tgt, vals)
        new_vals.append(torch.where(ar < front, buf[:, :C], fill))
    remap = torch.where(del_mask, -1, torch.where(surv_tail, tgt, ar))
    remap = torch.where(in_row, remap, -1)
    return tuple(new_vals), front[:, 0].to(torch.int32), remap


def _padded_unique(x, sentinel):
    """Sorted unique values of ``x`` padded with ``sentinel`` (same length)."""
    s = torch.sort(x).values
    first = torch.ones_like(s, dtype=torch.bool)
    first[1:] = s[1:] != s[:-1]
    return torch.sort(torch.where(first, s, sentinel)).values


def prepare_lanes(cfg: BingoConfig, is_insert, u, v, w, active=None):
    """Lane validity and split biases: ``(u, v, active, lane_ok, ins,
    dele, w_int, w_frac)``.  Out-of-range endpoints (u outside [0, V),
    v < 0) are never applied and counted as ``R_VERTEX``."""
    V = cfg.num_vertices
    u = u.to(torch.int32)
    v = v.to(torch.int32)
    is_insert = is_insert.to(torch.bool)
    if active is None:
        active = torch.ones_like(is_insert)
    lane_ok = (u >= 0) & (u < V) & (v >= 0)
    ins = is_insert & active & lane_ok
    dele = ~is_insert & active & lane_ok
    if cfg.fp_bias:
        w_int, w_frac = radix.decompose_fp(w, cfg.lam)
    else:
        w_int = w.to(torch.int32)
        w_frac = torch.zeros(u.shape, dtype=torch.float32, device=u.device)
    return u, v, active, lane_ok, ins, dele, w_int, w_frac


def sort_inserts(cfg, u, v, ins, w_int, w_frac):
    """Inserts sorted by vertex (stable) with their segmented ranks:
    ``(su_s, v_s, wi_s, wf_s, rank)``; non-inserts sort last as ``V``."""
    su = torch.where(ins, u, cfg.num_vertices)
    order = torch.argsort(su, stable=True)
    su_s = su[order]
    return su_s, v[order], w_int[order], w_frac[order], _segment_rank([su_s])


def sort_deletes(cfg, u, v, dele):
    """Deletes sorted by (vertex, value) — the reference's
    ``lexsort((dv, du))`` as two stable sorts, minor key first — with the
    rank of each duplicate: ``(du_s, dv_s, rankD)``."""
    du = torch.where(dele, u, cfg.num_vertices)
    dv = torch.where(dele, v, -1)
    o1 = torch.argsort(dv, stable=True)
    o2 = torch.argsort(du[o1], stable=True)
    ordD = o1[o2]
    du_s, dv_s = du[ordD], dv[ordD]
    return du_s, dv_s, _segment_rank([du_s, dv_s])


def round_stats(cfg, U, old_gtype, new_gtype, active, lane_ok, ins, dele,
                n_ins, n_del) -> UpdateStats:
    """``UpdateStats`` of a round from its affected rows' old/new group
    types and the applied counts.  Every op keeps its shape, so on CUDA
    tensors nothing waits on the host."""
    V = cfg.num_vertices
    i32 = torch.int32
    valid_row = (U < V)[:, None]
    pair = old_gtype.to(torch.int64) * 5 + new_gtype.to(torch.int64)
    changed = (old_gtype != new_gtype) & valid_row
    trans = torch.zeros(25, dtype=i32, device=U.device).scatter_add_(
        0, pair.reshape(-1), changed.reshape(-1).to(i32)).reshape(5, 5)
    rejected = torch.zeros(NUM_REASONS, dtype=i32, device=U.device)
    rejected[R_VERTEX] = (active & ~lane_ok).sum(dtype=i32)
    rejected[R_CAPACITY] = ins.sum(dtype=i32) - n_ins
    rejected[R_ABSENT] = dele.sum(dtype=i32) - n_del
    return UpdateStats(n_ins.to(i32), n_del.to(i32), trans.to(i32), rejected)


def batched_update(state: BingoState, cfg: BingoConfig, is_insert, u, v, w,
                   active=None):
    """High-throughput batched update (paper §5.2 / Fig. 10(a)), in place.

    Apply ``is_insert[b] ? insert(u, v, w) : delete(u, v)`` for every
    active lane, inserts before deletes, earliest-version-first duplicate
    deletion, one rebuild per affected vertex.  Lanes with out-of-range
    endpoints, inserts into a full row and deletes of absent edges are
    dropped and counted per reason in ``UpdateStats.rejected``.  The
    state's tensors are updated in place; returns ``(state, stats)``.
    """
    V, C = cfg.num_vertices, cfg.capacity
    dev = state.nbr.device
    u, v, active, lane_ok, ins, dele, w_int, w_frac = prepare_lanes(
        cfg, is_insert, u, v, w, active)
    B = u.shape[0]
    U = _padded_unique(torch.where(ins | dele, u, V), V)
    Uc = torch.clamp(U, max=V - 1).to(torch.int64)
    old_gtype = state.gtype[Uc]

    # ---- stage 1: parallel inserts (sort by vertex + segmented ranks) ----
    su_s, v_s, wi_s, wf_s, rank = sort_inserts(cfg, u, v, ins, w_int, w_frac)
    off = state.deg[torch.clamp(su_s, max=V - 1).to(torch.int64)] + rank
    okA = (su_s < V) & (off < C)
    rows_a, slots_a = su_s[okA].to(torch.int64), off[okA]
    state.nbr[rows_a, slots_a] = v_s[okA]
    state.bias[rows_a, slots_a] = wi_s[okA]
    state.frac[rows_a, slots_a] = wf_s[okA]
    state.deg.add_(torch.bincount(rows_a, minlength=V).to(torch.int32))
    n_ins = okA.sum(dtype=torch.int32)

    # ---- stage 2: parallel deletes ----
    du_s, dv_s, rankD = sort_deletes(cfg, u, v, dele)
    dcl = torch.clamp(du_s, max=V - 1).to(torch.int64)
    rows = state.nbr[dcl]                                       # (B, C)
    colC = torch.arange(C, dtype=torch.int32, device=dev)[None, :]
    m = (rows == dv_s[:, None]) & (colC < state.deg[dcl][:, None]) \
        & (du_s < V)[:, None]
    cnt = torch.cumsum(m, dim=1, dtype=torch.int32)
    # the rankD-th duplicate deletes the (rankD+1)-th (earliest-first) match
    hit = m & (cnt == (rankD + 1)[:, None])
    okD = hit.any(1)
    slotD = torch.argmax(hit.to(torch.int32), dim=1)
    n_del = okD.sum(dtype=torch.int32)

    rowid = torch.searchsorted(U, du_s)
    del_mask = torch.zeros((B, C), dtype=torch.bool, device=dev)
    del_mask[rowid[okD], slotD[okD]] = True
    (new_nbr, new_bias, new_frac), new_len, _ = two_phase_delete(
        ((state.nbr[Uc], -1), (state.bias[Uc], 0), (state.frac[Uc], 0.0)),
        del_mask, state.deg[Uc])
    real = U < V
    Ur = U[real].to(torch.int64)
    state.nbr[Ur] = new_nbr[real]
    state.bias[Ur] = new_bias[real]
    state.frac[Ur] = new_frac[real]
    state.deg[Ur] = new_len[real]

    # ---- stage 3: single rebuild per affected vertex (groups + alias) ----
    refresh_vertices(state, cfg, U)
    stats = round_stats(cfg, U, old_gtype, state.gtype[Uc], active, lane_ok,
                        ins, dele, n_ins, n_del)
    return state, stats


def make_updater(cfg: BingoConfig, backend: Optional[str] = None):
    """Update closure through the ``EngineBackend`` named by ``backend``
    (default ``cfg.backend``): ``run(st, is_insert, u, v, w, active=None)
    -> (st, UpdateStats)``, updating ``st`` in place."""
    from repro_torch.core.backend import get_backend
    bk = get_backend(cfg.backend if backend is None else backend)

    def run(st, is_insert, u, v, w, active=None):
        return bk.apply_updates(st, cfg, is_insert, u, v, w, active=active)
    return run
