"""Batched-update kernel: one §5.2 round, no host sync.

Port of ``repro/kernels/update_fused.py:update_fused_pallas``.  The
ordering prepass sorts in torch ops (one ``torch.sort`` of an int64 key a
lane and a ``torch.cumsum``), as the reference sorts outside its
``pallas_call``; around them three hand-written prep kernels of
``csrc/update_fused.cu`` do the rest of ``plan_round``: ``prep_lanes``
(lane validity, the key — vertex, then inserts before deletes, then an
insert's lane index or a delete's value + 1 —, the split biases and the
reject counts) first, ``first_flags`` (the first key of each vertex,
whose running count compacts the vertices into ``U`` without a second
sort) and ``prep_rows`` (each row's vertex, its insert and delete
segments ``[lo, hi)`` of the sorted keys by binary search, an insert's
payload gathered through the sort's order, a delete's value and
duplicate rank).  Sorted, a vertex's inserts are in lane order and its
deletes in (value, lane) order: the orders of the reference's insert
sort and its delete ``lexsort``, in one sort (the key holds vertices
below 2^30).  Each affected row gets its lanes as contiguous segments of
the sorted lane arrays, so any number of lanes per row is exact — the
reference's ``block_dels`` bound, which existed for a dense VMEM patch,
is not carried over.  ``plan_round``'s torch ops on CPU tensors are the
prep kernels' plain version; the two are equal bit for bit.

``csrc/update_fused.cu`` then takes the affected rows a warp at a time on
a persistent grid (load the live slots, append the inserts at ``deg +
rank``, locate each delete as the (rank+1)-th match in the post-insert
row, two-phase delete-and-swap, rebuild the row's groups, counters and
alias row, write back in place) and counts the round's ``UpdateStats``
into the plan's stats buffer, so the stats are views of a device buffer
and nothing waits on the host.

``update_fused`` dispatches by the device of the state: CPU tensors run
the plain version ``update_fused_ref`` (= ``core/updates.batched_update``),
CUDA tensors launch the kernels, fake tensors launch nothing (``_fake``),
anything else raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.core.dyngraph import BingoConfig, BingoState
from repro_torch.core.updates import (NUM_REASONS, R_ABSENT, R_CAPACITY,
                                      R_VERTEX, UpdateStats, _padded_unique,
                                      batched_update)
from repro_torch.kernels import _fake

__all__ = ["update_fused", "update_fused_ref", "UpdatePlan", "plan_round",
           "launch_round", "stats_of"]

update_fused_ref = batched_update

# The round's stats buffer (int32): ins_applied, del_applied, the 5 x 5
# transitions (old * 5 + new), the NUM_REASONS reject counts; then the
# kernel's two row counters (zero before and after a launch).
_TRANS, _REJ = 2, 27
STATS_LEN = _REJ + NUM_REASONS + 2
_LOW32 = 0xFFFFFFFF
_VERTEX_SHIFT = 33          # csrc/update_fused.cu's kVertexShift


class UpdatePlan(NamedTuple):
    """The ordering prepass of one round (all tensors (B,) but ``stats``).
    The first ten fields are the kernel's lane arguments, in its order."""
    U: torch.Tensor          # sorted affected vertices, padded with V
    ins_lo: torch.Tensor     # insert segment of row r: [ins_lo, ins_hi)
    ins_hi: torch.Tensor
    v_s: torch.Tensor        # at sorted insert lanes: value, int bias, frac
    wi_s: torch.Tensor       # (-1, 0, +0.0 elsewhere)
    wf_s: torch.Tensor
    del_lo: torch.Tensor     # delete segment of row r: [del_lo, del_hi)
    del_hi: torch.Tensor
    dv_s: torch.Tensor       # at sorted delete lanes: value, duplicate rank
    rank_d: torch.Tensor     # (-1, 0 elsewhere)
    stats: torch.Tensor      # (STATS_LEN,) int32: the reject counts so far


def stats_of(buf: torch.Tensor) -> UpdateStats:
    """``UpdateStats`` as views of a round's stats buffer."""
    return UpdateStats(buf[0], buf[1], buf[_TRANS:_REJ].view(5, 5),
                       buf[_REJ:_REJ + NUM_REASONS])


def _lanes(cfg: BingoConfig, is_insert, u, v, w, active):
    """The lane tensors as the prep kernel takes them: bool, int32 u/v,
    int32 (integer mode) or float32 (fp mode) biases, all contiguous."""
    w = w.to(torch.float32 if cfg.fp_bias else torch.int32)
    act = None if active is None else active.to(torch.bool).contiguous()
    return (is_insert.to(torch.bool).contiguous(),
            u.to(torch.int32).contiguous(), v.to(torch.int32).contiguous(),
            w.contiguous(), act)


def _prep_lanes_plain(cfg, is_insert, u, v, w, active):
    """``prep_lanes``' plain version: ``(key, U, w_int, w_frac, stats)``
    (``U``: the reference's ``_padded_unique``, what ``first_flags`` and
    ``prep_rows`` make of the sorted keys)."""
    V = cfg.num_vertices
    if active is None:
        active = torch.ones_like(is_insert)
    lane_ok = (u >= 0) & (u < V) & (v >= 0)
    ins = is_insert & active & lane_ok
    dele = ~is_insert & active & lane_ok
    lane = torch.arange(u.shape[0], device=u.device)
    low = torch.where(dele, v.to(torch.int64) + 1, lane)
    key = torch.where(ins | dele,
                      (u.to(torch.int64) << _VERTEX_SHIFT)
                      | (dele.to(torch.int64) << 32) | low,
                      (V << _VERTEX_SHIFT) | lane)
    U = _padded_unique(torch.where(ins | dele, u, V), V)
    if cfg.fp_bias:
        scaled = w * torch.tensor(cfg.lam, dtype=torch.float32,
                                  device=w.device)
        ip = torch.floor(scaled)
        w_int, w_frac = ip.to(torch.int32), scaled - ip
    else:
        w_int, w_frac = w, torch.zeros(u.shape, dtype=torch.float32,
                                       device=u.device)
    i32 = torch.int32
    stats = torch.zeros(STATS_LEN, dtype=i32, device=u.device)
    stats[_REJ + R_VERTEX] = (active & ~lane_ok).sum(dtype=i32)
    stats[_REJ + R_CAPACITY] = ins.sum(dtype=i32)
    stats[_REJ + R_ABSENT] = dele.sum(dtype=i32)
    return key, U, w_int, w_frac, stats


def _prep_rows_plain(U, key_s, ordr, v, w_int, w_frac, V):
    """``prep_rows``' plain version: ``(U, ins_lo, ins_hi, v_s, wi_s,
    wf_s, del_lo, del_hi, dv_s, rank_d)``."""
    i32 = torch.int32
    B = U.shape[0]
    j = torch.arange(B, dtype=torch.int64, device=U.device)
    real = (key_s >> _VERTEX_SHIFT) < V
    dele = ((key_s >> 32) & 1).to(torch.bool)
    ins_at, del_at = real & ~dele, real & dele
    row = U.to(torch.int64) << _VERTEX_SHIFT         # a row's first key
    mid = torch.searchsorted(key_s, row | (1 << 32)).to(i32)
    return (U, torch.searchsorted(key_s, row).to(i32), mid,
            torch.where(ins_at, v[ordr], -1),
            torch.where(ins_at, w_int[ordr], 0),
            torch.where(ins_at, w_frac[ordr], 0.0), mid,
            torch.searchsorted(key_s, row + (1 << _VERTEX_SHIFT)).to(i32),
            torch.where(del_at, (key_s & _LOW32) - 1, -1).to(i32),
            torch.where(del_at, j - torch.searchsorted(key_s, key_s),
                        0).to(i32))


def plan_round(cfg: BingoConfig, is_insert, u, v, w,
               active=None) -> UpdatePlan:
    """The ordering prepass: sort keys, sorts, per-row lane segments and
    the reject counts.  CPU tensors take the plain torch ops, CUDA
    tensors the prep kernels (``plan_round.launches`` counts their
    rounds); the two are equal bit for bit."""
    from repro_torch.kernels import _build
    V = cfg.num_vertices
    if V >= 1 << 30:
        raise ValueError(f"plan_round: the sort key holds vertices below "
                         f"2^30, got num_vertices={V}")
    is_insert, u, v, w, active = _lanes(cfg, is_insert, u, v, w, active)
    B = u.shape[0]
    dev = u.device
    cuda = dev.type == "cuda"
    if not cuda and dev.type != "cpu":
        raise ValueError(f"plan_round: no kernel for device {dev}")
    i32 = torch.int32
    if cuda:
        lib = _build.library("update_fused")
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        key = torch.empty(B, dtype=torch.int64, device=dev)
        w_int = torch.empty(B, dtype=i32, device=dev)
        w_frac = torch.empty(B, dtype=torch.float32, device=dev)
        stats = torch.zeros(STATS_LEN, dtype=i32, device=dev)
        P = _build.ptr
        _check(lib.update_prep_lanes_launch(
            P(is_insert), P(u), P(v), P(None if cfg.fp_bias else w),
            P(w if cfg.fp_bias else None), P(active), P(key), P(w_int),
            P(w_frac), P(stats), B, V, ctypes.c_float(cfg.lam), stream),
            "prep_lanes")
    else:
        key, U, w_int, w_frac, stats = _prep_lanes_plain(
            cfg, is_insert, u, v, w, active)
    key_s, ordr = torch.sort(key, stable=True)
    if cuda:
        flags = torch.empty(B, dtype=i32, device=dev)
        _check(lib.update_first_flags_launch(P(key_s), P(flags), B, V,
                                             stream), "first_flags")
        cum = torch.cumsum(flags, 0, dtype=i32)
        rows = [torch.empty(B, dtype=i32, device=dev) for _ in range(10)]
        rows[5] = torch.empty(B, dtype=torch.float32, device=dev)
        _check(lib.update_prep_rows_launch(
            P(key_s), P(cum), P(ordr), P(v), P(w_int), P(w_frac),
            *[P(x) for x in rows], B, V, stream), "prep_rows")
        plan_round.launches += 1
    else:
        rows = _prep_rows_plain(U, key_s, ordr, v, w_int, w_frac, V)
    return UpdatePlan(*rows, stats)


plan_round.launches = 0


def _check(err, what):
    from repro_torch.kernels import _build
    if err != 0:
        raise RuntimeError(f"update_fused {what} launch failed: "
                           f"{_build.error_string(err)}")


def _check_state(state: BingoState, cfg: BingoConfig):
    V, C, K, Cg, Kin = (cfg.num_vertices, cfg.capacity, cfg.num_radix,
                        cfg.group_capacity, cfg.num_inter)
    want = {"nbr": (torch.int32, (V, C)), "bias": (torch.int32, (V, C)),
            "frac": (torch.float32, (V, C)), "deg": (torch.int32, (V,)),
            "gmem": (torch.int32, (V, K, Cg)), "gsize": (torch.int32, (V, K)),
            "digitsum": (torch.int32, (V, K)), "wdec": (torch.float32, (V,)),
            "gtype": (torch.int8, (V, K))}
    if not cfg.adaptive:
        want["ginv"] = (torch.int32, (V, K, C))
    tabs = {f: getattr(state, f) for f in want}
    tabs["prob"], tabs["alias"] = state.itable.prob, state.itable.alias
    want["prob"], want["alias"] = (torch.float32, (V, Kin)), (torch.int32, (V, Kin))
    for f, (dt, shape) in want.items():
        x = tabs[f]
        if x.dtype != dt or tuple(x.shape) != shape or not x.is_cuda \
                or not x.is_contiguous():
            raise ValueError(f"state.{f}: want contiguous CUDA {dt} {shape}, "
                             f"got {x.device} {x.dtype} {tuple(x.shape)}")
    if (state.ginv is None) != cfg.adaptive:
        raise ValueError("ginv must be present exactly in baseline mode")


def launch_round(state: BingoState, cfg: BingoConfig,
                 plan: UpdatePlan) -> UpdateStats:
    """Launch the kernel on a planned round; updates ``state`` in place,
    adds the round's counts to ``plan.stats`` (a plan is launched once)
    and returns its ``UpdateStats``, views of that buffer."""
    from repro_torch.kernels import _build
    _check_state(state, cfg)
    B = plan.U.shape[0]
    lib = _build.library("update_fused")
    ptrs = [_build.ptr(x) for x in
            (*plan[:10], plan.stats, state.nbr, state.bias, state.frac,
             state.deg, state.gmem, state.ginv, state.gsize, state.digitsum,
             state.wdec, state.gtype, state.itable.prob, state.itable.alias)]
    _check(lib.update_fused_launch(
        *ptrs, B, cfg.num_vertices, cfg.capacity, cfg.num_radix,
        cfg.group_capacity, cfg.num_inter, cfg.base_log2, int(cfg.adaptive),
        int(cfg.fp_bias), ctypes.c_float(cfg.alpha), ctypes.c_float(cfg.beta),
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)), "round")
    update_fused.launches += 1
    return stats_of(plan.stats)


def _fake_round(state, cfg, u) -> UpdateStats:
    """A round on fake tensors: ``plan_round``'s buffers (the sort key,
    the sorted key and its order; the split biases, the first flags and
    their running count, the plan's ten lane arrays), the stats buffer
    returned, and the kernel's record."""
    B = u.shape[0]
    _fake.record("update_fused", lanes=B, vertices=state.nbr.shape[0],
                 capacity=cfg.capacity,
                 num_radix=cfg.num_radix, group_capacity=cfg.group_capacity,
                 kin=cfg.num_inter, fp=int(cfg.fp_bias),
                 adaptive=int(cfg.adaptive))
    dev = state.nbr.device
    plan = [torch.empty(B, dtype=torch.int64, device=dev) for _ in range(3)]
    plan += [torch.empty(B, dtype=torch.int32, device=dev) for _ in range(14)]
    del plan
    return stats_of(torch.zeros(STATS_LEN, dtype=torch.int32, device=dev))


def update_fused(state: BingoState, cfg: BingoConfig, is_insert, u, v, w,
                 active=None):
    """One batched §5.2 round: ``(state, UpdateStats)``, state in place.

    Same contract as ``core/updates.batched_update``, which is also what
    runs for CPU tensors.  For CUDA tensors: the prepass, one kernel
    launch, the stats read from the kernel's buffer; no host sync.  Fake
    tensors launch nothing (``_fake``).
    """
    dev = state.nbr.device
    if _fake.is_fake(state.nbr):
        return state, _fake_round(state, cfg, u)
    if dev.type == "cpu":
        return update_fused_ref(state, cfg, is_insert, u, v, w, active)
    if dev.type != "cuda":
        raise ValueError(f"update_fused: no kernel for device {dev}")
    if cfg.num_inter > 64:
        raise ValueError("update_fused: at most 64 inter-group lanes")
    plan = plan_round(cfg, is_insert, u, v, w, active)
    return state, launch_round(state, cfg, plan)


update_fused.launches = 0
