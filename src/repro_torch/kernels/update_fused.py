"""Batched-update kernel: one §5.2 round, one launch.

Port of ``repro/kernels/update_fused.py:update_fused_pallas``.  The
ordering prepass stays in torch ops, as in the reference: inserts sorted
by vertex (stable) with segmented ranks, deletes sorted by (vertex,
value) with duplicate ranks, and ``U``, the sorted affected vertices.
Instead of dense per-row patches, each affected row gets its insert and
delete lanes as contiguous segments of the sorted lane arrays (``lo``/
``hi`` offsets per row), so any number of lanes per row is exact — the
reference's ``block_dels`` bound, which existed for a dense VMEM patch,
is not carried over.

``csrc/update_fused.cu`` then runs one block per affected row: load the
row, append the inserts at ``deg + rank``, locate each delete as the
(rank+1)-th match in the post-insert row, two-phase delete-and-swap,
rebuild the row's groups, counters and alias row, and write everything
back in place.  ``UpdateStats`` come from the per-lane delete flags and
the old/new group types in torch ops.

``update_fused`` dispatches by the device of the state: CPU tensors run
the plain version ``update_fused_ref`` (= ``core/updates.batched_update``),
CUDA tensors launch the kernel, anything else raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.core.dyngraph import BingoConfig, BingoState
from repro_torch.core.updates import (_padded_unique, batched_update,
                                      prepare_lanes, round_stats,
                                      sort_deletes, sort_inserts)

__all__ = ["update_fused", "update_fused_ref", "UpdatePlan", "plan_round",
           "launch_round"]

update_fused_ref = batched_update


class UpdatePlan(NamedTuple):
    """The ordering prepass of one round (all tensors (B,) on the card).
    The first ten fields are the kernel's lane arguments, in its order."""
    U: torch.Tensor          # sorted affected vertices, padded with V
    ins_lo: torch.Tensor     # insert segment of row r: [ins_lo, ins_hi)
    ins_hi: torch.Tensor
    v_s: torch.Tensor        # sorted insert lanes: value, int bias, frac
    wi_s: torch.Tensor
    wf_s: torch.Tensor
    del_lo: torch.Tensor     # delete segment of row r: [del_lo, del_hi)
    del_hi: torch.Tensor
    dv_s: torch.Tensor       # sorted delete lanes: value, duplicate rank
    rank_d: torch.Tensor
    n_ins: torch.Tensor      # () inserts that fit their row
    lanes: tuple             # (active, lane_ok, ins, dele) for the stats


def plan_round(state: BingoState, cfg: BingoConfig, is_insert, u, v, w,
               active=None) -> UpdatePlan:
    """The ordering prepass: sorts, ranks and per-row lane segments."""
    V, C = cfg.num_vertices, cfg.capacity
    u, v, active, lane_ok, ins, dele, w_int, w_frac = prepare_lanes(
        cfg, is_insert, u, v, w, active)
    U = _padded_unique(torch.where(ins | dele, u, V), V)
    su_s, v_s, wi_s, wf_s, rank = sort_inserts(cfg, u, v, ins, w_int, w_frac)
    off = state.deg[torch.clamp(su_s, max=V - 1).to(torch.int64)] + rank
    n_ins = ((su_s < V) & (off < C)).sum(dtype=torch.int32)
    du_s, dv_s, rank_d = sort_deletes(cfg, u, v, dele)
    i32 = torch.int32

    def seg(sorted_keys):
        return (torch.searchsorted(sorted_keys, U).to(i32),
                torch.searchsorted(sorted_keys, U, right=True).to(i32))

    ins_lo, ins_hi = seg(su_s)
    del_lo, del_hi = seg(du_s)
    return UpdatePlan(U.contiguous(), ins_lo, ins_hi, v_s.contiguous(),
                      wi_s.contiguous(), wf_s.contiguous(), del_lo, del_hi,
                      dv_s.contiguous(), rank_d.to(i32), n_ins,
                      (active, lane_ok, ins, dele))


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
                 plan: UpdatePlan) -> torch.Tensor:
    """Launch the kernel on a planned round; updates ``state`` in place
    and returns the per-lane delete flags (B,) int32 (sorted lane order)."""
    from repro_torch.kernels import _build
    _check_state(state, cfg)
    B = plan.U.shape[0]
    del_ok = torch.zeros(B, dtype=torch.int32, device=plan.U.device)
    lib = _build.library("update_fused")
    ptrs = [_build.ptr(x) for x in
            (*plan[:10], del_ok, state.nbr, state.bias, state.frac, state.deg,
             state.gmem, state.ginv, state.gsize, state.digitsum, state.wdec,
             state.gtype, state.itable.prob, state.itable.alias)]
    err = lib.update_fused_launch(
        *ptrs, B, cfg.num_vertices, cfg.capacity, cfg.num_radix,
        cfg.group_capacity, cfg.num_inter, cfg.base_log2, int(cfg.adaptive),
        ctypes.c_float(cfg.alpha), ctypes.c_float(cfg.beta),
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err != 0:
        raise RuntimeError(f"update_fused launch failed: {_build.error_string(err)}")
    update_fused.launches += 1
    return del_ok


def update_fused(state: BingoState, cfg: BingoConfig, is_insert, u, v, w,
                 active=None):
    """One batched §5.2 round: ``(state, UpdateStats)``, state in place.

    Same contract as ``core/updates.batched_update``, which is also what
    runs for CPU tensors.  For CUDA tensors: the prepass, one kernel
    launch, and the round's stats.
    """
    dev = state.nbr.device
    if dev.type == "cpu":
        return update_fused_ref(state, cfg, is_insert, u, v, w, active)
    if dev.type != "cuda":
        raise ValueError(f"update_fused: no kernel for device {dev}")
    if cfg.num_inter > 64:
        raise ValueError("update_fused: at most 64 inter-group lanes")
    plan = plan_round(state, cfg, is_insert, u, v, w, active)
    Uc = torch.clamp(plan.U, max=cfg.num_vertices - 1).to(torch.int64)
    old_gtype = state.gtype[Uc]
    del_ok = launch_round(state, cfg, plan)
    return state, round_stats(cfg, plan.U, old_gtype, state.gtype[Uc],
                              *plan.lanes, plan.n_ins,
                              del_ok.sum(dtype=torch.int32))


update_fused.launches = 0
