"""The paper's own workload as dry-run cells: one rank's share of a round.

Port of ``repro/launch/walk_cell.py``.  The sampling space is 1-D
vertex-partitioned over every rank of the mesh (paper §9.1): rank r
holds rows ``[r·Vs, (r+1)·Vs)`` of every state table, neighbour ids
global.  Each cell's function is what one rank runs, on the port's own
path, with the rank's process groups:

  ``walk_step``     — one synchronous step: ``sample_step`` of the
                      rank's resident walkers (B4a) and one
                      ``exchange_walkers`` all-to-all to the next
                      vertex's owner;
  ``walk_whole``    — the rank's walkers' whole L-step walks on its
                      shard-local view (remote neighbours cut to -1),
                      ``sample_walk`` (B1), no exchange;
  ``walk_relay``    — the exact sharded whole walk, ``make_relay`` over
                      the mesh (B3 a round, the overlapped schedule);
  ``walk_relay_2d`` — the same relay on the ranks re-meshed as (S_v
                      vertex shards × S_w walker groups),
                      ``walker_axes=("walker",)``: tables replicated over
                      the walker groups, each relaying W/S_w walkers;
  ``update_step``   — one batched round, ``apply_updates`` (B2) of the
                      replicated batch's lanes whose source the rank owns
                      (as the sharded engine ingests), stats summed over
                      the ranks;
  ``update_walk``   — that round, then the whole walks on the fresh rows
                      (B2 + B1), paths in global ids;
  ``serve_round``   — one serving round: a walk cohort through the relay
                      on the pre-update tables (B3), then the update
                      window owner-masked and lane-masked (B2).

The state is ``empty_state`` of the rank's rows on the caller's device
(fake tensors in the dry run).  Overrides: ``capacity_mult`` (the
capacity-ladder tier C' = mult·C), ``cohorts``, ``adaptive``,
``overlap``, ``walker_replicas`` (S_w), ``serve_walkers`` (the serving
round's walk bucket, 65,536).  ``wcfg`` sizes the cell
(default ``FULL``): a one-rank share of FULL on a world of one runs the
same functions for real on the card (``chip_smoke.py`` phase 3k).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs import bingo_walk
from repro_torch.core.backend import get_backend
from repro_torch.core.dyngraph import BingoConfig, empty_state
from repro_torch.core.updates import UpdateStats
from repro_torch.core.walks import WalkParams
from repro_torch.distributed.relay import make_relay, relay_layout, relay_local
from repro_torch.distributed.walker_exchange import exchange_walkers
from repro_torch.launch.specs import CellSpec
from repro_torch.serve.guard import valid_lanes

__all__ = ["build_walk_cell", "one_rank_share"]

SERVE_WALKERS = 65536           # one walk-cohort bucket of the serving round


class _WalkCfgShim:
    """``roofline.model_flops`` duck type: 'active params' = resident
    sampling-space words (so ``useful_ratio`` reads touched / resident)."""

    def __init__(self, wcfg, bcfg):
        self._n = (wcfg.num_vertices * wcfg.capacity * 2
                   + wcfg.num_vertices * bcfg.num_radix * 2
                   + wcfg.num_vertices * bcfg.num_inter * 2)

    def active_param_count(self):
        return self._n


def one_rank_share(wcfg=bingo_walk.FULL, ranks: int = 256):
    """``wcfg`` with its vertices and walkers cut to one rank of
    ``ranks``; widths, length and the update batch unchanged."""
    return dataclasses.replace(
        wcfg, name=f"{wcfg.name}-1of{ranks}",
        num_vertices=wcfg.num_vertices // ranks,
        walkers=wcfg.walkers // ranks)


def _sum_stats(stats: UpdateStats, group) -> UpdateStats:
    """``UpdateStats`` summed over ``group`` in one all-reduce (the
    reference's psum); ``stats`` itself without a group."""
    if group is None:
        return stats
    import torch.distributed as dist
    parts = [x.reshape(-1).to(torch.int64) for x in stats[:4]]
    flat = torch.cat(parts)
    dist.all_reduce(flat, group=group)
    return UpdateStats(*[p.reshape(x.shape).to(torch.int32) for p, x in
                         zip(flat.split([p.numel() for p in parts]), stats[:4])])


def _lanes(Bu: int, device, mask: bool = False):
    """An update batch's lane arrays: is_insert, u, v, w (and a lane
    mask)."""
    i32 = dict(dtype=torch.int32, device=device)
    out = (torch.zeros(Bu, dtype=torch.bool, device=device),
           torch.zeros(Bu, **i32), torch.zeros(Bu, **i32),
           torch.ones(Bu, **i32))
    return out + ((torch.ones(Bu, dtype=torch.bool, device=device),)
                  if mask else ())


def build_walk_cell(shape_name: str, mesh, overrides: dict,
                    wcfg=None, backend=None) -> CellSpec:
    """The ``bingo-walk`` cell ``shape_name`` on ``mesh`` (a
    ``DeviceMesh`` over an initialised world; every dim a vertex dim),
    run through ``backend`` (default: the config's engine backend)."""
    wcfg = wcfg or bingo_walk.FULL
    cmult = int(overrides.get("capacity_mult", 1))
    bcfg = BingoConfig(num_vertices=wcfg.num_vertices,
                       capacity=wcfg.capacity * cmult,
                       bias_bits=wcfg.bias_bits,
                       adaptive=overrides.get("adaptive", True),
                       cohorts=overrides.get("cohorts", 2))
    bk = backend or get_backend(bcfg.backend)
    W, L, Bu = wcfg.walkers, wcfg.walk_length, wcfg.update_batch
    params = WalkParams(kind="deepwalk", length=L)
    overlap = overrides.get("overlap", True)
    chips = mesh.size()
    meta = {"cfg_obj": _WalkCfgShim(wcfg, bcfg), "sizing": wcfg.name}

    def cell(fn, args, names, donate, tokens, **more):
        return CellSpec(arch="bingo-walk", shape_name=shape_name,
                        kind="prefill", fn=fn, args=args, donate=donate,
                        meta={**meta, "args": names, "tokens": tokens,
                              **more})

    if shape_name == "walk_relay_2d":
        S_w = int(overrides.get("walker_replicas", 4))
        if chips % S_w or W % S_w:
            raise ValueError(f"walker_replicas={S_w} must divide chips="
                             f"{chips} and walkers={W}")
        S_v = chips // S_w
        from torch.distributed.device_mesh import DeviceMesh
        mesh2 = DeviceMesh(mesh.device_type, mesh.mesh.reshape(S_v, S_w),
                           mesh_dim_names=("data", "walker"))
        lay = relay_layout(mesh=mesh2, walker_axes=("walker",))
        Vs, Wg = wcfg.num_vertices // S_v, W // S_w
        lcfg = dataclasses.replace(bcfg, num_vertices=Vs)

        def relay_2d(state, walkers, seed):
            return relay_local(
                bk, lcfg, params, state, walkers, seed, sidx=lay.sidx,
                num_shards=S_v, shard_size=Vs, group=lay.group,
                wid_base=lay.gidx * Wg, sync_group=lay.sync_group,
                overlap=overlap)

        return cell(relay_2d, lambda dev: (
            empty_state(lcfg, dev),
            torch.zeros(Wg, dtype=torch.int32, device=dev), 0),
            ("state", "walkers", "seed"), (), W * L,
            mesh_sv=S_v, mesh_sw=S_w, rounds_costed=1)

    lay = relay_layout(mesh=mesh)
    S, sidx, group = lay.num_shards, lay.sidx, lay.group
    Vs = wcfg.num_vertices // S
    lo = sidx * Vs
    lcfg = dataclasses.replace(bcfg, num_vertices=Vs)
    share = {"update_fused": 1.0 / S}

    def state_of(dev):
        return empty_state(lcfg, dev)

    def walkers_of(n):
        return lambda dev: torch.zeros(n, dtype=torch.int32, device=dev)

    def local_view(state):
        owned = (state.nbr >= lo) & (state.nbr < lo + Vs)
        return state._replace(nbr=torch.where(owned, state.nbr - lo, -1))

    def owned_lanes(u, v, mask=None):
        own = valid_lanes(bcfg, u, v) & (u >= lo) & (u < lo + Vs)
        if mask is not None:
            own = own & mask
        return torch.where(own, u - lo, 0), own

    if shape_name == "walk_step":
        def walk_step(state, walkers, seed):
            gen = torch.Generator(device=walkers.device).manual_seed(
                seed * S + sidx)
            local = torch.where(walkers >= 0, walkers - lo, 0).clamp(0, Vs - 1)
            nxt, _ = bk.sample_step(state, lcfg, local, gen)
            nxt = torch.where((walkers >= 0) & (nxt >= 0), nxt, -1)
            return exchange_walkers(nxt, Vs, S, group)[0]

        return cell(walk_step, lambda dev: (state_of(dev),
                                            walkers_of(W // S)(dev), 0),
                    ("state", "walkers", "seed"), (), W)

    if shape_name == "walk_whole":
        def walk_whole(state, walkers, seed):
            local = torch.where(walkers >= 0, walkers - lo, 0).clamp(0, Vs - 1)
            return bk.sample_walk(local_view(state), lcfg, local.contiguous(),
                                  seed * S + sidx, params)

        return cell(walk_whole, lambda dev: (state_of(dev),
                                             walkers_of(W // S)(dev), 0),
                    ("state", "walkers", "seed"), (), W * L)

    if shape_name == "walk_relay":
        relay = make_relay(bk, bcfg, params, mesh=mesh, overlap=overlap)
        return cell(lambda state, walkers, seed: relay(state, walkers, seed),
                    lambda dev: (state_of(dev), walkers_of(W)(dev), 0),
                    ("state", "walkers", "seed"), (), W * L,
                    rounds_costed=1)

    if shape_name == "update_step":
        def update_step(state, is_insert, u, v, w):
            lu, own = owned_lanes(u, v)
            st, stats = bk.apply_updates(state, lcfg, is_insert, lu, v, w,
                                         active=own)
            return st, _sum_stats(stats, group)

        return cell(update_step, lambda dev: (state_of(dev),) + _lanes(Bu, dev),
                    ("state", "is_insert", "u", "v", "w"), (0,), Bu,
                    kernel_share=share)

    if shape_name == "update_walk":
        def update_walk(state, is_insert, u, v, w, walkers, seed):
            lu, own = owned_lanes(u, v)
            st, stats = bk.apply_updates(state, lcfg, is_insert, lu, v, w,
                                         active=own)
            stats = _sum_stats(stats, group)
            resident = (walkers >= lo) & (walkers < lo + Vs)
            local = torch.where(resident, walkers - lo, 0).contiguous()
            paths = bk.sample_walk(local_view(st), lcfg, local,
                                   seed * S + sidx, params)
            paths = torch.where(resident[:, None] & (paths >= 0), paths + lo,
                                -1)
            return st, paths, stats

        return cell(update_walk, lambda dev: (
            (state_of(dev),) + _lanes(Bu, dev) + (walkers_of(W // S)(dev), 0)),
            ("state", "is_insert", "u", "v", "w", "walkers", "seed"), (0,),
            Bu + W * L, kernel_share=share)

    if shape_name == "serve_round":
        Bw = int(overrides.get("serve_walkers", SERVE_WALKERS))
        relay = make_relay(bk, bcfg, params, mesh=mesh, overlap=overlap)

        def serve_round(state, is_insert, u, v, w, lanes, starts, seed):
            paths = relay(state, starts, seed)[0]
            lu, own = owned_lanes(u, v, lanes)
            st, stats = bk.apply_updates(state, lcfg, is_insert, lu, v, w,
                                         active=own)
            return st, paths, _sum_stats(stats, group)

        return cell(serve_round, lambda dev: (
            (state_of(dev),) + _lanes(Bu, dev, mask=True)
            + (walkers_of(Bw)(dev), 0)),
            ("state", "is_insert", "u", "v", "w", "lanes", "starts", "seed"),
            (0,), Bu + Bw * L, kernel_share=share, rounds_costed=1)

    raise ValueError(shape_name)
