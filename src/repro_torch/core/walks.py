"""Random-walk applications on top of the Bingo sampler (paper §2.2/§6).

Port of ``repro/core/walks.py``:

  * ``deepwalk`` — first-order biased walk, fixed length (default 80);
  * ``node2vec`` — second-order walk: KnightKing-style static proposal
    from the backend + rejection with the history factor f(w, v) of
    Eq. 1, with an exact second-order ITS fallback after a bounded number
    of trials (distribution unchanged);
  * ``ppr``      — geometric termination with probability ``stop_prob``;
  * ``simple``   — unbiased neighbor pick.

Walkers that terminate (or sit on degree-0 vertices) emit -1 and hold.
deepwalk/ppr/simple go whole-walk by default — one call of the backend's
``sample_walk``, one whole-walk kernel launch on the card — keyed by the
raw int32 ``seed`` of the counter-hash PRNG (the reference derives it
from a JAX key with ``ops.seed_from_key``).  node2vec and
``whole_walk=False`` take the per-step ``scan_walk``: one backend sample
per step (one per-step kernel launch on the card, per proposal trial for
node2vec), with uniforms drawn from a ``torch.Generator`` on the state's
device seeded with ``seed``.  The per-step path draws the same
distribution as the reference's ``jax.random`` stream, not the same
numbers.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.backend import get_backend
from repro_torch.core.dyngraph import BingoConfig, BingoState
from repro_torch.core.sampler import _its_rows, _rand

__all__ = ["WalkParams", "random_walk", "scan_walk", "deepwalk", "node2vec",
           "ppr", "make_walker", "generator", "N2V_COUNTS"]

_N2V_TRIALS = 16
# Elements of the (walkers, C, C) neighbour compare of one fallback chunk.
_N2V_FALLBACK_ELEMS = 1 << 24

# Proposal trials and fallback walkers of the node2vec steps run since the
# last reset, counted on the host from sizes the loop already knows.
N2V_COUNTS = {"trials": 0, "proposals": 0, "fallback": 0}


class WalkParams(NamedTuple):
    kind: str = "deepwalk"     # deepwalk | node2vec | ppr | simple
    length: int = 80
    p: float = 0.5             # node2vec return parameter
    q: float = 2.0             # node2vec in-out parameter
    stop_prob: float = 0.0     # ppr termination probability per step


def generator(seed: int, device) -> torch.Generator:
    """The per-step path's ``torch.Generator`` on ``device``, seeded."""
    return torch.Generator(device=device).manual_seed(int(seed))


def _is_neighbor(state: BingoState, cfg: BingoConfig, src, cand):
    """Vectorized membership test cand ∈ N(src) — one masked row compare."""
    src = src.to(torch.int64)
    row = state.nbr[src]                                   # (B, C)
    valid = (torch.arange(cfg.capacity, device=row.device)[None, :]
             < state.deg[src][:, None])
    return ((row == cand[:, None]) & valid).any(-1)


def _n2v_factor(state, cfg, prev, cand, p, q):
    dist0 = cand == prev
    dist1 = _is_neighbor(state, cfg, prev, cand)
    return torch.where(dist0, 1.0 / p, torch.where(dist1, 1.0, 1.0 / q))


def _n2v_exact(state, cfg, prev, cur, has_prev, gen, params):
    """Exact second-order ITS over cur's row: w_j · f(prev, v_j).  The
    (walkers, C, C) neighbour compare runs in chunks of walkers."""
    C = cfg.capacity
    ar = torch.arange(C, device=cur.device)[None, :]
    x01 = _rand(gen, cur.shape[0])
    out = []
    step = max(1, _N2V_FALLBACK_ELEMS // (C * C))
    for i0 in range(0, cur.shape[0], step):
        cu, pv = cur[i0:i0 + step], prev[i0:i0 + step]
        w = state.bias[cu].to(torch.float32) + state.frac[cu]
        nbrs = state.nbr[cu]                               # (n, C)
        prow = state.nbr[pv]
        pvalid = ar < state.deg[pv][:, None]
        d0 = nbrs == pv[:, None]
        d1 = ((prow[:, None, :] == nbrs[:, :, None])
              & pvalid[:, None, :]).any(-1)
        f = torch.where(d0, 1.0 / params.p,
                        torch.where(d1, 1.0, 1.0 / params.q))
        f = torch.where(has_prev[i0:i0 + step, None], f, 1.0)
        w = torch.where(ar < state.deg[cu][:, None], w * f, 0.0)
        slot = _its_rows(w, x01[i0:i0 + step])
        out.append(nbrs.gather(1, slot.to(torch.int64)[:, None])[:, 0])
    return torch.cat(out)


def _n2v_accept(state, cfg, prev, cur, has_prev, gen, params, bk=None):
    """Second-order step: backend proposals + history-factor rejection.

    Proposals come from ``bk.sample_step`` (one per-step kernel launch per
    trial on the card); the Eq. 1 factor test and the exact second-order
    ITS fallback read the previous vertex's row in torch ops.  The
    reference re-draws all B walkers in every trial; here only walkers not
    yet accepted re-draw (their vertices are the kernel's ``rows``), and
    walkers on degree-0 vertices are settled at -1 from the start, as
    their output is -1 either way.  The distribution is the same, the
    stream differs.  One host sync per trial (the pending set's size).
    """
    if bk is None:
        bk = get_backend(cfg.backend)
    cur, prev = cur.to(torch.int64), prev.to(torch.int64)
    fmax = max(1.0 / params.p, 1.0, 1.0 / params.q)
    nxt = torch.full(cur.shape, -1, dtype=torch.int32, device=cur.device)
    pend = torch.nonzero(state.deg[cur] > 0).squeeze(1)
    for _ in range(_N2V_TRIALS):
        if pend.numel() == 0:
            break
        N2V_COUNTS["trials"] += 1
        N2V_COUNTS["proposals"] += pend.numel()
        cand, _ = bk.sample_step(state, cfg, cur[pend], gen)
        cand = cand.to(torch.int32)
        f = _n2v_factor(state, cfg, prev[pend], cand, params.p, params.q)
        f = torch.where(has_prev[pend], f, 1.0)  # first hop is first-order
        accept = _rand(gen, pend.shape[0]) * fmax < f
        nxt[pend] = torch.where(accept, cand, -1)
        pend = pend[~accept]
    if pend.numel():
        N2V_COUNTS["fallback"] += pend.numel()
        nxt[pend] = _n2v_exact(state, cfg, prev[pend], cur[pend],
                               has_prev[pend], gen, params).to(torch.int32)
    return nxt


def scan_walk(bk, state: BingoState, cfg: BingoConfig, starts, gen,
              params: WalkParams):
    """Per-step walk: one backend sample per step, drawn from ``gen``.

    The only path for node2vec, and the per-step counterpart of the
    whole-walk kernel for deepwalk/ppr/simple (``whole_walk=False``).
    Returns the (B, length+1) int32 path, column 0 = ``starts``.
    """
    B = starts.shape[0]
    cur = starts.to(torch.int64)
    prev = cur
    has_prev = torch.zeros(B, dtype=torch.bool, device=cur.device)
    alive = state.deg[cur] > 0
    cols = [starts.to(torch.int32)]
    for _ in range(params.length):
        safe = torch.clamp(cur, min=0)
        if params.kind == "node2vec":
            nxt = _n2v_accept(state, cfg, prev, safe, has_prev, gen, params,
                              bk)
        elif params.kind == "simple":
            nxt, _ = bk.sample_uniform(state, cfg, safe, gen)
        else:
            nxt, _ = bk.sample_step(state, cfg, safe, gen)
        nxt = nxt.to(torch.int64)
        if params.kind == "ppr" and params.stop_prob > 0:
            alive = alive & (_rand(gen, B) >= params.stop_prob)
        alive = alive & (state.deg[safe] > 0)
        cols.append(torch.where(alive, nxt, -1).to(torch.int32))
        nxt_alive = (alive & (nxt >= 0)
                     & (state.deg[torch.clamp(nxt, min=0)] > 0))
        cur = torch.where(alive, nxt, cur)
        prev = torch.where(alive, safe, prev)
        has_prev = has_prev | alive
        alive = nxt_alive
    return torch.stack(cols, dim=1)


def random_walk(state: BingoState, cfg: BingoConfig, starts, seed: int,
                params: WalkParams, backend: Optional[str] = None,
                whole_walk: Optional[bool] = None, uniforms=None):
    """Run a batch of walks; returns ``(B, length + 1)`` int32 paths.

    Column 0 holds the start vertices; terminated walkers pad with -1.
    Dispatch, as the reference's: deepwalk/ppr/simple run whole-walk
    through ``bk.sample_walk`` when the backend defines it (``seed`` keys
    the counter-hash stream; ``uniforms`` (L, B, 6) float32 pins it);
    node2vec and ``whole_walk=False`` take the per-step ``scan_walk``
    (``seed`` seeds its generator).  ``whole_walk=True`` on a backend
    without ``sample_walk`` raises, as do fed ``uniforms`` with node2vec
    or the per-step path.
    """
    bk = get_backend(cfg.backend if backend is None else backend)
    can_whole = hasattr(bk, "sample_walk")
    if whole_walk is True and not can_whole:
        raise ValueError(
            f"backend {bk.name!r} has no sample_walk whole-walk support")
    if uniforms is not None:
        if params.kind == "node2vec" or whole_walk is False or not can_whole:
            raise ValueError(
                "fed uniforms require the whole-walk path "
                "(deepwalk/ppr/simple through sample_walk)")
        return bk.sample_walk(state, cfg, starts, seed, params, u=uniforms)
    if whole_walk is not False and can_whole and params.kind != "node2vec":
        return bk.sample_walk(state, cfg, starts, seed, params)
    return scan_walk(bk, state, cfg, starts,
                     generator(seed, state.nbr.device), params)


def deepwalk(state, cfg, starts, seed: int, length: int = 80,
             backend: Optional[str] = None):
    return random_walk(state, cfg, starts, seed,
                       WalkParams(kind="deepwalk", length=length),
                       backend=backend)


def node2vec(state, cfg, starts, seed: int, length: int = 80,
             p: float = 0.5, q: float = 2.0, backend: Optional[str] = None):
    return random_walk(state, cfg, starts, seed,
                       WalkParams(kind="node2vec", length=length, p=p, q=q),
                       backend=backend)


def ppr(state, cfg, starts, seed: int, max_length: int = 400,
        stop_prob: float = 1.0 / 80.0, backend: Optional[str] = None):
    return random_walk(state, cfg, starts, seed,
                       WalkParams(kind="ppr", length=max_length,
                                  stop_prob=stop_prob), backend=backend)


def make_walker(state: BingoState, cfg: BingoConfig, params: WalkParams,
                backend: Optional[str] = None,
                whole_walk: Optional[bool] = None):
    """Walk closure ``run(st, starts, seed) -> (st, path)`` — the
    reference's signature; the state passes through untouched."""
    def run(st, starts, seed):
        return st, random_walk(st, cfg, starts, seed, params,
                               backend=backend, whole_walk=whole_walk)
    return run
