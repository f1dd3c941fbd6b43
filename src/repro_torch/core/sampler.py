"""Hierarchical (inter-group -> intra-group) sampling — paper §4.1/§4.3/§5.1.

Port of ``repro/core/sampler.py``: the reference half of the sampling
stack — ``sample_group``/``sample_slot``/``sample_neighbor``, the
``transition_probs`` ground truth, and the registered ``"reference"``
``EngineBackend``.  The production path is ``core/backend.py``'s
``"fused"`` backend over the per-step kernels; both realize the same
distribution (Theorem 4.1).  This module is plain torch by design and
runs no kernel.

Stage (i):  O(1) alias pick over the K radix groups (+ decimal group).
Stage (ii): O(1) pick inside the chosen group:
  * materialized groups (ONE/SPARSE/REGULAR): uniform slot pick from
    ``gmem`` (base 2: every member carries the same sub-bias 2^k, Eq. 6);
    for radix bases > 2 a digit-proportional acceptance step follows (§9.2);
  * DENSE groups: rejection on the raw adjacency row — accept iff the
    candidate's digit at position k is set (§5.1; acceptance > alpha);
  * decimal group (fp mode): ITS over the frac row (§4.3).

Randomness comes from an explicit ``torch.Generator`` on the state's
device, where the reference splits JAX keys: the same distribution, a
different stream.  The rejection loop tests its condition on the host,
one sync per trial, where the reference's ``lax.while_loop`` tests it on
the device.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import radix
from repro_torch.core.alias import AliasTable, sample_alias
from repro_torch.core.backend import register_backend, segment_args
from repro_torch.core.dyngraph import DENSE, BingoConfig, BingoState

__all__ = ["sample_group", "sample_slot", "sample_neighbor",
           "transition_probs", "ReferenceBackend"]

_MAX_TRIALS = 64  # rejection bound before the exact ITS fallback kicks in


def _rand(gen, *shape):
    return torch.rand(shape, generator=gen, device=gen.device)


def _idx(i, n):
    """``i`` clamped into [0, n) as an int64 index."""
    return torch.clamp(i, 0, n - 1).to(torch.int64)


def sample_group(state: BingoState, cfg: BingoConfig, u, gen):
    """Stage (i): pick a radix group per walker via the inter-group alias."""
    u = u.to(torch.int64)
    u0, u1 = _rand(gen, 2, u.shape[0])
    rows = AliasTable(state.itable.prob[u], state.itable.alias[u])
    return sample_alias(rows, u0, u1)


def _its_rows(w, x01):
    """Inverse-transform sampling over weight rows ``w`` (B, C): the
    first lane ``i`` with ``cumsum(w)[i] > x01·Σw``, as int32."""
    c = torch.cumsum(w, dim=-1)
    x = x01[:, None] * c[:, -1:]
    idx = (c <= x).sum(-1)
    return torch.clamp(idx, max=w.shape[-1] - 1).to(torch.int32)


def sample_slot(state: BingoState, cfg: BingoConfig, u, k, gen):
    """Stage (ii): pick an adjacency slot inside group ``k`` per walker."""
    K, C, Cg = cfg.num_radix, cfg.capacity, cfg.group_capacity
    u = u.to(torch.int64)
    B = u.shape[0]
    kc = torch.clamp(k, max=K - 1)
    is_dec = (k == K) if cfg.fp_bias else torch.zeros(
        B, dtype=torch.bool, device=u.device)
    dense = (state.gtype[u, kc] == DENSE) & ~is_dec
    mat = ~dense & ~is_dec

    gsz = torch.clamp(state.gsize[u, kc], min=1)
    pos = torch.minimum((_rand(gen, B) * gsz).to(torch.int32), gsz - 1)
    slot = torch.where(mat, state.gmem[u, kc, _idx(pos, Cg)], -1)

    needs_loop = cfg.adaptive or cfg.base_log2 > 1
    if needs_loop:
        # Base-2 materialized picks are already exact; only DENSE rejection
        # (and, for base > 2, digit acceptance) iterate.
        ok = is_dec.clone() if cfg.base_log2 > 1 else ~dense
        bmax = float(cfg.base - 1)
        dg = torch.clamp(state.deg[u], min=1)
        for _ in range(_MAX_TRIALS):
            if not bool((~ok).any()):          # one host sync per trial
                break
            uj, up, ua = _rand(gen, 3, B)
            j_dense = torch.minimum((uj * dg).to(torch.int32), dg - 1)
            p2 = torch.minimum((up * gsz).to(torch.int32), gsz - 1)
            j_mat = state.gmem[u, kc, _idx(p2, Cg)]
            cand = torch.where(dense, j_dense, j_mat)
            dig = radix.digit_at(state.bias[u, _idx(cand, C)], kc,
                                 cfg.base_log2)
            accept = (ua * bmax < dig.to(torch.float32)) & (cand >= 0)
            slot = torch.where(~ok & accept, cand, slot)
            ok = ok | accept
    else:
        ok = mat

    # Exact fallbacks sharing one masked ITS pass: decimal-group walkers
    # sample ∝ frac; rejection-timeout walkers sample ∝ digit_k (the exact
    # conditional of Eq. 6) — distribution unchanged.
    need_its = is_dec | ~ok
    if (cfg.fp_bias or needs_loop) and bool(need_its.any()):
        valid = (torch.arange(C, device=u.device)[None, :]
                 < state.deg[u][:, None])
        w_dig = radix.digit_at(state.bias[u], kc[:, None],
                               cfg.base_log2).to(torch.float32)
        w = torch.where(is_dec[:, None], state.frac[u], w_dig)
        w = torch.where(valid, w, 0.0)
        slot = torch.where(need_its, _its_rows(w, _rand(gen, B)), slot)
    return slot


def sample_neighbor(state: BingoState, cfg: BingoConfig, u, gen
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One full Bingo sample per walker: returns ``(next_vertex, slot)``.

    Callers must mask walkers sitting on degree-0 vertices.
    """
    u = u.to(torch.int64)
    k = sample_group(state, cfg, u, gen)
    slot = sample_slot(state, cfg, u, k, gen)
    return state.nbr[u, _idx(slot, cfg.capacity)], slot


@register_backend
class ReferenceBackend:
    """The plain torch engine as an ``EngineBackend``.

    The unfused gather → alias pick → group pick sampling pipeline above
    plus the whole-table batched update (``core/updates.py``), exact in
    every mode; the oracle the fused backend is held against.
    """

    name = "reference"

    def sample_step(self, state, cfg, u, gen):
        return sample_neighbor(state, cfg, u, gen)

    def sample_uniform(self, state, cfg, u, gen):
        u = u.to(torch.int64)
        dg = torch.clamp(state.deg[u], min=1)
        j = torch.minimum((_rand(gen, u.shape[0]) * dg).to(torch.int32),
                          dg - 1)
        return state.nbr[u, j.to(torch.int64)], j

    def sample_walk(self, state, cfg, starts, seed, params, u=None):
        """Whole walk as the per-step loop (``core/walks.py:scan_walk``);
        with fed uniforms ``u`` (L, B, 6) the fed-uniform plain walk
        (``walk_fused_ref``), the stream the fused backend draws too."""
        from repro_torch.core import walks    # runtime import: walks imports us
        if u is None or params.kind == "node2vec":
            return walks.scan_walk(self, state, cfg, starts,
                                   walks.generator(seed, state.nbr.device),
                                   params)
        from repro_torch.kernels.walk_fused import walk_fused_ref
        stop = float(params.stop_prob) if params.kind == "ppr" else 0.0
        return walk_fused_ref(
            state.itable.prob, state.itable.alias, state.bias, state.nbr,
            state.deg, state.frac if cfg.fp_bias else None, starts, u,
            base_log2=cfg.base_log2, stop_prob=stop,
            uniform=params.kind == "simple")

    def sample_walk_segment(self, state, cfg, starts, t0, seed, params,
                            u=None, wid=None):
        """One relay round as the plain windowed loop
        (``walk_segment_ref``), the segment kernel's plain version: the
        same stream, fed or hashed, bit for bit."""
        from repro_torch.kernels.walk_fused import walk_segment_ref
        args, kw = segment_args(state, cfg, starts, t0, seed, params, u, wid)
        return walk_segment_ref(*args, **kw)

    def apply_updates(self, state, cfg, is_insert, u, v, w, active=None):
        from repro_torch.core.updates import batched_update
        return batched_update(state, cfg, is_insert, u, v, w, active=active)


def transition_probs(state: BingoState, cfg: BingoConfig, u) -> torch.Tensor:
    """Exact per-slot transition probabilities ``w_i / Σ w_i`` for the
    vertices ``u`` (B,): shape (B, C) float32.  Theorem 4.1: the factorized
    sampler must reproduce them; walk tests compare histograms against it.
    """
    u = u.to(torch.int64)
    valid = (torch.arange(cfg.capacity, device=u.device)[None, :]
             < state.deg[u][:, None])
    w = state.bias[u].to(torch.float32) + state.frac[u]
    w = torch.where(valid, w, 0.0)
    return w / torch.clamp(w.sum(-1, keepdim=True), min=1e-30)
