"""The paper's comparison samplers (its Table 3), in plain PyTorch.

Port of ``repro/core/baselines.py``.  The paper compares Bingo against
KnightKing (alias method + rejection), gSampler (ITS-style sampling) and
FlowWalker (reservoir sampling), systems that "reload or reconstruct the
corresponding structure after each round of updates" (paper §6.2), which
is what these baselines do.  All four share Bingo's padded ``(V, C)``
adjacency, so a comparison isolates the cost of the sampling space:

  * ``AliasBaseline``     — an alias table a vertex; any update to a
    vertex rebuilds its whole row (``core/alias.build_alias``).
  * ``ITSBaseline``       — a CDF row a vertex; a draw is a search of the
    row; an insert extends the prefix sums, a delete recomputes the row.
  * ``RejectionBaseline`` — no auxiliary structure but the row's largest
    bias: draws by rejection, at most ``_MAX_REJ`` trials, then an exact
    ITS fallback for the walkers still rejected.
  * ``ReservoirBaseline`` — FlowWalker's weighted reservoir over the whole
    row: O(d) work a draw, nothing to update.

Like the reference they are plain tensor code with no kernel.  Updates
are functional, as the reference's are: ``insert``/``delete`` return a
new baseline and leave the old one (and every baseline sharing its
adjacency) as it was.  A draw takes an explicit ``torch.Generator`` on
the tensors' device where the reference takes a key: the same
distribution, other draws.  ``*_ops`` count the abstract work that the
paper's Table 1 predicts, as the reference's do.

One difference from the reference: its ``ITSBaseline.insert`` writes the
new prefix sum at the appended slot only, so the row's last entry, which
a draw scales by, keeps the old total and the new edge is never drawn
until a delete rebuilds the row.  Here the insert writes the new total
to the appended slot and every padding slot after it; the row's valid
entries are the reference's bit for bit, and the whole row is a fresh
cumulative sum.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.alias import AliasTable, build_alias, sample_alias

__all__ = [
    "AdjState", "adj_from_edges", "adj_insert", "adj_delete",
    "AliasBaseline", "ITSBaseline", "RejectionBaseline", "ReservoirBaseline",
]

_MAX_REJ = 256  # rejection bound before the exact ITS fallback


class AdjState(NamedTuple):
    """Shared padded adjacency (the layout of ``BingoState``'s rows)."""

    nbr: torch.Tensor   # (V, C) int32, -1 padded
    w: torch.Tensor     # (V, C) float32 biases
    deg: torch.Tensor   # (V,) int32


def _tensor(x, dtype, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def adj_from_edges(V: int, C: int, src, dst, w, device="cuda") -> AdjState:
    """The adjacency of the edges, each row in edge order, cut at ``C``
    entries; on ``device``."""
    src = _tensor(src, torch.int64, device)
    dst = _tensor(dst, torch.int32, device)
    w = _tensor(w, torch.float32, device)
    order = torch.argsort(src, stable=True)
    s, d, ww = src[order], dst[order], w[order]
    idx = torch.arange(s.shape[0], device=s.device)
    first = torch.ones_like(s, dtype=torch.bool)
    first[1:] = s[1:] != s[:-1]
    rank = idx - torch.cummax(torch.where(first, idx, -1), 0).values
    ok = rank < C
    s, rank = s[ok], rank[ok]
    nbr = torch.full((V, C), -1, dtype=torch.int32, device=s.device)
    wm = torch.zeros((V, C), dtype=torch.float32, device=s.device)
    nbr[s, rank] = d[ok]
    wm[s, rank] = ww[ok]
    deg = torch.zeros(V, dtype=torch.int32, device=s.device).index_add_(
        0, s, torch.ones_like(s, dtype=torch.int32))
    return AdjState(nbr, wm, deg)


def _vertex(u, device) -> torch.Tensor:
    """A vertex id as a 0-d int64 tensor on ``device``."""
    return _tensor(u, torch.int64, device).reshape(())


def _row_put(table, u, value, hit=None):
    """``table`` copied, with ``value`` in row ``u`` (where ``hit``)."""
    out = table.clone()
    out[u] = value if hit is None else torch.where(hit, value, table[u])
    return out


def _cols(st: AdjState) -> torch.Tensor:
    return torch.arange(st.nbr.shape[1], device=st.nbr.device)


def adj_insert(st: AdjState, u, v, w) -> AdjState:
    """Append ``(u, v, w)`` at the row's tail; a full row is unchanged."""
    dev = st.nbr.device
    u = _vertex(u, dev)
    d = st.deg[u]
    hit = _cols(st) == d                     # no slot when the row is full
    return AdjState(
        _row_put(st.nbr, u, _tensor(v, torch.int32, dev), hit),
        _row_put(st.w, u, _tensor(w, torch.float32, dev), hit),
        _row_put(st.deg, u, d + (d < st.nbr.shape[1]).to(d.dtype)))


def adj_delete(st: AdjState, u, v) -> AdjState:
    """Delete-and-swap on the row (earliest match): the row's last entry
    moves into the deleted slot; an absent edge changes nothing."""
    dev = st.nbr.device
    C = st.nbr.shape[1]
    u = _vertex(u, dev)
    col = _cols(st)
    row, wrow, d = st.nbr[u], st.w[u], st.deg[u]
    m = (row == _tensor(v, torch.int32, dev)) & (col < d)
    ok = m.any()
    slot = torch.argmax(m.to(torch.int32))
    last = d - 1
    last_c = torch.clamp(last, 0, C - 1)
    move = ok & (slot != last) & (col == slot)
    clear = ok & (col == last)
    nrow = torch.where(clear, -1, torch.where(move, row[last_c], row))
    nw = torch.where(clear, 0.0, torch.where(move, wrow[last_c], wrow))
    nbr, w = st.nbr.clone(), st.w.clone()
    nbr[u], w[u] = nrow.to(nbr.dtype), nw
    return AdjState(nbr, w, _row_put(st.deg, u, d - ok.to(d.dtype)))


def _valid_w(st: AdjState, u) -> torch.Tensor:
    """Rows ``u`` of the biases, zero past each row's degree."""
    valid = _cols(st)[None, :] < st.deg[u][:, None]
    return torch.where(valid, st.w[u], 0.0)


def _uniform(shape, gen) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=gen.device)


def _search(c, x, C):
    """First slot whose prefix sum exceeds ``x``, capped at ``C - 1``."""
    return torch.clamp((c <= x[..., None]).sum(-1), max=C - 1)


# ---------------------------------------------------------------------------
# Alias method (KnightKing-style)
# ---------------------------------------------------------------------------

class AliasBaseline(NamedTuple):
    adj: AdjState
    table: AliasTable   # (V, C)

    @classmethod
    def build(cls, adj: AdjState) -> "AliasBaseline":
        V = adj.nbr.shape[0]
        return cls(adj, build_alias(_valid_w(adj, torch.arange(
            V, device=adj.nbr.device))))

    def sample(self, u, gen) -> torch.Tensor:
        """One next vertex for each of ``u`` (B,), from ``gen``."""
        u = u.to(torch.int64)
        u0, u1 = _uniform((2,) + tuple(u.shape), gen)
        slot = sample_alias(AliasTable(self.table.prob[u],
                                       self.table.alias[u]), u0, u1)
        return self.adj.nbr[u, slot]

    def insert(self, u, v, w) -> "AliasBaseline":
        return self._rebuild_row(adj_insert(self.adj, u, v, w), u)

    def delete(self, u, v) -> "AliasBaseline":
        return self._rebuild_row(adj_delete(self.adj, u, v), u)

    def _rebuild_row(self, adj: AdjState, u) -> "AliasBaseline":
        # O(d) per-update table rebuild — the cost Bingo's O(K) removes.
        u = _vertex(u, adj.nbr.device)
        t = build_alias(_valid_w(adj, u[None]))
        prob, alias = self.table.prob.clone(), self.table.alias.clone()
        prob[u], alias[u] = t.prob[0], t.alias[0]
        return AliasBaseline(adj, AliasTable(prob, alias))

    @staticmethod
    def sample_ops(d):
        return torch.ones_like(d)

    @staticmethod
    def update_ops(d):
        return d


# ---------------------------------------------------------------------------
# Inverse Transform Sampling (C-SAW / gSampler-style)
# ---------------------------------------------------------------------------

class ITSBaseline(NamedTuple):
    adj: AdjState
    cdf: torch.Tensor   # (V, C) inclusive prefix sums of biases

    @classmethod
    def build(cls, adj: AdjState) -> "ITSBaseline":
        V = adj.nbr.shape[0]
        return cls(adj, torch.cumsum(_valid_w(adj, torch.arange(
            V, device=adj.nbr.device)), dim=-1))

    def sample(self, u, gen) -> torch.Tensor:
        u = u.to(torch.int64)
        c = self.cdf[u]
        x = _uniform(tuple(u.shape), gen) * c[..., -1]
        return self.adj.nbr[u, _search(c, x, self.adj.nbr.shape[1])]

    def insert(self, u, v, w) -> "ITSBaseline":
        # append the bias: the row's new total from the appended slot on
        dev = self.adj.nbr.device
        C = self.adj.nbr.shape[1]
        u = _vertex(u, dev)
        d = self.adj.deg[u]
        prev = torch.where(d > 0, self.cdf[u, torch.clamp(d - 1, 0, C - 1)],
                           0.0)
        total = prev + _tensor(w, torch.float32, dev)
        return ITSBaseline(adj_insert(self.adj, u, v, w),
                           _row_put(self.cdf, u, total,
                                    (_cols(self.adj) >= d) & (d < C)))

    def delete(self, u, v) -> "ITSBaseline":
        # O(d): the row's prefix sums are recomputed
        adj = adj_delete(self.adj, u, v)
        u = _vertex(u, adj.nbr.device)
        cdf = self.cdf.clone()
        cdf[u] = torch.cumsum(_valid_w(adj, u[None])[0], dim=-1)
        return ITSBaseline(adj, cdf)

    @staticmethod
    def sample_ops(d):
        return torch.ceil(torch.log2(torch.clamp(d.to(torch.float32),
                                                 min=2.0)))

    @staticmethod
    def update_ops(d):
        return d  # the delete; an insert is O(1)


# ---------------------------------------------------------------------------
# Rejection sampling
# ---------------------------------------------------------------------------

class RejectionBaseline(NamedTuple):
    adj: AdjState
    wmax: torch.Tensor  # (V,) float32 largest bias of each row

    @classmethod
    def build(cls, adj: AdjState) -> "RejectionBaseline":
        V = adj.nbr.shape[0]
        return cls(adj, _valid_w(adj, torch.arange(
            V, device=adj.nbr.device)).max(-1).values)

    def sample(self, u, gen) -> torch.Tensor:
        """Up to ``_MAX_REJ`` trials a walker (one host sync a trial
        decides whether any walker is still rejected), then the exact ITS
        draw for the rest."""
        u = u.to(torch.int64)
        B = u.shape[0]
        adj = self.adj
        C = adj.nbr.shape[1]
        dg = torch.clamp(adj.deg[u], min=1)
        wm, wrow = self.wmax[u], adj.w[u]
        slot = torch.zeros(B, dtype=torch.int64, device=u.device)
        ok = torch.zeros(B, dtype=torch.bool, device=u.device)
        t = 0
        while t < _MAX_REJ and bool((~ok).any()):
            j = torch.minimum((_uniform((B,), gen) * dg).to(torch.int64),
                              (dg - 1).to(torch.int64))
            accept = _uniform((B,), gen) * wm \
                < wrow.gather(1, j[:, None])[:, 0]
            slot = torch.where(~ok & accept, j, slot)
            ok = ok | accept
            t += 1
        # exact ITS fallback for pathological rows (keeps the distribution)
        c = torch.cumsum(_valid_w(adj, u), dim=-1)
        x = _uniform((B,), gen) * c[:, -1]
        slot = torch.where(ok, slot, _search(c, x, C))
        return adj.nbr[u, slot]

    def insert(self, u, v, w) -> "RejectionBaseline":
        dev = self.adj.nbr.device
        uu = _vertex(u, dev)
        return RejectionBaseline(
            adj_insert(self.adj, u, v, w),
            _row_put(self.wmax, uu, torch.maximum(
                self.wmax[uu], _tensor(w, torch.float32, dev))))

    def delete(self, u, v) -> "RejectionBaseline":
        # O(d): the largest bias may shrink, rescan the row
        adj = adj_delete(self.adj, u, v)
        u = _vertex(u, adj.nbr.device)
        return RejectionBaseline(adj, _row_put(
            self.wmax, u, _valid_w(adj, u[None])[0].max()))

    @staticmethod
    def sample_ops(d, wmax=None, wsum=None):
        if wmax is None:
            return d  # worst-case bound O(d·max/Σ) with max/Σ ≈ O(1/1)
        return d.to(torch.float32) * wmax / torch.clamp(wsum, min=1e-9)

    @staticmethod
    def update_ops(d):
        return d


# ---------------------------------------------------------------------------
# Weighted reservoir (FlowWalker-style)
# ---------------------------------------------------------------------------

class ReservoirBaseline(NamedTuple):
    adj: AdjState

    @classmethod
    def build(cls, adj: AdjState) -> "ReservoirBaseline":
        return cls(adj)

    def sample(self, u, gen) -> torch.Tensor:
        """A-ExpJ weighted reservoir collapsed to its vectorised form: an
        exponential race, argmin Exp(1)/w_i over the row — weighted
        sampling at O(d) a draw, the FlowWalker cost the paper measures
        (its Fig. 16(b))."""
        u = u.to(torch.int64)
        w = _valid_w(self.adj, u)
        e = torch.empty(w.shape, device=w.device).exponential_(generator=gen)
        score = torch.where(w > 0, e / torch.clamp(w, min=1e-30),
                            torch.inf)
        return self.adj.nbr[u, torch.argmin(score, dim=-1)]

    def insert(self, u, v, w) -> "ReservoirBaseline":
        return ReservoirBaseline(adj_insert(self.adj, u, v, w))

    def delete(self, u, v) -> "ReservoirBaseline":
        return ReservoirBaseline(adj_delete(self.adj, u, v))

    @staticmethod
    def sample_ops(d):
        return d

    @staticmethod
    def update_ops(d):
        return torch.ones_like(d)
