"""Bingo dynamic-graph + sampling-space state (paper §3–§5).

Port of ``repro/core/dyngraph.py``.  Fixed-capacity padded tensors:

  adjacency          nbr/bias/frac : (V, C)      slot-compact rows, ``deg`` counts
  intra-group lists  gmem          : (V, K, Cg)  neighbor *slot indices* (§4.2)
  inverted index     ginv          : (V, K, C)   slot -> position-in-group
                                                 (baseline mode only)
  counters           gsize, digitsum : (V, K)    |G_k| and Σ digit_k(w_i)
  decimal group      wdec          : (V,)        Σ frac (fp-bias mode, §4.3)
  group types        gtype         : (V, K)      Eq. 9 classification (§5.1)
  inter-group space  itable        : alias table over K (+1 decimal) groups

Every derived table is a pure function of ``(bias_row, frac_row, deg)``;
``build_vertex_groups`` computes it for a batch of rows.  Builds run in
vertex chunks so the ``(rows, C, K)`` digit intermediates stay small at
a million vertices.  ``refresh_vertices`` updates the state's tensors in
place (the counterpart of the reference's donated buffers).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import radix
from repro_torch.core.alias import AliasTable, _row_total, build_alias

__all__ = [
    "EMPTY", "DENSE", "ONE", "SPARSE", "REGULAR",
    "BingoConfig", "BingoState",
    "classify", "build_vertex_groups", "build_itable_rows",
    "empty_state", "from_edges", "refresh_vertices",
    "state_from_numpy", "state_to_numpy",
]

# Group type codes (Eq. 9); precedence dense > one-element > sparse > regular.
EMPTY, DENSE, ONE, SPARSE, REGULAR = 0, 1, 2, 3, 4

_STATE_FIELDS = ("nbr", "bias", "frac", "deg", "gmem", "ginv", "gsize",
                 "digitsum", "wdec", "gtype")


@dataclasses.dataclass(frozen=True)
class BingoConfig:
    """Static configuration; the same fields and properties as the
    reference's ``BingoConfig``."""

    num_vertices: int
    capacity: int                 # C — max neighbors per vertex
    bias_bits: int = 16           # max integer-bias width
    base_log2: int = 1            # radix base = 2**base_log2 (paper: base 2)
    adaptive: bool = True         # §5.1 group-adaptive (GA) vs baseline (BS)
    alpha: float = 0.40           # dense threshold  (|G|/d > alpha)
    beta: float = 0.10            # sparse threshold (|G|/d < beta)
    fp_bias: bool = False         # §4.3 floating-point biases
    lam: float = 16.0             # λ amortization factor (fp mode)
    backend: str = "auto"         # engine backend (core/backend.py)
    cohorts: int = 1              # walk-kernel interleaving factor (unused
                                  # by the CUDA kernel; output-invariant)
    capacity_ladder: tuple = ()   # pre-declared capacity tiers for regrowth

    def __post_init__(self):
        if not isinstance(self.capacity_ladder, tuple):
            object.__setattr__(self, "capacity_ladder",
                               tuple(int(c) for c in self.capacity_ladder))
        lad = self.capacity_ladder
        if lad:
            if any(b <= a for a, b in zip(lad, lad[1:])):
                raise ValueError(
                    f"capacity_ladder must be strictly increasing: {lad}")
            if self.capacity not in lad:
                raise ValueError(
                    f"capacity {self.capacity} is not a rung of "
                    f"capacity_ladder {lad} — the ladder must be declared "
                    "up front so every tier's programs are known")

    @property
    def ladder(self) -> tuple:
        """The capacity tiers, always non-empty."""
        return self.capacity_ladder or (self.capacity,)

    @property
    def tier(self) -> int:
        """Index of the current capacity in the ladder."""
        return self.ladder.index(self.capacity)

    def tier_config(self, t: int) -> "BingoConfig":
        """The config at ladder rung ``t`` (only ``capacity`` differs)."""
        return dataclasses.replace(self, capacity=self.ladder[t])

    @property
    def num_radix(self) -> int:
        """K — number of radix groups."""
        return radix.num_groups(self.bias_bits, self.base_log2)

    @property
    def group_capacity(self) -> int:
        """Cg — per-group slot capacity (``ceil(alpha*C)+1`` in adaptive
        mode, where larger groups are DENSE and unmaterialized)."""
        if self.adaptive:
            return min(self.capacity,
                       int(math.ceil(self.alpha * self.capacity)) + 1)
        return self.capacity

    @property
    def num_inter(self) -> int:
        """Entries in the inter-group alias table (K + decimal group)."""
        return self.num_radix + (1 if self.fp_bias else 0)

    @property
    def base(self) -> int:
        return 1 << self.base_log2


class BingoState(NamedTuple):
    nbr: torch.Tensor               # (V, C) int32, -1 padded
    bias: torch.Tensor              # (V, C) int32 integer (λ-scaled) biases
    frac: torch.Tensor              # (V, C) float32 decimal parts (fp mode)
    deg: torch.Tensor               # (V,) int32
    gmem: torch.Tensor              # (V, K, Cg) int32 slot indices, -1 padded
    ginv: Optional[torch.Tensor]    # (V, K, C) int32 or None (adaptive mode)
    gsize: torch.Tensor             # (V, K) int32
    digitsum: torch.Tensor          # (V, K) int32
    wdec: torch.Tensor              # (V,) float32 decimal group weight
    gtype: torch.Tensor             # (V, K) int8 Eq. 9 classes
    itable: AliasTable              # prob/alias (V, num_inter)

    @property
    def num_vertices(self) -> int:
        return self.nbr.shape[0]


def classify(gsize: torch.Tensor, deg: torch.Tensor,
             cfg: BingoConfig) -> torch.Tensor:
    """Eq. 9 group classification over ``(..., K)`` sizes.

    The thresholds are float32 products ``alpha_f32 * deg``, as in the
    reference (a weakly typed Python float times a float32 array).
    """
    if not cfg.adaptive:
        return torch.where(gsize > 0, REGULAR, EMPTY).to(torch.int8)
    dev = gsize.device
    degf = deg[..., None].to(torch.float32)
    g = gsize.to(torch.float32)
    alpha = torch.tensor(cfg.alpha, dtype=torch.float32, device=dev)
    beta = torch.tensor(cfg.beta, dtype=torch.float32, device=dev)
    t = torch.where(g > alpha * degf, DENSE,
                    torch.where(gsize == 1, ONE,
                                torch.where(g < beta * degf, SPARSE, REGULAR)))
    return torch.where(gsize == 0, EMPTY, t).to(torch.int8)


def build_vertex_groups(cfg: BingoConfig, bias_rows, frac_rows, deg):
    """Full sampling-space (re)build for a batch of R rows.

    ``bias_rows``/``frac_rows`` (R, C), ``deg`` (R,).  Returns ``(gmem
    (R,K,Cg), ginv (R,K,C)|None, gsize (R,K), digitsum (R,K), gtype (R,K),
    wdec (R,))``.  ``wdec`` is a left-to-right sum over the C lanes, the
    order the update kernel uses.
    """
    K, C, Cg = cfg.num_radix, cfg.capacity, cfg.group_capacity
    R = bias_rows.shape[0]
    dev = bias_rows.device
    valid = torch.arange(C, dtype=torch.int32, device=dev)[None, :] < deg[:, None]
    digs = radix.digits(bias_rows, K, cfg.base_log2)           # (R, C, K)
    digs = torch.where(valid[..., None], digs, 0)
    member = digs != 0
    gsize = member.sum(1, dtype=torch.int32)                    # (R, K)
    digitsum = digs.sum(1, dtype=torch.int32)
    gtype = classify(gsize, deg, cfg)

    pos = torch.cumsum(member, dim=1, dtype=torch.int32) - 1    # (R, C, K)
    keep = member & (pos < Cg)
    if cfg.adaptive:                                            # DENSE rows stay empty
        keep = keep & (gtype[:, None, :] != DENSE)
    ks = torch.arange(K, dtype=torch.int32, device=dev)
    flat = torch.where(keep, ks * Cg + pos, K * Cg).to(torch.int64)
    slot = torch.arange(C, dtype=torch.int32, device=dev)[None, :, None]
    gmem = torch.full((R, K * Cg + 1), -1, dtype=torch.int32, device=dev)
    gmem.scatter_(1, flat.reshape(R, C * K),
                  slot.expand(R, C, K).reshape(R, C * K))
    gmem = gmem[:, :K * Cg].reshape(R, K, Cg)

    ginv = None
    if not cfg.adaptive:
        ginv = torch.where(member, pos, -1).transpose(1, 2).contiguous()

    wdec = _row_total(torch.where(valid, frac_rows, 0.0))
    return gmem, ginv, gsize, digitsum, gtype, wdec


def build_itable_rows(cfg: BingoConfig, digitsum, wdec) -> AliasTable:
    """Inter-group alias tables (stage-(i) sampling space) from counters."""
    w = radix.group_weights(digitsum, cfg.base_log2)
    if cfg.fp_bias:
        w = torch.cat([w, wdec[..., None]], dim=-1)             # decimal group
    return build_alias(w)


def empty_state(cfg: BingoConfig, device="cuda") -> BingoState:
    V, C, K, Cg = (cfg.num_vertices, cfg.capacity, cfg.num_radix,
                   cfg.group_capacity)
    i32 = dict(dtype=torch.int32, device=device)
    n = cfg.num_inter
    return BingoState(
        nbr=torch.full((V, C), -1, **i32),
        bias=torch.zeros((V, C), **i32),
        frac=torch.zeros((V, C), dtype=torch.float32, device=device),
        deg=torch.zeros((V,), **i32),
        gmem=torch.full((V, K, Cg), -1, **i32),
        ginv=None if cfg.adaptive else torch.full((V, K, C), -1, **i32),
        gsize=torch.zeros((V, K), **i32),
        digitsum=torch.zeros((V, K), **i32),
        wdec=torch.zeros((V,), dtype=torch.float32, device=device),
        gtype=torch.zeros((V, K), dtype=torch.int8, device=device),
        itable=AliasTable(
            prob=torch.ones((V, n), dtype=torch.float32, device=device),
            alias=torch.arange(n, **i32).expand(V, n).contiguous()),
    )


def _segment_rank(keys):
    """Rank of each entry within its run of equal consecutive ``keys``
    (a list of equal-length tensors, compared together)."""
    B = keys[0].shape[0]
    dev = keys[0].device
    idx = torch.arange(B, dtype=torch.int64, device=dev)
    first = torch.zeros(B, dtype=torch.bool, device=dev)
    for k in keys:
        first[1:] = first[1:] | (k[1:] != k[:-1])
    first[0] = True
    return idx - torch.cummax(torch.where(first, idx, -1), dim=0).values


def _scatter_adjacency(cfg: BingoConfig, src, dst, w_int, w_frac):
    """Slot-compact adjacency tensors from an edge list.

    Edges of one source keep their input order (stable sort); edges past
    a row's capacity are dropped, as the reference's ``mode="drop"`` does.
    """
    V, C = cfg.num_vertices, cfg.capacity
    dev = src.device
    order = torch.argsort(src, stable=True)
    s, d = src[order], dst[order]
    wi, wf = w_int[order], w_frac[order]
    rank = _segment_rank([s])
    ok = (rank < C) & (s >= 0) & (s < V)
    s_ok, r_ok = s[ok].to(torch.int64), rank[ok]
    nbr = torch.full((V, C), -1, dtype=torch.int32, device=dev)
    bias = torch.zeros((V, C), dtype=torch.int32, device=dev)
    frac = torch.zeros((V, C), dtype=torch.float32, device=dev)
    nbr[s_ok, r_ok] = d[ok]
    bias[s_ok, r_ok] = wi[ok]
    frac[s_ok, r_ok] = wf[ok]
    deg = torch.bincount(s_ok, minlength=V).to(torch.int32)
    return nbr, bias, frac, deg


def _default_chunk(cfg: BingoConfig) -> int:
    """Rows per group-build chunk: keeps each (rows, C, K) int32
    intermediate near 256 MiB."""
    return max(1, (1 << 26) // max(1, cfg.capacity * cfg.num_radix))


def from_edges(cfg: BingoConfig, src, dst, bias, device="cuda",
               chunk: Optional[int] = None) -> BingoState:
    """Construct the full Bingo sampling space from an edge list.

    ``src``/``dst``/``bias`` are numpy arrays or tensors; ``bias`` is
    integer in integer mode and float in fp mode (λ-scaled per §4.3).
    The group tables are built ``chunk`` vertices at a time.
    """
    src = torch.as_tensor(np.asarray(src), dtype=torch.int32).to(device)
    dst = torch.as_tensor(np.asarray(dst), dtype=torch.int32).to(device)
    bias_t = torch.as_tensor(np.asarray(bias)).to(device)
    if cfg.fp_bias:
        w_int, w_frac = radix.decompose_fp(bias_t, cfg.lam)
    else:
        w_int = bias_t.to(torch.int32)
        w_frac = torch.zeros(src.shape, dtype=torch.float32, device=device)
    nbr, b, f, deg = _scatter_adjacency(cfg, src, dst, w_int, w_frac)
    st = empty_state(cfg, device)
    st = st._replace(nbr=nbr, bias=b, frac=f, deg=deg)
    V = cfg.num_vertices
    chunk = chunk or _default_chunk(cfg)
    for v0 in range(0, V, chunk):
        v1 = min(V, v0 + chunk)
        gmem, ginv, gsize, digitsum, gtype, wdec = build_vertex_groups(
            cfg, b[v0:v1], f[v0:v1], deg[v0:v1])
        st.gmem[v0:v1] = gmem
        if ginv is not None:
            st.ginv[v0:v1] = ginv
        st.gsize[v0:v1] = gsize
        st.digitsum[v0:v1] = digitsum
        st.gtype[v0:v1] = gtype
        st.wdec[v0:v1] = wdec
    itab = build_itable_rows(cfg, st.digitsum, st.wdec)
    return st._replace(itable=itab)


def refresh_vertices(state: BingoState, cfg: BingoConfig, verts,
                     chunk: int = 4096) -> BingoState:
    """Rebuild group rows + inter-group tables of a padded vertex list,
    in place.  Entries of ``verts`` equal to ``V`` (sentinel) are skipped.
    Returns ``state`` (its tensors updated in place)."""
    V = cfg.num_vertices
    verts = verts[verts < V].to(torch.int64)
    for i0 in range(0, verts.shape[0], chunk):
        vv = verts[i0:i0 + chunk]
        gmem, ginv, gsize, digitsum, gtype, wdec = build_vertex_groups(
            cfg, state.bias[vv], state.frac[vv], state.deg[vv])
        itab = build_itable_rows(cfg, digitsum, wdec)
        state.gmem[vv] = gmem
        if state.ginv is not None:
            state.ginv[vv] = ginv
        state.gsize[vv] = gsize
        state.digitsum[vv] = digitsum
        state.gtype[vv] = gtype
        state.wdec[vv] = wdec
        state.itable.prob[vv] = itab.prob
        state.itable.alias[vv] = itab.alias
    return state


def state_from_numpy(arrays, cfg: BingoConfig, device="cuda") -> BingoState:
    """A ``BingoState`` on ``device`` from numpy leaves.

    ``arrays`` is any object with the state's fields as attributes (a
    reference ``BingoState``, or what ``state_to_numpy`` returns); each
    leaf goes through ``np.asarray``.
    """
    def t(x):
        return torch.from_numpy(np.array(x, copy=True)).to(device)
    leaves = {f: getattr(arrays, f) for f in _STATE_FIELDS}
    st = {f: (None if x is None else t(x)) for f, x in leaves.items()}
    if (st["ginv"] is None) != cfg.adaptive:
        raise ValueError("ginv must be present exactly in baseline mode")
    return BingoState(**st, itable=AliasTable(t(arrays.itable.prob),
                                              t(arrays.itable.alias)))


def state_to_numpy(state: BingoState) -> BingoState:
    """The same state with every leaf as a numpy array (``ginv`` may stay
    None) — the inverse of ``state_from_numpy``."""
    def a(x):
        return None if x is None else x.detach().cpu().numpy()
    return BingoState(**{f: a(getattr(state, f)) for f in _STATE_FIELDS},
                      itable=AliasTable(a(state.itable.prob),
                                        a(state.itable.alias)))
