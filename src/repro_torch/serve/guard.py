"""Validated ingestion: device-side update classification + quarantine.

Port of ``repro/serve/guard.py`` (DESIGN.md §11).

* ``make_classifier`` — a device-side pre-pass in torch ops that assigns
  every lane of an update round a reason code from the shared taxonomy
  (``core/updates``): ``R_OK`` / ``R_VERTEX`` / ``R_WEIGHT`` / ``R_DUP``
  / ``R_ABSENT`` / ``R_CAPACITY``, bit-equal to the reference's.  It
  replicates the batched round's ordering (segmented insert ranks
  against current degrees, post-insert delete locate), so a lane it
  marks OK is guaranteed to apply.  Where the reference sorts with
  ``lexsort((kv, ku))`` the port makes one stable ``torch.sort`` of the
  int64 key ``ku·(V+1) + kv + 1``; ``cummax`` is ``torch.cummax``; a
  scatter with ``mode="drop"`` is a full-permutation ``scatter_``.  The
  reference locates deletes in a copy of the whole ``(V, C)`` table with
  the round's inserts written in (1 GiB a round at 2^20 × 256); the port
  gathers the delete lanes' ``(B, C)`` rows and overlays this round's
  accepted inserts on them, and never writes to or copies ``state.nbr``.
  No op waits on the host (no ``.item()``, ``nonzero``, boolean-mask
  indexing or ``bincount``), so the classifier makes no host sync on the
  card.  A sharded engine's classifier codes its rank's lanes against its
  rows and sums the codes over the group with one ``all_reduce``.
* ``IngestGuard`` — the host-side bookkeeper (numpy, as in the
  reference): rejects go to a quarantine buffer as ``QuarantineRecord``s;
  capacity overflows spill to a bounded-retry pending queue that is
  re-attempted after rounds that applied deletes, or after a regrow.
  Conservation: ``accepted + quarantined + len(pending) == ingested``.
"""

from __future__ import annotations

from collections import deque
from typing import Deque, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.dyngraph import BingoConfig, _segment_rank
from repro_torch.core.updates import (NUM_REASONS, R_ABSENT, R_CAPACITY,
                                      R_DUP, R_OK, R_VERTEX, R_WEIGHT)

__all__ = ["GuardPolicy", "QuarantineRecord", "PendingInsert",
           "IngestGuard", "make_classifier", "valid_lanes"]


class GuardPolicy(NamedTuple):
    """Serving-side ingestion policy (DESIGN.md §11).

    ``reject_duplicates=False`` by default: Bingo is a multigraph engine
    (duplicate deletes resolve earliest-version-first), so duplicate
    inserts are legal — flip it to enforce simple-graph semantics.
    ``max_retries=0`` sends capacity overflows straight to quarantine
    instead of the pending queue.
    """
    reject_duplicates: bool = False
    max_retries: int = 4          # per-edge retry budget after overflow
    retry_batch: int = 64         # fixed lane count of a retry round


class QuarantineRecord(NamedTuple):
    round: int       # rounds_ingested at classification time
    is_insert: bool
    u: int
    v: int
    w: float
    reason: int      # R_* code (``REASON_NAMES[reason]`` for the label)


class PendingInsert(NamedTuple):
    round: int       # round that first saw the edge
    u: int
    v: int
    w: float
    retries_left: int


def valid_lanes(cfg: BingoConfig, u, v):
    """Endpoint-range mask against the GLOBAL vertex count."""
    V = cfg.num_vertices
    return (u >= 0) & (u < V) & (v >= 0) & (v < V)


def _scatter_back(order, vals):
    """``out[order[i]] = vals[i]`` for a permutation ``order``."""
    return torch.empty_like(vals).scatter_(0, order, vals)


def _sort_pairs(major, minor, V):
    """Stable order of lanes by ``(major, minor)``, ``major`` in [0, V],
    ``minor`` in [-1, V): the reference's ``lexsort((minor, major))``."""
    key = major.to(torch.int64) * (V + 1) + minor.to(torch.int64) + 1
    return torch.sort(key, stable=True).indices


def make_classifier(cfg: BingoConfig, policy: GuardPolicy = GuardPolicy(),
                    *, offset: int = 0, rows: Optional[int] = None,
                    group=None):
    """Build the device-side pre-pass.

    Returns ``classify(state, is_insert, u, v, w) -> (B,) int32`` reason
    codes on the state's device.  Mirrors the batched round's ordering —
    segmented insert ranks against current degrees decide ``R_CAPACITY``;
    deletes are located against the row *after* this round's accepted
    inserts (so deleting an edge inserted earlier in the same round is
    OK).  ``state`` is read, never written.

    For one vertex shard, ``state`` holds rows ``[offset, offset + rows)``
    of the whole state and ``group`` is the process group of the shards.
    The lanes whose source the shard owns are classified against its rows
    (degrees, neighbour rows, insert ranks and delete locates are all per
    source vertex), with endpoints still checked against the global
    vertex count; every other lane is ``R_OK`` locally.  One
    ``all_reduce`` sums the ``(B,)`` vectors over the group, so every
    rank returns the whole round's codes (a lane no rank owns is
    ``R_VERTEX`` everywhere) and its books stay equal to the other
    ranks'.  On NCCL the collective is stream-ordered: nothing waits on
    the host.
    """
    V, C = cfg.num_vertices, cfg.capacity
    Vr = V if rows is None else int(rows)      # rows of the state held here

    def classify(state, is_insert, u, v, w):
        dev = state.nbr.device
        B = u.shape[0]
        is_insert = is_insert.to(torch.bool)
        u = u.to(torch.int32)
        v = v.to(torch.int32)
        col = torch.arange(C, dtype=torch.int32, device=dev)[None, :]

        valid = valid_lanes(cfg, u, v)
        if rows is None:
            own = valid
        else:           # owned lanes, with source ids local to the shard
            own = valid & (u >= offset) & (u < offset + Vr)
            u = torch.where(own, u - offset, 0)
        if cfg.fp_bias:
            bad_w = ~torch.isfinite(w) | (w <= 0)
        else:
            bad_w = w.to(torch.int32) < 1
        bad_w = bad_w & is_insert & own         # delete lanes ignore w
        uc = torch.where(own, u, 0).to(torch.int64)     # wrap-safe gathers

        ins0 = is_insert & own & ~bad_w
        if policy.reject_duplicates:
            live = col < state.deg[uc][:, None]
            in_state = ((state.nbr[uc] == v[:, None]) & live).any(-1) & ins0
            ku = torch.where(ins0, u, Vr)
            kv = torch.where(ins0, v, -1)
            ordP = _sort_pairs(ku, kv, V)
            ku_s = ku[ordP]
            firstP = _segment_rank([ku_s, kv[ordP]]) == 0
            repeat = _scatter_back(ordP, ~firstP & (ku_s < Vr))
            dup = ins0 & (in_state | repeat)
        else:
            dup = torch.zeros(B, dtype=torch.bool, device=dev)
        ins1 = ins0 & ~dup

        # -- capacity: the batched round's segmented insert ranks --
        su = torch.where(ins1, u, Vr)
        order = torch.argsort(su, stable=True)
        su_s, v_s = su[order], v[order]
        rank = _segment_rank([su_s])
        deg_s = state.deg[torch.clamp(su_s, max=Vr - 1).to(torch.int64)]
        okA = (su_s < Vr) & (deg_s + rank < C)
        overflow = _scatter_back(order, (su_s < Vr) & ~okA)

        # -- absent deletes: located in the post-insert rows --
        del0 = ~is_insert & own
        du = torch.where(del0, u, Vr)
        dv = torch.where(del0, v, -1)
        ordD = _sort_pairs(du, dv, V)
        du_s, dv_s = du[ordD], dv[ordD]
        rankD = _segment_rank([du_s, dv_s])
        dcl = torch.clamp(du_s, max=Vr - 1).to(torch.int64)
        d0 = state.deg[dcl].to(torch.int64)
        rows_ = state.nbr[dcl]                                  # (B, C)
        # the row's accepted inserts are its segment of the sorted insert
        # lanes, the first C - deg of them, at slots deg, deg + 1, ...
        lo = torch.searchsorted(su_s, du_s)
        hi = torch.searchsorted(su_s, du_s, right=True)
        n_ok = torch.clamp(torch.minimum(hi - lo, C - d0), min=0)
        k = col - d0[:, None]
        new = (k >= 0) & (k < n_ok[:, None])
        at = torch.clamp(lo[:, None] + k, 0, B - 1)
        rows_ = torch.where(new, v_s[at], rows_)
        m = (rows_ == dv_s[:, None]) & (col < (d0 + n_ok)[:, None]) \
            & (du_s < Vr)[:, None]
        cnt = torch.cumsum(m, dim=-1, dtype=torch.int32)
        hit = (m & (cnt == (rankD + 1)[:, None])).any(-1)
        found = _scatter_back(ordD, hit & (du_s < Vr))
        absent = del0 & ~found

        reasons = torch.full((B,), R_OK, dtype=torch.int32, device=dev)
        reasons = torch.where(~own, R_VERTEX, reasons)
        reasons = torch.where(bad_w, R_WEIGHT, reasons)
        reasons = torch.where(dup, R_DUP, reasons)
        reasons = torch.where(ins1 & overflow, R_CAPACITY, reasons)
        reasons = torch.where(absent, R_ABSENT, reasons)
        reasons = reasons.to(torch.int32)
        if rows is not None:
            # each valid lane has one owner: the sum is the owner's code
            reasons = torch.where(own, reasons, R_OK)
            if group is not None:
                import torch.distributed as dist
                dist.all_reduce(reasons, group=group)
            reasons = torch.where(valid, reasons, R_VERTEX)
        return reasons

    return classify


class IngestGuard:
    """Host-side quarantine buffer + pending-overflow queue.

    One per guarded engine.  ``account`` ingests a classified round's
    reason codes; ``take_retry`` hands back a fixed-shape retry batch of
    pending inserts once deletes (or a regrow) may have made capacity;
    ``settle_retry`` routes each retried lane to accepted /
    back-to-pending / quarantine.  ``offset``/``rows``/``group`` make the
    classifier a shard's (``make_classifier``); the books are the whole
    round's on every rank.
    """

    def __init__(self, cfg: BingoConfig,
                 policy: GuardPolicy = GuardPolicy(), *, offset: int = 0,
                 rows: Optional[int] = None, group=None):
        self.cfg = cfg
        self.policy = policy
        self._shard = dict(offset=offset, rows=rows, group=group)
        self.classify = make_classifier(cfg, policy, **self._shard)
        self.quarantine: List[QuarantineRecord] = []
        self.pending: Deque[PendingInsert] = deque()
        self.ingested = 0
        self.accepted = 0
        self.quarantined = 0
        self.retried = 0
        self.reason_counts = np.zeros(NUM_REASONS, np.int64)
        self.deletes_since_retry = 0
        self.regrows_since_retry = 0

    # -- conservation ------------------------------------------------------
    def check_conservation(self):
        """accepted + quarantined + pending == ingested, or raise."""
        total = self.accepted + self.quarantined + len(self.pending)
        if total != self.ingested:
            raise AssertionError(
                f"guard conservation broken: accepted={self.accepted} + "
                f"quarantined={self.quarantined} + "
                f"pending={len(self.pending)} != ingested={self.ingested}")

    def snapshot(self) -> dict:
        """JSON-able guard state for checkpoint manifests."""
        return {
            "ingested": self.ingested, "accepted": self.accepted,
            "quarantined": self.quarantined, "retried": self.retried,
            "deletes_since_retry": self.deletes_since_retry,
            "regrows_since_retry": self.regrows_since_retry,
            "reason_counts": self.reason_counts.tolist(),
            "quarantine": [list(q) for q in self.quarantine],
            "pending": [list(p) for p in self.pending],
        }

    def load_snapshot(self, snap: dict):
        self.ingested = int(snap["ingested"])
        self.accepted = int(snap["accepted"])
        self.quarantined = int(snap["quarantined"])
        self.retried = int(snap["retried"])
        self.deletes_since_retry = int(snap["deletes_since_retry"])
        self.regrows_since_retry = int(snap.get("regrows_since_retry", 0))
        self.reason_counts = np.asarray(snap["reason_counts"], np.int64)
        self.quarantine = [
            QuarantineRecord(int(r), bool(i), int(u), int(v), float(w),
                             int(c))
            for r, i, u, v, w, c in snap["quarantine"]]
        self.pending = deque(
            PendingInsert(int(r), int(u), int(v), float(w), int(n))
            for r, u, v, w, n in snap["pending"])

    # -- main-round accounting --------------------------------------------
    def account(self, rnd, is_insert, u, v, w, reasons_np) -> np.ndarray:
        """Route one classified round; returns the per-reason counts.

        OK lanes count as accepted (the caller applies them with
        ``active = reasons == R_OK``); ``R_CAPACITY`` insert lanes spill
        to the pending queue (quarantine when ``max_retries == 0``);
        everything else is quarantined.
        """
        is_insert = np.asarray(is_insert)
        u, v, w = np.asarray(u), np.asarray(v), np.asarray(w)
        counts = np.bincount(reasons_np, minlength=NUM_REASONS)
        counts[R_OK] = 0
        self.ingested += int(reasons_np.shape[0])
        self.accepted += int(np.sum(reasons_np == R_OK))
        self.reason_counts += counts
        for i in np.nonzero(reasons_np != R_OK)[0]:
            code = int(reasons_np[i])
            if code == R_CAPACITY and self.policy.max_retries > 0:
                self.pending.append(PendingInsert(
                    rnd, int(u[i]), int(v[i]), float(w[i]),
                    self.policy.max_retries))
            else:
                self.quarantine.append(QuarantineRecord(
                    rnd, bool(is_insert[i]), int(u[i]), int(v[i]),
                    float(w[i]), code))
                self.quarantined += 1
        return counts

    # -- capacity regrowth -------------------------------------------------
    def regrow(self, cfg_next: BingoConfig):
        """Re-target the guard at a grown capacity tier (DESIGN.md §14):
        rebuild the classifier at the new capacity and restore every
        pending insert's retry budget."""
        self.cfg = cfg_next
        self.classify = make_classifier(cfg_next, self.policy, **self._shard)
        self.regrows_since_retry += 1
        self.pending = deque(
            p._replace(retries_left=self.policy.max_retries)
            for p in self.pending)

    # -- overflow retries --------------------------------------------------
    def want_retry(self) -> bool:
        # Retry once capacity may have been freed (deletes) *or* created
        # (a ladder regrow); deletes alone would starve insert-only
        # streams.
        return bool(self.pending) and (self.deletes_since_retry > 0
                                       or self.regrows_since_retry > 0)

    def take_retry(self):
        """Pop up to ``retry_batch`` pending inserts; pad to fixed shape.

        Returns ``(entries, u, v, w)`` — entries is the popped list (its
        length is the live lane count), arrays are ``(retry_batch,)``
        with pad lanes ``u = -1`` (classified ``R_VERTEX``, never
        applied, never accounted).
        """
        R = self.policy.retry_batch
        entries = [self.pending.popleft()
                   for _ in range(min(R, len(self.pending)))]
        u = np.full(R, -1, np.int32)
        v = np.zeros(R, np.int32)
        w = np.ones(R, np.float32 if self.cfg.fp_bias else np.int32)
        for i, p in enumerate(entries):
            u[i], v[i], w[i] = p.u, p.v, p.w
        self.deletes_since_retry = 0
        self.regrows_since_retry = 0
        return entries, u, v, w

    def settle_retry(self, rnd, entries, reasons_np) -> int:
        """Route retried lanes; returns how many applied."""
        applied = 0
        for i, p in enumerate(entries):
            code = int(reasons_np[i])
            if code != R_OK:
                self.reason_counts[code] += 1
            if code == R_OK:
                self.accepted += 1
                self.retried += 1
                applied += 1
            elif code == R_CAPACITY and p.retries_left > 1:
                self.pending.append(p._replace(retries_left=p.retries_left - 1))
            else:
                # out of retries — or the state changed under the entry;
                # quarantine with the final reason, R_CAPACITY for
                # exhausted budgets.
                self.quarantine.append(QuarantineRecord(
                    rnd, True, p.u, p.v, p.w, code))
                self.quarantined += 1
        return applied
