"""Structural invariants of the Bingo sampling space.

Port of ``repro/core/invariants.py``.  Two entry points (DESIGN.md §11):

* ``check_state`` — the exhaustive numpy oracle.  Walks every rule the
  sampling space depends on and returns a structured violation report
  (list of ``Violation(vertex, digit, rule, detail)``, in the reference's
  order); with ``assert_ok=True`` (the default) it raises
  ``AssertionError`` listing the violations.  Only the rows it checks are
  copied to the host.
* ``check_state_device`` — the cheap subset as torch ops: per-rule
  *violating-vertex counts* over the row tables, a device tensor, with no
  host sync (``DynamicWalkEngine.audit`` reads it).  It covers the
  O(V·C) row/counter rules (``DEVICE_RULES``).  The reference builds the
  ``(V, C, K)`` digit tensor at once — 16 GiB at 2^20 vertices, C = 256,
  K = 16 — so the port counts the same vertices ``chunk`` rows at a time.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.dyngraph import (DENSE, EMPTY, ONE, REGULAR, SPARSE,
                                      BingoConfig, _default_chunk, classify)

__all__ = ["Violation", "check_state", "check_state_device", "DEVICE_RULES"]


class Violation(NamedTuple):
    vertex: int       # offending vertex
    digit: int        # radix-group index, -1 for row-level rules
    rule: str         # rule id (see DEVICE_RULES + the host-only rules)
    detail: str       # human-readable specifics


# Rules covered by the device-side subset, in output order.
# ``at_capacity`` is a *pressure* rule, not a corruption rule: it counts
# rows sitting at ``deg == capacity`` while inserts are pending against
# the state (``pending_inserts > 0``) — the loss-imminent condition the
# §14 capacity ladder exists to relieve.  With the default
# ``pending_inserts=0`` it never fires.
DEVICE_RULES = ("deg_range", "live_nbr", "stale_tail", "bias_positive",
                "digitsum", "gsize", "wdec", "gtype", "at_capacity")


def _row_counts(state, cfg: BingoConfig, v0: int, v1: int,
                pending: bool) -> torch.Tensor:
    """Per-rule violating-vertex counts of rows ``[v0, v1)``."""
    C = state.nbr.shape[1]
    K = cfg.num_radix
    r, B = cfg.base_log2, cfg.base
    i32 = torch.int32
    nbr, bias, frac = state.nbr[v0:v1], state.bias[v0:v1], state.frac[v0:v1]
    deg = state.deg[v0:v1]
    col = torch.arange(C, dtype=i32, device=nbr.device)[None, :]
    live = col < deg[:, None]                               # (R, C)

    bad_deg = (deg < 0) | (deg > C)
    bad_live = (live & (nbr < 0)).any(-1)
    bad_tail = (~live & (nbr != -1)).any(-1)
    if cfg.fp_bias:
        bad_bias = (live & (bias + frac <= 0)).any(-1)
    else:
        bad_bias = (live & (bias < 1)).any(-1)

    ks = torch.arange(K, dtype=i32, device=nbr.device)
    digs = torch.where(live[..., None], (bias[..., None] >> (r * ks)) & (B - 1),
                       0)                                   # (R, C, K)
    bad_dsum = (state.digitsum[v0:v1] != digs.sum(1, dtype=i32)).any(-1)
    bad_gsz = (state.gsize[v0:v1]
               != (digs != 0).sum(1, dtype=i32)).any(-1)
    del digs
    bad_wdec = (state.wdec[v0:v1]
                - torch.where(live, frac, 0.0).sum(-1)).abs() > 1e-4
    bad_type = (state.gtype[v0:v1]
                != classify(state.gsize[v0:v1], deg, cfg)).any(-1)
    bad_cap = (deg == C) & pending

    counts = [bad_deg, bad_live, bad_tail, bad_bias,
              bad_dsum, bad_gsz, bad_wdec, bad_type, bad_cap]
    return torch.stack([b.sum(dtype=i32) for b in counts])


def check_state_device(state, cfg: BingoConfig, pending_inserts: int = 0,
                       chunk: Optional[int] = None) -> torch.Tensor:
    """Per-rule violating-vertex counts, ``(len(DEVICE_RULES),)`` int32 on
    the state's device.

    All-zero means the row tables and per-vertex counters are mutually
    consistent.  The rows are swept ``chunk`` at a time (default
    ``_default_chunk(cfg)``: each ``(rows, C, K)`` digit intermediate
    near 256 MiB); nothing waits on the host.
    """
    V = state.nbr.shape[0]
    chunk = chunk or _default_chunk(cfg)
    pending = int(pending_inserts) > 0
    total = torch.zeros(len(DEVICE_RULES), dtype=torch.int32,
                        device=state.nbr.device)
    for v0 in range(0, V, chunk):
        total += _row_counts(state, cfg, v0, min(V, v0 + chunk), pending)
    return total


def _host(x, idx):
    """Rows ``idx`` (all rows if None) of a tensor or array, as numpy."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        if idx is not None:
            x = x[torch.as_tensor(idx, dtype=torch.int64, device=x.device)]
        return x.detach().cpu().numpy()
    x = np.asarray(x)
    return x if idx is None else x[np.asarray(idx, np.int64)]


def check_state(state, cfg: BingoConfig, vertices=None, *,
                assert_ok: bool = True,
                pending_inserts: int = 0) -> List[Violation]:
    """Exhaustive host-side audit; returns the full violation report.

    ``state`` holds tensors (on any device) or numpy arrays; with
    ``vertices`` only those rows are copied to the host.
    ``assert_ok=True`` raises ``AssertionError`` (listing up to the
    first 20 violations) when the report is non-empty.
    ``assert_ok=False`` always returns.
    """
    verts = None if vertices is None else [int(u) for u in vertices]
    nbr = _host(state.nbr, verts)
    bias = _host(state.bias, verts)
    frac = _host(state.frac, verts)
    deg = _host(state.deg, verts)
    gmem = _host(state.gmem, verts)
    ginv = _host(state.ginv, verts)
    gsize = _host(state.gsize, verts)
    digitsum = _host(state.digitsum, verts)
    wdec = _host(state.wdec, verts)
    gtype = _host(state.gtype, verts)
    iprob = _host(state.itable.prob, verts)
    ialias = _host(state.itable.alias, verts)

    C = nbr.shape[1]
    K = cfg.num_radix
    B = cfg.base
    r = cfg.base_log2
    rows = enumerate(range(nbr.shape[0]) if verts is None else verts)
    out: List[Violation] = []

    def bad(u, k, rule, detail):
        out.append(Violation(int(u), int(k), rule, detail))

    for i, u in rows:
        d = int(deg[i])
        if not 0 <= d <= C:
            bad(u, -1, "deg_range", f"deg={d} outside [0, {C}]")
            continue  # the row rules below index with d
        if not (nbr[i, :d] >= 0).all():
            bad(u, -1, "live_nbr", f"negative neighbor in live slots: "
                f"{nbr[i, :d].tolist()}")
        if not (nbr[i, d:] == -1).all():
            bad(u, -1, "stale_tail", "neighbor past deg not -1")
        if not cfg.fp_bias:
            if not (bias[i, :d] >= 1).all():
                bad(u, -1, "bias_positive", "zero/negative int bias in "
                    "live slot")
        else:
            if not (bias[i, :d] + frac[i, :d] > 0).all():
                bad(u, -1, "bias_positive", "non-positive fp bias in "
                    "live slot")
        # counters match the adjacency row exactly
        digs = (bias[i, :d, None] >> (r * np.arange(K))) & (B - 1)  # (d, K)
        if not (digitsum[i] == digs.sum(0)).all():
            bad(u, -1, "digitsum",
                f"{digitsum[i].tolist()} vs recomputed {digs.sum(0).tolist()}")
        if not (gsize[i] == (digs != 0).sum(0)).all():
            bad(u, -1, "gsize",
                f"{gsize[i].tolist()} vs recomputed "
                f"{(digs != 0).sum(0).tolist()}")
        if not np.isclose(wdec[i], frac[i, :d].sum(), atol=1e-4):
            bad(u, -1, "wdec", f"{wdec[i]} vs recomputed {frac[i, :d].sum()}")
        if pending_inserts > 0 and d == C:
            bad(u, -1, "at_capacity",
                f"row full at deg == C == {C} with {pending_inserts} "
                "insert(s) pending — regrow (DESIGN.md §14) or lose them")

        for k in range(K):
            sz = int(gsize[i, k])
            expected = set(np.nonzero(digs[:, k] != 0)[0].tolist())
            t = int(gtype[i, k])
            if sz == 0:
                if t != EMPTY:
                    bad(u, k, "gtype", f"empty group typed {t}")
                continue
            if cfg.adaptive:
                if sz > cfg.alpha * d:
                    want = DENSE
                elif sz == 1:
                    want = ONE
                elif sz < cfg.beta * d:
                    want = SPARSE
                else:
                    want = REGULAR
            else:
                want = REGULAR
            if t != want:
                bad(u, k, "gtype", f"classified {t}, expected {want} "
                    f"(gsize={sz}, deg={d})")
            if t == DENSE:
                continue  # unmaterialized — nothing else to check
            # materialized: gmem prefix lists exactly the member slots
            got = gmem[i, k, :sz]
            if not (got >= 0).all():
                bad(u, k, "gmem_hole", f"hole in group row: {got.tolist()}")
                continue
            if len(set(got.tolist())) != sz:
                bad(u, k, "gmem_dup", f"duplicate slot in group row: "
                    f"{sorted(got.tolist())}")
            if set(got.tolist()) != expected:
                bad(u, k, "gmem_membership",
                    f"{sorted(got.tolist())} vs expected {sorted(expected)}")
            if not (gmem[i, k, sz:] == -1).all():
                bad(u, k, "gmem_stale_tail", "group row past gsize not -1")
            if ginv is not None:
                for p_, s_ in enumerate(got):
                    if ginv[i, k, s_] != p_:
                        bad(u, k, "ginv", f"ginv[{s_}]={ginv[i, k, s_]}, "
                            f"expected {p_}")
                dead = np.setdiff1d(np.arange(C), got)
                if not (ginv[i, k, dead] == -1).all():
                    bad(u, k, "ginv_stale", "stale inverted entries")

        # inter-group alias row encodes the exact group weights (Thm 4.1
        # stage-(i) marginal)
        wts = digitsum[i].astype(np.float64) * (float(B) ** np.arange(K))
        if cfg.fp_bias:
            wts = np.append(wts, wdec[i])
        prob = np.asarray(iprob[i], np.float64)
        al = ialias[i]
        n = len(prob)
        enc = prob.copy()
        for j in range(n):
            enc[al[j]] += 1.0 - prob[j]
        enc /= n
        tot = wts.sum()
        if tot > 0 and not np.allclose(enc, wts / tot, atol=2e-4):
            bad(u, -1, "alias_encoding",
                f"alias row encodes {enc.tolist()}, group weights "
                f"{(wts / tot).tolist()}")

    if assert_ok and out:
        head = "\n  ".join(
            f"v{vi.vertex} g{vi.digit} [{vi.rule}] {vi.detail}"
            for vi in out[:20])
        more = "" if len(out) <= 20 else f"\n  ... and {len(out) - 20} more"
        raise AssertionError(
            f"{len(out)} invariant violation(s):\n  {head}{more}")
    return out
