"""Dynamic-update workload builder — the paper's §6.1 three-step recipe.

  (i)   split edges into set A (original − 10·BATCHSIZE) and B (10·BATCHSIZE);
  (ii)  per update, coin-flip insert vs delete (or force one for the
        "Insertion"/"Deletion" workloads);
  (iii) delete a random edge of A, or insert a random edge of B into A.

The initial graph is A; updates come in 10 rounds of BATCHSIZE.  The builder
tracks A incrementally so deletes always target live edges and inserts never
duplicate, matching the paper's generator.

Copy of the numpy part of ``repro/graph/streams.py`` (the port imports
nothing of the reference package).  The device prefetch lives in the
engine (``serve/dynwalk.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

__all__ = ["UpdateStream", "make_update_stream", "validate_edges"]


def validate_edges(src, dst, w, *, num_vertices=None, fp_bias=False):
    """Per-edge validity mask for a host edge list (DESIGN.md §11).

    Flags out-of-range endpoints (negative always; ``>= num_vertices``
    when a vertex count is given) and degenerate biases — NaN/inf/
    non-positive in fp mode, ``< 1`` in integer-bias mode.  Returns
    ``(ok (m,) bool, reasons list[str])`` where ``reasons`` names each
    distinct failure with a count — the message ``make_update_stream``
    raises with, and what a quarantining caller should log.
    """
    src = np.asarray(src)
    dst = np.asarray(dst)
    w = np.asarray(w)
    bad_v = (src < 0) | (dst < 0)
    if num_vertices is not None:
        bad_v |= (src >= num_vertices) | (dst >= num_vertices)
    if fp_bias or np.issubdtype(w.dtype, np.floating):
        bad_w = ~np.isfinite(w) | (w <= 0)
    else:
        bad_w = w < 1
    reasons = []
    if bad_v.any():
        idx = np.nonzero(bad_v)[0][:5]
        reasons.append(
            f"{int(bad_v.sum())} out-of-range endpoint(s), e.g. "
            + ", ".join(f"({int(src[i])},{int(dst[i])})" for i in idx))
    if bad_w.any():
        idx = np.nonzero(bad_w)[0][:5]
        reasons.append(
            f"{int(bad_w.sum())} invalid weight(s), e.g. "
            + ", ".join(f"{w[i]!r}" for i in idx))
    return ~(bad_v | bad_w), reasons


class UpdateStream(NamedTuple):
    init_src: np.ndarray   # initial graph (set A)
    init_dst: np.ndarray
    init_w: np.ndarray
    is_insert: np.ndarray  # (rounds, batch) bool
    u: np.ndarray          # (rounds, batch) int32
    v: np.ndarray          # (rounds, batch) int32
    w: np.ndarray          # (rounds, batch) bias of inserted edges


def make_update_stream(src: np.ndarray, dst: np.ndarray, w: np.ndarray,
                       *, batch_size: int, rounds: int = 10,
                       mode: str = "mixed", seed: int = 0,
                       num_vertices: int = None,
                       on_invalid: str = "raise") -> UpdateStream:
    """Build the paper's update workload from a full edge list.

    ``mode``: ``insertion`` | ``deletion`` | ``mixed`` (§6.1 "Dynamic
    updates").  ``batch_size`` is the paper's BATCHSIZE (100K at full scale;
    laptop benchmarks shrink it proportionally).

    Inputs are validated (``validate_edges``): NaN/inf/non-positive
    weights and out-of-range vertex ids (negative; ``>= num_vertices``
    when given) would otherwise flow straight into the alias build.
    ``on_invalid``: ``"raise"`` (default) raises ``ValueError`` naming
    the offenders; ``"drop"`` silently builds the stream from the valid
    edges only — the quarantine-style choice for dirty real-world lists.
    """
    ok, reasons = validate_edges(src, dst, w, num_vertices=num_vertices)
    if not ok.all():
        if on_invalid == "raise":
            raise ValueError("invalid edges in update-stream input: "
                             + "; ".join(reasons))
        if on_invalid != "drop":
            raise ValueError(f"unknown on_invalid mode {on_invalid!r}")
        src, dst, w = src[ok], dst[ok], w[ok]
    rng = np.random.default_rng(seed)
    m = len(src)
    total = rounds * batch_size
    if total >= m:
        raise ValueError(f"graph too small: {m} edges < {total} updates")

    perm = rng.permutation(m)
    b_idx, a_idx = perm[:total], perm[total:]

    # Set A as mutable arrays; deletes swap-with-tail so sampling a live
    # edge is O(1) — mirroring BINGO's own deletion trick host-side.
    a_src, a_dst, a_w = (src[a_idx].copy(), dst[a_idx].copy(),
                         w[a_idx].copy())
    a_len = len(a_src)
    b_src, b_dst, b_w = src[b_idx], dst[b_idx], w[b_idx]
    b_pos = 0

    ins = np.zeros((rounds, batch_size), bool)
    uu = np.zeros((rounds, batch_size), np.int32)
    vv = np.zeros((rounds, batch_size), np.int32)
    ww = np.ones((rounds, batch_size), np.int32)

    if mode == "insertion":
        coin = np.ones((rounds, batch_size), bool)
    elif mode == "deletion":
        coin = np.zeros((rounds, batch_size), bool)
    elif mode == "mixed":
        coin = rng.random((rounds, batch_size)) < 0.5
    else:
        raise ValueError(f"unknown update mode {mode!r}")

    for r in range(rounds):
        for i in range(batch_size):
            do_insert = bool(coin[r, i]) and b_pos < len(b_src)
            if not do_insert and a_len == 0:
                do_insert = True  # nothing left to delete
            if do_insert:
                ins[r, i] = True
                uu[r, i], vv[r, i], ww[r, i] = (b_src[b_pos], b_dst[b_pos],
                                                b_w[b_pos])
                if a_len < len(a_src):
                    a_src[a_len], a_dst[a_len], a_w[a_len] = (
                        b_src[b_pos], b_dst[b_pos], b_w[b_pos])
                    a_len += 1
                b_pos += 1
            else:
                j = int(rng.integers(a_len))
                uu[r, i], vv[r, i] = a_src[j], a_dst[j]
                a_len -= 1
                a_src[j], a_dst[j], a_w[j] = (a_src[a_len], a_dst[a_len],
                                              a_w[a_len])

    n0 = len(a_idx)
    return UpdateStream(src[a_idx], dst[a_idx], w[a_idx], ins, uu, vv, ww)
