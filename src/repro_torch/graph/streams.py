"""Dynamic-update workload builder — the paper's §6.1 three-step recipe.

  (i)   split edges into set A (original − 10·BATCHSIZE) and B (10·BATCHSIZE);
  (ii)  per update, coin-flip insert vs delete (or force one for the
        "Insertion"/"Deletion" workloads);
  (iii) delete a random edge of A, or insert a random edge of B into A.

The initial graph is A; updates come in 10 rounds of BATCHSIZE.  The builder
tracks A incrementally so deletes always target live edges and inserts never
duplicate, matching the paper's generator.

Port of ``repro/graph/streams.py`` (the port imports nothing of the
reference package): the numpy builders are copies; ``rounds_on_device``
and ``windows_on_device`` upload ahead of use from pinned host memory
with non-blocking copies, so on the card an upload neither waits for the
device nor makes the host wait.
"""

from __future__ import annotations

from collections import deque
from typing import Iterator, NamedTuple, Tuple

import numpy as np
import torch

__all__ = ["UpdateStream", "coalesce_windows", "make_update_stream",
           "rounds_on_device", "windows_on_device", "validate_edges",
           "upload"]


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

    return UpdateStream(src[a_idx], dst[a_idx], w[a_idx], ins, uu, vv, ww)


def upload(x, device) -> torch.Tensor:
    """A host array (or CPU tensor) as a tensor on ``device``: on the card
    through pinned memory and a non-blocking copy (no host sync, and the
    copy is ordered on the current stream), else a plain copy."""
    t = x if isinstance(x, torch.Tensor) else \
        torch.from_numpy(np.ascontiguousarray(x))
    device = torch.device(device)
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device, copy=True)


def coalesce_windows(stream: UpdateStream, *, max_lanes: int,
                     max_delay: int = 0) -> Iterator[Tuple]:
    """Deadline-driven windowed coalescing (DESIGN.md §12).

    Re-chunks the stream's ``(rounds, batch)`` updates into fixed-shape
    windows of exactly ``max_lanes`` lanes, flushing early when the
    oldest queued lane has waited more than ``max_delay`` arrival rounds.
    Yields ``(is_insert, u, v, w, n_valid)`` host tuples where lanes
    ``>= n_valid`` are padding ``(insert, 0, 0, 1)``; feed ``n_valid`` to
    ``DynamicWalkEngine.ingest`` so the padded lanes are masked out while
    every round keeps one shape.

    With ``max_delay=0`` every arrival round flushes immediately; with a
    large delay every window is full.  The arrival "clock" is the
    stream's own round index — callers with a wall clock should use
    ``ServingScheduler`` instead, which applies the same policy to live
    traffic.
    """
    if max_lanes < 1:
        raise ValueError(f"max_lanes must be >= 1; got {max_lanes}")
    if max_delay < 0:
        raise ValueError(f"max_delay must be >= 0; got {max_delay}")
    rounds = stream.is_insert.shape[0]
    q_ins: list = []
    q_u: list = []
    q_v: list = []
    q_w: list = []
    q_tick: list = []   # arrival round of each queued lane
    pending = 0

    def flush(n):
        nonlocal pending
        ins = np.concatenate(q_ins)
        u = np.concatenate(q_u)
        v = np.concatenate(q_v)
        w = np.concatenate(q_w)
        out = (np.ones(max_lanes, bool),
               np.zeros(max_lanes, np.int32),
               np.zeros(max_lanes, np.int32),
               np.ones(max_lanes, w.dtype))
        out[0][:n] = ins[:n]
        out[1][:n] = u[:n]
        out[2][:n] = v[:n]
        out[3][:n] = w[:n]
        q_ins[:] = [ins[n:]]
        q_u[:] = [u[n:]]
        q_v[:] = [v[n:]]
        q_w[:] = [w[n:]]
        del q_tick[:n]
        pending -= n
        return out + (n,)

    for r in range(rounds):
        q_ins.append(stream.is_insert[r])
        q_u.append(stream.u[r])
        q_v.append(stream.v[r])
        q_w.append(stream.w[r])
        q_tick.extend([r] * stream.is_insert.shape[1])
        pending += stream.is_insert.shape[1]
        while pending >= max_lanes:
            yield flush(max_lanes)
        if pending and r - q_tick[0] >= max_delay:
            yield flush(pending)
    if pending:
        yield flush(pending)


def _prefetched(items: Iterator, prefetch: int) -> Iterator:
    """``items`` pulled ``prefetch`` ahead of the consumer."""
    queue: deque = deque()
    for item in items:
        queue.append(item)
        if len(queue) > max(1, prefetch):
            yield queue.popleft()
    while queue:
        yield queue.popleft()


def windows_on_device(stream: UpdateStream, *, max_lanes: int,
                      max_delay: int = 0, prefetch: int = 2,
                      device="cuda") -> Iterator[Tuple]:
    """``coalesce_windows`` uploaded ``prefetch`` windows ahead of use.

    Yields ``(is_insert, u, v, w, n_valid)`` with the four lane arrays as
    tensors on ``device``; ``n_valid`` stays a host int (it feeds the
    engine's lane mask).
    """
    def up(win):
        return tuple(upload(a, device) for a in win[:4]) + (win[4],)
    return _prefetched(map(up, coalesce_windows(
        stream, max_lanes=max_lanes, max_delay=max_delay)), prefetch)


def rounds_on_device(stream: UpdateStream, *, prefetch: int = 2,
                     coalesce: int = 1, device="cuda") -> Iterator[Tuple]:
    """Yield ``(is_insert, u, v, w)`` rounds as tensors on ``device``,
    uploaded ``prefetch`` rounds ahead of use, so the copies overlap the
    consumer's work on the current round.  ``coalesce > 1`` concatenates
    that many consecutive rounds into one larger batch before upload —
    the serving-side lever that trades update latency for the §5.2
    batched-path throughput (``serve/dynwalk.py``).
    """
    rounds = stream.is_insert.shape[0]
    if coalesce < 1:
        raise ValueError(f"coalesce must be >= 1; got {coalesce}")

    def host_round(j):
        sl = slice(j * coalesce, min((j + 1) * coalesce, rounds))
        return tuple(upload(a[sl].reshape(-1), device) for a in
                     (stream.is_insert, stream.u, stream.v, stream.w))
    return _prefetched(map(host_round, range(-(-rounds // coalesce))),
                       prefetch)
