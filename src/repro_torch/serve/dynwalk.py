"""Streaming dynamic-walk serving: interleave update rounds with walks.

Port of the single-device path of ``repro/serve/dynwalk.py``.  A
``DynamicWalkEngine`` owns one ``BingoState`` and threads it through
alternating batched-update rounds (``ingest``, one update-kernel launch
each on the card) and whole-walk batches (``walk``, one walk-kernel
launch each).  Update rounds mutate the state's tensors in place — the
counterpart of the reference's donated buffers — so the caller must not
keep using the state it passed in; read ``engine.state``.

The guard, the vertex-sharded mode, capacity regrowth, walk buckets and
deferred guard accounting come in later slices of the port.
"""

from __future__ import annotations

from collections import deque
from typing import Iterable, Iterator, Optional

import numpy as np
import torch

from repro_torch.core.dyngraph import BingoConfig, BingoState
from repro_torch.core.updates import UpdateStats, make_updater
from repro_torch.core.walks import WalkParams, make_walker
from repro_torch.graph.streams import UpdateStream

__all__ = ["DynamicWalkEngine"]

_SEED_HI = (1 << 31) - 1     # walk seeds are drawn in [0, 2^31 - 1)


def _upload(x: np.ndarray, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(x))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _rounds_on_device(stream: UpdateStream, device, *, prefetch: int = 2,
                      coalesce: int = 1) -> Iterator[tuple]:
    """``(is_insert, u, v, w)`` rounds uploaded ``prefetch`` rounds ahead
    (asynchronous copies from pinned memory on the card), with
    ``coalesce`` consecutive rounds folded into one batch."""
    rounds = stream.is_insert.shape[0]
    if coalesce < 1:
        raise ValueError(f"coalesce must be >= 1; got {coalesce}")

    def host_round(j):
        sl = slice(j * coalesce, min((j + 1) * coalesce, rounds))
        return tuple(_upload(a[sl].reshape(-1), device) for a in
                     (stream.is_insert, stream.u, stream.v, stream.w))

    n = -(-rounds // coalesce)
    queue: deque = deque()
    nxt = 0
    while nxt < n and len(queue) < max(1, prefetch):
        queue.append(host_round(nxt))
        nxt += 1
    while queue:
        if nxt < n:
            queue.append(host_round(nxt))
            nxt += 1
        yield queue.popleft()


class DynamicWalkEngine:
    """One dynamic graph on one device, serving update rounds and walks.

    ``seed`` seeds the engine's own ``torch.Generator``, from which
    ``walk`` draws a walk seed when the caller gives none.
    """

    def __init__(self, state: BingoState, cfg: BingoConfig,
                 params: WalkParams = WalkParams(), *,
                 backend: Optional[str] = None, seed: int = 0):
        self.cfg = cfg
        self.params = params
        self._state = state
        self._update = make_updater(cfg, backend=backend)
        self._walk = make_walker(state, cfg, params, backend=backend)
        self._gen = torch.Generator().manual_seed(seed)
        self.rounds_ingested = 0
        self.updates_applied = 0
        self.walks_served = 0
        self.last_seed: Optional[int] = None   # seed of the latest walk batch

    @property
    def state(self) -> BingoState:
        """The current sampling space (updated in place by ``ingest``)."""
        return self._state

    @property
    def device(self) -> torch.device:
        return self._state.nbr.device

    def _as(self, x, dtype=None) -> torch.Tensor:
        t = torch.as_tensor(x, device=self.device)
        return t if dtype is None else t.to(dtype)

    def ingest(self, is_insert, u, v, w, *,
               n_valid: Optional[int] = None) -> UpdateStats:
        """Apply one batched update round; returns its ``UpdateStats``.

        Every lane goes to the update pipeline, which rejects and counts
        lanes it cannot apply.  Lanes ``>= n_valid`` are padding: never
        applied and never counted.
        """
        B = int(u.shape[0])
        nv = B if n_valid is None else int(n_valid)
        if not 0 <= nv <= B:
            raise ValueError(f"n_valid {nv} outside round of {B} lanes")
        lanes = torch.arange(B, device=self.device) < nv
        self._state, stats = self._update(
            self._state, self._as(is_insert, torch.bool),
            self._as(u, torch.int32), self._as(v, torch.int32), self._as(w),
            lanes)
        self.rounds_ingested += 1
        self.updates_applied += nv
        return stats._replace(max_fill=self._fill())

    def _fill(self) -> torch.Tensor:
        """Fill watermark ``max(deg) / capacity`` as a device scalar."""
        return self._state.deg.max() / self.cfg.capacity

    def walk(self, starts, seed: Optional[int] = None) -> torch.Tensor:
        """Serve one whole-walk batch; returns ``(B, length+1)`` paths.

        ``seed`` keys the counter-hash PRNG; when None it is drawn from
        the engine's generator.  ``last_seed`` keeps it, so a batch can be
        replayed.
        """
        starts = self._as(starts, torch.int32).contiguous()
        if seed is None:
            seed = int(torch.randint(0, _SEED_HI, (1,), generator=self._gen))
        self.last_seed = seed
        self._state, paths = self._walk(self._state, starts, seed)
        self.walks_served += int(starts.shape[0])
        return paths

    def run_stream(self, stream: UpdateStream, starts, *,
                   coalesce: int = 1, prefetch: int = 2,
                   walks_per_round: int = 1) -> Iterable:
        """Drive a full update stream, walking between rounds.

        Yields ``(round_index, UpdateStats, paths)`` per coalesced round;
        ``paths`` stacks ``walks_per_round`` whole-walk batches from
        ``starts``.  Rounds are uploaded ahead of use, so the copies
        overlap the previous round's device work.
        """
        if walks_per_round < 1:
            raise ValueError(
                f"walks_per_round must be >= 1; got {walks_per_round}")
        starts = self._as(starts, torch.int32).contiguous()
        for r, (ins, u, v, w) in enumerate(_rounds_on_device(
                stream, self.device, prefetch=prefetch, coalesce=coalesce)):
            stats = self.ingest(ins, u, v, w)
            paths = [self.walk(starts) for _ in range(walks_per_round)]
            yield r, stats, (torch.stack(paths) if walks_per_round > 1
                             else paths[0])
