"""BINGO walks -> packed LM token batches (the paper's use case #1).

Port of ``repro/data/pipeline.py``.  Random walks are how graph structure
becomes sequences (DeepWalk-style corpora for representation learning).
The pipeline:

  walker fan-out:  each producer round samples a walk batch from the
                   (dynamically updating) ``BingoState``: one whole-walk
                   kernel launch on the card;
  packing:         walks concatenate with a separator into fixed
                   (B, S+1) token rows (vertex-id vocabulary), on the
                   host, as the reference packs them;
  straggler hook:  ``overprovision`` producers are launched per round and
                   producer 0 is kept (the single-process reading of the
                   reference's backup-task policy).

Each round's starts and walk seed are drawn from a host
``torch.Generator`` seeded with ``seed`` (``_draw``), then the starts move
to the state's device, so one seed gives the same batches on the CPU and
on the card.  A round is split so a caller can feed it: ``walk(starts,
seed)`` walks one given batch and ``produce(paths)`` packs it.  The
reference draws its starts from ``jax.random`` keys, which torch cannot
repeat, so a test overrides ``_draw`` with the reference's draws.  Batches are
int32 tensors ``{"inputs", "targets"}`` on the state's device.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.core import walks as W
from repro_torch.core.dyngraph import BingoConfig, BingoState

__all__ = ["pack_walks", "WalkCorpusPipeline"]


def pack_walks(paths: np.ndarray, seq_len: int, sep: int,
               pad: int = -1) -> np.ndarray:
    """Concatenate walk rows (with separators) into (N, seq_len + 1) rows.

    ``paths`` is (W, L+1) with -1 padding from terminated walkers.  The
    +1 column lets the trainer slice inputs/targets with one shift.
    """
    toks: list[int] = []
    for row in paths:
        live = row[row >= 0]
        if len(live) < 2:
            continue
        toks.extend(int(t) for t in live)
        toks.append(sep)
    n = len(toks) // (seq_len + 1)
    if n == 0:
        return np.full((0, seq_len + 1), pad, np.int32)
    return np.asarray(toks[: n * (seq_len + 1)], np.int32).reshape(
        n, seq_len + 1)


class WalkCorpusPipeline:
    """Iterator of LM batches produced by live BINGO random walks."""

    def __init__(self, state: BingoState, cfg: BingoConfig, *,
                 params: Optional[W.WalkParams] = None,
                 walkers_per_round: int = 256, seq_len: int = 128,
                 batch_size: int = 8, seed: int = 0,
                 overprovision: int = 1):
        self.state = state
        self.cfg = cfg
        self.params = params or W.WalkParams(kind="deepwalk", length=16)
        self.Wr = walkers_per_round
        self.seq_len = seq_len
        self.batch_size = batch_size
        self.sep = cfg.num_vertices          # one-past-max vertex id
        self.vocab = cfg.num_vertices + 1
        self.gen = torch.Generator().manual_seed(seed)
        self.overprovision = max(1, overprovision)
        self.rounds = 0                      # walk batches launched
        self._buf = np.zeros((0, seq_len + 1), np.int32)

    def update_graph(self, state: BingoState):
        """Swap in a new snapshot (called after dynamic updates land; the
        port's rounds update the tables in place, so this swaps only the
        reference held)."""
        self.state = state

    def _draw(self):
        """One producer's (starts on the state's device, int32 walk seed)."""
        starts = torch.randint(0, self.cfg.num_vertices, (self.Wr,),
                               generator=self.gen, dtype=torch.int32)
        seed = int(torch.randint(0, 2**31 - 1, (1,), generator=self.gen))
        return starts.to(self.state.nbr.device), seed

    def walk(self, starts, seed: int):
        """One walk batch from ``starts`` keyed by ``seed``: (W, L+1)."""
        self.rounds += 1
        return W.random_walk(self.state, self.cfg, starts, seed, self.params)

    def produce(self, paths):
        """Pack one round's paths (read to the host) into the buffer."""
        packed = pack_walks(paths.cpu().numpy(), self.seq_len, self.sep)
        if len(packed):
            self._buf = np.concatenate([self._buf, packed])
        return packed

    def _produce_round(self):
        """One fan-out round: overprovisioned producers, first kept."""
        rounds = [self.walk(*self._draw())
                  for _ in range(self.overprovision)]
        # straggler policy: on a cluster, block on the first
        # 1/overprovision producers to finish; one process keeps producer 0
        self.produce(rounds[0])

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        while len(self._buf) < self.batch_size:
            self._produce_round()
        rows = self._buf[: self.batch_size]
        self._buf = self._buf[self.batch_size:]
        dev = self.state.nbr.device
        return {
            "inputs": torch.from_numpy(np.ascontiguousarray(
                rows[:, :-1])).to(dev),
            "targets": torch.from_numpy(np.ascontiguousarray(
                rows[:, 1:])).to(dev),
        }
