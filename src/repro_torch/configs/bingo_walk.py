"""The paper's own workload as a dry-run "architecture": bingo-walk.

A vertex-sharded BINGO sampling space (1-D partition, paper §9.1) driving
one distributed walker step: local hierarchical sample + all_to_all walker
exchange over the data(×pod) mesh axes.  This is the cell "most
representative of the paper's technique" for the §Perf hillclimb.

Production sizing mirrors the paper's largest dataset (Twitter: 41.7M
vertices, 1.47B edges, max degree 770K — capacity-classed to C=4096 with
the >C tail handled by vertex splitting, a standard power-law mitigation).
"""

from __future__ import annotations

import dataclasses

__all__ = ["BingoWalkConfig", "FULL", "SMOKE"]


@dataclasses.dataclass(frozen=True)
class BingoWalkConfig:
    name: str
    num_vertices: int      # global V (padded to the data shard count)
    capacity: int          # C — padded neighbor slots per vertex
    bias_bits: int         # K = bias_bits radix groups
    walkers: int           # global concurrent walkers
    walk_length: int       # steps per walk (paper default 80)
    update_batch: int      # batched-update size (paper: 100K)


FULL = BingoWalkConfig(
    name="bingo-walk",
    num_vertices=41_943_040,      # ~41.7M padded to 2^22*10
    capacity=1024,                # covers >99.99% of Twitter's power-law
                                  # degrees; the 770K-degree tail is vertex-
                                  # split into capacity-class replicas
                                  # (DESIGN.md §2 — Hornet block pools ->
                                  # padded capacity classes)
    bias_bits=16,
    walkers=4_194_304,            # one walker per ~10 vertices
    walk_length=80,
    update_batch=102_400,
)

SMOKE = BingoWalkConfig(
    name="bingo-walk-smoke",
    num_vertices=256,
    capacity=32,
    bias_bits=8,
    walkers=128,
    walk_length=8,
    update_batch=64,
)
