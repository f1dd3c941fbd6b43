"""1-D vertex partitioning for the distributed walk engine (paper §9.1).

Port of ``repro/graph/partition.py``.  The port ships walkers, not
sampling structures, between ranks; each rank of the process group holds
one contiguous range of rows of every ``(V, ...)`` table.  This module is
the host-side bookkeeping: balanced contiguous vertex ranges, vertex ->
shard lookup, and the padding that makes ``V`` divide over the ranks.
On a 2D vertex × walker mesh a shard is a rank's *vertex index*
(``distributed.relay.RelayLayout.sidx``), not its rank: ``num_shards`` is
S_v, and the S_w walker groups' replicas of a shard hold the same range.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["Partition1D"]


@dataclasses.dataclass(frozen=True)
class Partition1D:
    num_vertices: int      # logical V
    num_shards: int

    @property
    def padded_vertices(self) -> int:
        s = self.num_shards
        return -(-self.num_vertices // s) * s

    @property
    def shard_size(self) -> int:
        return self.padded_vertices // self.num_shards

    def shard_of(self, vertex):
        """Owning shard of each vertex id (vectorized)."""
        return np.asarray(vertex) // self.shard_size

    def vertex_range(self, shard: int) -> tuple[int, int]:
        """Rows ``[lo, hi)`` of vertex index ``shard``."""
        lo = shard * self.shard_size
        return lo, min(lo + self.shard_size, self.num_vertices)

    def local_id(self, vertex):
        return np.asarray(vertex) % self.shard_size
