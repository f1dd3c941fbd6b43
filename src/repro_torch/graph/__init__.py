"""Graph substrate: generators, update streams and 1-D partitioning
(mirrors ``repro.graph``)."""

from repro_torch.graph.partition import Partition1D
from repro_torch.graph.rmat import degree_bias, rmat_edges, sample_bias
from repro_torch.graph.streams import (UpdateStream, make_update_stream,
                                       rounds_on_device)

__all__ = [
    "rmat_edges", "degree_bias", "sample_bias",
    "UpdateStream", "make_update_stream", "rounds_on_device",
    "Partition1D",
]
