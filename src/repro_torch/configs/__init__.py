"""Assigned architectures (+ the paper's own bingo-walk workload).

Port of ``repro/configs``: data copies, the same names and values.

``get_config(arch)`` returns the full published configuration;
``smoke_config(arch)`` a reduced same-family config for CPU tests;
``cells(arch)`` the (shape, run/skip) matrix for the dry-run.
"""

from repro_torch.configs.registry import (ARCHS, CELLS, cells, get_config,
                                          smoke_config)
from repro_torch.configs.shapes import SHAPES, Shape

__all__ = ["ARCHS", "CELLS", "get_config", "smoke_config", "cells",
           "SHAPES", "Shape"]
