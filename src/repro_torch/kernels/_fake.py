"""Kernel wrappers on fake tensors: the outputs' shapes, a record, no launch.

The dry run (``launch/dryrun.py``) runs a cell's function on
``FakeTensor``s.  A kernel wrapper given a fake (or ``meta``) tensor
allocates its outputs' shapes, passes the kernel's name and shape
parameters to every listener registered here (the dry run's cost
counter, ``launch/roofline.CostCounter``), and launches nothing: its
launch count does not move.  The branch is chosen by the tensor's type
alone, so a real tensor always reaches the kernel (CUDA) or its plain
version (CPU).
"""

from __future__ import annotations

from torch._subclasses.fake_tensor import FakeTensor

__all__ = ["LISTENERS", "is_fake", "record"]

LISTENERS: list = []      # callables (kernel name, {shape parameter: int})


def is_fake(t) -> bool:
    """True for a ``FakeTensor`` or a ``meta`` tensor."""
    return isinstance(t, FakeTensor) or t.device.type == "meta"


def record(name: str, **shape) -> None:
    """Tell the listeners that kernel ``name`` would launch on ``shape``."""
    for fn in LISTENERS:
        fn(name, shape)
