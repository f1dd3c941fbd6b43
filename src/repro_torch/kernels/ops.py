"""Public entries of the kernels, dispatched by tensor device.

Port of ``repro/kernels/ops.py`` for this slice's two kernels.  CPU
tensors go to the plain PyTorch version — the caller asked for the CPU,
as the tests do.  CUDA tensors go to the kernel, or the call raises:
there is no fallback, and a failed build raises.
"""

from __future__ import annotations

from repro_torch.kernels.update_fused import update_fused
from repro_torch.kernels.walk_fused import walk_fused

__all__ = ["walk_fused", "update_fused", "launch_counts",
           "reset_launch_counts"]

_WRAPPERS = {"walk_fused": walk_fused, "update_fused": update_fused}


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset."""
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in _WRAPPERS.values():
        fn.launches = 0
