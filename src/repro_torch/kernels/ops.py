"""Public entries of the kernels, dispatched by tensor device.

Port of ``repro/kernels/ops.py``, every kernel of it.  CPU
tensors go to the plain PyTorch version — the caller asked for the CPU,
as the tests do.  CUDA tensors go to the kernel, or the call raises:
there is no fallback, and a failed build raises.
"""

from __future__ import annotations

from repro_torch.kernels.alias_build import alias_build
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_sm90)
from repro_torch.kernels.radix_hist import radix_hist
from repro_torch.kernels.update_fused import update_fused
from repro_torch.kernels.walk_fused import walk_fused, walk_segment
from repro_torch.kernels.walk_sample import walk_sample, walk_sample_uniform

__all__ = ["walk_fused", "walk_segment", "update_fused", "walk_sample",
           "walk_sample_uniform", "radix_hist", "alias_build",
           "flash_attention", "launch_counts", "reset_launch_counts"]

_WRAPPERS = {"walk_fused": walk_fused, "walk_segment": walk_segment,
             "update_fused": update_fused, "walk_sample": walk_sample,
             "walk_sample_uniform": walk_sample_uniform,
             "radix_hist": radix_hist, "alias_build": alias_build,
             "flash_attention": flash_attention,
             "flash_attention_sm90": flash_attention_sm90}


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset."""
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in _WRAPPERS.values():
        fn.launches = 0
