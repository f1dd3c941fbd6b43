"""Elastic scaling + straggler mitigation policies.

Port of ``repro/train/elastic.py``: pure arithmetic.  Mesh geometry
derives from the devices at launch (``torch.cuda.device_count()`` when
none are given); a restart after shrink/grow re-derives the batch and
FSDP factors and restores the last checkpoint.

Straggler mitigation: walk generation is per-vertex-shard embarrassingly
parallel, so the data pipeline over-provisions walk batches by
``overprovision`` and each step consumes the first fraction to arrive (a
backup-task scheme; hooks in ``data/pipeline.py``).
"""

from __future__ import annotations

import dataclasses
import math

import torch

__all__ = ["ElasticPlan", "derive_plan"]


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    num_devices: int
    data: int
    model: int
    pods: int
    global_batch: int
    microbatches: int


def derive_plan(global_batch: int, *, model_parallel: int = 16,
                devices=None, max_per_device_batch: int = 16,
                ) -> ElasticPlan:
    """Re-derive mesh factors for the currently-available devices.

    Keeps ``model_parallel`` fixed (weights layout is arch-bound) and
    flexes the data(×pod) extent; grad-accumulation microbatches absorb
    whatever the device batch cannot.  ``devices=None`` counts the CUDA
    devices and raises where there are none.
    """
    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("derive_plan: no CUDA device; pass devices=")
    else:
        n = len(devices)
    model = math.gcd(model_parallel, n)
    dp = max(n // model, 1)
    pods = 1
    per_dev = max(global_batch // dp, 1)
    micro = max(math.ceil(per_dev / max_per_device_batch), 1)
    # microbatches must divide the per-device batch
    while per_dev % micro:
        micro += 1
    return ElasticPlan(num_devices=n, data=dp, model=model, pods=pods,
                       global_batch=global_batch, microbatches=micro)
