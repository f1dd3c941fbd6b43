"""Batched Vose alias tables over K-entry weight rows.

Port of ``repro/kernels/alias_build.py`` (``alias_build_pallas``) and its
oracle ``kernels/ref.py:alias_build_ref``.  The plain version is the
port's ``core/alias.py:build_alias``, which follows the reference's
``alias._build_row`` in its float order.  ``alias_build`` is the wrapper:
on CPU tensors it runs ``alias_build_ref``; on CUDA tensors it launches
``csrc/alias_build.cu`` (a row to a group of 8, 16 or 32 lanes, the
warp-wide Vose row of ``csrc/alias_row.cuh`` that the update kernel
shares) and counts the launch in ``alias_build.launches``.  Kernel and
plain version are equal bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.alias import build_alias
from repro_torch.kernels import _build

__all__ = ["alias_build_ref", "alias_build"]

_MAX_ENTRIES = 64       # alias_row.cuh's kMaxInter


def alias_build_ref(w: torch.Tensor):
    """Vose tables ``(prob float32, alias int32)`` for weight rows (V, K)."""
    t = build_alias(w)
    return t.prob, t.alias


def alias_build(w: torch.Tensor):
    """Vose tables for ``w`` (V, K), cast to float32, dispatched by its
    device; ``K <= 64``.  Returns ``(prob (V, K) float32, alias (V, K)
    int32)``."""
    if w.device.type == "cpu":
        return alias_build_ref(w)
    if w.device.type != "cuda":
        raise ValueError(f"alias_build: no kernel for device {w.device}")
    w = w.to(torch.float32)
    if w.dim() != 2 or not 1 <= w.shape[1] <= _MAX_ENTRIES:
        raise ValueError(f"alias_build: want (V, K) rows with 1 <= K <= "
                         f"{_MAX_ENTRIES}, got {tuple(w.shape)}")
    V, K = w.shape
    _build.check("w", w, torch.float32, (V, K))
    prob = torch.empty((V, K), dtype=torch.float32, device=w.device)
    alias = torch.empty((V, K), dtype=torch.int32, device=w.device)
    lib = _build.library("alias_build")
    err = lib.alias_build_launch(
        *[_build.ptr(x) for x in (w, prob, alias)], V, K,
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err != 0:
        raise RuntimeError(f"alias_build launch failed: {_build.error_string(err)}")
    alias_build.launches += 1
    return prob, alias


alias_build.launches = 0
