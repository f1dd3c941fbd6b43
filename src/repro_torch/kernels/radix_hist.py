"""Eq. 4 radix histograms: base-2 digit sums and group sizes per vertex.

Port of ``repro/kernels/radix_hist.py`` (``radix_hist_pallas``) and its
oracle ``kernels/ref.py:radix_hist_ref``.  For each vertex and digit
position k < K, over the bias slots below its degree: the sum of the
base-2 digits ``(bias >> k) & 1`` (``digitsum``) and the count of those
that are nonzero (``gsize``).  In base 2 the two coincide; both are
computed as the reference defines them.  ``radix_hist`` is the wrapper:
on CPU tensors it runs ``radix_hist_ref``; on CUDA tensors it launches
``csrc/radix_hist.cu`` (32 rows a warp: a row of degree at most 32
counted by its own lane in carry-save bit planes, a longer row by 8
lanes whose counts a butterfly sums, one count written to both tables)
and counts the launch in ``radix_hist.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

__all__ = ["radix_hist_ref", "radix_hist"]


def radix_hist_ref(bias: torch.Tensor, deg: torch.Tensor, num_k: int):
    """``(digitsum (V, K), gsize (V, K))`` int32 from ``bias`` (V, C) int32
    and ``deg`` (V,) int32.  One digit position at a time, so no (V, C, K)
    tensor is made (at 2^20 vertices, C = 256 and K = 16 it would hold 4 G
    elements)."""
    V, C = bias.shape
    valid = (torch.arange(C, dtype=torch.int32, device=bias.device)[None, :]
             < deg[:, None])
    digitsum = torch.empty((V, num_k), dtype=torch.int32, device=bias.device)
    gsize = torch.empty_like(digitsum)
    for k in range(num_k):
        digs = torch.where(valid, (bias >> k) & 1, 0)
        digitsum[:, k] = digs.sum(1, dtype=torch.int32)
        gsize[:, k] = (digs != 0).sum(1, dtype=torch.int32)
    return digitsum, gsize


def radix_hist(bias: torch.Tensor, deg: torch.Tensor, *, num_k: int):
    """Eq. 4 counters, dispatched by the device of ``bias``; ``1 <= num_k
    <= 32``.  Returns ``(digitsum, gsize)``, both (V, num_k) int32."""
    if bias.device.type == "cpu":
        return radix_hist_ref(bias, deg, num_k)
    if bias.device.type != "cuda":
        raise ValueError(f"radix_hist: no kernel for device {bias.device}")
    if not 1 <= num_k <= 32:
        raise ValueError(f"radix_hist: num_k must lie in [1, 32], got {num_k}")
    V, C = bias.shape
    _build.check("bias", bias, torch.int32, (V, C))
    _build.check("deg", deg, torch.int32, (V,))
    digitsum = torch.empty((V, num_k), dtype=torch.int32, device=bias.device)
    gsize = torch.empty_like(digitsum)
    lib = _build.library("radix_hist")
    err = lib.radix_hist_launch(
        *[_build.ptr(x) for x in (bias, deg, digitsum, gsize)], V, C, num_k,
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err != 0:
        raise RuntimeError(f"radix_hist launch failed: {_build.error_string(err)}")
    radix_hist.launches += 1
    return digitsum, gsize


radix_hist.launches = 0
