"""Gradient compression: int8 quantization with error feedback.

Port of ``repro/distributed/compress.py``: symmetric per-tensor int8
quantization (4x fewer bytes for a gradient all-reduce) and error
feedback (Seide et al. / EF-SGD), which keeps the quantization residual
and adds it to the next step's gradient, so the compression bias vanishes
over steps.  ``torch.round`` rounds half to even, as ``jnp.round`` does,
so the quantized values are the reference's bit for bit.

Usage: wrap the gradient tree between the loss's gradient and the
optimizer:

    g_q, new_ef = compress_grads(grads, ef_state)
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.tree import tree_map

__all__ = ["init_error_feedback", "compress_grads", "quantize_int8",
           "dequantize_int8"]


def quantize_int8(x) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization: (q, scale)."""
    amax = torch.max(torch.abs(x))
    scale = torch.clamp(amax / 127.0, min=1e-30)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.to(torch.float32) * scale


def init_error_feedback(params) -> Any:
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)


def compress_grads(grads, ef_state, *, enabled: bool = True):
    """Returns (compressed-then-decompressed grads, new error feedback).

    The quantize -> dequantize round trip is what the wire sees; the
    residual (g + ef - deq) feeds back into the next step.
    """
    if not enabled:
        return grads, ef_state

    def one(g, ef):
        corrected = g.to(torch.float32) + ef
        q, scale = quantize_int8(corrected)
        deq = dequantize_int8(q, scale)
        return deq.to(g.dtype), corrected - deq

    pairs = tree_map(one, grads, ef_state)
    return tree_map(lambda t: t[0], pairs), tree_map(lambda t: t[1], pairs)
