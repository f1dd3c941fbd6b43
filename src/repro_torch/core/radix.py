"""Radix-based bias decomposition (paper Eq. 3/4, supplement §9.2).

Port of ``repro/core/radix.py``.  Every integer bias ``w`` splits into its
base-``B`` digits, ``B = 2^r``; digit position ``k`` contributes sub-bias
``digit_k(w) * B^k`` to radix group ``p_k``.
"""

from __future__ import annotations

import torch

__all__ = ["digits", "digit_at", "group_weights", "num_groups", "decompose_fp"]


def num_groups(bias_bits: int, base_log2: int) -> int:
    """Number of radix groups K needed to cover ``bias_bits``-bit biases."""
    return -(-bias_bits // base_log2)  # ceil


def digit_at(bias, k, base_log2: int = 1):
    """Base-``2^r`` digit of ``bias`` at position ``k`` (broadcasting)."""
    mask = (1 << base_log2) - 1
    return (bias >> (k * base_log2)) & mask


def digits(bias: torch.Tensor, num_k: int, base_log2: int = 1) -> torch.Tensor:
    """All ``num_k`` digits of ``bias``; shape ``bias.shape + (num_k,)``."""
    ks = torch.arange(num_k, dtype=bias.dtype, device=bias.device)
    return digit_at(bias[..., None], ks, base_log2)


def group_weights(digitsum: torch.Tensor, base_log2: int = 1) -> torch.Tensor:
    """W(p_k) (Eq. 4) from per-group digit sums: ``digitsum[k] * B^k``.

    float32.  ``B^k`` is built as an exact power of two (``B^k <= 2^31``
    for the bases and widths used), which is what the reference's
    docstring promises; the reference computes it with ``jnp.exp2``,
    which JAX's CPU backend rounds a few ulps off for exponents of 13 and
    above (a reference-side deviation, recorded in ROADMAP.md).
    """
    num_k = digitsum.shape[-1]
    scale = torch.tensor([float(1 << (k * base_log2)) for k in range(num_k)],
                         dtype=torch.float32, device=digitsum.device)
    return digitsum.to(torch.float32) * scale


def decompose_fp(bias_fp: torch.Tensor, lam: float):
    """Split λ-scaled float biases into ``(int_part int32, frac float32)``.

    Paper §4.3: ``int_part + frac == bias_fp * lam``, all in float32.
    """
    scaled = bias_fp.to(torch.float32) * torch.tensor(
        lam, dtype=torch.float32, device=bias_fp.device)
    int_part = torch.floor(scaled)
    frac = scaled - int_part
    return int_part.to(torch.int32), frac
