"""Sampling ground truth (paper Eq. 2).

Port of ``repro/core/sampler.py:transition_probs``.  The key-driven
reference sampler (``sample_group``/``sample_slot``, the reference
backend) comes with node2vec in a later slice.
"""

from __future__ import annotations

import torch

from repro_torch.core.dyngraph import BingoConfig, BingoState

__all__ = ["transition_probs"]


def transition_probs(state: BingoState, cfg: BingoConfig, u) -> torch.Tensor:
    """Exact per-slot transition probabilities ``w_i / Σ w_i`` for the
    vertices ``u`` (B,): shape (B, C) float32.  Theorem 4.1: the factorized
    sampler must reproduce them; walk tests compare histograms against it.
    """
    u = u.to(torch.int64)
    valid = (torch.arange(cfg.capacity, device=u.device)[None, :]
             < state.deg[u][:, None])
    w = state.bias[u].to(torch.float32) + state.frac[u]
    w = torch.where(valid, w, 0.0)
    return w / torch.clamp(w.sum(-1, keepdim=True), min=1e-30)
