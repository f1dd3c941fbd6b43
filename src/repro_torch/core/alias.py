"""Batched alias tables (Walker/Vose) — the paper's stage-(i) structure.

Port of ``repro/core/alias.py``.  One inter-group table per vertex over
its K radix groups (+1 decimal group in fp mode).  ``build_alias`` runs
``n`` sequential steps over an ``(R, n)`` batch of rows, in exactly the
reference's order: the first small entry is retired against the first
large one, and ``scaled[l] + (scaled[s] - 1.0)`` keeps its parentheses,
so the float32 results are bit-identical to ``alias._build_row``.  The
update kernel (``csrc/update_fused.cu``) runs the same loop per row.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["AliasTable", "build_alias", "alias_probs"]


class AliasTable(NamedTuple):
    prob: torch.Tensor   # (..., n) float32 — acceptance threshold per bucket
    alias: torch.Tensor  # (..., n) int32   — redirect target per bucket


def _row_total(w: torch.Tensor) -> torch.Tensor:
    """Row sum as explicit left-to-right lane adds over ``(..., n)``.

    ``torch.sum``'s order is unspecified; the reference and the update
    kernel both spell the order out, so this does too.
    """
    total = w[..., 0]
    for j in range(1, w.shape[-1]):
        total = total + w[..., j]
    return total


def build_alias(w: torch.Tensor) -> AliasTable:
    """Vose tables for a batch of weight rows ``(..., n)`` (float32)."""
    w = w.to(torch.float32)
    shape = w.shape
    n = shape[-1]
    w = w.reshape(-1, n)
    R = w.shape[0]
    dev = w.device
    total = _row_total(w)[:, None]
    n_f = torch.tensor(float(n), dtype=torch.float32, device=dev)
    tiny = torch.tensor(1e-30, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    one = torch.ones((), dtype=torch.float32, device=dev)
    scaled = torch.where(total > 0, w * n_f / torch.maximum(total, tiny), zero)
    prob = torch.ones((R, n), dtype=torch.float32, device=dev)
    alias = torch.arange(n, dtype=torch.int32, device=dev).expand(R, n).clone()
    done = torch.zeros((R, n), dtype=torch.bool, device=dev)
    rows = torch.arange(R, device=dev)
    for _ in range(n):
        small = ~done & (scaled < 1.0)
        large = ~done & (scaled >= 1.0)
        do = small.any(1) & large.any(1)
        s = torch.argmax(small.to(torch.int32), dim=1)   # first small
        l = torch.argmax(large.to(torch.int32), dim=1)   # first large
        rs, s_, l_ = rows[do], s[do], l[do]
        sval = scaled[rs, s_]
        prob[rs, s_] = sval
        alias[rs, s_] = l_.to(torch.int32)
        scaled[rs, l_] = scaled[rs, l_] + (sval - one)
        done[rs, s_] = True
    return AliasTable(prob.reshape(shape), alias.reshape(shape))


def alias_probs(table: AliasTable) -> torch.Tensor:
    """Exact per-entry selection probabilities encoded by ``table``:
    P(j) = (prob[j] + sum_i (1 - prob[i]) [alias[i] == j]) / n."""
    n = table.prob.shape[-1]
    prob = table.prob.reshape(-1, n)
    alias = table.alias.reshape(-1, n).to(torch.int64)
    redirected = torch.zeros_like(prob).scatter_add_(1, alias, 1.0 - prob)
    return ((prob + redirected) / n).reshape(table.prob.shape)
