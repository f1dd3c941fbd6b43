"""AdamW + warmup-cosine schedule + global-norm clipping over nested dicts.

Port of ``repro/train/optim.py``: the same config, rules and float
order.  Moment dtype is configurable: ``bfloat16`` moments halve the
optimizer's memory (the reference's 405B fit lever); moments are updated
in float32 and stored in ``moment_dtype``, params stay float32.

The step counter is an int32 tensor on the params' device and the
schedule is computed from it in float32 on the device, so a step reads
nothing on the host.  ``adamw_update`` writes params and moments in
place under ``torch.no_grad()`` (the port's counterpart of the
reference's donated buffers) and returns them.  Weight decay applies
where the *stacked* leaf has ``ndim >= 2``, as the reference's rule
reads: the (R, D) stacked norms and biases are decayed too.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.train.checkpoint import leaf_from_numpy
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["OptConfig", "OptState", "adamw_init", "adamw_update",
           "cosine_schedule", "global_norm", "opt_state_from_jax",
           "tree_leaves", "tree_map"]


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"       # "bfloat16" for the 405B fit


class OptState(NamedTuple):
    step: torch.Tensor                  # () int32, on the params' device
    mu: Any
    nu: Any


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def cosine_schedule(cfg: OptConfig, step):
    """Learning rate at ``step`` (an int32 tensor), float32, on its device."""
    warm = cfg.lr * (step + 1) / max(cfg.warmup_steps, 1)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * \
        (1 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cfg.lr * cos)


def global_norm(tree):
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_leaves(tree)))


def adamw_init(params, cfg: OptConfig) -> OptState:
    dt = _dtype(cfg.moment_dtype)
    first = tree_leaves(params)[0]
    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=first.device),
        mu=tree_map(lambda p: torch.zeros_like(p, dtype=dt), params),
        nu=tree_map(lambda p: torch.zeros_like(p, dtype=dt), params))


@torch.no_grad()
def adamw_update(params, grads, state: OptState, cfg: OptConfig
                 ) -> Tuple[Any, OptState, dict]:
    """One AdamW step: params and moments updated in place and returned,
    with ``{"lr", "grad_norm"}`` as device tensors."""
    step = state.step + 1
    lr = cosine_schedule(cfg, state.step)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    bc1 = 1 - cfg.b1 ** step
    bc2 = 1 - cfg.b2 ** step

    def upd(p, g, mu, nu):
        g = g.to(torch.float32) * scale
        mu32 = cfg.b1 * mu.to(torch.float32) + (1 - cfg.b1) * g
        nu32 = cfg.b2 * nu.to(torch.float32) + (1 - cfg.b2) * g * g
        mhat = mu32 / bc1
        nhat = nu32 / bc2
        delta = mhat / (torch.sqrt(nhat) + cfg.eps)
        if p.dim() >= 2:
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        p.copy_(p.to(torch.float32) - lr * delta)
        mu.copy_(mu32)
        nu.copy_(nu32)

    tree_map(upd, params, grads, state.mu, state.nu)
    return params, OptState(step, state.mu, state.nu), \
        {"lr": lr, "grad_norm": gnorm}


def opt_state_from_jax(state, device="cuda") -> OptState:
    """The port's ``OptState`` from the reference's (leaves that
    ``numpy.asarray`` takes, JAX arrays or numpy); moments keep their
    dtype, bfloat16 included (read as a checkpoint's leaf is)."""
    def one(a):
        return leaf_from_numpy(a).to(device)
    return OptState(step=one(state.step), mu=tree_map(one, state.mu),
                    nu=tree_map(one, state.nu))
