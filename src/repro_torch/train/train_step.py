"""The train step: gradient accumulation, remat, compression hooks.

Port of ``repro/train/train_step.py``.  ``make_train_step`` closes over
static config and returns ``step(params, opt_state, ef_state, batch) ->
(params, opt_state, ef_state, metrics)``.  Gradients come from
``torch.autograd.grad`` over detached copies of the param leaves, which
composes with ``torch.utils.checkpoint`` (the ``remat`` policies of
``models.loss_fn``).  With ``microbatches > 1`` the batch's leading dim
splits into that many microbatches whose float32 gradients are summed in
a loop and divided by their count, as the reference's scan does; that
branch reports ``{"loss", "lr", "grad_norm"}`` only, as the reference's.
Params and moments are updated in place (``optim.adamw_update``).
Metrics stay tensors on the device: a dense model's step reads nothing
on the host (the MoE layer reads its group sizes once a call).

The reference's ``unroll``, ``act_spec``, ``unroll_micro`` and
``grad_spec`` (scan unrolling and sharding constraints) have no torch
meaning here and are not taken.
"""

from __future__ import annotations

import torch

from repro_torch.distributed.compress import compress_grads
from repro_torch.models.model import loss_fn
from repro_torch.train.optim import OptConfig, adamw_update, tree_map

__all__ = ["make_train_step", "value_and_grad"]


def _loss_and_grad(params, cfg, batch, remat):
    leaves = []

    def leaf(p):
        t = p.detach().requires_grad_()
        leaves.append(t)
        return t

    tracked = tree_map(leaf, params)
    loss, metrics = loss_fn(tracked, cfg, batch, remat=remat)
    # a leaf the batch does not reach (the token embedding of a frontend
    # batch) gets zeros, as the reference's grad gives it
    grads = iter(torch.autograd.grad(loss, leaves, allow_unused=True,
                                     materialize_grads=True))
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
        tree_map(lambda _p: next(grads), params)


def value_and_grad(params, cfg, batch, *, remat: str = "dots",
                   microbatches: int = 1):
    """``(loss, metrics, grads)`` of ``loss_fn`` at ``params`` on
    ``batch``: the step's gradients before compression and the optimizer
    (``metrics`` is ``{}`` when ``microbatches > 1``)."""
    if microbatches == 1:
        return _loss_and_grad(params, cfg, batch, remat)
    if any(x.shape[0] % microbatches for x in batch.values()):
        raise ValueError("the batch must divide into the microbatches")
    mbatch = {k: torch.chunk(x, microbatches) for k, x in batch.items()}
    gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
    lsum = torch.zeros((), dtype=torch.float32,
                       device=next(iter(batch.values())).device)
    for i in range(microbatches):
        loss, _, grads = _loss_and_grad(
            params, cfg, {k: v[i] for k, v in mbatch.items()}, remat)
        gsum = tree_map(torch.add, gsum, grads)
        lsum = lsum + loss
    return lsum / microbatches, {}, \
        tree_map(lambda g: g / microbatches, gsum)


def make_train_step(cfg, opt_cfg: OptConfig, *, remat: str = "dots",
                    microbatches: int = 1, compress: bool = False):
    def step(params, opt_state, ef_state, batch):
        loss, metrics, grads = value_and_grad(
            params, cfg, batch, remat=remat, microbatches=microbatches)
        grads, ef_state = compress_grads(grads, ef_state, enabled=compress)
        params, opt_state, opt_m = adamw_update(params, grads, opt_state,
                                                opt_cfg)
        return params, opt_state, ef_state, \
            {"loss": loss, **metrics, **opt_m}

    return step
