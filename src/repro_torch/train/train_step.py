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
from repro_torch.models import steps
from repro_torch.models.layers import on_mesh
from repro_torch.models.model import loss_fn
from repro_torch.train.optim import (OptConfig, adamw_update, tree_leaves,
                                     tree_map)

__all__ = ["make_train_step", "value_and_grad"]


@on_mesh
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
        tree_map(lambda p: _placed_as(next(grads), p), params)


def _placed_as(g, p):
    """A DTensor gradient on its param's placements (the reference's
    ``grad_spec``); a plain one as is."""
    if type(g).__name__ == "DTensor" and g.placements != p.placements:
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _microbatches(x, n: int):
    """``x`` cut into ``n`` along dim 0.  A DTensor is cut on each rank's
    shard (microbatch i holds block i of every shard), so no rank needs
    another's rows."""
    if type(x).__name__ != "DTensor":
        return torch.chunk(x, n)
    from torch.distributed.tensor import DTensor
    return [DTensor.from_local(c, x.device_mesh, x.placements,
                               run_check=False)
            for c in torch.chunk(x.to_local(), n)]


def _unflatten(tree, leaves):
    """``tree`` with its leaves, in ``tree_leaves``' order, from
    ``leaves``."""
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
    return next(leaves)


@on_mesh
def value_and_grad(params, cfg, batch, *, remat: str = "dots",
                   microbatches: int = 1):
    """``(loss, metrics, grads)`` of ``loss_fn`` at ``params`` on
    ``batch``: the step's gradients before compression and the optimizer
    (``metrics`` is ``{}`` when ``microbatches > 1``)."""
    if microbatches == 1:
        return _loss_and_grad(params, cfg, batch, remat)
    if any(x.shape[0] % microbatches for x in batch.values()):
        raise ValueError("the batch must divide into the microbatches")
    mbatch = {k: _microbatches(x, microbatches) for k, x in batch.items()}
    device = next(iter(batch.values())).device

    def body(i, carry, _xs):
        loss, _, grads = _loss_and_grad(
            params, cfg, {k: v[i] for k, v in mbatch.items()}, remat)
        return tuple(map(torch.add, carry[:-1], tree_leaves(grads))) + (
            carry[-1] + loss,), ()

    # the zero sums are held by the loop alone, so each microbatch's sums
    # free the ones before them; a dry run costs one microbatch and
    # counts it for all (steps.loop)
    carry, _ = steps.loop(
        body, tuple(torch.zeros_like(p, dtype=torch.float32)
                    for p in tree_leaves(params))
        + (torch.zeros((), dtype=torch.float32, device=device),),
        microbatches, iters=1)
    gsum = _unflatten(params, iter(carry[:-1]))
    return carry[-1] / microbatches, {}, \
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
