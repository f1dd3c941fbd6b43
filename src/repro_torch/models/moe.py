"""Mixture-of-Experts FFN: top-k router + dropless grouped GEMM.

Port of ``repro/models/moe.py``.  Tokens (replicated top_k times) are
sorted by expert id (a stable ``argsort``, as the reference's) and each
expert's contiguous group of rows goes through that expert's FFN: the
reference's ``jax.lax.ragged_dot`` grouped matmul, written here as one
plain product per non-empty group.  Cutting the sorted rows into groups
reads the (E,) group sizes on the host: one device-to-host read (and
sync) per MoE layer per call, the only one; the counts themselves are
scatter-adds.  The combine is an unsort + router-weighted sum.

Supports mixtral (8e top-2), llama4-scout (16e top-1), jamba (16e top-2).
Returns the standard switch-style load-balancing auxiliary loss.  The
router's ``topk`` breaks ties between equal probabilities by its own
rule; ties have probability zero on random float weights.
"""

from __future__ import annotations

import torch

from repro_torch.models.layers import (dense_init, dot, grad_layout,
                                       local_parts, placed, swiglu, whole)

__all__ = ["init_moe", "moe_ffn"]


def init_moe(gen: torch.Generator, d_model: int, d_ff: int,
             num_experts: int, dtype=torch.float32):
    return {
        "router": dense_init(gen, (d_model, num_experts),
                             dtype=torch.float32),     # router in fp32
        "wg": dense_init(gen, (num_experts, d_model, d_ff), dtype=dtype),
        "wi": dense_init(gen, (num_experts, d_model, d_ff), dtype=dtype),
        "wo": dense_init(gen, (num_experts, d_ff, d_model), dtype=dtype),
    }


def _grouped(xs, w, sizes):
    """``ragged_dot``: row group e of ``xs`` (sizes[e] rows, in order)
    times ``w[e]``."""
    out = xs.new_empty((xs.shape[0], w.shape[-1]))
    start = 0
    for e, n in enumerate(sizes):
        if n:
            out[start:start + n] = xs[start:start + n] @ w[e]
        start += n
    return out


def _onehot(idx, n: int, dtype):
    """(..., n): 1 where the last dim's index is ``idx``, else 0."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _counts(idx, n: int, dtype):
    """Occurrences of each of 0..n-1 in ``idx``, by a scatter-add: no host
    sync (a CUDA ``bincount`` reads its input's maximum on the host).  On
    a DTensor, by a one-hot sum: DTensor has no rule for the in-place
    scatter into a plain tensor."""
    if type(idx).__name__ == "DTensor":
        return _onehot(idx, n, dtype).sum(tuple(range(idx.dim())))
    idx = idx.reshape(-1)
    out = torch.zeros((n,), dtype=dtype, device=idx.device)
    return out.index_add_(0, idx, torch.ones_like(idx, dtype=dtype))


def _topk(probs, k: int):
    """The router's top-k; on a DTensor, on each rank's tokens (DTensor's
    rule for the top-k's backward can split the k picks over ranks)."""
    if type(probs).__name__ != "DTensor":
        return torch.topk(probs, k, dim=-1, sorted=True)
    from torch.distributed.tensor import DTensor
    from repro_torch.models.layers import batch_placements
    mesh = probs.device_mesh
    pl = batch_placements(probs, mesh)
    gate, idx = torch.topk(local_parts(mesh, [(probs, pl)])[0], k, dim=-1,
                           sorted=True)
    return (DTensor.from_local(gate, mesh, pl, run_check=False),
            DTensor.from_local(idx, mesh, pl, run_check=False))


def _dense_sharded(xf, comb, params, dt):
    """The dense dispatch on DTensors, each rank on its shard: tokens
    over the FSDP axes; over ``model`` the experts where the params
    shard them (EP), else each expert's hidden features (TP).  Both
    contract a dim split over ``model``: the output is a partial sum
    there."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from repro_torch.distributed.sharding import fsdp_axes
    mesh = xf.device_mesh
    names = list(mesh.mesh_dim_names)
    wg = params["wg"]
    ep = any(isinstance(p, Shard) and p.dim == 0 for p in wg.placements)
    T = xf.shape[0]
    tok, w_in, w_out, cb, out = ([Replicate() for _ in names]
                                 for _ in range(5))
    n_dp = 1
    for a in fsdp_axes(mesh):
        n_dp *= dict(zip(names, mesh.shape)).get(a, 1)
    for a in fsdp_axes(mesh):
        if a in names and T % n_dp == 0:
            i = names.index(a)
            tok[i] = cb[i] = out[i] = Shard(0)
    if "model" in names and mesh.shape[names.index("model")] > 1:
        i = names.index("model")
        w_in[i] = Shard(0) if ep else Shard(2)
        w_out[i] = Shard(0) if ep else Shard(1)
        if ep:
            cb[i] = Shard(1)
        out[i] = Partial()

    tok, w_in, w_out, cb, out = (placed(pl, mesh)
                                 for pl in (tok, w_in, w_out, cb, out))

    x_l, g_l, i_l, o_l, c_l = local_parts(mesh, (
        (xf, tok), (wg.to(dt), w_in), (params["wi"].to(dt), w_in),
        (params["wo"].to(dt), w_out), (comb, cb)))
    h = swiglu(torch.einsum("td,edf->tef", x_l, g_l),
               torch.einsum("td,edf->tef", x_l, i_l))
    hw = h * c_l[:, :, None].to(dt)
    o = torch.einsum("tef,efd->td", hw, o_l)
    return DTensor.from_local(o, mesh, out, run_check=False)


def moe_ffn(params, x, top_k: int, dispatch: str = "ragged"):
    """x: (B, S, D) -> (out (B, S, D), aux_loss ()).

    ``dispatch``:
      * ``ragged`` — sort-by-expert + one product per expert group (the
        runtime path: top-k FLOPs, one host read of the group sizes);
      * ``dense``  — mask-combined dense einsum over all experts, as the
        reference lowers it for its dry run (on DTensors, each rank on
        its shard of the tokens and of the experts or their hidden
        features).  Both modes produce the same outputs to float
        rounding.
    """
    B, S, D = x.shape
    E = params["router"].shape[-1]
    T = B * S
    xf = x.reshape(T, D)
    dt = x.dtype

    # the router's gradient into x, whole over ``model`` where the router
    # is, taken as a partial sum there, as the experts' is (``grad_layout``)
    logits = dot(grad_layout(xf, "partial").to(torch.float32),
                 params["router"])                         # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate, eidx = _topk(probs, top_k)                       # (T, k)
    # on DTensors the gates' gradient, a partial sum over the dims that
    # split the experts' products, is reduced here once (``grad_layout``)
    gate = grad_layout(gate / torch.clamp(gate.sum(-1, keepdim=True),
                                          min=1e-9), "reduced")

    if dispatch == "dense" and type(eidx).__name__ == "DTensor":
        comb = (_onehot(eidx, E, torch.float32) * gate[..., None]).sum(1)
        out = _dense_sharded(xf, comb, params, dt)
    elif dispatch == "dense":
        # (T, E) combine weights: gate at the top-k experts, 0 elsewhere
        comb = torch.zeros((T, E), dtype=torch.float32, device=x.device)
        comb.scatter_add_(1, eidx, gate)
        h = swiglu(torch.einsum("td,edf->tef", xf, params["wg"].to(dt)),
                   torch.einsum("td,edf->tef", xf, params["wi"].to(dt)))
        # weight the hidden by the combine mask BEFORE the down-projection
        # so e and f contract in one product — never materializing (T, E, D)
        hw = h * comb[:, :, None].to(dt)
        out = torch.einsum("tef,efd->td", hw, params["wo"].to(dt))
    elif dispatch == "ragged":
        # ---- dispatch: sort the T·k routed copies by expert ----------------
        flat_e = eidx.reshape(-1)                          # (T·k,)
        order = torch.argsort(flat_e, stable=True)
        tok_of = order // top_k                            # source token
        xs = xf[tok_of]                                    # (T·k, D)
        sizes = _counts(flat_e, E, torch.int64).tolist()     # host read
        # ---- grouped GEMM (dropless) ---------------------------------------
        h = swiglu(_grouped(xs, params["wg"].to(dt), sizes),
                   _grouped(xs, params["wi"].to(dt), sizes))
        ys = _grouped(h, params["wo"].to(dt), sizes)
        # ---- combine: unsort + router-weighted sum -------------------------
        gate_sorted = gate.reshape(-1)[order].to(dt)       # (T·k,)
        out = torch.zeros((T, D), dtype=dt, device=x.device).index_add_(
            0, tok_of, ys * gate_sorted[:, None])
    else:
        raise ValueError(dispatch)

    # switch-style load-balancing aux loss
    # on DTensors the router's statistics are reduced whole before their
    # product (DTensor would pick where, and torch versions pick apart)
    me = whole(probs.mean(0))                              # (E,)
    ce = whole(_counts(eidx, E, torch.float32)) / (T * top_k)
    aux = E * torch.sum(me * ce)
    return out.reshape(B, S, D), aux
