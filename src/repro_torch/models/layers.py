"""Shared layer primitives: norms, MLPs, rotary embeddings, initializers.

Port of ``repro/models/layers.py``, in its float order: the RMS norm
and the rotary angles in float32, the SwiGLU gate's SiLU in float32 and
cast back, SiLU spelled as the reference's ``x * sigmoid(x)``.
``dense_init`` draws from an explicit ``torch.Generator`` and allocates
on the generator's device; a truncated normal in [-2, 2]
standard deviations, as the reference's, but not its numbers (weights
carried over from the reference go through ``model.params_from_jax``).
The DTensor helpers (``on_mesh``, ``pin_batch``, ``unshard``, ``dot``,
``grad_layout``, ``whole``,
``split_last``, ``merge_last``, ``pointwise``, ``local_parts``,
``placed``, ``batch_placements``, ``shard_offset``) are what the model needs to run on a
``DeviceMesh``; each is the plain operation, or nothing, on a plain
tensor.
"""

from __future__ import annotations

import contextlib
import functools

import torch

__all__ = ["rms_norm", "dense_init", "silu", "swiglu", "rope",
           "rope_partial", "init_mlp", "mlp", "on_mesh", "split_last",
           "merge_last", "pointwise", "pin_batch", "shard_offset",
           "unshard", "dot", "grad_layout", "whole", "placed",
           "local_parts", "batch_placements"]


def on_mesh(fn):
    """``fn(params, ...)`` where, if ``params`` holds DTensors, the plain
    tensors the model makes on the way (positions, rotary angles, masks,
    zero accumulators: the same on every rank) read as replicated
    DTensors, in the backward pass too.  On plain params, ``fn`` as is."""
    @functools.wraps(fn)
    def wrapped(params, *args, **kwargs):
        with _replicated_constants(params):
            return fn(params, *args, **kwargs)
    return wrapped


def split_last(x, *sizes):
    """``x`` with its last dim split into ``sizes`` (heads).  A DTensor
    whose last dim is sharded over mesh dims that ``sizes[0]`` does not
    divide is gathered over them first: the split has no sharding rule
    there."""
    if type(x).__name__ == "DTensor":
        from torch.distributed.tensor import Replicate, Shard
        last = x.dim() - 1
        dims = [i for i, p in enumerate(x.placements)
                if isinstance(p, Shard) and p.dim == last]
        n = 1
        for i in dims:
            n *= x.device_mesh.shape[i]
        if sizes[0] % n:
            pl = [Replicate() if i in dims else p
                  for i, p in enumerate(x.placements)]
            x = x.redistribute(x.device_mesh, pl)
    return x.reshape(*x.shape[:-1], *sizes)


def merge_last(x, n: int = 2):
    """``x`` with its last ``n`` dims merged into one (heads back into
    features).  On a DTensor the result is pinned to its placements, so
    that the backward pass's split gets its gradient on a layout it can
    split (``split_last``'s)."""
    y = x.reshape(*x.shape[:-n], -1)
    if type(y).__name__ == "DTensor" and any(p.is_shard()
                                             for p in y.placements):
        y = y.redistribute(y.device_mesh, y.placements)
    return y


def pointwise(fn, x):
    """``fn(x)`` for an elementwise ``fn``; on a DTensor, on its local
    shard (for the ops DTensor has no sharding rule for, or none for
    their backward: ``log_sigmoid``)."""
    if type(x).__name__ != "DTensor":
        return fn(x)
    from torch.distributed.tensor import DTensor, Replicate
    pl = [Replicate() if p.is_partial() else p for p in x.placements]
    x = x.redistribute(x.device_mesh, pl)
    return DTensor.from_local(fn(x.to_local()), x.device_mesh, pl,
                              run_check=False)


def placed(pl, mesh) -> list:
    """Placements with every mesh dim of size 1 replicated: a shard (or
    a partial sum) over one rank is the whole, and DTensor's view rules
    refuse some shards of size-1 mesh dims."""
    from torch.distributed.tensor import Replicate
    return [Replicate() if n == 1 else p for p, n in zip(pl, mesh.shape)]


def local_parts(mesh, items) -> list:
    """Each DTensor of ``items`` (pairs of a DTensor and placements)
    redistributed to its placements, as its local shard, for a
    computation on the shards.  A tensor whole on a mesh dim that another
    one splits takes its gradient there as a partial sum: each rank's
    part of the computation contributes to it."""
    from torch.distributed.tensor import Partial, Shard
    split = [any(isinstance(pl[i], Shard) for _, pl in items)
             for i in range(mesh.ndim)]
    out = []
    for x, pl in items:
        grad = [Partial() if cut and not isinstance(p, Shard) else p
                for p, cut in zip(pl, split)]
        if list(x.placements) != list(pl):
            x = x.redistribute(mesh, pl)
        x = x.to_local(grad_placements=grad)
        out.append(_ContiguousGrad.apply(x) if x.requires_grad else x)
    return out


class _ContiguousGrad(torch.autograd.Function):
    """The identity, its gradient made contiguous: ``to_local``'s backward
    wraps the local gradient in the forward's DTensor layout, whose
    strides some torch versions' view rules take as the local tensor's
    (a gradient stacked along another dim fails their views)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def batch_placements(x, mesh):
    """Dim 0 over the FSDP axes (``data`` alone if they do not divide
    it), every other mesh dim replicated."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.distributed.sharding import fsdp_axes
    names = list(mesh.mesh_dim_names)
    sizes = dict(zip(names, mesh.shape))
    out = [Replicate() for _ in names]
    for axes in (fsdp_axes(mesh), ("data",)):
        axes = [a for a in axes if a in sizes]
        n = 1
        for a in axes:
            n *= sizes[a]
        if axes and x.shape[0] % n == 0:
            for a in axes:
                out[names.index(a)] = Shard(0)
            break
    return placed(out, mesh)


def pin_batch(x):
    """The residual stream between blocks: on a DTensor, the batch over
    the FSDP axes and everything else whole on each rank (a block's
    tensor-parallel partial sums are reduced here; the reference's
    ``act_spec`` also splits the sequence over ``model``, which torch
    2.11's DTensor cannot flatten into a product's rows); a plain
    tensor as is."""
    if type(x).__name__ != "DTensor":
        return x
    mesh = x.device_mesh
    pl = batch_placements(x, mesh)
    return x if list(x.placements) == pl else x.redistribute(x.device_mesh, pl)


def whole(x):
    """``x`` whole on every rank: a DTensor reduced or gathered to
    replicated; a plain tensor as is."""
    if type(x).__name__ != "DTensor":
        return x
    from torch.distributed.tensor import Replicate
    pl = [Replicate()] * x.device_mesh.ndim
    return x if list(x.placements) == pl else x.redistribute(x.device_mesh,
                                                              pl)


def unshard(w):
    """A weight at its use: a DTensor gathered over the FSDP axes (pod,
    data), its tensor-parallel split over ``model`` kept, as FSDP
    gathers a layer's weights before its compute (the backward pass
    reduce-scatters the gradient back); a plain tensor as is."""
    if type(w).__name__ != "DTensor":
        return w
    from torch.distributed.tensor import Replicate
    mesh = w.device_mesh
    pl = [Replicate() if name in ("pod", "data") and not p.is_partial()
          else p for name, p in zip(mesh.mesh_dim_names, w.placements)]
    return w.redistribute(mesh, pl) if pl != list(w.placements) else w


def dot(x, w):
    """``x @ w``: an activation (..., K) by a weight (K, N).  On DTensors
    the product runs where the weight lies, a layout the model states
    rather than DTensor's strategy (which torch versions choose
    differently): the activation moves to the weight (whole over every
    mesh dim that splits the weight, its K split like the weight's, its
    batch kept on the other dims), each rank multiplies its shards, and
    the result, a partial sum over the mesh dims that split K, is reduced
    onto the batch over the FSDP axes (``batch_placements``), its N left
    split over ``model`` where the weight splits it there.  In training
    and prefill ``unshard`` has gathered the weight over the FSDP axes
    (a tensor-parallel column or row product); decode reads each weight
    where it lies, FSDP's shard too.  On plain tensors ``x @ w``."""
    if type(w).__name__ != "DTensor" or type(x).__name__ != "DTensor":
        return x @ w
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = w.device_mesh
    names = mesh.mesh_dim_names
    last = x.dim() - 1
    xpl, opl = [], []
    for p, q in zip(w.placements, x.placements):
        if isinstance(p, Shard) and p.dim == 0:         # K split
            xpl.append(Shard(last))
            opl.append(Partial())
        elif isinstance(p, Shard):                      # N split
            xpl.append(Replicate())
            opl.append(Shard(last))
        else:                                           # the batch kept
            q = q if isinstance(q, Shard) and q.dim != last else Replicate()
            xpl.append(q)
            opl.append(q)
    x_l, w_l = local_parts(mesh, [(x, placed(xpl, mesh)),
                                  (w, list(w.placements))])
    out = DTensor.from_local(x_l @ w_l, mesh, placed(opl, mesh),
                             run_check=False)
    pl = batch_placements(out, mesh)
    for i, (name, p) in enumerate(zip(names, w.placements)):
        if name == "model" and isinstance(p, Shard) and p.dim == 1:
            pl[i] = Shard(last)
    pl = placed(pl, mesh)
    return out if list(out.placements) == pl else out.redistribute(mesh, pl)


def grad_layout(x, how: str):
    """``x`` itself, its gradient laid out as stated: on a DTensor,
    ``how="reduced"`` reduces a gradient that arrives as a partial sum
    over mesh dims where ``x`` is whole by one all-reduce on each, and
    ``how="partial"`` takes a gradient that arrives whole over the mesh
    dims where ``x`` is whole as a partial sum there (each rank's share
    the whole over the dim's size).  Where a gradient that is whole
    meets one that is a partial sum, DTensor picks the layout, and torch
    versions pick apart (2.11 reduces the partial one, 2.13 splits the
    whole one), so the model states it.  On a plain tensor, ``x``."""
    if type(x).__name__ != "DTensor" or not x.requires_grad:
        return x
    return _GradLayout.apply(x, how)


class _GradLayout(torch.autograd.Function):
    """The identity; the backward of ``grad_layout``."""

    @staticmethod
    def forward(ctx, x, how):
        ctx.how, ctx.mesh, ctx.pl = how, x.device_mesh, list(x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed import _functional_collectives as funcol
        from torch.distributed.tensor import DTensor, Partial, Replicate
        mesh, pl = ctx.mesh, list(g.placements)
        local = g.to_local()
        for i, (want, got) in enumerate(zip(ctx.pl, g.placements)):
            if not isinstance(want, Replicate) or mesh.shape[i] == 1:
                continue
            if ctx.how == "reduced" and isinstance(got, Partial):
                local = funcol.all_reduce(local, "sum", (mesh, i))
                if isinstance(local, funcol.AsyncCollectiveTensor):
                    local = local.wait()
                pl[i] = Replicate()
            elif ctx.how == "partial" and isinstance(got, Replicate):
                local = local / mesh.shape[i]
                pl[i] = Partial()
        if pl == list(g.placements):
            return g, None
        return DTensor.from_local(local, mesh, pl, run_check=False,
                                  shape=g.shape, stride=g.stride()), None


def shard_offset(x, dim: int) -> int:
    """The first global index along ``dim`` of this rank's shard of the
    DTensor ``x`` (even shards, mesh dims outermost first)."""
    from torch.distributed.tensor import Shard
    mesh = x.device_mesh
    coord = mesh.get_coordinate()
    idx, n = 0, 1
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim == dim:
            idx = idx * mesh.shape[i] + coord[i]
            n *= mesh.shape[i]
    return idx * (x.shape[dim] // n)


@contextlib.contextmanager
def _replicated_constants(params):
    from repro_torch.tree import tree_leaves
    leaves = tree_leaves(params)
    if not any(type(t).__name__ == "DTensor" for t in leaves):
        yield
        return
    from torch.distributed.tensor import DTensor
    disp = DTensor._op_dispatcher
    old = disp._allow_implicit_replication
    disp._allow_implicit_replication = True
    try:
        yield
    finally:
        disp._allow_implicit_replication = old


def dense_init(gen: torch.Generator, shape, scale: float = 1.0,
               dtype=torch.float32):
    """Truncated-normal fan-in init (stddev = scale / sqrt(fan_in))."""
    fan_in = shape[0] if len(shape) > 1 else shape[-1]
    std = scale / max(fan_in, 1) ** 0.5
    w = torch.empty(tuple(shape), dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (w * std).to(dtype)


def rms_norm(x, scale, eps: float = 1e-5):
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * scale.to(torch.float32)).to(dt)


def silu(x):
    """``jax.nn.silu``'s spelling, which rounds as the reference does on
    more inputs than ``F.silu``."""
    return x * torch.sigmoid(x)


def swiglu(gate, up):
    return silu(gate.to(torch.float32)).to(gate.dtype) * up


def _rope_angles(positions, dim: int, theta: float):
    """(..., dim/2) rotary angles for integer positions."""
    freqs = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                          device=positions.device) / dim))
    return positions[..., None].to(torch.float32) * freqs


def rope(x, positions, theta: float = 10000.0):
    """Rotary embedding over the full head dim. x: (B, S, H, dh)."""
    dh = x.shape[-1]
    ang = _rope_angles(positions, dh, theta)             # (B, S, dh/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


def rope_partial(x, positions, fraction: float, theta: float = 10000.0):
    """Partial rotary (glm4): rotate the first ``fraction`` of head dims."""
    if fraction >= 1.0:
        return rope(x, positions, theta)
    dh = x.shape[-1]
    rot = int(dh * fraction)
    rot -= rot % 2
    xr, xp = x[..., :rot], x[..., rot:]
    return torch.cat([rope(xr, positions, theta), xp], dim=-1)


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int,
             dtype=torch.float32):
    return {
        "wg": dense_init(gen, (d_model, d_ff), dtype=dtype),
        "wi": dense_init(gen, (d_model, d_ff), dtype=dtype),
        "wo": dense_init(gen, (d_ff, d_model), dtype=dtype),
    }


def mlp(params, x):
    """SwiGLU MLP. x: (..., D)."""
    dt = x.dtype
    gate = dot(x, params["wg"].to(dt))
    up = dot(x, params["wi"].to(dt))
    return dot(swiglu(gate, up), params["wo"].to(dt))
