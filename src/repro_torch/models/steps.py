"""Time loops of the recurrences: on local shards, and costed in a dry run.

The mamba scan (``ssm.mamba_train``) and the sLSTM cell
(``xlstm.slstm_apply``) step through time one step at a time: S steps
of a few ops each.  Two helpers keep that cheap where the recurrence
runs on DTensors or under the dry run's cost counter, and are no-ops on
plain tensors outside it:

  * ``on_shards(fn, args, specs, out_specs)`` runs ``fn`` on each
    DTensor argument's local shard, laid out by ``specs`` (a batch dim
    over the FSDP axes, a channel dim over ``model``, the rest whole):
    the recurrence is independent across those dims, so no collective
    is lost, and each step is one local op, not a DTensor dispatch.
    The models run their other per-(batch, channel or head) math this
    way too (mamba's causal conv and decode step, the mLSTM's parallel
    form and decode step, decode attention over KV heads split over
    ``model``): the layout is the model's, and DTensor never flattens a
    batch and a split head dim into a product's rows, which some torch
    versions refuse.
  * ``loop(body, carry, n, xs)`` runs ``carry, out = body(i, carry,
    xs)`` for ``i < n``.  Under ``costed(k)`` (the dry run, with a
    ``roofline.CostCounter`` active) it runs only the iterations of the
    first ``k`` time steps and counts their work, forward and backward,
    as many times over as it takes to cover all ``n`` (the torch
    meaning of the reference's ``scan_flops_correction``: each
    iteration's work is the same).  The other iterations' outputs are
    stood in by unwritten tensors of their shape, and the memory their
    graph would keep for the backward pass by the costed ones' scaled
    alike.  A chunked loop (mamba's) takes chunks of the budget's length
    (``chunk_len``), so one costed iteration is a few steps; each
    iteration's own checkpointing runs inside as it would, so its
    recomputation is counted as the real backward pass does it.  The
    train step's microbatches, the same work each, are costed on one
    (``iters=1``).  ``stats`` sums the costed and total time steps.
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["COUNTERS", "on_shards", "loop", "costed", "stats", "chunk_len"]

COUNTERS: list = []     # the active cost counters (``roofline.CostCounter``)
_BUDGET = [None]        # iterations a loop runs under ``costed``
_STATS = {"steps_costed": 0, "steps_total": 0}


def stats() -> dict:
    return dict(_STATS)


def chunk_len(L: int) -> int:
    """A chunked loop's chunk length: ``L``, or the budget where that is
    shorter (under ``costed`` with a counter active).  Each step's work
    is the same whatever the chunking, so a loop costed on one short
    chunk counts what the long chunks would."""
    k = _BUDGET[0]
    return min(L, k) if k is not None and COUNTERS else L


@contextlib.contextmanager
def costed(k: int):
    """Loops run at most ``k`` time steps (at least one iteration),
    their work scaled to all."""
    old = _BUDGET[0]
    _BUDGET[0] = k
    _STATS.update(steps_costed=0, steps_total=0)
    try:
        yield
    finally:
        _BUDGET[0] = old


# ---------------------------------------------------------------------------
# local shards
# ---------------------------------------------------------------------------

def _resolve(spec, t, mesh):
    """A spec of symbols (``"B"``: the FSDP axes, ``"C"``: ``model``,
    ``None``: whole) as ``sharding.placements`` reads, each axis kept
    only where it divides the dim."""
    from repro_torch.distributed.sharding import (axis_size, fsdp_axes,
                                                  placements)
    from repro_torch.models.layers import placed
    names = set(mesh.mesh_dim_names)
    out = []
    for d, sym in zip(t.shape, spec):
        ax = None
        if sym == "B":
            for cand in (fsdp_axes(mesh), ("data",)):
                if set(cand) <= names and d % axis_size(mesh, cand) == 0:
                    ax = cand
                    break
        elif sym == "C" and "model" in names \
                and d % axis_size(mesh, "model") == 0:
            ax = "model"
        out.append(ax)
    return placed(placements(tuple(out), mesh), mesh)


def on_shards(fn, args, specs, out_specs):
    """``fn(*args)`` on the local shards of DTensor ``args`` (see the
    module docstring); plain tensors go straight through."""
    from torch.distributed.tensor import DTensor
    dt = [a for a in args if isinstance(a, DTensor)]
    if not dt:
        return fn(*args)
    from repro_torch.models.layers import local_parts
    mesh = dt[0].device_mesh
    local = local_parts(mesh, [(a, _resolve(s, a, mesh))
                               for a, s in zip(args, specs)])
    outs = fn(*local)
    single = isinstance(outs, torch.Tensor)
    outs = (outs,) if single else outs
    # each output's placements follow its spec's symbols, resolved on the
    # global size: the local size times the shards of its placements
    res = []
    for o, s in zip(outs, out_specs):
        pl = _out_placements(o, s, mesh, args, specs)
        res.append(DTensor.from_local(o, mesh, pl, run_check=False))
    return res[0] if single else tuple(res)


def _out_placements(o, spec, mesh, args, specs):
    """The placements of an output: each symbol takes the placement the
    same symbol got on the inputs."""
    from torch.distributed.tensor import Replicate, Shard
    got = {}
    for a, s in zip(args, specs):
        for i, p in enumerate(_resolve(s, a, mesh)):
            if isinstance(p, Shard):
                got.setdefault(i, s[p.dim])
    out = [Replicate() for _ in mesh.mesh_dim_names]
    for i, sym in got.items():
        if sym in spec:
            out[i] = Shard(spec.index(sym))
    return out              # from shards of _resolve: no size-1 mesh dim


# ---------------------------------------------------------------------------
# costed loops
# ---------------------------------------------------------------------------

class _Scaled(torch.autograd.Function):
    """``fn(*xs)`` whose work is counted ``scale`` times in the forward
    and the backward pass.  The forward runs it with its graph (outside
    any enclosing checkpoint's hooks), weighs the graph's bytes and
    drops it; a stand-in of ``scale`` times those bytes is saved for the
    backward pass, as the whole loop's graph would be (an enclosing
    checkpoint frees and remakes it as it would the real one).  The
    backward pass recomputes the graph uncounted and counts its
    gradient ``scale`` times; a checkpoint inside ``fn`` recomputes and
    is counted as it would be."""

    @staticmethod
    def forward(ctx, fn, scale, counter, *xs):
        ctx.fn, ctx.scale, ctx.counter = fn, scale, counter
        ins = [x.detach().requires_grad_(x.requires_grad) for x in xs]
        before = counter.live_bytes
        with _scaled(counter, scale), torch.enable_grad(), \
                torch.autograd.graph.saved_tensors_hooks(_same, _same):
            outs = fn(*ins)
        graph = counter.live_bytes - before - sum(
            o.untyped_storage().nbytes() for o in outs)
        outs = tuple(o.detach() for o in outs)
        standin = torch.empty(max(int(graph * scale), 0), dtype=torch.uint8,
                              device=xs[0].device)
        ctx.save_for_backward(standin, *xs)
        return outs

    @staticmethod
    def backward(ctx, *grads):
        xs = ctx.saved_tensors[1:]
        ins = [x.detach().requires_grad_(x.requires_grad) for x in xs]
        with _scaled(ctx.counter, 0.0), torch.enable_grad():
            outs = ctx.fn(*ins)
        want = [x for x in ins if x.requires_grad]
        pairs = [(o, g) for o, g in zip(outs, grads)
                 if g is not None and o.requires_grad]
        with _scaled(ctx.counter, ctx.scale):
            got = iter(torch.autograd.grad(
                [o for o, _ in pairs], want, [g for _, g in pairs],
                allow_unused=True) if pairs and want else ())
        return (None,) * 3 + tuple(next(got) if x.requires_grad else None
                                   for x in ins)


def _same(t):
    return t


@contextlib.contextmanager
def _scaled(counter, scale):
    old = counter.scale
    counter.scale = old * scale
    try:
        yield
    finally:
        counter.scale = old


def loop(body, carry, n: int, xs=(), *, width: int = 1, iters=None):
    """``carry, out = body(i, carry, xs)`` for ``i < n``: returns the
    last carry and the list of outputs.  ``carry`` and ``out`` are
    tuples of tensors; ``xs`` holds every other tensor the body reads
    (whole sequences it slices, weights), so that the costed backward
    reaches them.  Under ``costed(k)`` with a counter active only the
    first ``min(k, n)`` iterations run (see the module docstring).
    ``width`` is the time steps an iteration covers (``stats``);
    ``iters``, if given, is how many iterations a costed loop runs
    whatever the budget (a loop over something else than time, whose
    iterations ``stats`` leaves out: the microbatches)."""
    k = _BUDGET[0]
    if k is not None:
        k = iters or max(1, -(-k // width))   # iterations of the budget
    record = iters is None and k is not None and bool(COUNTERS)
    if k is None or not COUNTERS or k >= n:
        outs = []
        for i in range(n):
            carry, out = body(i, carry, xs)
            outs.append(out)
        if record:
            _STATS["steps_costed"] += n * width
            _STATS["steps_total"] += n * width
        return carry, outs
    if record:
        _STATS["steps_costed"] += k * width
        _STATS["steps_total"] += n * width
    nc = len(carry)

    def first(*c):
        c, x, outs = tuple(c[:nc]), tuple(c[nc:]), []
        for i in range(k):
            c, out = body(i, c, x)
            outs.append(out)
        return tuple(c) + tuple(y for out in outs for y in out)

    flat = _Scaled.apply(first, n / k, COUNTERS[-1], *carry, *xs)
    carry, rest = flat[:nc], flat[nc:]
    w = len(rest) // k
    outs = [tuple(rest[i * w:(i + 1) * w]) for i in range(k)]
    outs += [tuple(torch.empty_like(y) for y in outs[-1])
             for _ in range(n - k)]
    return tuple(carry), outs
