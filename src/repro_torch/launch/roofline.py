"""Roofline terms of a dry-run cell, counted from fake tensors.

Port of ``repro/launch/roofline.py``.  Three terms per (arch × shape ×
mesh), all in seconds a step on the H100 constants of ``launch/hw.py``:

  compute    = per-rank operations / PEAK_FLOPS_BF16
  memory     = per-rank bytes accessed / HBM_BW
  collective = per-rank on-node collective bytes / NVLINK_BW
               + off-node collective bytes / NET_BW

Where the reference reads ``cost_analysis()``, ``memory_analysis()`` and
the optimized HLO, the port runs the cell once on ``FakeTensor``s under
``CostCounter``, a ``TorchDispatchMode`` that sees every aten op, every
c10d collective and every kernel wrapper's fake branch:

  * operations — ``torch.utils.flop_counter``'s formulas for the
    matmul-class ops, one operation per output element for every other
    aten op (as XLA costs elementwise ops), and a kernel's model
    (``kernel_work``) for each kernel wrapper;
  * bytes accessed — each aten op's tensor inputs plus outputs (views
    and uninitialised allocations move nothing), and a kernel's model;
  * collective bytes — each c10d op's operand bytes by kind, and each
    functional collective's (``_c10d_functional``: what DTensor
    redistributes with), as the reference's HLO parse sums them, split
    by where the peers sit: a
    collective over a group of S ranks sends to S − 1 peers equally (an
    all-to-all keeps its own 1/S), and the peers on this rank's node
    (ranks in blocks of ``hw.NODE_CARDS``) take their share over NVLink,
    the rest over the network; an equal-split exchange over S contiguous
    ranks keeps 7/(S − 1) of what it sends on the node;
  * memory — the bytes of the live fake storages, tracked op by op: the
    arguments, the outputs, the aliased outputs (arguments written in
    place and returned), and the peak during the call.

On DTensors the counter counts one rank's work: it defers every op on a
DTensor to DTensor's own dispatch (``NotImplemented``), and so sees the
rank's local ops on its shards and the collectives that redistribute
them; a DTensor's storage is its local shard's.  DTensor's planning
(its sharding propagation, which runs the op at global shapes once per
op signature, and its strided shards' offset helpers) runs hidden from
it and outside the fake mode (``_hide_propagation``); on a CPU mesh a
shard-to-shard move on fake tensors is the card's all-to-all, not
gloo's all-gather fallback (``_alltoall_on_fake``).  Work inside a
costed loop of ``models.steps`` counts ``scale`` times.

MODEL_FLOPS keeps the reference's 6·N·D (train) / 2·N·D (inference)
convention with N = active parameters.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.launch import hw

__all__ = ["COLLECTIVES", "MEAN_DEGREE", "RooflineReport", "model_flops",
           "analyze", "walk_row_bytes", "walk_step_bytes", "update_row_bytes",
           "kernel_work", "bound",
           "CostCounter", "walk_step_roofline", "grade_walk_snapshot"]

COLLECTIVES = ("all_to_all_single", "all_reduce", "all_gather",
               "reduce_scatter", "broadcast", "all_to_all", "send_recv")

# c10d op name -> (kind, index of its operand argument)
_C10D = {"alltoall_base_": ("all_to_all_single", 1),
         "alltoall_": ("all_to_all", 1),
         "allreduce_": ("all_reduce", 0),
         "allreduce_coalesced_": ("all_reduce", 0),
         "allgather_": ("all_gather", 1),
         "_allgather_base_": ("all_gather", 1),
         "allgather_into_tensor_coalesced_": ("all_gather", 1),
         "reduce_scatter_": ("reduce_scatter", 1),
         "_reduce_scatter_base_": ("reduce_scatter", 1),
         "reduce_scatter_tensor_coalesced_": ("reduce_scatter", 1),
         "broadcast_": ("broadcast", 0),
         "send": ("send_recv", 0), "recv_": ("send_recv", 0)}

# functional collective (and DTensor's all-to-all) -> kind (the operand
# is argument 0, the group the last)
_FUNCTIONAL = {"all_gather_into_tensor": "all_gather",
               "all_gather_into_tensor_coalesced": "all_gather",
               "reduce_scatter_tensor": "reduce_scatter",
               "reduce_scatter_tensor_coalesced": "reduce_scatter",
               "all_reduce": "all_reduce",
               "all_reduce_coalesced": "all_reduce",
               "all_to_all_single": "all_to_all_single",
               "shard_dim_alltoall": "all_to_all_single",
               "broadcast": "broadcast"}

# the live-storage check (``CostCounter._note``): every storage while at
# most this many are tracked, else the old ones this often (in ops)
_OLD_EXACT = 512
_OLD_EVERY = 64

# ops with a scratch tensor whose size is the device's choice (log-sigmoid's
# buffer, empty on CUDA): (its index among the op's tensor outputs or
# inputs, "out" or "in"); it is not counted, so a cell counts alike on
# fake ``cpu`` and ``cuda`` tensors
_SCRATCH = {"log_sigmoid_forward": (1, "out"),
            "log_sigmoid_backward": (2, "in")}

# factories that read only their input's dtype and device: their output
# is counted, not that input (torch versions' autograd formulas pick
# ``zeros`` or ``new_zeros`` alike)
_NO_READ = ("new_zeros", "new_ones", "new_full")

# ops that allocate without writing: no bytes, no operations
_UNWRITTEN = ("empty", "empty_like", "empty_strided", "new_empty",
              "new_empty_strided")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


_PROPAGATING = [0]      # depth of DTensor's planning (sharding propagation)

# DTensor's planning: the sharding propagation (whose shape inference
# runs the op on global-shape fake tensors) and the shard-offset helpers
# of its strided placements, which compute offsets with small tensors
_PLANNING = (("torch.distributed.tensor._sharding_prop", "ShardingPropagator",
              ("propagate_op_sharding_non_cached",
               "_propagate_tensor_meta_non_cached")),
             ("torch.distributed.tensor.placement_types", "_StridedShard",
              ("local_shard_size_and_offset", "_local_shard_size_and_offset",
               "_local_shard_size")))


def _hide_propagation():
    """Run DTensor's planning unseen by the counter and outside the fake
    mode: it is bookkeeping at global shapes (once per op signature,
    then cached), and its offset helpers read small tensors on the host,
    which a fake tensor cannot give.  Raises if this torch lacks one of
    the methods: the counter would then count the planning's ops."""
    import importlib
    import inspect
    for mod, cls_name, names in _PLANNING:
        cls = getattr(importlib.import_module(mod), cls_name, None)
        for name in names:
            raw = inspect.getattr_static(cls, name, None) if cls else None
            if raw is None:
                raise RuntimeError(
                    f"roofline: torch {torch.__version__} has no "
                    f"{mod}.{cls_name}.{name}, which the counter hides "
                    f"(DTensor's planning, _PLANNING)")
            if getattr(raw, "_hidden", False):
                continue
            kind = type(raw) if isinstance(raw, (staticmethod,
                                                 classmethod)) else None
            fn = raw.__func__ if kind else raw
            hidden = _planning(fn)
            setattr(cls, name, kind(hidden) if kind else hidden)


def _alltoall_on_fake():
    """DTensor's shard-to-shard move is an all-to-all
    (``_dtensor.shard_dim_alltoall``), but on a CPU mesh DTensor falls
    back to an all-gather and a chunk (gloo has no all-to-all).  On fake
    tensors take the all-to-all, so a dry run on a CPU counts what the
    card's would."""
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import placement_types as pt
    fallback = pt.shard_dim_alltoall
    if getattr(fallback, "_hidden", False):
        return

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        if mesh.device_type != "cpu" or not isinstance(input, FakeTensor):
            return fallback(input, gather_dim, shard_dim, mesh, mesh_dim)
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim,
            funcol._resolve_group_name((mesh, mesh_dim)))

    alltoall._hidden = True
    pt.shard_dim_alltoall = alltoall


def _planning(fn):
    import functools

    @functools.wraps(fn)
    def hidden(*args, **kwargs):
        from torch._subclasses.fake_tensor import unset_fake_temporarily
        _PROPAGATING[0] += 1
        try:
            with unset_fake_temporarily():
                return fn(*args, **kwargs)
        finally:
            _PROPAGATING[0] -= 1

    hidden._hidden = True
    return hidden


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float
    coll_breakdown: Dict[str, int]
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    model_flops: float
    useful_ratio: float               # MODEL_FLOPS / (FLOPs * chips)
    memory_analysis: dict
    tokens: int
    meta: dict
    coll_on_node_bytes: float = 0.0   # of coll_bytes_per_device: to peers
    coll_off_node_bytes: float = 0.0  # on this rank's node / off it

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def model_flops(cfg, kind: str, tokens: int) -> float:
    """6·N_active·tokens (train) / 2·N_active·tokens (inference)."""
    n = cfg.active_param_count()
    return (6.0 if kind == "train" else 2.0) * n * tokens


def analyze(*, arch: str, shape: str, mesh_name: str, chips: int,
            cost: dict, mem: dict, cfg, kind: str, tokens: int,
            meta: Optional[dict] = None) -> RooflineReport:
    """The report of one cell from its counted ``cost``
    (``CostCounter.cost()``: ``flops``, ``bytes accessed``,
    ``collectives`` by kind, ``on_node``/``off_node`` bytes) and its
    ``mem`` (``CostCounter.memory()``).  The counter sees every
    dispatch, each loop iteration included, so of the reference's
    corrections only ``meta["flops_scale"]`` applies (an LM cell's MoE
    lowered with every expert computed); the relay's rounds are costed
    once (``meta["rounds_costed"]``) and the recurrences' time loops on
    a bounded number of steps (``meta["steps_costed"]``)."""
    meta = meta or {}
    # dense MoE dispatch computes every expert: keep the active share
    flops = float(cost.get("flops", 0.0)) * meta.get("flops_scale", 1.0)
    byts = float(cost.get("bytes accessed", 0.0))
    coll = {k: int(v) for k, v in cost.get("collectives", {}).items()}
    coll_total = float(sum(coll.values()))
    on = float(cost.get("on_node", 0.0))
    off = float(cost.get("off_node", 0.0))
    t_c = flops / hw.PEAK_FLOPS_BF16
    t_m = byts / hw.HBM_BW
    t_x = on / hw.NVLINK_BW + off / hw.NET_BW
    terms = {"compute": t_c, "memory": t_m, "collective": t_x}
    mf = model_flops(cfg, kind, tokens)
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        flops_per_device=flops, bytes_per_device=byts,
        coll_bytes_per_device=coll_total, coll_breakdown=coll,
        t_compute=t_c, t_memory=t_m, t_collective=t_x,
        bottleneck=max(terms, key=terms.get),
        model_flops=mf,
        useful_ratio=mf / max(flops * chips, 1.0),
        memory_analysis=mem, tokens=tokens, meta=meta,
        coll_on_node_bytes=on, coll_off_node_bytes=off,
    )


# ---------------------------------------------------------------------------
# Kernel work models, from shapes alone
# ---------------------------------------------------------------------------

def walk_row_bytes(capacity: int, kin: int, fp_bias: bool = False) -> int:
    """Device-memory bytes the reference's walk kernel moves a step per
    walker, whole rows DMA'd: the prob (f32) and alias (i32) rows of
    ``kin`` entries, the bias and nbr (i32) rows of ``capacity`` entries,
    the one-entry deg row, and in fp mode the frac (f32) row.  The
    step-throughput model (``walk_step_roofline``) keeps it."""
    return 4 * (2 * kin + 2 * capacity + 1) + (4 * capacity if fp_bias
                                               else 0)


# FULL's source graph, Twitter: 1.47 B edges over 41.7 M vertices.  A
# walker at a row drawn uniformly stands on a row of this many live
# slots on average (capped at the capacity).
MEAN_DEGREE = 35


def walk_step_bytes(capacity: int, degree: float,
                    fp_bias: bool = False) -> float:
    """Device-memory bytes the port's walk kernels read for one biased
    step at a row of ``degree`` live slots (at most ``capacity``): the
    deg word, one prob and one alias entry, the bias row's live slots
    (the group's members are found by their digits; in fp mode the frac
    row's too) and the picked nbr word.  The reference's kernel reads
    whole rows instead (``walk_row_bytes``)."""
    d = min(capacity, degree)
    return 4 * (4 + d + (d if fp_bias else 0))


def update_row_bytes(*, capacity: int, num_radix: int, group_capacity: int,
                     kin: int, fp: int, adaptive: int) -> int:
    """Bytes of one vertex's row across the tables a batched update round
    reads and rewrites: nbr and bias (and, in fp mode, frac) rows, the
    member lists, the inverted index (baseline mode), deg, wdec, the
    group sizes and digit sums, the alias row, the group types."""
    C, K, Cg = capacity, num_radix, group_capacity
    words = ((3 if fp else 2) * C + K * Cg + (0 if adaptive else K * C)
             + 2 + 2 * K + 2 * kin)
    return 4 * words + K


def kernel_work(name: str, shape: dict, share: float = 1.0) -> tuple:
    """``(bytes, operations)`` a kernel launch needs, from its record's
    shape parameters alone (``kernels/_fake.record``).

    B1 ``walk_fused`` / B3 ``walk_segment``: every walker reads one
    step's words each of its L steps (``walk_step_bytes`` at
    ``MEAN_DEGREE``: fake tensors hold no degrees; the
    ``simple`` kind reads deg and one nbr word) and writes its path (B3
    also its t0, walker id and frontier words); two operations per live
    bias word.  B4a ``walk_sample`` / B4b ``walk_sample_uniform``: one
    step, the row index, the uniforms and (nxt, slot).  B2
    ``update_fused``: each lane's row read and written once
    (``update_row_bytes``) plus the lanes (flag, u, v, w, mask); three
    operations per group and slot and the alias row's Kin^2 steps.
    ``share`` scales B2's rows: the expected share of a replicated batch
    whose source vertex a rank owns (1/S over S vertex shards), since a
    fake mask cannot be read; the rows are at most the table's.
    """
    C, kin = shape.get("capacity", 0), shape.get("kin", 0)
    biased = kin > 0
    d = min(C, MEAN_DEGREE)
    step = walk_step_bytes(C, MEAN_DEGREE, bool(shape.get("fp"))) if biased \
        else 8
    if name in ("walk_fused", "walk_segment"):
        B, L = shape["walkers"], shape["length"]
        io = 4 * B * (L + 2) + (4 * B * 4 if name == "walk_segment" else 0)
        return B * L * step + io, (2 * d * B * L if biased else 0)
    if name in ("walk_sample", "walk_sample_uniform"):
        B = shape["walkers"]
        return B * step + 4 * B * (3 + shape["ucols"]), (2 * d * B if biased
                                                         else 0)
    if name == "update_fused":
        B = shape["lanes"]
        rows = min(B * share, shape.get("vertices", B))
        rb = update_row_bytes(**{k: shape[k] for k in (
            "capacity", "num_radix", "group_capacity", "kin", "fp",
            "adaptive")})
        K = shape["num_radix"]
        return (2 * rb * rows + 14 * B,
                (3 * K * C + shape["kin"] ** 2) * rows)
    raise ValueError(f"no work model for kernel {name!r}")


def bound(nbytes, nops):
    """``(bound_ms, bound_by)``: the larger of bytes over the memory rate
    and 32-bit operations over the float32 rate outside the tensor cores
    (the published table has no separate integer rate)."""
    t_b, t_o = nbytes / hw.HBM_BW * 1e3, nops / hw.OPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


# ---------------------------------------------------------------------------
# The counter
# ---------------------------------------------------------------------------

def _process_group(args):
    """The ``ProcessGroup`` among a c10d op's arguments (None if none)."""
    import torch.distributed as dist
    for a in args:
        if type(a).__name__ == "ScriptObject":
            try:
                return dist.ProcessGroup.unbox(a)
            except (RuntimeError, TypeError):
                continue                # the ReduceOp, say
        if isinstance(a, dist.ProcessGroup):
            return a
    return None


class CostCounter(TorchDispatchMode):
    """Counts a call's operations, bytes, collectives and live memory.

    Enter it inside (after) the ``FakeTensorMode`` the call runs under;
    ``track_args`` the call's arguments first, ``finish`` its outputs
    after.  ``share`` maps a kernel name to the share ``kernel_work``
    scales it by.  ``kernels`` holds, per kernel, its records, bytes and
    operations.
    """

    def __init__(self, share: Optional[dict] = None):
        super().__init__()
        from torch.distributed.tensor import DTensor
        _hide_propagation()
        _alltoall_on_fake()
        self._dtensor = DTensor
        self.share = dict(share or {})
        self.scale = 1.0               # set by ``models.steps.costed``
        self.flops = 0.0
        self.bytes = 0.0
        self.coll = {k: 0 for k in COLLECTIVES}
        self.on_node = 0.0
        self.off_node = 0.0
        self.kernels: Dict[str, dict] = {}
        self._young: dict = {}         # storage id -> (weak ref, bytes)
        self._old: dict = {}
        self._ops = self._swept = 0
        self._live_bytes = 0
        self.peak = 0
        self.arg_ids: set = set()
        self.arg_bytes = 0
        self.donated_ids: set = set()
        self.out_bytes = self.alias_bytes = 0

    # -- memory ------------------------------------------------------------
    def _storages(self, tree):
        from torch.multiprocessing.reductions import StorageWeakRef
        out = {}
        for t in tree_flatten(tree)[0]:
            if isinstance(t, self._dtensor):
                t = t._local_tensor
            if isinstance(t, torch.Tensor):
                ref = StorageWeakRef(t.untyped_storage())
                out[ref.cdata] = (ref, t.untyped_storage().nbytes())
        return out

    def _note(self, tree):
        """Track new storages; where the tracked bytes could set a new
        peak, first drop the freed ones (those noted since the last
        check, and all of them while at most ``_OLD_EXACT`` are tracked,
        else every ``_OLD_EVERY`` ops), then update the peak.  Checking
        every storage at every op costs time quadratic in a long call's
        ops; the storages skipped can only raise the peak, never lower
        it."""
        for k, v in self._storages(tree).items():
            if k not in self._young and k not in self._old:
                self._young[k] = v
                self._live_bytes += v[1]
        self._ops += 1
        if self._live_bytes <= self.peak:
            return
        self._sweep(self._young)
        self._old.update(self._young)
        self._young = {}
        if self._live_bytes > self.peak and (
                len(self._old) <= _OLD_EXACT
                or self._ops - self._swept >= _OLD_EVERY):
            self._sweep(self._old)
            self._swept = self._ops
        self.peak = max(self.peak, self._live_bytes)

    def _sweep(self, tracked: dict):
        expired = torch.UntypedStorage._expired
        for k in [k for k, (ref, _) in tracked.items() if expired(ref.cdata)]:
            self._live_bytes -= tracked.pop(k)[1]

    @property
    def live_bytes(self) -> int:
        """The bytes of the storages alive now (every one checked)."""
        self._sweep(self._young)
        self._sweep(self._old)
        return self._live_bytes

    def track_args(self, args, donated=()):
        """Register the call's arguments (``donated``: indices of those
        written in place)."""
        st = self._storages(args)
        self.arg_ids = set(st)
        self.arg_bytes = sum(n for _, n in st.values())
        self.donated_ids = set(self._storages([args[i] for i in donated]))
        self._note(args)

    def finish(self, out):
        """Account the call's outputs; returns ``memory()``."""
        self._note(out)
        st = self._storages(out)
        self.out_bytes = sum(n for _, n in st.values())
        self.alias_bytes = sum(n for k, (_, n) in st.items()
                               if k in self.donated_ids)
        return self.memory()

    def memory(self) -> dict:
        """The reference's ``memory_analysis`` keys: temp is what was live
        at the peak beyond the arguments and the outputs that are not
        arguments, so ``total_nonalias_bytes`` is the peak."""
        nonalias_out = self.out_bytes - self.alias_bytes
        temp = max(0, self.peak - self.arg_bytes - nonalias_out)
        mem = {"argument_size_in_bytes": self.arg_bytes,
               "output_size_in_bytes": self.out_bytes,
               "temp_size_in_bytes": temp,
               "alias_size_in_bytes": self.alias_bytes}
        mem["total_nonalias_bytes"] = (self.arg_bytes + self.out_bytes + temp
                                       - self.alias_bytes)
        return mem

    # -- work --------------------------------------------------------------
    def _kernel(self, name, shape):
        nb, nops = kernel_work(name, shape, self.share.get(name, 1.0))
        k = self.kernels.setdefault(name, {"records": 0, "bytes": 0.0,
                                           "ops": 0.0})
        k["records"] += 1
        k["bytes"] += nb * self.scale
        k["ops"] += nops * self.scale
        self.bytes += nb * self.scale
        self.flops += nops * self.scale

    def __enter__(self):
        from repro_torch.kernels import _fake
        from repro_torch.models import steps
        _fake.LISTENERS.append(self._kernel)
        steps.COUNTERS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        from repro_torch.kernels import _fake
        from repro_torch.models import steps
        _fake.LISTENERS.remove(self._kernel)
        steps.COUNTERS.remove(self)
        return super().__exit__(*exc)

    def _collective(self, func, args):
        import torch.distributed as dist
        if func.namespace in ("_c10d_functional", "_dtensor"):
            kind, at = _FUNCTIONAL[func._opname], 0
            from torch.distributed.distributed_c10d import \
                _resolve_process_group
            pg = args[-1]
            if isinstance(pg, str):
                pg = _resolve_process_group(pg)
        else:
            kind, at = _C10D.get(func._opname, ("send_recv", 0))
            pg = _process_group(args)
        n = sum(_nbytes(t) for t in tree_flatten(args[at])[0]
                if isinstance(t, torch.Tensor)) * self.scale
        self.coll[kind] += n
        ranks = dist.get_process_group_ranks(pg) if pg is not None else [0]
        S = len(ranks)
        if S < 2:
            return
        me = dist.get_rank()
        near = sum(1 for r in ranks
                   if r != me and r // hw.NODE_CARDS == me // hw.NODE_CARDS)
        sent = n * (S - 1) / S if kind == "all_to_all_single" else n
        self.on_node += sent * near / (S - 1)
        self.off_node += sent * (S - 1 - near) / (S - 1)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, self._dtensor) for t in types):
            return NotImplemented       # DTensor's dispatch: the local ops
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if _PROPAGATING[0]:
            return out                  # shape inference at global shapes
        if func.namespace == "c10d":
            self._collective(func, args)
            return out
        if func.namespace in ("_c10d_functional", "_dtensor"):
            if func._opname in _FUNCTIONAL:
                self._collective(func, args)
            self._note(out)
            return out
        self._note(out)
        if func.namespace == "prim" or func.is_view \
                or func._opname in _UNWRITTEN:
            return out
        from torch.utils.flop_counter import flop_registry
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)] \
            if func._opname not in _NO_READ else []
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        if func._opname in _SCRATCH:
            i, where = _SCRATCH[func._opname]
            if where == "out":
                outs = outs[:i] + outs[i + 1:]
            else:
                ins = ins[:i] + ins[i + 1:]
        self.bytes += sum(_nbytes(t) for t in ins + outs) * self.scale
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out) * self.scale
        else:
            self.flops += sum(t.numel() for t in outs) * self.scale
        return out

    def cost(self) -> dict:
        return {"flops": self.flops, "bytes accessed": self.bytes,
                "collectives": dict(self.coll), "on_node": self.on_node,
                "off_node": self.off_node}


# ---------------------------------------------------------------------------
# Walk step-throughput model (DESIGN.md §8 cohort interleave)
# ---------------------------------------------------------------------------

def walk_step_roofline(*, walkers: int, capacity: int, kin: int,
                       length: int, cohorts: int = 1,
                       fp_bias: bool = False) -> dict:
    """Predicted whole-walk steps/second at one cohort count.

    Two terms a step: ``t_bw = walkers * row_bytes / HBM_BW``, the
    bandwidth floor, and ``t_lat = DMA_LATENCY / cohorts``, the exposed
    latency of the data-dependent row gather (the next row's address is
    the sample), amortised over the cohorts in flight.  steps/s =
    walkers / (t_bw + t_lat).
    """
    row = walk_row_bytes(capacity, kin, fp_bias)
    t_bw = walkers * row / hw.HBM_BW
    t_lat = hw.DMA_LATENCY / max(cohorts, 1)
    t_step = t_bw + t_lat
    return {
        "cohorts": cohorts,
        "row_bytes": row,
        "t_bandwidth": t_bw,
        "t_latency": t_lat,
        "predicted_steps_per_s": walkers / t_step,
        "length": length,
    }


def grade_walk_snapshot(snap: dict) -> list:
    """Achieved-vs-predicted rows for every fused ``-K<k>`` case of one
    BENCH_walks snapshot (``{env, sizing, cases}``); interpret-mode
    snapshots are not graded.  Returns dicts with kind, cohorts,
    platform, achieved/predicted steps/s and their ratio."""
    env = snap.get("env", {})
    sz = snap.get("sizing", {})
    if env.get("interpret", True):
        return []
    rows = []
    for case, achieved in sorted(snap.get("cases", {}).items()):
        m = re.match(r"(.+)-pallas-fused-K(\d+)$", case)
        if not m:
            continue
        kind, k = m.group(1), int(m.group(2))
        pred = walk_step_roofline(
            walkers=sz.get("walkers", 256),
            capacity=sz.get("capacity", 128),
            kin=sz.get("kin", 12),
            length=sz.get("walk_length", 16),
            cohorts=k)
        rows.append({
            "kind": kind, "cohorts": k,
            "platform": env.get("platform", "?"),
            "achieved_steps_per_s": float(achieved),
            "predicted_steps_per_s": pred["predicted_steps_per_s"],
            "ratio": float(achieved) / pred["predicted_steps_per_s"],
        })
    return rows


def _main_walks(path: str) -> None:
    import json
    with open(path) as f:
        doc = json.load(f)
    snaps = doc.get("snapshots") or [doc]
    print("| kind | K | platform | achieved steps/s | predicted steps/s "
          "| achieved/predicted |")
    print("|" + "---|" * 6)
    graded = 0
    for snap in snaps:
        for r in grade_walk_snapshot(snap):
            graded += 1
            print(f"| {r['kind']} | {r['cohorts']} | {r['platform']} "
                  f"| {r['achieved_steps_per_s']:.3e} "
                  f"| {r['predicted_steps_per_s']:.3e} "
                  f"| {r['ratio']:.3f} |")
    if not graded:
        print("(no interpret=false snapshots to grade)")


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--walks", default="BENCH_walks.json",
                    help="a BENCH_walks.json to grade (achieved against "
                         "the per-cohort step-throughput model)")
    _main_walks(ap.parse_args().walks)
