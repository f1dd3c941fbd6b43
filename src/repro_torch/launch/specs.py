"""Per-cell specs of the dry run: the LM cells and the arithmetic they share.

Port of ``repro/launch/specs.py``.  A ``CellSpec`` holds what
``launch/dryrun.py`` runs: the cell's function, a function that builds
its example arguments on a device (called under ``FakeTensorMode`` in
the dry run, so nothing is allocated), which arguments the function
writes in place and returns (the reference's donated buffers), and
``meta``.  ``build_cell(arch, shape_name, mesh)`` builds an LM cell:

  train    — one optimizer step (``make_train_step`` with the arch's
             ``train_plan``: microbatches, remat, moment dtype);
  prefill  — the full-context forward emitting the last position's
             logits only (no (B, S, V) logits);
  decode   — one ``decode_step`` token against a ``seq_len`` cache.

Where the reference hands ``jax.jit`` shape stand-ins and shardings, the
port's arguments are DTensors on the production ``DeviceMesh``, placed
by ``sharding.param_pspecs`` / ``batch_pspec`` / ``cache_pspecs``: each
is made from a local shard of its rank's shape (``DTensor.from_local``),
never from a global tensor, so a fake rank holds only its share.
Params' global shapes come from ``init_model`` through a generator on
the ``meta`` device (``_params_meta``): nothing is drawn.  ``place``
puts given global values on the same placements (the real comparisons
of the CPU tests and of ``chip_smoke.py`` phase 3l).  MoE archs lower
with ``moe_dispatch="dense"`` (the ragged mode reads its group sizes on
the host) and ``meta["flops_scale"]`` takes the phantom expert compute
back out (``roofline.analyze``).  ``train_plan``,
``scan_flops_correction``, ``attn_flops_correction`` and
``moe_flops_scale`` are the reference's arithmetic; the dry run counts
every loop iteration eagerly, so of the reference's corrections only
``flops_scale`` has a use here, and the recurrences' time loops are
costed by ``models.steps`` (``meta["steps_costed"]``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.configs import SHAPES, get_config
from repro_torch.distributed.sharding import (axis_size, batch_pspec,
                                              cache_pspecs, fsdp_axes,
                                              param_pspecs, placements)
from repro_torch.launch import hw
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import placed
from repro_torch.tree import tree_map

__all__ = ["CellSpec", "build_cell", "train_plan", "scan_flops_correction",
           "attn_flops_correction", "moe_flops_scale", "place",
           "rank_shape"]


@dataclasses.dataclass
class CellSpec:
    arch: str
    shape_name: str
    kind: str
    fn: Callable
    args: Callable            # device -> the example argument tuple
    donate: Tuple[int, ...]   # arguments written in place and returned
    meta: dict
    specs: Tuple[Any, ...] = ()   # LM cells: each argument's spec tree


def train_plan(cfg: ModelConfig, mesh) -> dict:
    """Baseline training knobs per arch (the §Perf starting point)."""
    n_params = cfg.param_count()
    dp = axis_size(mesh, fsdp_axes(mesh))
    shape = SHAPES["train_4k"]
    per_dev_seqs = max(shape.global_batch // dp, 1)
    per_dev_tokens = per_dev_seqs * shape.seq_len
    micro = 1
    while per_dev_tokens // micro > 8192 and per_dev_seqs % (micro * 2) == 0:
        micro *= 2
    return {
        "microbatches": micro,
        "remat": "full" if cfg.num_experts else
                 ("dots" if cfg.d_model >= 4096 else "none"),
        "moment_dtype": "bfloat16" if n_params >= 5e10 else "float32",
        "semi": cfg.num_layers >= 100,
    }


def scan_flops_correction(cfg: ModelConfig, tokens_global: int, chips: int,
                          train: bool) -> float:
    """Per-device FLOPs of the time-step scans that the reference's cost
    analysis counts once: the mamba SSM recurrence and the sLSTM
    recurrent matvecs (approximate)."""
    per_dev = tokens_global / chips
    f = 0.0
    n_mamba = cfg.block_pattern.count("mamba") * cfg.repeats
    if n_mamba:
        f += 10.0 * cfg.mamba_d_inner * cfg.mamba_d_state * per_dev * n_mamba
    n_slstm = cfg.block_pattern.count("slstm") * cfg.repeats
    if n_slstm:
        dh = cfg.d_model // cfg.num_heads
        f += (8.0 * dh * cfg.d_model + 30.0 * cfg.d_model) * per_dev \
            * n_slstm
    return f * (3.0 if train else 1.0)


def attn_flops_correction(cfg: ModelConfig, shape, chips: int) -> float:
    """Analytic attention FLOPs of the (n-1)/n q-chunks a long-sequence
    prefill's chunk loop hides from the reference's cost analysis."""
    S = shape.seq_len
    if S < 8192:
        return 0.0
    tokens = shape.global_batch * S
    f = 0.0
    for slot in range(cfg.stage_period):
        if cfg.block_pattern[slot] != "attn":
            continue
        if cfg.chunk_attn and slot not in cfg.global_attn_slots:
            avg_ctx, span = cfg.chunk_attn / 2, cfg.chunk_attn
        elif cfg.sliding_window:
            avg_ctx, span = min(cfg.sliding_window, S), S
        else:
            avg_ctx, span = (S / 2 if cfg.causal else S), S
        n = max(span // 1024, 1)
        f += 4.0 * tokens * avg_ctx * cfg.num_heads * cfg.dh \
            * cfg.repeats * (1.0 - 1.0 / n)
    return f / chips


def moe_flops_scale(cfg: ModelConfig) -> float:
    """Active over dense parameters: the reference lowers MoE with every
    expert computed and scales its FLOPs by this."""
    if not cfg.num_experts:
        return 1.0
    return cfg.active_param_count() / cfg.param_count()




# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------

class _MetaGenerator(torch.Generator):
    """A CPU generator that reports the ``meta`` device: ``init_model``
    through it allocates every leaf on ``meta`` and draws nothing."""

    @property
    def device(self):
        return torch.device("meta")


def _params_meta(cfg: ModelConfig):
    """The params tree's global shapes and dtypes, on ``meta``."""
    from repro_torch.models.model import init_model
    return init_model(cfg, _MetaGenerator())


def _batch_meta(cfg: ModelConfig, batch: int, seq: int, train: bool):
    meta = dict(dtype=torch.int32, device="meta")
    if cfg.frontend == "none":
        out = {"inputs": torch.empty((batch, seq), **meta)}
    else:
        out = {"embeddings": torch.empty((batch, seq, cfg.d_model),
                                         dtype=torch.bfloat16, device="meta")}
    if train:
        out["targets"] = torch.empty((batch, seq), **meta)
    return out


def _box(shape, pl, mesh):
    """This rank's shard of a global ``shape`` under placements ``pl``:
    (local shape, offset).  Every sharded dim divides evenly (the specs'
    rules check it), so this is plain arithmetic: no tensor is made,
    which a fake mode would intercept."""
    from torch.distributed.tensor import Shard
    coord = mesh.get_coordinate()
    local, off = list(shape), [0] * len(shape)
    for i, p in enumerate(pl):                 # mesh dims, outermost first
        if isinstance(p, Shard):
            n = mesh.shape[i]
            if local[p.dim] % n:
                raise ValueError(f"dim {p.dim} of {tuple(shape)} does not "
                                 f"split over {n}")
            local[p.dim] //= n
            off[p.dim] += coord[i] * local[p.dim]
    return tuple(local), tuple(off)


def _local(t, spec, mesh, device):
    """A DTensor of ``t``'s global shape and dtype placed by ``spec``,
    made from a zero local shard on ``device``."""
    from torch.distributed.tensor import DTensor
    pl = placed(placements(spec, mesh), mesh)
    shape, _ = _box(t.shape, pl, mesh)
    local = torch.zeros(shape, dtype=t.dtype, device=device)
    return DTensor.from_local(local, mesh, pl, run_check=False,
                              shape=t.shape, stride=_contiguous(t.shape))


def _contiguous(shape) -> tuple:
    stride, n = [], 1
    for d in reversed(tuple(shape)):
        stride.append(n)
        n *= d
    return tuple(reversed(stride))


def _dtensors(tree, specs, mesh, device):
    return tree_map(lambda t, s: _local(t, s, mesh, device), tree, specs)


def place(values, specs, mesh):
    """Global tensors ``values`` (a tree, or a tuple of trees and Nones
    beside ``specs``) as DTensors on ``mesh``, each rank keeping its
    shard of the same values: what a cell's arguments hold for real."""
    from torch.distributed.tensor import DTensor

    def one(t, spec):
        pl = placed(placements(spec, mesh), mesh)
        shape, off = _box(t.shape, pl, mesh)
        local = t[tuple(slice(o, o + n) for o, n in zip(off, shape))]
        return DTensor.from_local(local.contiguous(), mesh, pl,
                                  run_check=False, shape=t.shape,
                                  stride=_contiguous(t.shape))

    if isinstance(values, tuple) and not hasattr(values, "_fields"):
        return tuple(None if v is None else place(v, s, mesh)
                     for v, s in zip(values, specs))
    if hasattr(values, "_fields"):               # OptState
        return type(values)(*[place(v, s, mesh)
                              for v, s in zip(values, specs)])
    return tree_map(one, values, specs)


def _build_train(arch, cfg, shape, mesh, plan) -> CellSpec:
    from repro_torch.train.optim import OptConfig, OptState
    from repro_torch.train.train_step import make_train_step
    opt_cfg = OptConfig(moment_dtype=plan["moment_dtype"])
    step = make_train_step(cfg, opt_cfg, remat=plan["remat"],
                           microbatches=plan["microbatches"])
    params = _params_meta(cfg)
    mdt = getattr(torch, plan["moment_dtype"])
    moments = tree_map(lambda p: torch.empty(p.shape, dtype=mdt,
                                             device="meta"), params)
    batch = _batch_meta(cfg, shape.global_batch, shape.seq_len, train=True)
    pspecs = param_pspecs(params, cfg, mesh)
    bspecs = batch_pspec(cfg, mesh, batch)
    # the reference's OptState(step=P(), mu=pspecs, nu=pspecs)
    ospecs = OptState(step=(), mu=pspecs, nu=pspecs)
    step_meta = torch.empty((), dtype=torch.int32, device="meta")

    def args(device):
        return (_dtensors(params, pspecs, mesh, device),
                OptState(_local(step_meta, (), mesh, device),
                         _dtensors(moments, pspecs, mesh, device),
                         _dtensors(moments, pspecs, mesh, device)),
                None, _dtensors(batch, bspecs, mesh, device))

    tokens = shape.global_batch * shape.seq_len
    return CellSpec(
        arch=arch, shape_name=shape.name, kind="train",
        fn=lambda p, o, e, b: step(p, o, e, b), args=args, donate=(0, 1),
        meta={"plan": plan, "tokens": tokens,
              "flops_scale": moe_flops_scale(cfg)},
        specs=(pspecs, ospecs, None, bspecs))


def _build_prefill(arch, cfg, shape, mesh) -> CellSpec:
    from repro_torch.models.layers import dot, unshard
    from repro_torch.models.model import forward_hidden
    params = _params_meta(cfg)
    batch = _batch_meta(cfg, shape.global_batch, shape.seq_len, train=False)
    pspecs = param_pspecs(params, cfg, mesh)
    bspecs = batch_pspec(cfg, mesh, batch)

    def prefill(params, batch):
        h, _ = forward_hidden(params, cfg, batch)               # (B, S, D)
        head = params["embed"].T if cfg.tie_embeddings else params["head"]
        return dot(h[:, -1].to(torch.float32), unshard(head).to(torch.float32))

    def args(device):
        return (_dtensors(params, pspecs, mesh, device),
                _dtensors(batch, bspecs, mesh, device))

    return CellSpec(
        arch=arch, shape_name=shape.name, kind="prefill", fn=prefill,
        args=args, donate=(),
        meta={"tokens": shape.global_batch * shape.seq_len,
              "flops_scale": moe_flops_scale(cfg)},
        specs=(pspecs, bspecs))


def _build_decode(arch, cfg, shape, mesh) -> CellSpec:
    from repro_torch.models.model import decode_step, init_decode_cache
    B = shape.global_batch
    params = _params_meta(cfg)
    cache = init_decode_cache(cfg, B, shape.seq_len, device="meta")
    tok = torch.empty((B,), dtype=torch.int32, device="meta")
    pspecs = param_pspecs(params, cfg, mesh)
    cspecs = cache_pspecs(cfg, mesh, cache)
    dp = fsdp_axes(mesh)
    tok_spec = (dp if B % axis_size(mesh, dp) == 0 else None,)

    def serve_step(params, tokens, pos, cache):
        return decode_step(params, cfg, tokens, pos, cache)

    def args(device):
        return (_dtensors(params, pspecs, mesh, device),
                _local(tok, tok_spec, mesh, device),
                _local(tok, tok_spec, mesh, device),
                _dtensors(cache, cspecs, mesh, device))

    return CellSpec(
        arch=arch, shape_name=shape.name, kind="decode", fn=serve_step,
        args=args, donate=(3,),
        meta={"tokens": B, "flops_scale": moe_flops_scale(cfg)},
        specs=(pspecs, tok_spec, tok_spec, cspecs))


def rank_shape(shape):
    """``shape`` with its global batch cut to one rank's share of the
    production mesh (rounded up to 1): what one card runs for real."""
    return dataclasses.replace(shape, global_batch=max(
        shape.global_batch // hw.SINGLE_POD_CHIPS, 1))


def build_cell(arch: str, shape_name: str, mesh, *,
               cfg: Optional[ModelConfig] = None, shape=None) -> CellSpec:
    """The LM cell ``arch`` × ``shape_name`` on ``mesh`` (a
    ``DeviceMesh`` over an initialised world).  ``cfg`` (default the
    arch's FULL) and ``shape`` (default ``SHAPES[shape_name]``) resize
    it; the train plan's microbatches are cut to divide the rank's
    batch."""
    cfg = cfg or get_config(arch)
    if cfg.num_experts:
        # the ragged dispatch reads its group sizes on the host, which a
        # fake tensor cannot give; the dense one computes every expert and
        # ``flops_scale`` takes the phantom compute back out
        cfg = dataclasses.replace(cfg, moe_dispatch="dense")
    shape = shape or SHAPES[shape_name]
    if shape.kind == "train":
        plan = train_plan(cfg, mesh)
        local = max(shape.global_batch // axis_size(mesh, fsdp_axes(mesh)), 1)
        plan["microbatches"] = math.gcd(plan["microbatches"], local)
        return _build_train(arch, cfg, shape, mesh, plan)
    if shape.kind == "prefill":
        return _build_prefill(arch, cfg, shape, mesh)
    if shape.kind == "decode":
        return _build_decode(arch, cfg, shape, mesh)
    raise ValueError(shape.kind)
