"""Per-cell specs of the dry run, and the arithmetic the cells share.

Port of ``repro/launch/specs.py``, the part the walk cells need.  A
``CellSpec`` holds what ``launch/dryrun.py`` runs: the cell's function,
a function that builds its example arguments on a device (called under
``FakeTensorMode`` in the dry run, so nothing is allocated), which
arguments the function writes in place (the reference's donated
buffers), and ``meta``.  ``train_plan``, ``scan_flops_correction``,
``attn_flops_correction`` and ``moe_flops_scale`` are the reference's
arithmetic on configs and mesh shapes.  The LM cells (a sharded train,
prefill or decode step) are not built here yet: ``build_cell`` raises.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

from repro_torch.configs import SHAPES
from repro_torch.distributed.sharding import axis_size, fsdp_axes
from repro_torch.models.config import ModelConfig

__all__ = ["CellSpec", "build_cell", "train_plan", "scan_flops_correction",
           "attn_flops_correction", "moe_flops_scale"]


@dataclasses.dataclass
class CellSpec:
    arch: str
    shape_name: str
    kind: str
    fn: Callable
    args: Callable            # device -> the example argument tuple
    donate: Tuple[int, ...]   # arguments written in place and returned
    meta: dict


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


def build_cell(arch: str, shape_name: str, mesh, fast: bool = False):
    raise NotImplementedError(
        f"{arch} × {shape_name}: the LM cells (a sharded train, prefill or "
        "decode step on DTensor parameters) are not ported yet; ROADMAP "
        "A.19")
