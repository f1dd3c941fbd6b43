"""Unified model configuration covering all assigned architecture families.

Port of ``repro/models/config.py``: the same fields, defaults and derived
quantities (its own copy; the port imports nothing of the reference).
``torch_dtype`` maps ``cfg.dtype`` to a torch dtype, in one place.

A model is ``R`` repeats of a ``P``-slot *stage* (``num_layers = R * P``).
Heterogeneous archs (jamba's 1:7 attn:mamba interleave, llama4's every-4th
global-attention layer, xlstm's sLSTM slots) express their layer pattern in
``block_pattern`` / ``moe_pattern`` / flags; homogeneous archs use P=1.
Each stage slot's parameters are stacked over the R repeats (a leading
axis ``R``); the port's forward and decode loop over the repeats.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

__all__ = ["ModelConfig", "torch_dtype"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a ``ModelConfig.dtype`` string."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown model dtype {name!r}") from None


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // num_heads

    # --- layer pattern -----------------------------------------------------
    stage_period: int = 1           # P
    block_pattern: Tuple[str, ...] = ("attn",)   # len P: attn|mamba|mlstm|slstm
    moe_pattern: Tuple[bool, ...] = ()           # len P; () -> all-dense FFN

    # --- attention ---------------------------------------------------------
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0      # glm4 partial rotary
    sliding_window: int = 0         # mixtral SWA (0 = full)
    chunk_attn: int = 0             # llama4 chunked local attention (0 = off)
    global_attn_slots: Tuple[int, ...] = ()  # slots with global (full, NoPE) attn
    causal: bool = True             # hubert encoder: False

    # --- MoE ---------------------------------------------------------------
    num_experts: int = 0
    top_k: int = 0
    router_aux_coef: float = 0.01
    moe_dispatch: str = "ragged"    # ragged (runtime) | dense (SPMD lowering)

    # --- mamba (jamba) -----------------------------------------------------
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2

    # --- xlstm ---------------------------------------------------------------
    xlstm_pf: float = 2.0           # mLSTM block expansion factor

    # --- misc ----------------------------------------------------------------
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    frontend: str = "none"          # none | vision | audio  (stub embeddings)
    encoder_only: bool = False
    dtype: str = "bfloat16"

    def __post_init__(self):
        if self.num_layers % self.stage_period != 0:
            raise ValueError(f"{self.name}: num_layers % stage_period != 0")
        if len(self.block_pattern) != self.stage_period:
            raise ValueError(f"{self.name}: len(block_pattern) != "
                             "stage_period")
        if self.moe_pattern and len(self.moe_pattern) != self.stage_period:
            raise ValueError(f"{self.name}: len(moe_pattern) != "
                             "stage_period")

    # -- derived ------------------------------------------------------------
    @property
    def repeats(self) -> int:
        """R — number of stacked stage repeats."""
        return self.num_layers // self.stage_period

    @property
    def dh(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def mamba_d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    @property
    def mamba_dt_rank(self) -> int:
        return -(-self.d_model // 16)

    def is_moe_slot(self, slot: int) -> bool:
        return bool(self.moe_pattern) and self.moe_pattern[slot]

    @property
    def has_attention(self) -> bool:
        return "attn" in self.block_pattern

    @property
    def recurrent_only(self) -> bool:
        """True if decode state is O(1) in context (no unbounded KV)."""
        if not self.has_attention:
            return True
        return bool(self.sliding_window) or bool(self.chunk_attn) and not \
            self.global_attn_slots

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        D, F, V = self.d_model, self.d_ff, self.vocab_size
        H, Hkv, dh = self.num_heads, self.num_kv_heads, self.dh
        total = V * D                                   # embedding
        if not self.tie_embeddings and not self.encoder_only:
            total += D * V                              # lm head
        for slot in range(self.stage_period):
            kind = self.block_pattern[slot]
            n = self.repeats
            if kind == "attn":
                blk = D * (H * dh) + 2 * D * (Hkv * dh) + (H * dh) * D
                if self.qkv_bias:
                    blk += (H + 2 * Hkv) * dh
            elif kind == "mamba":
                Di, N, dc = self.mamba_d_inner, self.mamba_d_state, \
                    self.mamba_d_conv
                dtr = self.mamba_dt_rank
                blk = (D * 2 * Di + Di * dc + Di * (dtr + 2 * N)
                       + dtr * Di + Di * N + Di + Di * D)
            elif kind == "mlstm":
                Di = int(self.xlstm_pf * D)
                blk = D * 2 * Di + 3 * Di * Di + 2 * Di + Di * D + 4 * Di
            elif kind == "slstm":
                blk = 4 * D * D + 4 * D * D + 8 * D + \
                    int(D * 4 / 3) * D * 2
            else:
                raise ValueError(kind)
            if kind == "attn" or kind in ("mamba",):
                if self.is_moe_slot(slot):
                    blk += D * self.num_experts + \
                        self.num_experts * 3 * D * F
                elif F:
                    blk += 3 * D * F
            blk += 2 * D                                 # two RMSNorm scales
            total += n * blk
        total += D                                       # final norm
        return total

    def active_param_count(self) -> int:
        """Activated params per token (MoE: top_k of num_experts)."""
        if not self.num_experts:
            return self.param_count()
        D, F = self.d_model, self.d_ff
        dense_equiv = self.param_count()
        for slot in range(self.stage_period):
            if self.is_moe_slot(slot):
                dense_equiv -= self.repeats * \
                    (self.num_experts - self.top_k) * 3 * D * F
        return dense_equiv
