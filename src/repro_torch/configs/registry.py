"""Architecture registry + the 40-cell (arch × shape) dry-run matrix.

Port of ``repro/configs/registry.py``: the same names and cells.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from repro_torch.configs import (glm4_9b, hubert_xlarge, jamba_v0_1_52b,
                                 llama3_405b, llama4_scout_17b_a16e,
                                 llava_next_mistral_7b, mixtral_8x7b,
                                 qwen2_0_5b, xlstm_350m, yi_34b)
from repro_torch.configs.shapes import SHAPES
from repro_torch.models.config import ModelConfig

__all__ = ["ARCHS", "CELLS", "get_config", "smoke_config", "cells"]

_MODULES = {
    "xlstm-350m": xlstm_350m,
    "yi-34b": yi_34b,
    "qwen2-0.5b": qwen2_0_5b,
    "llama3-405b": llama3_405b,
    "glm4-9b": glm4_9b,
    "mixtral-8x7b": mixtral_8x7b,
    "llama4-scout-17b-a16e": llama4_scout_17b_a16e,
    "jamba-v0.1-52b": jamba_v0_1_52b,
    "llava-next-mistral-7b": llava_next_mistral_7b,
    "hubert-xlarge": hubert_xlarge,
}

ARCHS: Tuple[str, ...] = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    return _MODULES[arch].FULL


def smoke_config(arch: str) -> ModelConfig:
    return _MODULES[arch].SMOKE


def _skip_reason(cfg: ModelConfig, shape_name: str) -> str:
    """'' = run; otherwise the DESIGN.md §4 skip reason."""
    if cfg.encoder_only and SHAPES[shape_name].kind == "decode":
        return "encoder-only: no decode step"
    if shape_name == "long_500k":
        # sub-quadratic decoders only: recurrent/hybrid state or bounded KV
        unbounded_full_attn = (
            cfg.has_attention
            and not cfg.sliding_window
            and not cfg.chunk_attn
            and "mamba" not in cfg.block_pattern
            and "mlstm" not in cfg.block_pattern
        )
        if unbounded_full_attn:
            return "pure full attention: 500k decode excluded per spec"
    return ""


def cells(arch: str) -> List[dict]:
    """All four shape cells for ``arch`` with run/skip + reason."""
    cfg = get_config(arch)
    out = []
    for name, shape in SHAPES.items():
        reason = _skip_reason(cfg, name)
        out.append({"arch": arch, "shape": shape, "skip": bool(reason),
                    "reason": reason})
    return out


CELLS: Dict[str, List[dict]] = {a: cells(a) for a in ARCHS}
