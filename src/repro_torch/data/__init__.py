"""Data pipeline (mirrors ``repro.data``): BINGO walks -> packed LM token
batches."""

from repro_torch.data.pipeline import WalkCorpusPipeline, pack_walks

__all__ = ["WalkCorpusPipeline", "pack_walks"]
