"""Serving layer (mirrors ``repro.serve``)."""

from repro_torch.serve.dynwalk import DynamicWalkEngine

__all__ = ["DynamicWalkEngine"]
