"""Training-side utilities the serving layer needs (mirrors
``repro.train``): state-tree checkpointing."""
