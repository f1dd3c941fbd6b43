"""State, updates, sampling and walks (mirrors ``repro.core``)."""
