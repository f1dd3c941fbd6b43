"""Drivers (mirrors ``repro.launch``): the LM serving driver."""
