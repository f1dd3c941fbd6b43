"""Drivers (mirrors ``repro.launch``): the LM serving and training
drivers."""
