"""Bingo dynamic-graph random walks in PyTorch, with hand-written Hopper kernels.

The port of the JAX package ``repro``: each module here mirrors the JAX
module of the same path, which is the reference it is held against.
Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU, where every kernel is replaced by its plain PyTorch version.
"""
