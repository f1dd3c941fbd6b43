"""Nested dicts of tensors, walked as the reference walks its pytrees.

Params, gradients, moments and error-feedback states are nested dicts
with the reference's keys; ``tree_leaves`` lists their leaves in
``jax.tree.leaves``'s order (dict keys sorted) and ``tree_map`` maps a
function over one tree's leaves and the same leaves of others.
"""

from __future__ import annotations

__all__ = ["tree_leaves", "tree_map"]


def tree_leaves(tree) -> list:
    """Leaves in the reference's order (``jax.tree.leaves``: dict keys
    sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the same leaves of ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)
