"""Payload trees: a tensor, or a tuple/list of payload trees.

The engine routes stacked payloads (one sub-payload per combiner part) and
``(payload, validity)`` pairs through one exchange; this is the little tree
algebra it needs in place of ``jax.tree``.
"""
from __future__ import annotations

__all__ = ["leaves", "tree_map"]


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leaf-wise over trees of identical structure."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *subs) for subs in zip(tree, *rest))
    return fn(tree, *rest)


def leaves(tree) -> list:
    """The leaves of ``tree`` in the order :func:`tree_map` visits them."""
    if isinstance(tree, (tuple, list)):
        return [leaf for sub in tree for leaf in leaves(sub)]
    return [tree]
