"""Payload trees: a tensor, or a tuple/list of payload trees.

The engine routes stacked payloads (one sub-payload per combiner part) and
``(payload, validity)`` pairs through one exchange; this is the little tree
algebra it needs in place of ``jax.tree``.
"""
from __future__ import annotations

__all__ = ["leaves", "structure", "tree_map", "unflatten"]


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


def structure(tree):
    """``tree``'s nesting with its leaves left out: hashable, a cache key."""
    if isinstance(tree, (tuple, list)):
        return type(tree), tuple(structure(sub) for sub in tree)
    return None


def unflatten(struct, flat):
    """The tree of :func:`structure` ``struct`` whose leaves, in
    :func:`leaves` order, are ``flat``."""
    return _build(struct, iter(flat))


def _build(s, it):
    # a module-level recursion: a nested recursive closure would form a
    # reference cycle holding ``flat`` (and its tensors) until the cyclic
    # garbage collector runs
    if s is None:
        return next(it)
    kind, subs = s
    return kind(_build(sub, it) for sub in subs)
