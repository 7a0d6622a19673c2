"""Parameter trees: nested dicts, lists and tuples of tensors.

The optimizers walk a parameter tree and the gradient and state trees
beside it, in place of ``jax.tree``.  :func:`leaves` visits dict keys in
sorted order, as ``jax.tree.leaves`` does, so a sum over the leaves
(:func:`repro_torch.optim.adamw.global_norm`) adds them in the reference's
order.
"""
from __future__ import annotations

__all__ = ["leaves", "map_params", "split", "unflatten"]


def map_params(fn, params, *rest):
    """``fn(p, *others)`` at each leaf ``p`` of ``params``; each tree in
    ``rest`` is indexed by the same keys and positions, and whatever it
    holds there (a tensor, a dict of state, None) is passed as it is.
    A None in ``params`` stays None."""
    if isinstance(params, dict):
        return {k: map_params(fn, v, *(r[k] for r in rest)) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(map_params(fn, v, *(r[i] for r in rest))
                            for i, v in enumerate(params))
    if params is None:
        return None
    return fn(params, *rest)


def split(out, like, n: int) -> tuple:
    """Split a tree of ``n``-tuples, shaped as ``like``, into ``n`` trees."""
    return tuple(map_params(lambda _, o, i=i: o[i], like, out) for i in range(n))


def leaves(tree) -> list:
    """The tensors of ``tree``: dict keys sorted, None skipped."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for sub in tree for leaf in leaves(sub)]
    return [] if tree is None else [tree]


def unflatten(like, flat) -> object:
    """The tree shaped as ``like`` whose tensors, in :func:`leaves` order,
    are ``flat`` (``jax.tree.unflatten``); a None in ``like`` stays None."""
    return _unflatten(like, iter(flat))


def _unflatten(t, it):
    # a module-level recursion: a nested recursive closure would form a
    # reference cycle holding ``flat`` (and its tensors) until the cyclic
    # garbage collector runs
    if isinstance(t, dict):
        out = {k: _unflatten(t[k], it) for k in sorted(t)}
        return {k: out[k] for k in t}
    if isinstance(t, (list, tuple)):
        return type(t)(_unflatten(v, it) for v in t)
    return None if t is None else next(it)
