"""Symmetric wire packing for butterfly payloads.

``gram_sum`` payloads are symmetric (…, n, n) matrices, so only the upper
triangle — n(n+1)/2 elements — crosses the wire: :func:`pack_sym` flattens
the upper triangle before every exchange and :func:`unpack_sym` mirrors it
back on receipt, so planned (``Plan.bytes_on_wire(symmetric=True)``) and
observed byte counts agree.

The round trip is exact for symmetric inputs: off-diagonal entries are
copied (never recomputed), and the diagonal is selected with a ``where``
rather than reconstructed arithmetically, so zero-filled non-receiver slots
and NaN-poisoned invalid slots survive bit-for-bit.
"""
from __future__ import annotations

import functools

import torch

__all__ = ["pack_sym", "unpack_sym", "packable"]


@functools.lru_cache(maxsize=64)
def _triu(n: int, device: torch.device):
    """Row-major upper-triangle indices and the diagonal mask, built once
    per (n, device) so no exchange copies them from the host again."""
    iu, ju = torch.triu_indices(n, n, device=device)
    return iu, ju, torch.eye(n, dtype=torch.bool, device=device)


def packable(leaf) -> bool:
    """Is this payload leaf a batched square matrix we can pack?"""
    return leaf.ndim >= 2 and leaf.shape[-1] == leaf.shape[-2]


def pack_sym(x: torch.Tensor) -> torch.Tensor:
    """(…, n, n) symmetric → (…, n(n+1)/2) upper triangle, row-major."""
    iu, ju, _ = _triu(x.shape[-1], x.device)
    return x[..., iu, ju]


def unpack_sym(v: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`pack_sym`: (…, n(n+1)/2) → symmetric (…, n, n)."""
    iu, ju, eye = _triu(n, v.device)
    upper = v.new_zeros(v.shape[:-1] + (n, n))
    upper[..., iu, ju] = v
    return torch.where(eye, upper, upper + upper.mT)
