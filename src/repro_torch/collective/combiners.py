"""Pluggable combiners for the fault-tolerant butterfly engine.

The plan/route/validity machinery (redundant exchange, replica rerouting,
self-healing respawn) only requires the per-level combine to be
*associative over contiguous index blocks*.  A :class:`Combiner` packages
the three algorithm-specific pieces the engine needs:

  * ``prepare``  — the local transform applied before level 0 (local QR for
    TSQR, identity for arithmetic reductions);
  * ``combine``  — merge the lower-block and upper-block partials.  The
    engine always presents operands ordered by the level bit of the block
    index, so order-sensitive combines (QR row-stacking) produce
    bit-identical results on every member of a block;
  * ``finalize`` — post-butterfly fixup (mean divides by the rank count).

``wire_symmetric`` declares that payloads are symmetric matrices, which the
engine ships as the n(n+1)/2 packed triangle.

:class:`StackedCombiner` bundles several combiners into one: the payload is
a tuple with one sub-payload per part, each part's algebra applied to its
own leaves under a *single* plan.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ._tree import leaves, tree_map
from .packing import packable

__all__ = [
    "Combiner",
    "SumCombiner",
    "MeanCombiner",
    "MaxCombiner",
    "GramSumCombiner",
    "QRCombiner",
    "StackedCombiner",
    "stacked",
    "get_combiner",
    "COMBINERS",
    "posdiag",
    "qr_r",
]


def posdiag(r: torch.Tensor) -> torch.Tensor:
    """Normalize an upper-triangular factor to a non-negative diagonal, which
    makes the R factor unique, so every rank (and the numpy oracle) computes
    comparable results."""
    d = torch.diagonal(r, dim1=-2, dim2=-1)
    s = torch.where(d < 0, -1.0, 1.0).to(r.dtype)
    return r * s[..., :, None]


def qr_r(a: torch.Tensor) -> torch.Tensor:
    """Householder QR, R factor only, sign-normalized (a library call, as
    the reference calls ``jnp.linalg.qr``)."""
    return posdiag(torch.linalg.qr(a, mode="r")[1])


class Combiner:
    """Protocol for butterfly combiners.  Subclasses override ``combine``."""

    name: str = "?"
    wire_symmetric: bool = False

    def prepare(self, x):
        """Local transform before the first exchange (per payload leaf)."""
        return x

    def combine(self, lo, hi):
        """Merge two block partials; ``lo`` is the lower-index block."""
        raise NotImplementedError

    def finalize(self, x, n_ranks: int):
        """Post-butterfly fixup (per payload leaf)."""
        return x

    # -- tree-level protocol (what the engine calls) --------------------------

    def tree_prepare(self, x):
        return tree_map(self.prepare, x)

    def tree_combine(self, lo, hi):
        return tree_map(self.combine, lo, hi)

    def tree_finalize(self, x, n_ranks: int):
        return tree_map(lambda leaf: self.finalize(leaf, n_ranks), x)

    def wire_pack_flags(self, val) -> list[bool]:
        """Per-leaf wire packing, aligned with ``leaves(val)``: a leaf ships
        packed iff this combiner declares ``wire_symmetric`` and the leaf is
        a (batched) square matrix."""
        return [self.wire_symmetric and packable(leaf) for leaf in leaves(val)]


@dataclasses.dataclass(frozen=True)
class SumCombiner(Combiner):
    name = "sum"

    def combine(self, lo, hi):
        return lo + hi


@dataclasses.dataclass(frozen=True)
class MeanCombiner(Combiner):
    name = "mean"

    def combine(self, lo, hi):
        return lo + hi

    def finalize(self, x, n_ranks: int):
        return x / n_ranks


@dataclasses.dataclass(frozen=True)
class MaxCombiner(Combiner):
    name = "max"

    def combine(self, lo, hi):
        return torch.maximum(lo, hi)


@dataclasses.dataclass(frozen=True)
class GramSumCombiner(Combiner):
    """Sum of symmetric Gram payloads (the CholeskyQR reorthogonalization
    rides this); the payload ships as its packed upper triangle."""

    name = "gram_sum"
    wire_symmetric = True

    def combine(self, lo, hi):
        return lo + hi


@dataclasses.dataclass(frozen=True)
class QRCombiner(Combiner):
    """The paper's TSQR combine: ``R = qr([R_lo; R_hi])`` with the operands
    row-stacked in block order.  ``local_qr`` is the level-0 panel
    factorization (Householder or CholeskyQR2 on the Hopper kernels)."""

    local_qr: Callable = qr_r
    name = "qr_combine"

    def prepare(self, x):
        return self.local_qr(x)

    def combine(self, lo, hi):
        return qr_r(torch.cat([lo, hi], dim=-2))


@dataclasses.dataclass(frozen=True)
class StackedCombiner(Combiner):
    """Several combiners fused under one plan: the payload is a tuple with
    one sub-payload per part.  Per-leaf wire packing is delegated to each
    part."""

    parts: tuple[Combiner, ...] = ()
    name = "stacked"

    def __post_init__(self):
        if not self.parts:
            raise ValueError("StackedCombiner needs at least one part")

    def _subs(self, x) -> tuple:
        if not isinstance(x, (tuple, list)) or len(x) != len(self.parts):
            raise TypeError(
                f"stacked payload must be a tuple of {len(self.parts)} "
                f"sub-payloads (one per part), got {type(x).__name__}"
            )
        return tuple(x)

    # Which part's algebra a leaf belongs to is positional, so the engine
    # must go through the tree_* protocol.
    def prepare(self, x):
        raise TypeError("StackedCombiner operates at tree level")

    def combine(self, lo, hi):
        raise TypeError("StackedCombiner operates at tree level")

    def finalize(self, x, n_ranks: int):
        raise TypeError("StackedCombiner operates at tree level")

    def tree_prepare(self, x):
        return tuple(p.tree_prepare(s) for p, s in zip(self.parts, self._subs(x)))

    def tree_combine(self, lo, hi):
        return tuple(
            p.tree_combine(sl, sh)
            for p, sl, sh in zip(self.parts, self._subs(lo), self._subs(hi))
        )

    def tree_finalize(self, x, n_ranks: int):
        return tuple(
            p.tree_finalize(s, n_ranks) for p, s in zip(self.parts, self._subs(x))
        )

    def wire_pack_flags(self, val) -> list[bool]:
        flags: list[bool] = []
        for p, s in zip(self.parts, self._subs(val)):
            flags.extend(p.wire_pack_flags(s))
        return flags


def stacked(*ops) -> StackedCombiner:
    """Build a :class:`StackedCombiner` from combiner names or instances."""
    return StackedCombiner(parts=tuple(get_combiner(op) for op in ops))


COMBINERS: dict[str, Callable[[], Combiner]] = {
    "sum": SumCombiner,
    "mean": MeanCombiner,
    "max": MaxCombiner,
    "gram_sum": GramSumCombiner,
    "qr_combine": QRCombiner,
    "qr": QRCombiner,
}


def get_combiner(op) -> Combiner:
    """Resolve a combiner name (or pass an instance through)."""
    if isinstance(op, Combiner):
        return op
    try:
        return COMBINERS[op]()
    except KeyError:
        raise ValueError(
            f"unknown combiner {op!r}; choose from {sorted(set(COMBINERS))}"
        ) from None
