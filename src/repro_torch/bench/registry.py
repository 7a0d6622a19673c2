"""Decorator-based benchmark case registry (the port of
:mod:`repro.bench.registry`).

A *case* is a function returning ``{metric_name: Metric | number}``; the
:func:`bench_case` decorator attaches its tiers, tags, per-tier parameters
and timing policy and records it in :data:`REGISTRY`.  The runner
(:mod:`repro_torch.bench.runner`) resolves the tier's kwargs, times the call
(warmup + repeats, percentile summary → ``time_*`` warn-gated metrics) and
assembles the schema document.

Cases signal environmental impossibility (missing artifacts, too few
devices) by raising :class:`SkipCase`, and a *measured property violation*
— e.g. the paper's within-tolerance survival guarantee failing — by
raising :class:`BenchFailure`, which fails the whole run loudly (non-zero
exit) rather than burying the violation in a metric nobody reads.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Callable, Mapping

__all__ = [
    "BenchCase",
    "BenchFailure",
    "REGISTRY",
    "SkipCase",
    "TIERS",
    "bench_case",
    "cases_for",
]

TIERS = ("smoke", "full")


class SkipCase(Exception):
    """Raised by a case that cannot run in this environment."""


class BenchFailure(Exception):
    """Raised by a case whose measured invariant is violated (loud failure)."""


@dataclasses.dataclass(frozen=True)
class BenchCase:
    name: str
    fn: Callable[..., Mapping]
    tiers: tuple[str, ...]
    tags: tuple[str, ...]
    params: Mapping[str, Mapping]    # tier -> kwargs for fn
    warmup: int
    repeats: int

    def kwargs(self, tier: str) -> dict:
        return dict(self.params.get(tier, {}))


REGISTRY: dict[str, BenchCase] = {}


def bench_case(
    name: str,
    *,
    tiers: tuple[str, ...] = TIERS,
    tags: tuple[str, ...] = (),
    params: Mapping[str, Mapping] | None = None,
    warmup: int = 0,
    repeats: int = 1,
    registry: dict[str, BenchCase] | None = None,
):
    """Register a benchmark case.

    ``params`` maps tier name → kwargs the runner passes to the case
    function for that tier (missing tier → no kwargs).  ``warmup`` calls
    are discarded; ``repeats`` timed calls feed the percentile summary.
    ``registry`` overrides the global table (tests use private ones).
    """
    bad = set(tiers) - set(TIERS)
    if bad:
        raise ValueError(f"unknown tiers {sorted(bad)}; choose from {TIERS}")

    def deco(fn):
        table = REGISTRY if registry is None else registry
        if name in table:
            raise ValueError(f"duplicate bench case {name!r}")
        table[name] = BenchCase(
            name=name,
            fn=fn,
            tiers=tuple(tiers),
            tags=tuple(tags),
            params=dict(params or {}),
            warmup=warmup,
            repeats=max(1, repeats),
        )
        return fn

    return deco


def cases_for(
    tier: str,
    *,
    only: tuple[str, ...] | None = None,
    registry: dict[str, BenchCase] | None = None,
) -> list[BenchCase]:
    table = REGISTRY if registry is None else registry
    if only:
        missing = set(only) - set(table)
        if missing:
            raise KeyError(
                f"unknown bench case(s) {sorted(missing)}; "
                f"known: {sorted(table)}"
            )
    out = [
        c for c in table.values()
        if tier in c.tiers and (not only or c.name in only)
    ]
    return sorted(out, key=lambda c: c.name)
