"""Fault model for simulated fail-stop rank failures (Coti 2015, §II/III).

A copy of :mod:`repro.collective.faults` (numpy only), kept in the port so
that :mod:`repro_torch` imports nothing of the JAX package.

The paper's ULFM failure model: a process fails (fail-stop); peers detect the
failure when a communication with it returns an error.  Failures are modelled
as a *death vector* adjudicated at butterfly-step boundaries:

  ``death[r] = k``  means rank ``r`` fails at the ENTRY of butterfly exchange
  ``k`` (it completed exchanges ``0..k-1``, and is gone for exchange ``k``).
  ``k >= n_steps`` (canonically ``NEVER``) means the rank never fails during
  the collective.

The model is combiner-agnostic: the same death vector drives the QR
butterfly of :mod:`repro_torch.qr.tsqr` and every ``ft_allreduce`` combiner
in :mod:`repro_torch.collective.engine`.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Iterable, Mapping

import numpy as np

NEVER: int = 1 << 30

__all__ = [
    "NEVER",
    "FaultSpec",
    "sample_within_tolerance",
    "tolerance",
    "total_tolerance",
    "within_tolerance",
]


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """A set of simulated failures.

    ``deaths`` are fail-stop ``(rank, death_step)`` pairs — each rank dies at
    most once; ``death_step`` is the exchange index at whose *entry* the rank
    fails (0-based).  Two further fault kinds exist for schemes that can act
    on them (the coded-redundancy planner, :mod:`.coded`):

      * ``corrupt`` — ranks whose payload suffers silent data corruption
        (SDC): the rank participates normally and does not know it is wrong.
        The **butterfly planners ignore this field by design** — replication
        is oblivious to SDC, a corrupted replica propagates silently — which
        is exactly the blind spot checksum coding closes (Bosilca-style
        ABFT, arXiv:0806.3121): the coded plan quarantines the declared
        rank's contribution, reconstructs its true value from parity, and
        *verifies* the raw payload against the reconstruction.
      * ``slow`` — straggling ranks: alive, but their contribution would
        arrive late.  The butterfly has no choice but to await them (also
        ignored there); the coded plan excludes them from the gather and
        reconstructs their contribution from parity instead of waiting.

    The three rank sets must be pairwise disjoint (a dead rank has no
    payload to corrupt or delay).
    """

    deaths: tuple[tuple[int, int], ...] = ()
    corrupt: tuple[int, ...] = ()
    slow: tuple[int, ...] = ()

    def __post_init__(self) -> None:
        ranks = [r for r, _ in self.deaths]
        if len(ranks) != len(set(ranks)):
            raise ValueError(f"a rank may die at most once, got {self.deaths}")
        for r, s in self.deaths:
            if r < 0 or s < 0:
                raise ValueError(f"negative rank/step in {self.deaths}")
        for kind in ("corrupt", "slow"):
            rs = getattr(self, kind)
            if len(rs) != len(set(rs)):
                raise ValueError(f"duplicate ranks in {kind}={rs}")
            if any(r < 0 for r in rs):
                raise ValueError(f"negative rank in {kind}={rs}")
        dead = set(ranks)
        overlap = (dead & set(self.corrupt)) | (dead & set(self.slow)) | (
            set(self.corrupt) & set(self.slow)
        )
        if overlap:
            raise ValueError(
                f"ranks {sorted(overlap)} appear in more than one fault kind; "
                "deaths/corrupt/slow must be disjoint"
            )

    # -- constructors ------------------------------------------------------
    @classmethod
    def of(
        cls,
        deaths: Mapping[int, int] | Iterable[tuple[int, int]] = (),
        *,
        corrupt: Iterable[int] = (),
        slow: Iterable[int] = (),
    ) -> "FaultSpec":
        """From ``{rank: step}`` or ``[(rank, step), ...]`` deaths, plus
        optional ``corrupt`` / ``slow`` rank sets."""
        if isinstance(deaths, Mapping):
            items = tuple(sorted(deaths.items()))
        else:
            items = tuple(sorted(deaths))
        return cls(items, tuple(sorted(corrupt)), tuple(sorted(slow)))

    @classmethod
    def from_events(cls, events: Mapping[int, Iterable[int]]) -> "FaultSpec":
        """From ``{step: [ranks that die at entry of that step]}``."""
        deaths: dict[int, int] = {}
        for step, ranks in events.items():
            for r in ranks:
                if r in deaths:
                    raise ValueError(f"rank {r} dies twice")
                deaths[r] = step
        return cls.of(deaths)

    @classmethod
    def none(cls) -> "FaultSpec":
        return cls(())

    # -- views -------------------------------------------------------------
    def death_vector(self, n_ranks: int) -> np.ndarray:
        """``(P,) int64``; ``NEVER`` where the rank does not die."""
        vec = np.full((n_ranks,), NEVER, dtype=np.int64)
        for r, s in self.deaths:
            if r >= n_ranks:
                raise ValueError(f"rank {r} out of range for P={n_ranks}")
            vec[r] = s
        return vec

    def cumulative_by_entry(self, step: int) -> int:
        """Number of ranks dead at the entry of exchange ``step``."""
        return sum(1 for _, s in self.deaths if s <= step)

    def new_at(self, step: int) -> int:
        return sum(1 for _, s in self.deaths if s == step)

    @property
    def n_failures(self) -> int:
        return len(self.deaths)

    def __bool__(self) -> bool:  # truthy iff any fault of any kind
        return bool(self.deaths or self.corrupt or self.slow)


# ---------------------------------------------------------------------------
# Robustness accounting (paper §III-B3 / C3 / D3)
# ---------------------------------------------------------------------------

def tolerance(variant: str, step: int) -> int:
    """Failures tolerated *at the entry of exchange ``step``* (cumulative for
    redundant/replace; per-step for selfhealing).  Paper: ``2^s - 1`` where
    ``s`` counts *completed* exchanges, i.e. at entry of exchange ``step``
    there are ``2^step`` copies of every live intermediate.
    """
    if variant == "tree":
        return 0
    if variant in ("redundant", "replace", "selfhealing"):
        return (1 << step) - 1
    raise ValueError(f"unknown variant {variant!r}")


def total_tolerance(variant: str, n_steps: int) -> int:
    """Worst-case total failures tolerated over the whole collective."""
    if variant == "tree":
        return 0
    if variant in ("redundant", "replace"):
        # Cumulative bound is binding at every prefix; the total worst case
        # is the bound at the last step: 2^(S-1) - 1.
        return (1 << (n_steps - 1)) - 1 if n_steps > 0 else 0
    if variant == "selfhealing":
        # 2^s - 1 fresh failures tolerated at each step s (respawn resets).
        return sum((1 << s) - 1 for s in range(n_steps))
    raise ValueError(f"unknown variant {variant!r}")


def within_tolerance(variant: str, spec: FaultSpec, n_steps: int) -> bool:
    """Is ``spec`` within the *guaranteed-survival* bound for ``variant``?

    A reproduction finding (EXPERIMENTS.md §Paper-validation): the paper's
    ``2^s − 1`` claim is a *data-existence* argument (2^s copies exist at
    step s).  For **Replace**/**Self-Healing**, rerouting/respawn converts
    data existence into progress, so the paper's cumulative (resp.
    per-step) bound is exactly right.  For **Redundant** — no rerouting —
    invalidity *cascades*: a rank dead at entry of exchange k invalidates
    its whole dependency coset ``d ⊕ span{2^k, ..., 2^{S-1}}`` (a 2^{-k}
    fraction of all ranks).  The paper's bound holds when all failures
    strike at one step; across steps the tight sufficient condition is the
    union-bound measure  Σ_k n_k · 2^{-k} < 1  (n_k = failures at entry of
    exchange k), which reduces to 2^s − 1 in the single-step case.
    """
    if variant == "tree":
        return spec.n_failures == 0
    if variant == "redundant":
        measure = sum(2.0 ** (-s) for _, s in spec.deaths if s < n_steps)
        return measure < 1.0
    if variant == "replace":
        return all(
            spec.cumulative_by_entry(s) <= tolerance(variant, s)
            for s in range(n_steps)
        )
    if variant == "selfhealing":
        return all(spec.new_at(s) <= tolerance(variant, s) for s in range(n_steps))
    raise ValueError(f"unknown variant {variant!r}")


def sample_within_tolerance(
    variant: str, n_ranks: int, n_steps: int, rng: np.random.Generator
) -> FaultSpec:
    """One random single-rank fail-stop death guaranteed within ``variant``'s
    survival bound — the serving layer's mid-flight fault injector draws from
    this so every injected death is *recoverable* (a batch whose fault
    exceeded tolerance could not be re-served from replicas at all).

    For ``redundant`` the union-bound measure ``2^{-s} < 1`` forces the death
    to strike at exchange entry ``s ≥ 1`` (at entry of exchange 0 only one
    copy of each local factor exists); ``replace``/``selfhealing`` tolerate
    ``2^s − 1 ≥ 1`` deaths from step 1 as well.  ``tree`` tolerates nothing —
    asking for a tolerable death is a caller error.
    """
    if variant == "tree":
        raise ValueError(
            "variant 'tree' has zero fault tolerance; there is no "
            "within-tolerance death to sample"
        )
    if n_steps < 2:
        raise ValueError(
            f"n_steps={n_steps}: a single-exchange butterfly has no step "
            "with a replica to recover from (need P >= 4)"
        )
    rank = int(rng.integers(0, n_ranks))
    step = int(rng.integers(1, n_steps))
    spec = FaultSpec.of({rank: step})
    assert within_tolerance(variant, spec, n_steps)
    return spec
