"""Diskless (in-memory buddy) checkpointing — the paper's §II lineage.

The port of :mod:`repro.checkpoint.replicated`.  ``checkpoint(..., levels)``
replays the ``redundant`` plan's per-level ``(src, dst)`` exchange pairs
(:func:`repro_torch.collective.make_plan`: level ``s`` pairs rank ``r``
with ``r XOR 2^s``), so after ``s`` levels each shard exists ``2^s`` times
and the store tolerates ``2^s − 1`` simultaneous rank losses — the bound
of the factorization, from the same routing tables.

This host-side store simulates the per-rank memories; ``recover(rank)``
walks the replica set for the first live copy.  Shards are any objects
``copy.deepcopy`` takes (tensors stay on their device).
"""
from __future__ import annotations

import copy

import numpy as np

from repro_torch.collective import Plan, make_plan

__all__ = ["BuddyStore"]


class BuddyStore:
    def __init__(self, n_ranks: int):
        if n_ranks & (n_ranks - 1):
            raise ValueError("buddy store needs a power-of-two rank count")
        self.n_ranks = n_ranks
        # The fault-free redundant plan IS the replica-placement table:
        # steps[s].perm_rounds pairs r with its level-s XOR buddy.
        self.plan: Plan = make_plan("redundant", n_ranks)
        # holdings[r] = {owner_rank: (step, state)} — what r keeps in memory
        self.holdings: list[dict[int, tuple[int, object]]] = [{} for _ in range(n_ranks)]
        self.alive = np.ones(n_ranks, dtype=bool)

    # ------------------------------------------------------------------
    def checkpoint(self, step: int, shards: dict[int, object], levels: int = 1):
        """Each live rank stores its own shard, then pushes copies along the
        redundant plan's exchange routes for ``levels`` butterfly levels
        (2^levels copies total, capped at the plan depth)."""
        for r, shard in shards.items():
            if not self.alive[r]:
                continue
            self.holdings[r][r] = (step, copy.deepcopy(shard))
        for plan_step in self.plan.steps[:levels]:
            for rnd in plan_step.perm_rounds:
                for src, dst in rnd:
                    if not (self.alive[src] and self.alive[dst]):
                        continue
                    for owner, item in list(self.holdings[src].items()):
                        self.holdings[dst].setdefault(owner, item)

    def fail(self, rank: int):
        self.alive[rank] = False
        self.holdings[rank] = {}

    def respawn(self, rank: int):
        self.alive[rank] = True

    def replicas_of(self, rank: int) -> list[int]:
        return [r for r in range(self.n_ranks) if self.alive[r] and rank in self.holdings[r]]

    def recover(self, rank: int):
        """findReplica at the checkpoint layer: first live copy wins."""
        for r in self.replicas_of(rank):
            step, state = self.holdings[r][rank]
            return step, copy.deepcopy(state)
        raise KeyError(f"no live replica of rank {rank}'s shard")

    def copies(self, rank: int) -> int:
        return len(self.replicas_of(rank))
