"""Step-by-step communication plans for the four butterfly/tree variants.

A copy of :mod:`repro.collective.plan` (numpy only): plans must equal the
reference's field by field, so the planners are carried over unchanged.

A :class:`Plan` is computed on the host from the rank count and a
:class:`~repro_torch.collective.faults.FaultSpec`.  It holds, per level:

  * ``perm_rounds``  — the ``(src, dst)`` pairs of each communication round,
    split so that every round has unique sources (one replica serving
    several starved ranks under Replace goes to later rounds).  Fault-free,
    every variant needs exactly one round per level.
  * ``restore_rounds`` — Self-Healing only: the replica→respawned-rank state
    transfers performed after the exchange of that level (paper Alg. 5).
  * ``valid_after``   — the host-side prediction of which ranks hold a
    correct partial value after the level completes.  The executor threads
    the same validity on the device; tests assert the two agree.

Plans are *combiner-agnostic*: the same routing drives the QR combine of
TSQR and every ``ft_allreduce`` combiner (sum/mean/max/gram_sum).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

from .faults import NEVER, FaultSpec

__all__ = [
    "Step",
    "Plan",
    "make_plan",
    "ilog2",
    "leaf_bytes",
    "payload_numel",
    "VARIANTS",
]

Pair = tuple[int, int]


def ilog2(p: int) -> int:
    s = p.bit_length() - 1
    if p <= 0 or (1 << s) != p:
        raise ValueError(
            f"butterfly collectives require a power-of-two rank count, got {p}"
        )
    return s


def payload_numel(n_cols: int, symmetric: bool = False) -> int:
    """Elements per exchanged (n, n) payload.

    ``symmetric=True`` accounts for packed storage of a symmetric matrix
    (Gram payloads): n(n+1)/2 instead of n² — what the engine actually
    ships for ``wire_symmetric`` combiners since the
    :mod:`repro_torch.collective.packing` codec.  (Triangular R factors admit the same packing;
    that saving is not modeled — ``qr_combine`` is priced square.)
    """
    if symmetric:
        return n_cols * (n_cols + 1) // 2
    return n_cols * n_cols


def leaf_bytes(
    rows: int, cols: int, itemsize: int = 4, symmetric: bool = False
) -> int:
    """Wire bytes of one payload leaf.  Rectangular leaves ship dense
    (rows × cols); symmetric leaves (which must be square) ship the
    n(n+1)/2 packed triangle the engine's per-leaf codec produces."""
    if symmetric:
        if rows != cols:
            raise ValueError(
                f"symmetric leaves must be square, got ({rows}, {cols})"
            )
        return payload_numel(cols, symmetric=True) * itemsize
    return rows * cols * itemsize


@dataclasses.dataclass(frozen=True, eq=False)
class Step:
    level: int
    perm_rounds: tuple[tuple[Pair, ...], ...]
    restore_rounds: tuple[tuple[Pair, ...], ...]
    # Host-side predictions (numpy bool, shape (P,)):
    valid_after: np.ndarray      # holds a correct partial value after this level
    respawned: np.ndarray        # ranks respawned at the end of this level

    # Steps hold numpy fields, so the dataclass-generated __eq__/__hash__
    # are unusable (ambiguous array truth / unhashable arrays).  A value
    # signature restores both, which lets plans key jit/LRU caches.
    @functools.cached_property
    def _sig(self) -> tuple:
        return (
            self.level,
            self.perm_rounds,
            self.restore_rounds,
            self.valid_after.tobytes(),
            self.respawned.tobytes(),
        )

    def __eq__(self, other) -> bool:
        return isinstance(other, Step) and self._sig == other._sig

    def __hash__(self) -> int:
        return hash(self._sig)

    @property
    def n_messages(self) -> int:
        return sum(len(r) for r in self.perm_rounds) + sum(
            len(r) for r in self.restore_rounds
        )

    @property
    def n_rounds(self) -> int:
        return len(self.perm_rounds) + len(self.restore_rounds)


@dataclasses.dataclass(frozen=True, eq=False)
class Plan:
    variant: str
    n_ranks: int
    n_steps: int
    death: np.ndarray            # (P,) effective death vector consumed
    steps: tuple[Step, ...]
    final_valid: np.ndarray      # (P,) who holds the final value

    # -- value identity (hashable-static: plans key jit/LRU caches) ---------
    @functools.cached_property
    def _sig(self) -> tuple:
        return (
            self.variant,
            self.n_ranks,
            self.n_steps,
            self.death.tobytes(),
            self.steps,
            self.final_valid.tobytes(),
        )

    def __eq__(self, other) -> bool:
        return isinstance(other, Plan) and self._sig == other._sig

    def __hash__(self) -> int:
        return hash(self._sig)

    @functools.cached_property
    def is_fault_free(self) -> bool:
        """Fast-path eligibility, computed once per plan (the panel loop
        fires several collectives per panel — re-walking every step on every
        call was pure host overhead): one perm-round per step, no restore
        rounds, no deaths during the collective, every rank valid throughout
        (excludes ``tree``, whose senders go invalid by design)."""
        if not bool(self.final_valid.all()):
            return False
        if self.n_steps and bool((self.death < self.n_steps).any()):
            return False
        for step in self.steps:
            if len(step.perm_rounds) != 1 or step.restore_rounds:
                return False
            if not bool(step.valid_after.all()):
                return False
        return True

    # -- communication accounting (benchmarks/comm_volume.py) --------------
    def message_count(self) -> int:
        return sum(s.n_messages for s in self.steps)

    def round_count(self) -> int:
        """Serial communication rounds — the latency proxy."""
        return sum(max(1, s.n_rounds) for s in self.steps)

    def bytes_on_wire(
        self, n_cols: int, itemsize: int = 4, *, symmetric: bool = False
    ) -> int:
        """Total payload bytes moved by the plan.

        ``symmetric=True`` prices the n(n+1)/2 packed encoding available to
        symmetric payloads (``gram_sum``); the default n² is what a square
        ship costs.  benchmarks/comm_volume.py reports both.
        """
        payload = payload_numel(n_cols, symmetric) * itemsize
        return self.message_count() * payload

    def bytes_on_wire_stacked(self, leaves) -> int:
        """Exact wire bytes for a stacked / multi-leaf payload.

        ``leaves`` is a sequence of per-leaf specs ``(rows, cols, itemsize,
        symmetric)``; each message carries every leaf, with symmetric leaves
        priced packed and rectangular leaves dense — what the engine's
        per-leaf codec actually ships for a
        :class:`~repro_torch.collective.combiners.StackedCombiner` payload.
        The single-leaf square case reduces to :meth:`bytes_on_wire`.
        """
        per_message = sum(leaf_bytes(*spec) for spec in leaves)
        return self.message_count() * per_message


# ---------------------------------------------------------------------------
# Round decomposition: unique sources per round (no multicast).
# ---------------------------------------------------------------------------

def _split_rounds(pairs: list[Pair]) -> tuple[tuple[Pair, ...], ...]:
    """Split (src, dst) pairs into rounds with unique sources.

    Destinations are unique by construction (each rank receives once per
    level).  Sources repeat only when a replica serves several starved
    ranks; those go to later rounds.
    """
    if not pairs:
        return ()
    rounds: list[list[Pair]] = []
    used: list[set[int]] = []
    for src, dst in pairs:
        for i, srcs in enumerate(used):
            if src not in srcs:
                rounds[i].append((src, dst))
                srcs.add(src)
                break
        else:
            rounds.append([(src, dst)])
            used.append({src})
    return tuple(tuple(r) for r in rounds)


# ---------------------------------------------------------------------------
# Variant planners.  Each walks the algorithm in numpy, producing both the
# routing and the validity prediction (the robustness oracle).
# ---------------------------------------------------------------------------

def _plan_tree(p: int, death: np.ndarray) -> tuple[list[Step], np.ndarray]:
    """Paper Alg. 1 — the baseline reduction tree.  Zero redundancy."""
    n_steps = ilog2(p)
    valid = death > 0
    steps: list[Step] = []
    for s in range(n_steps):
        alive = death > s
        ok = valid & alive
        pairs: list[Pair] = []
        new_valid = np.zeros(p, dtype=bool)
        for r in range(0, p, 2 << s):
            snd, rcv = r + (1 << s), r
            pairs.append((snd, rcv))          # pattern is fault-oblivious
            new_valid[rcv] = ok[rcv] & ok[snd]
        steps.append(
            Step(s, _split_rounds(pairs), (), new_valid, np.zeros(p, bool))
        )
        valid = new_valid
    return steps, valid


def _plan_redundant(p: int, death: np.ndarray) -> tuple[list[Step], np.ndarray]:
    """Paper Alg. 2 — butterfly exchange; dependents of dead ranks go invalid."""
    n_steps = ilog2(p)
    ranks = np.arange(p)
    valid = death > 0
    steps: list[Step] = []
    for s in range(n_steps):
        buddy = ranks ^ (1 << s)
        pairs = [(int(r), int(r ^ (1 << s))) for r in range(p)]
        ok = valid & (death > s)
        new_valid = ok & ok[buddy]
        steps.append(
            Step(s, _split_rounds(pairs), (), new_valid, np.zeros(p, bool))
        )
        valid = new_valid
    return steps, valid


def _route_level(
    p: int, s: int, ok: np.ndarray
) -> tuple[list[Pair], np.ndarray]:
    """Fault-aware routing for one butterfly level (Replace, Alg. 3).

    Every live+valid rank ``r`` needs the partial value of its buddy *block*
    ``(r >> s) ^ 1``; any live+valid member of that block is a replica
    (``findReplica``).  Natural buddies pair up when both are healthy —
    in the fault-free case this reproduces the plain butterfly exactly.
    Replicas are load-balanced round-robin so the number of serial rounds
    is ``ceil(starved / live_replicas)`` per block.
    """
    pairs: list[Pair] = []
    received = np.zeros(p, dtype=bool)
    width = 1 << s
    # Group requesters by source block.
    for block_lo in range(0, p, width):
        block = block_lo >> s
        req_lo = (block ^ 1) << s
        requesters = [r for r in range(req_lo, req_lo + width) if ok[r]]
        donors = [m for m in range(block_lo, block_lo + width) if ok[m]]
        if not requesters:
            continue
        if not donors:
            continue  # starved: no copy of this block's value exists
        donor_set = set(donors)
        # Natural pairs first: r's XOR-buddy serves r when healthy.
        rest: list[int] = []
        for r in requesters:
            nat = r ^ width
            if nat in donor_set:
                pairs.append((nat, r))
                received[r] = True
            else:
                rest.append(r)
        for i, r in enumerate(rest):
            src = donors[i % len(donors)]
            pairs.append((src, r))
            received[r] = True
    return pairs, received


def _plan_replace(p: int, death: np.ndarray) -> tuple[list[Step], np.ndarray]:
    """Paper Alg. 3 — reroute to a replica of the dead buddy."""
    n_steps = ilog2(p)
    valid = death > 0
    steps: list[Step] = []
    for s in range(n_steps):
        ok = valid & (death > s)
        pairs, received = _route_level(p, s, ok)
        new_valid = ok & received
        steps.append(
            Step(s, _split_rounds(pairs), (), new_valid, np.zeros(p, bool))
        )
        valid = new_valid
    return steps, valid


def _plan_selfhealing(p: int, death: np.ndarray) -> tuple[list[Step], np.ndarray]:
    """Paper Alg. 4–6 — reroute like Replace, then respawn dead ranks from a
    replica at the end of each level (``spawnNew`` + Alg. 5 restart)."""
    n_steps = ilog2(p)
    eff_death = death.copy()          # respawn resets a rank's death to NEVER
    valid = eff_death > 0
    steps: list[Step] = []
    for s in range(n_steps):
        ok = valid & (eff_death > s)
        pairs, received = _route_level(p, s, ok)
        new_valid = ok & received
        # --- respawn: every currently-dead rank gets a fresh process whose
        # state is restored from a live replica inside its 2^(s+1) block,
        # which holds exactly the post-level-s partial value the dead rank
        # needs.
        respawned = np.zeros(p, dtype=bool)
        restore: list[Pair] = []
        width2 = 2 << s
        for blk_lo in range(0, p, width2):
            dead = [
                r for r in range(blk_lo, blk_lo + width2) if eff_death[r] <= s
            ]
            donors = [
                m for m in range(blk_lo, blk_lo + width2) if new_valid[m]
            ]
            if not dead or not donors:
                continue
            for i, r in enumerate(dead):
                restore.append((donors[i % len(donors)], r))
                respawned[r] = True
        eff_death = eff_death.copy()
        eff_death[respawned] = NEVER
        new_valid = new_valid | respawned
        steps.append(
            Step(s, _split_rounds(pairs), _split_rounds(restore), new_valid, respawned)
        )
        valid = new_valid
    return steps, valid


_PLANNERS = {
    "tree": _plan_tree,
    "redundant": _plan_redundant,
    "replace": _plan_replace,
    "selfhealing": _plan_selfhealing,
}

VARIANTS = tuple(_PLANNERS)


@functools.lru_cache(maxsize=512)
def _make_plan_cached(variant: str, n_ranks: int, spec: FaultSpec) -> Plan:
    death = spec.death_vector(n_ranks)
    n_steps = ilog2(n_ranks)
    steps, final_valid = _PLANNERS[variant](n_ranks, death)
    # Ranks that die after the last exchange but "during" the algorithm do
    # not exist in this model: death values >= n_steps mean "never".
    return Plan(
        variant=variant,
        n_ranks=n_ranks,
        n_steps=n_steps,
        death=death,
        steps=tuple(steps),
        final_valid=final_valid,
    )


def make_plan(
    variant: str,
    n_ranks: int,
    fault_spec: FaultSpec | None = None,
) -> Plan:
    """Host-plan the collective.  Memoized on ``(variant, n_ranks, spec)``:
    the panel loop requests the same fault-free plan for every collective of
    every panel, and callers key jit caches on the (shared, hashable) plan
    object."""
    if variant not in _PLANNERS:
        raise ValueError(f"unknown variant {variant!r}; choose from {VARIANTS}")
    return _make_plan_cached(variant, n_ranks, fault_spec or FaultSpec.none())
