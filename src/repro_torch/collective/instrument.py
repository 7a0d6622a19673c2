"""Per-round communication counters for the collective engine.

:class:`InstrumentedComm` wraps any :class:`~repro_torch.collective.comm.Comm`
backend and records, for every ``exchange`` the engine issues, the number of
point-to-point messages and the payload bytes they carry.  The routing is
host-planned, so the counters equal the plan's own accounting
(:meth:`~repro_torch.collective.plan.Plan.message_count` /
:meth:`~repro_torch.collective.plan.Plan.bytes_on_wire`) and the reference's.

Accounting note: the *general* executor exchanges ``(payload, validity)``
pairs, so observed bytes include one validity byte (bool) per message on
top of the payload.  The fault-free fast path ships the payload alone.
Symmetric combiners (``gram_sum``) pack to the n(n+1)/2 triangle on either
path.  A coded reduction ships no validity byte: each of its phases is its
own exchange, and the gather's reconstruction lanes ride beside the result,
so the counters equal :meth:`~repro_torch.collective.coded.CodedPlan.
message_count` and :meth:`~repro_torch.collective.coded.CodedPlan.
bytes_on_wire` (``_stacked``) exactly.

Over :class:`~repro_torch.collective.comm.DistComm` every rank wraps its own
comm and counts the whole perm round (all its messages, each priced by
``leaf_nbytes`` of the local block), so each rank's counters equal the
reference's for the same call under ``ShardMapComm``.
"""
from __future__ import annotations

import dataclasses

from ._tree import leaves
from .comm import Comm

__all__ = ["CommStats", "InstrumentedComm"]


@dataclasses.dataclass
class CommStats:
    """Cumulative + per-round exchange counters."""

    per_round: list[dict] = dataclasses.field(default_factory=list)

    @property
    def rounds(self) -> int:
        return len(self.per_round)

    @property
    def messages(self) -> int:
        return sum(r["messages"] for r in self.per_round)

    @property
    def payload_bytes(self) -> int:
        return sum(r["payload_bytes"] for r in self.per_round)

    def record(self, messages: int, payload_bytes: int) -> None:
        self.per_round.append(
            {"messages": messages, "payload_bytes": payload_bytes}
        )

    def reset(self) -> None:
        self.per_round.clear()

    def as_dict(self) -> dict:
        return {
            "rounds": self.rounds,
            "messages": self.messages,
            "payload_bytes": self.payload_bytes,
        }


@dataclasses.dataclass(frozen=True)
class InstrumentedComm(Comm):
    """Counting proxy around a concrete comm backend.

    ``stats`` accumulates across calls; use :meth:`CommStats.reset` (or a
    fresh wrapper) between measurements.
    """

    inner: Comm
    stats: CommStats = dataclasses.field(default_factory=CommStats)

    @property
    def n_ranks(self) -> int:  # type: ignore[override]
        return self.inner.n_ranks

    @property
    def device(self):  # type: ignore[override]
        return self.inner.device

    def ranks(self):
        return self.inner.ranks()

    def take(self, host_vec):
        return self.inner.take(host_vec)

    def bwhere(self, cond, a, b):
        return self.inner.bwhere(cond, a, b)

    def leaf_nbytes(self, leaf) -> int:
        return self.inner.leaf_nbytes(leaf)

    def exchange(self, x, perm):
        per_msg = sum(self.inner.leaf_nbytes(leaf) for leaf in leaves(x))
        self.stats.record(len(perm), len(perm) * per_msg)
        return self.inner.exchange(x, perm)
