"""Device-memory and collective traffic records of the kernel pipelines.

Every wrapper in :mod:`repro_torch.kernels.ops` notes, as it is called, the
bytes it streams from and to device memory and whether the call is a
*sweep* over a tall operand (the (m, n) panel stream; the n×n Cholesky and
inverse work is not).  The records for a call equal the reference's
(:mod:`repro.kernels.traffic`) for the same shapes: CholeskyQR2's R factor
takes **2** tall sweeps (``cholesky_qr2_r``), the explicit Q **3**
(``cholesky_qr2``) and the unfused pipeline 4.  The blocked QR adds its
``panel_cross``/``pad_cross``/``trailing_update`` sweeps and one
``panel_reduce`` record per butterfly (``reorth_reduce`` for Q's polish)
with serial rounds and plan-priced wire bytes.

Usage::

    with track_traffic() as t:
        ops.cholesky_qr2_r(a, use_pallas=True)
    assert t.tall_sweeps == 2

Each record also carries its dispatches and the new programs the call
built (``traces``, :mod:`repro_torch.kernels.dispatch`): a kernel-op
wrapper records one dispatch and the ``kernel:<op>`` trace of a signature
new to the process, the blocked pipeline one dispatch for the whole
factorization and a trace on the call that built its program.
"""
from __future__ import annotations

import contextlib
import dataclasses

__all__ = ["KernelTraffic", "note", "suppress", "track_traffic"]


@dataclasses.dataclass
class KernelTraffic:
    """Accumulated per-op device-memory traffic records."""

    records: list[dict] = dataclasses.field(default_factory=list)

    @property
    def tall_sweeps(self) -> int:
        """Number of sweeps over a tall (panel-streamed) operand."""
        return sum(r["sweeps"] for r in self.records)

    def sweeps_of(self, *ops: str) -> int:
        """Tall sweeps of the named ops only (the blocked QR's trailing-block
        accounting counts ``panel_cross``/``pad_cross`` + ``trailing_update``)."""
        return sum(r["sweeps"] for r in self.records if r["op"] in ops)

    def rounds_of(self, *ops: str) -> int:
        """Serial butterfly rounds of the named ops (``panel_reduce``,
        ``reorth_reduce``: one record per butterfly, priced from its plan)."""
        return sum(r["rounds"] for r in self.records if r["op"] in ops)

    def wire_bytes_of(self, *ops: str) -> int:
        """Plan-priced collective payload bytes of the named ops."""
        return sum(r["wire_bytes"] for r in self.records if r["op"] in ops)

    @property
    def read_bytes(self) -> int:
        return sum(r["read_bytes"] for r in self.records)

    @property
    def write_bytes(self) -> int:
        return sum(r["write_bytes"] for r in self.records)

    @property
    def total_bytes(self) -> int:
        return self.read_bytes + self.write_bytes

    @property
    def dispatches(self) -> int:
        """Programs run by the recorded calls (one a kernel-op wrapper, one
        for a whole pipelined factorization)."""
        return sum(r["dispatches"] for r in self.records)

    @property
    def traces(self) -> int:
        """New programs the recorded calls built (0 on warm calls)."""
        return sum(r["traces"] for r in self.records)

    @property
    def collective_rounds(self) -> int:
        """Serial butterfly rounds of the recorded collectives."""
        return sum(r["rounds"] for r in self.records)

    @property
    def wire_bytes(self) -> int:
        """Plan-priced collective payload bytes of the recorded reductions."""
        return sum(r["wire_bytes"] for r in self.records)

    @property
    def overlapped(self) -> int:
        """Reductions issued during the previous panel's trailing sweep."""
        return sum(r["overlapped"] for r in self.records)

    def as_dict(self) -> dict:
        return {
            "tall_sweeps": self.tall_sweeps,
            "read_bytes": self.read_bytes,
            "write_bytes": self.write_bytes,
            "dispatches": self.dispatches,
            "traces": self.traces,
            "collective_rounds": self.collective_rounds,
            "wire_bytes": self.wire_bytes,
            "overlapped": self.overlapped,
            "ops": [r["op"] for r in self.records],
        }


_ACTIVE: list[KernelTraffic] = []
_SUPPRESS: list[bool] = []


def note(op: str, *, sweeps: int = 0, read_bytes: int = 0,
         write_bytes: int = 0, dispatches: int = 1, traces: int = 0,
         rounds: int = 0, wire_bytes: int = 0, overlapped: int = 0) -> None:
    """Record one kernel-wrapper call into every active tracker (no-op when
    nothing is tracking).  The record has the reference's keys."""
    if not _ACTIVE or _SUPPRESS:
        return
    rec = {
        "op": op,
        "sweeps": int(sweeps),
        "read_bytes": int(read_bytes),
        "write_bytes": int(write_bytes),
        "dispatches": int(dispatches),
        "traces": int(traces),
        "rounds": int(rounds),
        "wire_bytes": int(wire_bytes),
        "overlapped": int(overlapped),
    }
    for t in _ACTIVE:
        t.records.append(rec)


@contextlib.contextmanager
def track_traffic():
    """Context manager yielding a :class:`KernelTraffic` that observes every
    ``ops``-level kernel call made inside the block."""
    t = KernelTraffic()
    _ACTIVE.append(t)
    try:
        yield t
    finally:
        _ACTIVE.remove(t)


@contextlib.contextmanager
def suppress():
    """Drop :func:`note` calls inside the block.  The fixed-shape blocked-QR
    pipeline runs under it and notes its exact per-call totals itself, as
    the reference's compiled pipeline does."""
    _SUPPRESS.append(True)
    try:
        yield
    finally:
        _SUPPRESS.pop()
