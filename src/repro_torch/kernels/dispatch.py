"""Kernel launch counters, and the trace and dispatch accounting of the
cached programs.

**Launches.**  Each kernel wrapper adds one to its count where it launches
its Hopper kernel, and nowhere else (a CPU tensor takes the plain version
and counts nothing).  A captured CUDA graph launches its kernels when it is
replayed, not when it is captured: :mod:`repro_torch.replay` takes the
wrappers' counts made during a capture out again and adds them on every
replay.  A run shows that it went through the kernels by resetting the
counts, driving the path, and reading them::

    dispatch.launches.reset()
    factorize(blocks, QRConfig(local_r="cqr2_pallas"))
    assert dispatch.launches.gram == 1      # one launch for all P ranks

**Traces and dispatches** (the reference's :mod:`repro.kernels.dispatch`,
same names and semantics):

  * *traces* — how many times an entry point built its cached program for
    a new key (:mod:`repro_torch.replay`).  On the card that is a CUDA-graph
    capture; on the CPU the program is the same callable run eagerly, and
    building it still counts.  Process-lifetime, never reset: a repeat call
    with the same statics and shapes adds **zero**.
  * *dispatches* — how many programs a call runs: one replay of a cached
    program, or one kernel-op wrapper call of
    :mod:`repro_torch.kernels.ops`.  The blocked pipeline counts **1** a
    factorization whatever its panel count; the eager driver counts its
    kernel ops.

The reference counts the kernel-op dispatches made inside a jitted body only
while it traces; the port counts them while it builds the cached program
(the eager run before the capture) and suppresses them on every later call,
so cold and warm calls give the reference's counts.

**Kernel traces.**  The reference jit-compiles each kernel per signature and
notes a ``kernel:<op>`` trace for each one it traces.  The port's kernels
are built once a process, but :func:`note_kernel_trace` keeps the same
count: one trace the first time the process sees a kernel call's signature
(the shapes, dtypes and statics the reference's jit keys on, as
:mod:`repro_torch.kernels.ops` spells them), none after.  A signature seen
while a cached program is built is seen once however often the body runs,
so a pipeline counts its prime and its trailing sweep once, as the
reference's scan traces them once.  So the totals equal the reference's.

Usage::

    with track_dispatch() as d:
        factorize(a, QRConfig(panel_width=128))
    assert d.dispatches["blocked_qr_pipeline"] == 1

    before = trace_count("blocked_qr_pipeline")
    factorize(a, QRConfig(panel_width=128))          # same shapes again
    assert trace_count("blocked_qr_pipeline") == before   # zero new captures
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
from collections.abc import Hashable

__all__ = [
    "DispatchStats",
    "LaunchCounts",
    "launches",
    "note_dispatch",
    "note_kernel_trace",
    "note_overlap",
    "note_rounds",
    "note_trace",
    "suppress",
    "trace_count",
    "track_dispatch",
]


@dataclasses.dataclass
class LaunchCounts:
    """One plain integer per kernel wrapper."""

    gram: int = 0
    fused_apply_gram: int = 0
    apply_right: int = 0
    trailing_update: int = 0
    panel_cross: int = 0
    pad_cross: int = 0
    combine_gram: int = 0

    def reset(self) -> None:
        for field in dataclasses.fields(self):
            setattr(self, field.name, 0)

    def as_dict(self) -> dict[str, int]:
        return dataclasses.asdict(self)

    def add(self, counts: dict[str, int], sign: int = 1) -> None:
        """Add (``sign=-1``: take away) a dict of counts."""
        for name, n in counts.items():
            setattr(self, name, getattr(self, name) + sign * n)


launches = LaunchCounts()

# Process-lifetime trace counts by entry point (retrace guards compare
# deltas; never reset), and the kernel signatures traced so far.
_TRACES: collections.Counter = collections.Counter()
_KERNEL_SIGNATURES: set = set()


@dataclasses.dataclass
class DispatchStats:
    """Per-scope counters collected by :func:`track_dispatch`."""

    traces: collections.Counter = dataclasses.field(default_factory=collections.Counter)
    dispatches: collections.Counter = dataclasses.field(default_factory=collections.Counter)
    # serial butterfly rounds per entry point, and how many of its
    # reductions were overlapped with the previous panel's trailing sweep
    rounds: collections.Counter = dataclasses.field(default_factory=collections.Counter)
    overlapped: collections.Counter = dataclasses.field(default_factory=collections.Counter)

    @property
    def n_traces(self) -> int:
        return sum(self.traces.values())

    @property
    def n_dispatches(self) -> int:
        return sum(self.dispatches.values())

    @property
    def n_rounds(self) -> int:
        return sum(self.rounds.values())

    @property
    def n_overlapped(self) -> int:
        return sum(self.overlapped.values())

    def as_dict(self) -> dict:
        return {
            "traces": dict(self.traces),
            "dispatches": dict(self.dispatches),
            "rounds": dict(self.rounds),
            "overlapped": dict(self.overlapped),
        }


_ACTIVE: list[DispatchStats] = []
_SUPPRESS: list[bool] = []


def note_trace(name: str) -> None:
    """Record one build of the named entry point's cached program."""
    _TRACES[name] += 1
    for t in _ACTIVE:
        t.traces[name] += 1


def note_kernel_trace(op: str, signature: Hashable) -> int:
    """Record the reference's ``kernel:<op>`` trace for a kernel call whose
    signature this process has not seen yet; returns the traces noted."""
    if (op, signature) in _KERNEL_SIGNATURES:
        return 0
    _KERNEL_SIGNATURES.add((op, signature))
    note_trace("kernel:" + op)
    return 1


def _note(field: str, name: str, n: int) -> None:
    if not _ACTIVE or _SUPPRESS:
        return
    for t in _ACTIVE:
        getattr(t, field)[name] += n


def note_dispatch(name: str, n: int = 1) -> None:
    """Record ``n`` program runs of the named entry point (no-op when
    nothing is tracking or inside :func:`suppress`)."""
    _note("dispatches", name, n)


def note_rounds(name: str, n: int = 1) -> None:
    """Record ``n`` serial butterfly rounds of the named entry point, priced
    from the host plan (no-op when nothing is tracking or inside
    :func:`suppress`)."""
    _note("rounds", name, n)


def note_overlap(name: str, n: int = 1) -> None:
    """Record ``n`` reductions issued against lookahead accumulators while
    the previous panel's trailing sweep runs (no-op when nothing is
    tracking or inside :func:`suppress`)."""
    _note("overlapped", name, n)


def trace_count(name: str | None = None) -> int:
    """Process-lifetime trace count: the total, or one entry point's."""
    if name is None:
        return sum(_TRACES.values())
    return _TRACES[name]


@contextlib.contextmanager
def track_dispatch():
    """Yield a :class:`DispatchStats` that observes every entry point
    entered inside the block."""
    t = DispatchStats()
    _ACTIVE.append(t)
    try:
        yield t
    finally:
        _ACTIVE.remove(t)


@contextlib.contextmanager
def suppress():
    """Drop :func:`note_dispatch`, :func:`note_rounds` and
    :func:`note_overlap` inside the block.  :func:`note_trace` is not
    suppressed: trace counts are process-lifetime facts."""
    _SUPPRESS.append(True)
    try:
        yield
    finally:
        _SUPPRESS.pop()
