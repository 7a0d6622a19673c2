"""Cached programs: the port's counterpart of the reference's jitted entry
points.

An entry point (the fixed-shape blocked pipeline, the batched TSQR,
``ft_allreduce_jit``, ...) hands :func:`run` its name, a hashable key of its
statics, a body and the body's tensor inputs.  The first call for a key
(and input shapes, dtypes and device) *builds* the key's program, which
counts one trace (:func:`repro_torch.kernels.dispatch.note_trace`); every
later call *runs* it:

  * **On the card** the program is a ``torch.cuda.CUDAGraph``.  The first
    call runs the body eagerly on a side stream (this run fills the
    per-device caches of index and weight vectors and the libraries'
    workspaces, so nothing in the captured body copies from the host) and
    returns that run's result; then it captures the body on the same
    stream from static input buffers into the graph's private memory pool.
    A later call copies its inputs into the static buffers, replays the
    graph on the current stream and returns clones of the static outputs.
    A capture that fails raises: nothing falls back to the eager route.
  * **On the CPU**, on the card inside :func:`eager`, or where the entry
    point passes ``capture=False``, the program is the body itself, run
    eagerly on every call.  The mesh routes pass it: their bodies exchange
    through :mod:`torch.distributed`, and a host-staged gloo exchange cannot
    be captured in a CUDA graph.

Both routes note the body's kernel-op dispatches and traffic only on the
call that builds the program (the reference notes them while it traces),
and the captured graph's kernel launches count on every replay, not at the
capture (:data:`repro_torch.kernels.dispatch.launches`).

Each entry point caches its programs as the reference's cached compile
function does: a least-recently-used map keyed on the entry's statics,
holding at most that function's ``lru_cache`` size (:data:`BOUNDS`), and under each
statics key one program per input signature with no bound, as jit's own
per-shape cache.  A trace counts exactly when the reference would count
one: a new statics key, a new signature under a live key, or a key the
count bound evicted (:func:`stats` counts those ``evictions``).

A graph keeps every intermediate of its body in its pool, several GiB for a
blocked factorization at 2^20 rows, so the graphs together may hold at most
:data:`CACHE_FRACTION` of the card's memory: past it the least recently
replayed graph is dropped with its pool (``drops``).  A dropped graph's
signature stays traced while its key lives, so its next call captures it
again and counts a ``recapture``, not a trace.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
from collections.abc import Callable, Hashable

import torch

from repro_torch.collective._tree import leaves, tree_map
from repro_torch.kernels import dispatch, traffic

__all__ = ["BOUNDS", "CACHE_FRACTION", "cache_bytes", "clear", "eager", "run", "stats"]

CACHE_FRACTION = 0.25   # of the card's memory that captured graphs may hold

# Statics keys each entry point caches: the maxsize of the lru_cache of the
# reference's compile function for it.
BOUNDS = {
    "blocked_qr_pipeline": 64,   # repro/qr/blocked.py::_compiled_sim_pipeline
    "tsqr_batched": 64,          # repro/qr/tsqr.py::_compiled_tsqr_batched
    "tsqr_coded": 64,            # repro/qr/tsqr.py::_compiled_tsqr_coded
    "ft_allreduce": 256,         # repro/collective/engine.py::_ft_allreduce_compiled
    "coded_allreduce": 256,      # repro/collective/coded.py::_coded_allreduce_compiled
    # the per-rank programs of the mesh routes, never captured
    "ft_allreduce_shard": 256,   # repro/collective/engine.py::_ft_allreduce_shard_compiled
    "tsqr_shard_map": 64,        # repro/qr/tsqr.py::_compiled_tsqr_shard
    "tsqr_gram_shard_map": 64,   # repro/qr/tsqr.py::_compiled_tsqr_gram_shard
    "shard_pipeline": 64,        # repro/qr/blocked.py::_compiled_shard_pipeline
    "blocked_qr_shard_map": 64,  # repro/qr/blocked.py::_compiled_shard_general
}


@dataclasses.dataclass
class _Graph:
    graph: torch.cuda.CUDAGraph
    static_in: tuple
    static_out: object
    launched: dict      # kernel launches a replay makes
    nbytes: int


@dataclasses.dataclass
class _Entry:
    """One statics key: the signatures built under it, and their graphs."""

    built: set = dataclasses.field(default_factory=set)
    graphs: dict = dataclasses.field(default_factory=dict)
    dropped: set = dataclasses.field(default_factory=set)


_CACHES: dict[str, collections.OrderedDict] = {
    name: collections.OrderedDict() for name in BOUNDS}
_GRAPHS: collections.OrderedDict = collections.OrderedDict()   # (name, key, sig), LRU first
_STATS: collections.Counter = collections.Counter()
_EAGER: list[bool] = []
_SIDE: dict[torch.device, torch.cuda.Stream] = {}


@contextlib.contextmanager
def eager():
    """Run every cached program eagerly inside the block, on the card too
    (a signature built here counts its trace once, as a captured one)."""
    _EAGER.append(True)
    try:
        yield
    finally:
        _EAGER.pop()


def cache_bytes() -> int:
    """Device bytes the cached graphs hold: their pools and static inputs."""
    return sum(g.nbytes for g in _GRAPHS.values())


def stats() -> dict[str, int]:
    """Process-lifetime counts: ``evictions`` (statics keys past an entry
    point's bound), ``drops`` (graphs dropped past the memory bound) and
    ``recaptures`` (dropped graphs captured again)."""
    return {k: _STATS[k] for k in ("evictions", "drops", "recaptures")}


def clear(name: str | None = None) -> None:
    """Drop every cached program (and its graph and pool), or only entry
    point ``name``'s (the reference's ``cache_clear()`` of its compile
    function): its next call for any key traces again."""
    for entry_name in ([name] if name is not None else list(_CACHES)):
        _CACHES[entry_name].clear()
    for gkey in [k for k in _GRAPHS if name is None or k[0] == name]:
        del _GRAPHS[gkey]
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


@contextlib.contextmanager
def _quiet():
    """Drop the body's dispatch and traffic notes: the reference notes them
    only while it traces."""
    with dispatch.suppress(), traffic.suppress():
        yield


def _signature(inputs) -> tuple:
    return tuple(None if t is None else (tuple(t.shape), t.dtype, t.device) for t in inputs)


def _entry(name: str, key: Hashable) -> _Entry:
    """The statics key's entry, most recently used; a new key evicts the
    least recently used past the entry point's bound."""
    cache = _CACHES[name]
    entry = cache.get(key)
    if entry is not None:
        cache.move_to_end(key)
        return entry
    entry = cache[key] = _Entry()
    freed = False
    while len(cache) > BOUNDS[name]:
        old_key, old = cache.popitem(last=False)
        _STATS["evictions"] += 1
        for sig in old.graphs:
            del _GRAPHS[(name, old_key, sig)]
        freed |= bool(old.graphs)
    if freed:
        torch.cuda.empty_cache()
    return entry


def run(name: str, key: Hashable, body: Callable, inputs: tuple, layout: Hashable = None, *,
        trace: str | None = None, capture: bool = True):
    """``body(*inputs)`` as the cached program of entry point ``name``,
    statics ``key``, and the inputs' ``layout`` (a payload's structure),
    shapes, dtypes and device.  ``inputs`` are tensors (or None); the result
    is a tree (tuples, lists) of tensors and None.  A build counts one
    ``trace`` (default ``name``); ``capture=False`` runs the body eagerly on
    the card too."""
    device = next(t.device for t in inputs if t is not None)
    captured = capture and device.type == "cuda" and not _EAGER
    entry = _entry(name, key)
    sig = (layout, _signature(inputs))
    if captured and sig in entry.graphs:
        _GRAPHS.move_to_end((name, key, sig))
        prog = entry.graphs[sig]
        for static, t in zip(prog.static_in, inputs):
            if t is not None:
                static.copy_(t)
        prog.graph.replay()
        dispatch.launches.add(prog.launched)
        return tree_map(lambda t: None if t is None else t.clone(), prog.static_out)
    traced = sig not in entry.built
    if traced:
        entry.built.add(sig)
        dispatch.note_trace(trace or name)
    if not captured:
        if traced:
            return body(*inputs)
        with _quiet():
            return body(*inputs)
    if sig in entry.dropped:
        entry.dropped.discard(sig)
        _STATS["recaptures"] += 1
    out, prog = _capture(body, inputs, device, quiet=not traced)
    entry.graphs[sig] = _GRAPHS[(name, key, sig)] = prog
    _bound_memory(device)
    return out


def _capture(body: Callable, inputs: tuple, device: torch.device, quiet: bool):
    """Warm up on a side stream (the call's result; its notes dropped when
    ``quiet``: the reference traces nothing then), then capture there."""
    side = _SIDE.get(device)
    if side is None:
        side = _SIDE[device] = torch.cuda.Stream(device)
    main = torch.cuda.current_stream(device)
    static_in = tuple(None if t is None else t.clone(memory_format=torch.contiguous_format)
                      for t in inputs)
    side.wait_stream(main)
    with torch.cuda.stream(side), (_quiet() if quiet else contextlib.nullcontext()):
        out = body(*static_in)
    main.wait_stream(side)
    for t in leaves(out):
        if t is not None:
            t.record_stream(main)   # the caller frees it on the main stream
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()        # the pool's segments are then all that grows
    reserved = torch.cuda.memory_reserved(device)
    graph = torch.cuda.CUDAGraph()
    before = dispatch.launches.as_dict()
    try:
        with _quiet(), torch.cuda.graph(graph, stream=side):
            static_out = body(*static_in)
    finally:
        after = dispatch.launches.as_dict()
        launched = {k: v - before[k] for k, v in after.items() if v != before[k]}
        dispatch.launches.add(launched, -1)   # a capture launches nothing
    nbytes = max(torch.cuda.memory_reserved(device) - reserved, 0) + sum(
        t.numel() * t.element_size() for t in static_in if t is not None)
    return out, _Graph(graph, static_in, static_out, launched, nbytes)


def _bound_memory(device: torch.device) -> None:
    """Drop the least recently replayed graphs past the memory bound (never
    the one just captured)."""
    limit = CACHE_FRACTION * torch.cuda.get_device_properties(device).total_memory
    dropped = False
    while len(_GRAPHS) > 1 and cache_bytes() > limit:
        (name, key, sig), _ = _GRAPHS.popitem(last=False)
        entry = _CACHES[name][key]
        del entry.graphs[sig]
        entry.dropped.add(sig)
        _STATS["drops"] += 1
        dropped = True
    if dropped:
        torch.cuda.empty_cache()
