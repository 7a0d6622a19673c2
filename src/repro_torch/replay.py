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
  * **On the CPU**, or on the card inside :func:`eager`, the program is the
    body itself, run eagerly on every call.

Both routes note the body's kernel-op dispatches and traffic only on the
call that builds the program (the reference notes them while it traces),
and the captured graph's kernel launches count on every replay, not at the
capture (:data:`repro_torch.kernels.dispatch.launches`).

A graph keeps every intermediate of its body in its pool, several GiB for a
blocked factorization at 2^20 rows, so the cache is bounded by the bytes it
holds (:data:`CACHE_FRACTION` of the card's memory, and at most
:data:`MAX_PROGRAMS` programs): the least recently used program is evicted
with its pool.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
from collections.abc import Callable, Hashable

import torch

from repro_torch.collective._tree import leaves, tree_map
from repro_torch.kernels import dispatch, traffic

__all__ = ["CACHE_FRACTION", "MAX_PROGRAMS", "cache_bytes", "clear", "eager", "run"]

CACHE_FRACTION = 0.25   # of the card's memory that captured graphs may hold
MAX_PROGRAMS = 64       # programs cached at once (the reference's lru_cache size)


@dataclasses.dataclass
class _Program:
    graph: torch.cuda.CUDAGraph | None = None
    static_in: tuple = ()
    static_out: object = None
    launched: dict = dataclasses.field(default_factory=dict)  # kernel launches a replay makes
    nbytes: int = 0


_CACHE: collections.OrderedDict = collections.OrderedDict()
_EAGER: list[bool] = []
_SIDE: dict[torch.device, torch.cuda.Stream] = {}


@contextlib.contextmanager
def eager():
    """Run every cached program eagerly inside the block, on the card too
    (programs built here are cached apart from the captured ones)."""
    _EAGER.append(True)
    try:
        yield
    finally:
        _EAGER.pop()


def cache_bytes() -> int:
    """Device bytes the cached graphs hold: their pools and static inputs."""
    return sum(p.nbytes for p in _CACHE.values())


def clear() -> None:
    """Drop every cached program (and its graph and pool)."""
    _CACHE.clear()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _signature(inputs) -> tuple:
    return tuple(None if t is None else (tuple(t.shape), t.dtype, t.device) for t in inputs)


def run(name: str, key: Hashable, body: Callable, inputs: tuple):
    """``body(*inputs)`` as the cached program of ``(name, key)`` and the
    inputs' shapes, dtypes and device.  ``inputs`` are tensors (or None);
    the result is a tree (tuples, lists) of tensors and None."""
    device = next(t.device for t in inputs if t is not None)
    captured = device.type == "cuda" and not _EAGER
    full_key = (name, key, _signature(inputs), captured)
    prog = _CACHE.get(full_key)
    if prog is not None:
        _CACHE.move_to_end(full_key)
        if not captured:
            with dispatch.suppress(), traffic.suppress():
                return body(*inputs)
        for static, t in zip(prog.static_in, inputs):
            if t is not None:
                static.copy_(t)
        prog.graph.replay()
        dispatch.launches.add(prog.launched)
        return tree_map(lambda t: None if t is None else t.clone(), prog.static_out)
    dispatch.note_trace(name)
    if not captured:
        _insert(full_key, _Program(), device)
        return body(*inputs)
    out, prog = _capture(body, inputs, device)
    _insert(full_key, prog, device)
    return out


def _capture(body: Callable, inputs: tuple, device: torch.device):
    """Warm up on a side stream (the call's result), then capture there."""
    side = _SIDE.get(device)
    if side is None:
        side = _SIDE[device] = torch.cuda.Stream(device)
    main = torch.cuda.current_stream(device)
    static_in = tuple(None if t is None else t.clone(memory_format=torch.contiguous_format)
                      for t in inputs)
    side.wait_stream(main)
    with torch.cuda.stream(side):
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
        with dispatch.suppress(), traffic.suppress(), torch.cuda.graph(graph, stream=side):
            static_out = body(*static_in)
    finally:
        after = dispatch.launches.as_dict()
        launched = {k: v - before[k] for k, v in after.items() if v != before[k]}
        dispatch.launches.add(launched, -1)   # a capture launches nothing
    nbytes = max(torch.cuda.memory_reserved(device) - reserved, 0) + sum(
        t.numel() * t.element_size() for t in static_in if t is not None)
    return out, _Program(graph, static_in, static_out, launched, nbytes)


def _insert(full_key, prog: _Program, device: torch.device) -> None:
    _CACHE[full_key] = prog
    limit = (CACHE_FRACTION * torch.cuda.get_device_properties(device).total_memory
             if device.type == "cuda" else float("inf"))
    evicted = False
    while len(_CACHE) > 1 and (len(_CACHE) > MAX_PROGRAMS or cache_bytes() > limit):
        evicted |= _CACHE.popitem(last=False)[1].graph is not None
    if evicted:
        torch.cuda.empty_cache()
