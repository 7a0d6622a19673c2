"""Communication backends for the fault-tolerant butterfly collectives.

The engine in :mod:`repro_torch.collective.engine` is written once against
this small interface and runs on either backend:

  * :class:`SimComm` — a single-device simulation where every per-rank value
    carries a leading ``(P,)`` axis and exchanges are gathers.  On the card
    this is how one H100 runs all P ranks: one kernel launch covers the
    whole (P, m_local, n) stack.
  * :class:`DistComm` (also exported as ``ShardMapComm``, the reference's
    name) — one process per rank (:mod:`repro_torch.collective.dist`);
    per-rank values are 0-d tensors and local blocks, and an exchange is
    one ``batch_isend_irecv`` per perm round.  The reference's production
    path, run as P processes in place of ``shard_map`` over P devices.

Non-receiving ranks get zeros (the semantics of a collective permute whose
destination list omits them), which the validity bits then adjudicate.

``exchange`` maps over payload trees (tuples of tensors), so the engine can
route a ``(payload, validity)`` pair or a stacked payload in one call.

A comm lives on one device (``device``, the card unless the caller asks
for the CPU): the per-rank vectors it builds (rank ids, validity bits) land
there, so the executors check that the payload does too
(:func:`check_device`).
"""
from __future__ import annotations

import dataclasses
import functools
from collections.abc import Sequence

import numpy as np
import torch

from ._tree import leaves, structure, tree_map, unflatten

__all__ = ["Comm", "DistComm", "ShardMapComm", "SimComm", "check_device", "resolve_device"]

Pair = tuple[int, int]


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; raise when there is none.  A CUDA device
    without an index gets the current one, so it compares equal to the
    device of the tensors placed on it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; the port runs on the GPU by "
                "default — pass device=\"cpu\" to run on the CPU"
            )
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class Comm:
    """Interface: per-rank values with a leading (P,) axis (simulated) or
    this rank's own values (one process per rank)."""

    n_ranks: int
    device: torch.device

    def ranks(self):
        raise NotImplementedError

    def take(self, host_vec):
        """Per-rank view of a host (P,) vector."""
        raise NotImplementedError

    def exchange(self, x, perm: Sequence[Pair]):
        """Permute per-rank payloads; non-receivers get zeros."""
        raise NotImplementedError

    def bwhere(self, cond, a, b):
        """`where` with a per-rank condition, broadcast over the payload."""
        raise NotImplementedError

    def leaf_nbytes(self, leaf) -> int:
        """Per-rank wire bytes of one payload leaf (the byte counters of
        :mod:`repro_torch.collective.instrument` read this)."""
        raise NotImplementedError


@functools.lru_cache(maxsize=1024)
def _perm_index(perm: tuple[Pair, ...], device: torch.device):
    """src/dst index tensors of one perm, built once per (perm, device)."""
    src = torch.tensor([s for s, _ in perm], dtype=torch.long, device=device)
    dst = torch.tensor([d for _, d in perm], dtype=torch.long, device=device)
    return src, dst


@functools.lru_cache(maxsize=1024)
def _host_vector(data: bytes, dtype: str, n: int, device: torch.device):
    """A plan's (P,) host vector on ``device``, copied once per value."""
    return torch.from_numpy(np.frombuffer(data, dtype=dtype, count=n).copy()).to(device)


def check_device(x, comm: Comm) -> None:
    """Raise ``ValueError`` unless every payload leaf of ``x`` lies on
    ``comm.device``, where the comm builds its per-rank vectors."""
    for leaf in leaves(x):
        if leaf.device != comm.device:
            raise ValueError(
                f"payload on {leaf.device} but the comm's per-rank vectors are on "
                f"{comm.device}; build the comm on the payload's device "
                f"(SimComm(n_ranks, device=x.device))"
            )


@dataclasses.dataclass(frozen=True)
class SimComm(Comm):
    """Single-device simulation: leading (P,) axis on every per-rank value.

    ``device=None`` means the card (and raises without one); pass
    ``device="cpu"`` to run on the CPU.
    """

    n_ranks: int
    device: torch.device | str | None = None

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))

    def ranks(self):
        return self.take(np.arange(self.n_ranks, dtype=np.int64))

    def take(self, host_vec):
        vec = np.ascontiguousarray(host_vec)
        if vec.shape != (self.n_ranks,):
            raise ValueError(
                f"expected a ({self.n_ranks},) host vector, got {vec.shape}"
            )
        return _host_vector(vec.tobytes(), vec.dtype.str, self.n_ranks, self.device)

    def exchange(self, x, perm: Sequence[Pair]):
        perm = tuple(tuple(p) for p in perm)

        def go(leaf):
            out = torch.zeros_like(leaf)
            if not perm:
                return out
            src, dst = _perm_index(perm, leaf.device)
            return out.index_copy_(0, dst, leaf.index_select(0, src))

        return tree_map(go, x)

    def bwhere(self, cond, a, b):
        extra = max(a.ndim, b.ndim) - cond.ndim
        return torch.where(cond.reshape(cond.shape + (1,) * extra), a, b)

    def leaf_nbytes(self, leaf) -> int:
        # leading (P,) axis: one rank's slice is 1/P of the array
        return int(np.prod(leaf.shape[1:], dtype=np.int64)) * leaf.element_size()


@dataclasses.dataclass(frozen=True)
class DistComm(Comm):
    """One process per rank: this rank's values are 0-d tensors and local
    blocks, and :meth:`exchange` crosses processes.

    ``group`` is the process group of the ``n_ranks`` ranks.  ``None``
    takes this rank's line along ``axis`` of the newest mesh with that
    axis built here (:func:`repro_torch.collective.dist.make_rank_mesh`:
    ``ShardMapComm(4, "model")`` on a 2 × 4 data × model mesh is this
    rank's model line), else the rank world's group where the world's axis
    is ``axis`` (:func:`~repro_torch.collective.dist.init_rank_world`), and
    raises ``ValueError`` otherwise
    (:func:`~repro_torch.collective.dist.resolve_line`);
    ``device`` where this rank computes (``None``: the world's device).
    The payload travels as described in :mod:`repro_torch.collective.dist`:
    staged through pinned host memory over gloo on the card, as it is over
    gloo on the CPU, and as a device tensor over NCCL (not run yet).
    """

    n_ranks: int
    axis: str
    group: object = dataclasses.field(default=None, compare=False, repr=False)
    device: torch.device | str | None = None
    members: tuple[int, ...] = dataclasses.field(init=False, default=())
    rank: int = dataclasses.field(init=False, default=0, compare=False)

    def __post_init__(self):
        import torch.distributed as dist

        from . import dist as _dist

        world = _dist.world_mesh()
        if world is None:
            raise RuntimeError(
                "DistComm needs a rank world: call "
                "repro_torch.collective.dist.init_rank_world (or run_ranks) first"
            )
        group = _dist.resolve_line(self.axis, self.n_ranks).group if self.group is None \
            else self.group
        size = dist.get_world_size(group)
        if size != self.n_ranks:
            raise ValueError(f"the process group has {size} ranks but n_ranks={self.n_ranks}")
        device = world.device if self.device is None else resolve_device(self.device)
        coerce = object.__setattr__
        coerce(self, "group", group)
        coerce(self, "device", device)
        coerce(self, "members", tuple(dist.get_process_group_ranks(group)))
        coerce(self, "rank", dist.get_rank(group))

    def ranks(self):
        return self.take(np.arange(self.n_ranks, dtype=np.int64))

    def take(self, host_vec):
        vec = np.ascontiguousarray(host_vec)
        if vec.shape != (self.n_ranks,):
            raise ValueError(
                f"expected a ({self.n_ranks},) host vector, got {vec.shape}"
            )
        return _host_vector(vec.tobytes(), vec.dtype.str, self.n_ranks, self.device)[self.rank]

    def exchange(self, x, perm: Sequence[Pair]):
        from . import dist as _dist

        dst = next((d for s, d in perm if s == self.rank), None)
        src = next((s for s, d in perm if d == self.rank), None)
        flat = leaves(x)
        got = _dist.swap(flat, dst, src, self.group, self.device)
        if got is None:
            got = [torch.zeros_like(leaf) for leaf in flat]
        return unflatten(structure(x), got)

    def bwhere(self, cond, a, b):
        return torch.where(cond, a, b)

    def leaf_nbytes(self, leaf) -> int:
        # one process per rank: the leaf is already this rank's local block
        return int(np.prod(leaf.shape, dtype=np.int64)) * leaf.element_size()


ShardMapComm = DistComm     # the reference's name for its production backend
