"""The rank world: P processes, one rank each, joined by ``torch.distributed``.

This is the port's counterpart of the reference's device mesh
(``repro.compat.make_mesh``, ``jax.sharding.Mesh``) for the
:class:`~repro_torch.collective.comm.DistComm` backend.  Where the
reference runs one SPMD program over P devices inside ``shard_map``, the
port runs P processes, each holding its own rows and running the same
engine on its local block; a butterfly exchange is one
``torch.distributed.batch_isend_irecv`` per perm round (:func:`swap`).

  * :func:`init_rank_world` joins this process to a world of ``world``
    ranks through a ``file://`` rendezvous (so parallel test workers never
    share a port) and returns the world's 1-D :class:`RankMesh`.
  * :func:`run_ranks` spawns a world (the ``spawn`` start method: a forked
    child cannot use CUDA once the parent has), calls ``fn(mesh, *args)`` in
    every rank and returns each rank's result in rank order.  A rank that
    raises fails the whole call with that rank's traceback.
  * :func:`local_mesh` is a mesh of this process alone (a world of one
    rank, where the local block is the whole matrix); :func:`sub_mesh` the
    mesh of the world's first ranks.

**Transport.**  On a CUDA device with the ``gloo`` backend (the default),
each message is the payload's leaves packed into one byte buffer on the
card and staged through pinned host memory: gloo sends no CUDA tensors,
and NCCL refuses two ranks on one device, so this is how P ranks share
one H100.  On the CPU the byte buffer is sent as it is.  With the
``nccl`` backend (one card per rank) the device buffer is sent with no
staging; that branch has not run on a card.  :data:`wire` counts the
messages, the bytes and the host-clock seconds of staging and of the
exchanges.

``RankMesh`` is the port's own frozen dataclass and not
``torch.distributed.device_mesh.DeviceMesh``: the reference's routes read
``mesh.axis_names`` and index ``mesh.shape`` by axis name, while a
``DeviceMesh``'s ``shape`` is indexed by position.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import queue
import shutil
import tempfile
import time
import traceback
from collections.abc import Callable, Sequence
from pathlib import Path

import torch
import torch.distributed as dist

__all__ = [
    "RankMesh",
    "WireStats",
    "close_rank_world",
    "init_rank_world",
    "local_mesh",
    "run_ranks",
    "sub_mesh",
    "swap",
    "wire",
    "world_mesh",
]

_ALIGN = 16          # byte alignment of each leaf inside a packed message


@dataclasses.dataclass(frozen=True)
class RankMesh:
    """A 1-D mesh of ranks: ``axis_names`` (one name), ``members`` (the
    global ranks in mesh order), the ``device`` every rank computes on, and
    the process ``group`` that joins them (``None`` on a rank outside it).
    ``shape`` maps the axis name to the rank count, as a JAX ``Mesh``'s
    does.  Equal meshes (same axis, members and device) key the same
    cached programs, as the reference's meshes hash by value."""

    axis_names: tuple[str, ...]
    members: tuple[int, ...]
    device: torch.device
    group: object = dataclasses.field(default=None, compare=False, repr=False)

    @property
    def shape(self) -> dict[str, int]:
        return {self.axis_names[0]: len(self.members)}

    @property
    def size(self) -> int:
        return len(self.members)

    @property
    def rank(self) -> int:
        """This process's rank on the mesh's axis."""
        return self.members.index(dist.get_rank())


_WORLD: list[RankMesh] = []


def _rendezvous_url(rendezvous: str | os.PathLike) -> str:
    text = os.fspath(rendezvous)
    return text if "://" in text else Path(text).resolve().as_uri()


def _resolve(device) -> torch.device:
    from .comm import resolve_device   # comm imports this module

    return resolve_device(device)


def init_rank_world(world: int, rank: int, rendezvous: str | os.PathLike, backend: str = "gloo",
                    *, device=None, axis: str = "rows") -> RankMesh:
    """Join this process to a world of ``world`` ranks as ``rank``.

    ``rendezvous`` is a ``file://`` URL or a path to a file that does not
    exist yet (every rank passes the same one).  ``device=None`` means the
    card (and raises without one); pass ``"cpu"`` for a CPU world, which
    needs ``backend="gloo"``.  Returns the world's mesh over ``axis``."""
    device = _resolve(device)
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("backend='nccl' sends device tensors; a CPU world needs 'gloo'")
    if dist.is_initialized():
        raise RuntimeError("this process already belongs to a rank world")
    dist.init_process_group(backend, init_method=_rendezvous_url(rendezvous),
                            world_size=world, rank=rank)
    mesh = RankMesh((axis,), tuple(range(world)), device, dist.group.WORLD)
    _WORLD.append(mesh)
    return mesh


def world_mesh() -> RankMesh | None:
    """The mesh of the world this process joined, or ``None``."""
    return _WORLD[-1] if _WORLD and dist.is_initialized() else None


def close_rank_world() -> None:
    """Leave the world (a no-op outside one)."""
    _WORLD.clear()
    if dist.is_initialized():
        dist.destroy_process_group()


@contextlib.contextmanager
def local_mesh(axis: str = "x", device=None):
    """A mesh of this process alone, over ``axis``.  Inside a world it is a
    group of this rank only; outside one it is a world of one rank, joined
    through a rendezvous file in a temporary directory and left on exit."""
    outer = world_mesh()
    if outer is not None:
        me = dist.get_rank()
        group = dist.new_group([me], use_local_synchronization=True)
        yield RankMesh((axis,), (me,), outer.device if device is None else _resolve(device),
                       group)
        return
    tmp = tempfile.mkdtemp(prefix="rank_world_")
    try:
        mesh = init_rank_world(1, 0, os.path.join(tmp, "rendezvous"), device=device, axis=axis)
        yield mesh
    finally:
        close_rank_world()
        shutil.rmtree(tmp, ignore_errors=True)


def sub_mesh(n: int, axis: str = "x") -> RankMesh | None:
    """The mesh of the world's first ``n`` ranks over ``axis``; ``None`` on
    the other ranks.  Every rank of the world must call it (the group is
    created collectively)."""
    outer = world_mesh()
    if outer is None or outer.size < n:
        raise ValueError(f"sub_mesh({n}) needs a rank world of at least {n} ranks")
    group = dist.new_group(list(range(n)))
    if dist.get_rank() >= n:
        return None
    return RankMesh((axis,), tuple(range(n)), outer.device, group)


# ---------------------------------------------------------------------------
# The wire
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class WireStats:
    """Process-lifetime counters of :func:`swap`: messages and bytes this
    rank sent, the bytes it staged through the host (sent and received), the
    host-clock seconds of that staging (device↔host copies, each ending in a
    synchronize) and of whole exchanges."""

    messages: int = 0
    bytes_sent: int = 0
    staged_bytes: int = 0
    staging_seconds: float = 0.0
    exchange_seconds: float = 0.0

    def reset(self) -> None:
        for field in dataclasses.fields(self):
            setattr(self, field.name, field.default)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


wire = WireStats()

_PINNED: dict[str, torch.Tensor] = {}


def _pinned(nbytes: int, role: str) -> torch.Tensor:
    """A pinned host byte buffer of at least ``nbytes``, reused per role
    (``"send"``, ``"recv"``): an exchange finishes its copies before it
    returns."""
    buf = _PINNED.get(role)
    if buf is None or buf.numel() < nbytes:
        buf = _PINNED[role] = torch.empty(max(nbytes, 1), dtype=torch.uint8, pin_memory=True)
    return buf[:nbytes]


def _layout(flat: Sequence[torch.Tensor]) -> tuple[list[int], int]:
    """Byte offset of each leaf in a packed message, and its total size."""
    offsets, total = [], 0
    for leaf in flat:
        offsets.append(total)
        nbytes = leaf.numel() * leaf.element_size()
        total += -(-nbytes // _ALIGN) * _ALIGN
    return offsets, total


def _as_leaf(buf: torch.Tensor, off: int, like: torch.Tensor) -> torch.Tensor:
    nbytes = like.numel() * like.element_size()
    return buf[off:off + nbytes].view(like.dtype).reshape(like.shape)


def _pack(flat, offsets, total, device) -> torch.Tensor:
    buf = torch.empty(total, dtype=torch.uint8, device=device)
    for leaf, off in zip(flat, offsets):
        _as_leaf(buf, off, leaf).copy_(leaf)
    return buf


def swap(flat: Sequence[torch.Tensor], dst: int | None, src: int | None, group,
         device: torch.device) -> list[torch.Tensor] | None:
    """Send the leaves ``flat`` to group rank ``dst`` and receive the same
    structure from group rank ``src`` (either may be ``None``), in one
    ``batch_isend_irecv``.  Returns the received leaves, or ``None`` when
    nothing was received.  Every rank of a perm round posts its ops in the
    same order, so each pair's messages match in order."""
    if dst is None and src is None:
        return None
    t0 = time.perf_counter()
    offsets, total = _layout(flat)
    staged = device.type == "cuda" and dist.get_backend(group) != "nccl"
    ops = []
    if dst is not None:
        send = _pack(flat, offsets, total, device)
        if staged:
            ts = time.perf_counter()
            send = _pinned(total, "send").copy_(send)
            wire.staging_seconds += time.perf_counter() - ts
            wire.staged_bytes += total
        ops.append(dist.P2POp(dist.isend, send, dist.get_global_rank(group, dst), group))
        wire.messages += 1
        wire.bytes_sent += total
    if src is not None:
        recv = (_pinned(total, "recv") if staged
                else torch.empty(total, dtype=torch.uint8, device=device))
        ops.append(dist.P2POp(dist.irecv, recv, dist.get_global_rank(group, src), group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    out = None
    if src is not None:
        if staged:
            ts = time.perf_counter()
            recv = recv.to(device)
            torch.cuda.synchronize(device)
            wire.staging_seconds += time.perf_counter() - ts
            wire.staged_bytes += total
        out = [_as_leaf(recv, off, leaf) for leaf, off in zip(flat, offsets)]
    wire.exchange_seconds += time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# Spawning a world
# ---------------------------------------------------------------------------

def _rank_main(fn, rank: int, world: int, rendezvous: str, backend: str, device, args,
               results) -> None:
    torch.set_num_threads(1)
    try:
        mesh = init_rank_world(world, rank, rendezvous, backend, device=device)
        try:
            out = fn(mesh, *args)
        finally:
            close_rank_world()
        results.put((rank, True, out))
    except BaseException:   # noqa: BLE001 — every failure goes back to the parent
        results.put((rank, False, traceback.format_exc()))


def run_ranks(fn: Callable, world: int, *, device=None, backend: str = "gloo", args: tuple = (),
              rendezvous_dir: str | os.PathLike | None = None, timeout: float = 600.0) -> list:
    """Spawn ``world`` rank processes; each joins the world and returns
    ``fn(mesh, *args)``.  Returns the results in rank order.

    ``fn`` and ``args`` must pickle (a module-level function), and so must
    each result.  ``device=None`` means the card: every rank computes on
    ``cuda`` (all on one card when there is one) and raises without one.
    The rendezvous file goes into ``rendezvous_dir`` (a fresh temporary
    directory when ``None``).  A rank that raises, dies or outlasts
    ``timeout`` seconds fails the call with ``RuntimeError``; every process
    is stopped before it returns."""
    if device is None:
        _resolve(None)                       # no card: raise here, before spawning
    elif not isinstance(device, str):
        device = str(device)
    own_dir = rendezvous_dir is None
    where = Path(tempfile.mkdtemp(prefix="rank_world_") if own_dir else rendezvous_dir)
    rendezvous = where / f"rendezvous-{os.getpid()}-{time.monotonic_ns()}"
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world, str(rendezvous), backend, device, args, results))
             for r in range(world)]
    got: dict[int, object] = {}
    try:
        for proc in procs:
            proc.start()
        deadline = time.monotonic() + timeout
        while len(got) < world:
            try:
                rank, ok, out = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and not p.is_alive() and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} died with exit code "
                                       f"{procs[dead[0]].exitcode} before it reported") from None
                if time.monotonic() > deadline:
                    raise RuntimeError(f"ranks {sorted(set(range(world)) - set(got))} did not "
                                       f"finish within {timeout} s") from None
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{out}")
            got[rank] = out
        for proc in procs:
            proc.join(timeout=30)
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=10)
        results.close()
        if own_dir:
            shutil.rmtree(where, ignore_errors=True)
    return [got[r] for r in range(world)]
