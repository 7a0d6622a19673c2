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
  * :func:`make_rank_mesh` lays a mesh of several axes over the world
    (``make_mesh((2, 4), ("data", "model"))``), each rank with the group of
    its line along each axis; :func:`psum`, :func:`pmean` and
    :func:`all_gather` are ``lax.psum``, ``lax.pmean`` and the tiled
    ``lax.all_gather`` over one axis of it.  A sum adds the line's values
    in member order, so every rank of a line holds the same bits.

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
import math
import os
import queue
import shutil
import tempfile
import time
import traceback
from collections.abc import Callable, Sequence
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "RankMesh",
    "WireStats",
    "close_rank_world",
    "init_rank_world",
    "all_gather",
    "local_mesh",
    "make_rank_mesh",
    "pmean",
    "psum",
    "resolve_line",
    "run_ranks",
    "sub_mesh",
    "swap",
    "wire",
    "world_mesh",
]

_ALIGN = 16          # byte alignment of each leaf inside a packed message


@dataclasses.dataclass(frozen=True)
class RankMesh:
    """A mesh of ranks: ``axis_names``, ``members`` (the global ranks in
    mesh order, row-major over the axes, as ``make_mesh`` lays out devices),
    the ``device`` every rank computes on, the process ``group`` that joins
    them (``None`` on a rank outside it) and ``dims``, the size of each axis
    (``()``: every member along the first axis).  ``shape`` maps each axis name
    to its size, in order, as a JAX ``Mesh``'s does.  Equal meshes (same
    axes, members, dims and device) key the same cached programs, as the
    reference's meshes hash by value.

    A mesh of several axes built by :func:`make_rank_mesh` also carries this
    rank's line along each axis (:meth:`line`), each with its own group."""

    axis_names: tuple[str, ...]
    members: tuple[int, ...]
    device: torch.device
    group: object = dataclasses.field(default=None, compare=False, repr=False)
    dims: tuple[int, ...] = ()
    lines: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    def __post_init__(self):
        dims = tuple(self.dims) or (len(self.members),) + (1,) * (len(self.axis_names) - 1)
        if len(dims) != len(self.axis_names) or math.prod(dims) != len(self.members):
            raise ValueError(f"axes {self.axis_names} of sizes {dims} do not lay out "
                             f"{len(self.members)} members")
        object.__setattr__(self, "dims", dims)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        return len(self.members)

    @property
    def rank(self) -> int:
        """This process's position in the mesh (row-major over the axes)."""
        return self.members.index(dist.get_rank())

    def index(self, axis: str) -> int:
        """This process's index along ``axis`` (``lax.axis_index``)."""
        return int(np.unravel_index(self.rank, self.dims)[self._axis(axis)])

    def line(self, axis: str) -> RankMesh:
        """The 1-D mesh of this rank's line along ``axis``: the ranks that
        share its index on every other axis, with that line's group."""
        self._axis(axis)
        if len(self.axis_names) == 1:
            return self
        if axis not in self.lines:
            raise ValueError("this mesh carries no line groups; build it with make_rank_mesh")
        return self.lines[axis]

    def _axis(self, axis: str) -> int:
        if axis not in self.axis_names:
            raise ValueError(f"mesh axes {self.axis_names} do not include {axis!r}")
        return self.axis_names.index(axis)


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
    _MESHES.clear()
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


# every make_rank_mesh call of this world, newest last: its axes and this
# rank's mesh (None on a rank outside), the same entries on every rank
_MESHES: list[tuple[tuple[str, ...], RankMesh | None]] = []


def make_rank_mesh(dims: Sequence[int], axis_names: Sequence[str]) -> RankMesh | None:
    """The mesh of ``dims`` over the world's first ``prod(dims)`` ranks,
    laid out row-major as ``make_mesh(dims, axis_names)`` lays out devices:
    on a (D, M) mesh over ("data", "model"), rank ``d·M + m``.

    Every rank of the world calls it with the same arguments and in the
    same order as the others: it creates the mesh's group and, on a mesh
    of several axes, one group for each line along each axis (the D model
    lines of M ranks, then the M data lines of D), collectively.  Returns
    ``None`` on a rank outside the mesh.  A world of fewer ranks raises the
    ``ValueError`` the reference's ``make_mesh`` raises with fewer devices.
    Every rank computes on the world's device."""
    world = world_mesh()
    if world is None:
        raise RuntimeError("make_rank_mesh needs a rank world: call init_rank_world "
                           "(or run_ranks) first")
    dims, axis_names = tuple(int(d) for d in dims), tuple(axis_names)
    if len(dims) != len(axis_names):
        raise ValueError(f"mesh_shape {dims} and axis_names {axis_names} differ in length")
    n = math.prod(dims)
    if world.size < n:
        raise ValueError(f"Number of devices {world.size} must be >= the product of "
                         f"mesh_shape {dims}")
    device = world.device
    me = dist.get_rank()
    group = dist.group.WORLD if n == world.size else dist.new_group(list(range(n)))
    lines = {}
    if len(dims) > 1:
        grid = np.arange(n).reshape(dims)
        for k, axis in enumerate(axis_names):
            for row in np.moveaxis(grid, k, -1).reshape(-1, dims[k]).tolist():
                line_group = dist.new_group(row)
                if me in row:
                    lines[axis] = RankMesh((axis,), tuple(row), device, line_group)
    mesh = RankMesh(axis_names, tuple(range(n)), device, group, dims, lines) if me < n else None
    _MESHES.append((axis_names, mesh))
    return mesh


def resolve_line(axis: str, n_ranks: int) -> RankMesh:
    """The line a :class:`~repro_torch.collective.comm.DistComm` over
    ``axis`` with no group runs on: this rank's line along ``axis`` of the
    newest mesh :func:`make_rank_mesh` built with that axis, else the
    world's own mesh where its axis is ``axis``.  Every rank of the world
    records every mesh, members or not, so "newest" names the same mesh on
    all of them.  Raises ``ValueError`` where this rank is outside that
    mesh, where no such line exists or where its size is not ``n_ranks``: a
    comm never falls back to a group of another axis."""
    newest = next(((names, mesh) for names, mesh in reversed(_MESHES) if axis in names), None)
    if newest is not None:
        names, mesh = newest
        if mesh is None:
            raise ValueError(f"this rank is outside the newest mesh with an axis {axis!r} "
                             f"(axes {names})")
        line = mesh.line(axis)
    else:
        world = world_mesh()
        if world is None or world.axis_names != (axis,):
            raise ValueError(
                f"no mesh of this rank has an axis {axis!r}: build one with make_rank_mesh "
                f"(repro_torch.launch.mesh) or pass the axis' process group")
        line = world
    if line.size != n_ranks:
        raise ValueError(f"mesh axis {axis!r} has {line.size} ranks but n_ranks={n_ranks}")
    return line


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
    (``"send"``, ``"recv"``, ``"gather"``): an exchange finishes its copies before it
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


def _staged(device: torch.device, group) -> bool:
    """Whether a message on ``group`` from ``device`` goes through pinned
    host memory: a CUDA tensor over any backend but NCCL."""
    return device.type == "cuda" and dist.get_backend(group) != "nccl"


def _stage_out(data: torch.Tensor, role: str) -> torch.Tensor:
    """Copy the device bytes ``data`` into the pinned host buffer of
    ``role`` (counted in :data:`wire`)."""
    ts = time.perf_counter()
    host = _pinned(data.numel(), role).copy_(data)
    wire.staging_seconds += time.perf_counter() - ts
    wire.staged_bytes += data.numel()
    return host


def _stage_in(host: torch.Tensor, device: torch.device) -> torch.Tensor:
    """Copy the received host bytes ``host`` to ``device`` and wait for the
    copy (counted in :data:`wire`)."""
    ts = time.perf_counter()
    out = host.to(device)
    torch.cuda.synchronize(device)
    wire.staging_seconds += time.perf_counter() - ts
    wire.staged_bytes += host.numel()
    return out


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
    staged = _staged(device, group)
    ops = []
    if dst is not None:
        send = _pack(flat, offsets, total, device)
        if staged:
            send = _stage_out(send, "send")
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
            recv = _stage_in(recv, device)
        out = [_as_leaf(recv, off, leaf) for leaf, off in zip(flat, offsets)]
    wire.exchange_seconds += time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# Axis collectives: lax.psum, lax.pmean and lax.all_gather(tiled=True)
# ---------------------------------------------------------------------------

def _gather(x: torch.Tensor, line: RankMesh) -> list[torch.Tensor]:
    """Every member's ``x`` along ``line``, in member order: one
    ``all_gather`` over the line's group, staged through pinned host memory
    as :func:`swap` stages (counted in :data:`wire`)."""
    n = line.size
    if n == 1:
        return [x]
    t0 = time.perf_counter()
    x = x.detach().contiguous()
    nbytes = x.numel() * x.element_size()
    send = x.reshape(-1).view(torch.uint8)
    staged = _staged(x.device, line.group)
    if staged:
        send, recv = _stage_out(send, "send"), _pinned(n * nbytes, "gather")
    else:
        recv = torch.empty(n * nbytes, dtype=torch.uint8, device=x.device)
    if nbytes:
        dist.all_gather(list(recv.view(n, nbytes).unbind(0)), send, group=line.group)
    if staged:
        recv = _stage_in(recv, x.device)
    wire.messages += n - 1
    wire.bytes_sent += (n - 1) * nbytes
    wire.exchange_seconds += time.perf_counter() - t0
    return [row.view(x.dtype).reshape(x.shape) for row in recv.view(n, nbytes).unbind(0)]


def _ordered_sum(parts: list[torch.Tensor]) -> torch.Tensor:
    """The parts added in member order: the same operations on the same
    values on every member, so every member holds the same bits (gloo's
    ``all_reduce`` promises no order)."""
    out = parts[0].clone()
    for part in parts[1:]:
        out += part
    return out


def _no_grad_through(name: str, x: torch.Tensor) -> None:
    if torch.is_grad_enabled() and x.requires_grad:
        raise NotImplementedError(f"{name} has no gradient in the port; only all_gather has one")


def psum(x: torch.Tensor, axis: str, mesh: RankMesh) -> torch.Tensor:
    """``lax.psum(x, axis)``: the sum of ``x`` over this rank's line along
    ``axis`` of ``mesh``, bit-identical on every rank of the line."""
    _no_grad_through("psum", x)
    return _ordered_sum(_gather(x, mesh.line(axis)))


def pmean(x: torch.Tensor, axis: str, mesh: RankMesh) -> torch.Tensor:
    """``lax.pmean(x, axis)``: :func:`psum` over the line's size."""
    _no_grad_through("pmean", x)
    return psum(x, axis, mesh) / mesh.shape[axis]


class _AllGather(torch.autograd.Function):
    """Tiled all-gather along the first dimension; its gradient is the
    transpose the reference's ``shard_map`` takes, a ``psum_scatter``: every
    member's cotangent summed in member order, and this rank's rows of the
    sum.  Each member sends its whole cotangent (n times the bytes of a
    reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, line):
        ctx.line, ctx.rows = line, x.shape[0]
        return torch.cat(_gather(x, line))

    @staticmethod
    def backward(ctx, grad):
        total = _ordered_sum(_gather(grad, ctx.line))
        return total[ctx.line.rank * ctx.rows:(ctx.line.rank + 1) * ctx.rows].contiguous(), None


def all_gather(x: torch.Tensor, axis: str, mesh: RankMesh) -> torch.Tensor:
    """``lax.all_gather(x, axis, axis=0, tiled=True)``: the line's blocks
    along ``axis`` concatenated along the first dimension in member order;
    differentiable (:class:`_AllGather`)."""
    return _AllGather.apply(x, mesh.line(axis))


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
    each result.  Keep ``args`` small: a spawned rank reads them only after
    it has imported the parent's main module, and args past a pipe's
    buffer (64 KiB) hold up the start of the next rank until then.  ``device=None`` means the card: every rank computes on
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
