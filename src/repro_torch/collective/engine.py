"""The plan-driven, fault-tolerant butterfly-collective engine.

:func:`execute_plan` runs any :class:`~repro_torch.collective.plan.Plan`
(tree / redundant / replace / selfhealing) with any
:class:`~repro_torch.collective.combiners.Combiner`, threading validity bits
alongside every payload and performing the Self-Healing restore rounds.
:func:`ft_allreduce` is the entry point for arithmetic reductions over the
same butterfly, and :func:`ft_allreduce_jit` the same reduction as a cached
program (:mod:`repro_torch.replay`: a CUDA graph on the card; over
:class:`~repro_torch.collective.comm.DistComm`, an eager per-rank program).
Every function here runs on either backend: a (P,)-leading stack on
``SimComm``, this rank's local block on ``DistComm``.

**Fault-free fast path.**  When the host plan proves fault-freeness
(:attr:`Plan.is_fault_free`), :func:`execute_plan` runs a straight-line
butterfly — exchange, order by the level bit, combine — with no validity
bit on the wire, no receive staging and no poison writes, and returns the
host-predicted (all-true) validity.  The result is bitwise equal to the
general executor; pass ``fast=False`` to force the general executor.

**Symmetric wire packing.**  Leaves governed by a ``wire_symmetric``
combiner (``gram_sum``) ship as their n(n+1)/2 upper triangle on both
paths, so the wire carries what ``Plan.bytes_on_wire(symmetric=True)``
prices.

Validity semantics: a dead rank's contribution is zero-filled and flagged
invalid.  The host plan predicts the same validity; tests assert the two
agree bit-for-bit.  Invalid payload slots are poisoned (NaN for floating
dtypes) so accidental use is loud.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import replay
from repro_torch.kernels import dispatch as _dispatch

from ._tree import leaves, structure, tree_map, unflatten
from .combiners import Combiner, get_combiner
from .comm import Comm, DistComm, SimComm, check_device
from .faults import NEVER, FaultSpec
from .packing import pack_sym, unpack_sym
from .plan import Plan, _split_rounds, make_plan

__all__ = ["execute_plan", "ft_allreduce", "ft_allreduce_jit", "recover_payload",
           "replica_fetch"]


def _poison(leaf: torch.Tensor) -> torch.Tensor:
    """Fill for invalid slots: NaN where representable, zero otherwise."""
    if leaf.is_floating_point() or leaf.is_complex():
        return torch.full_like(leaf, float("nan"))
    return torch.zeros_like(leaf)


def _wire_codec(combiner: Combiner, val):
    """(pack, unpack) applied at the comm boundary, decided per leaf by
    :meth:`Combiner.wire_pack_flags`."""
    flags = combiner.wire_pack_flags(val)
    if not any(flags):
        def ident(t):
            return t

        return ident, ident

    ns = [leaf.shape[-1] for leaf in leaves(val)]

    def pack(t):
        it = iter(flags)
        return tree_map(lambda leaf: pack_sym(leaf) if next(it) else leaf, t)

    def unpack(t):
        it = iter(zip(flags, ns))

        def go(leaf):
            f, n = next(it)
            return unpack_sym(leaf, n) if f else leaf

        return tree_map(go, t)

    return pack, unpack


def _order(comm: Comm, my, level: int, val, recv):
    """(lo, hi) operands ordered by this level's block bit."""
    mine_first = ((my >> level) & 1) == 0
    lo = tree_map(lambda m, o: comm.bwhere(mine_first, m, o), val, recv)
    hi = tree_map(lambda m, o: comm.bwhere(mine_first, o, m), val, recv)
    return lo, hi


def _execute_fast(x, comm: Comm, plan: Plan, combiner: Combiner):
    """Straight-line fault-free butterfly.  Requires a fault-free plan;
    bitwise equal to the general executor on such plans."""
    val = combiner.tree_prepare(x)
    pack, unpack = _wire_codec(combiner, val)
    my = comm.ranks()
    for step in plan.steps:
        recv = unpack(comm.exchange(pack(val), step.perm_rounds[0]))
        val = combiner.tree_combine(*_order(comm, my, step.level, val, recv))
    return val, comm.take(plan.final_valid)


def execute_plan(
    x,
    comm: Comm,
    plan: Plan,
    combiner: Combiner | str,
    *,
    fast: bool | None = None,
):
    """Run ``plan`` over ``x`` with ``combiner``.  Returns ``(value, valid)``.

    ``x`` is a tree of per-rank payloads: with a leading (P,) axis on
    ``SimComm``, this rank's local blocks on ``DistComm``.
    ``value`` is the un-finalized combine (use :func:`ft_allreduce` for mean
    semantics etc.); ``valid`` is the per-rank validity bit, which matches
    ``plan.final_valid`` bit-for-bit.

    ``fast=None`` takes the fault-free fast path when the host plan permits;
    ``False`` forces the general executor; ``True`` demands the fast path
    (raises if the plan is not fault-free).
    """
    combiner = get_combiner(combiner)
    check_device(x, comm)
    fault_free = plan.is_fault_free
    if fast is True and not fault_free:
        raise ValueError(
            "fast=True requires a fault-free plan (one perm-round per step, "
            "no deaths, all ranks valid)"
        )
    if fault_free and fast is not False:
        return _execute_fast(x, comm, plan, combiner)

    val = combiner.tree_prepare(x)
    pack, unpack = _wire_codec(combiner, val)
    d = comm.take(plan.death)
    my = comm.ranks()
    valid = d > 0
    for step in plan.steps:
        s = step.level
        can = valid & (d > s)
        # ---- exchange (possibly several unique-source rounds) -------------
        # Each rank receives at most once per level, so the round whose
        # validity bit arrived selects the payload: zero-filled otherwise.
        pval = pack(val)
        recv_p = tree_map(torch.zeros_like, pval)
        recv_v = torch.zeros_like(can)
        for rnd in step.perm_rounds:
            rr, rv = comm.exchange((pval, can), rnd)
            recv_p = tree_map(lambda acc, got: comm.bwhere(rv, got, acc), recv_p, rr)
            recv_v = recv_v | rv
        recv = unpack(recv_p)
        # ---- combine: operands ordered by this level's block bit ----------
        new = combiner.tree_combine(*_order(comm, my, s, val, recv))
        valid = can & recv_v
        val = tree_map(lambda nv: comm.bwhere(valid, nv, _poison(nv)), new)
        # ---- Self-Healing: respawn dead ranks from a replica ---------------
        if step.restore_rounds:
            for rnd in step.restore_rounds:
                rr, rv = comm.exchange((pack(val), valid), rnd)
                rr = unpack(rr)
                got = rv & ~valid
                val = tree_map(lambda cur, rec: comm.bwhere(got, rec, cur), val, rr)
                valid = valid | got
            respawned = comm.take(step.respawned)
            d = torch.where(respawned, torch.full_like(d, NEVER), d)
    return val, valid


def replica_fetch(x, comm: Comm, valid) -> object:
    """Restore invalid ranks' payloads from replicas of the reduced value.

    After a within-tolerance butterfly every *valid* rank holds an identical
    copy of the reduction.  Each invalid rank receives the value from a
    valid donor (round-robin, decomposed into unique-source rounds exactly
    like the Replace multicast).  ``valid`` is the *host-side* (P,)
    prediction (``plan.final_valid``).  Raises ``ValueError`` when no rank
    is valid: the value is extinct and no routing can recover it.
    """
    valid = np.asarray(valid, dtype=bool)
    if valid.all():
        return x
    if not valid.any():
        raise ValueError("replica_fetch: no valid rank holds the value")
    check_device(x, comm)
    donors = np.flatnonzero(valid)
    starved = np.flatnonzero(~valid)
    pairs = [
        (int(donors[i % len(donors)]), int(r)) for i, r in enumerate(starved)
    ]
    for rnd in _split_rounds(pairs):
        got = np.zeros(valid.shape[0], dtype=bool)
        got[[d for _, d in rnd]] = True
        g = comm.take(got)
        recv = comm.exchange(x, rnd)
        x = tree_map(lambda cur, rec: comm.bwhere(g, rec, cur), x, recv)
    return x


def recover_payload(x, comm: Comm, valid, *, plan=None) -> object:
    """Phase-boundary recovery, by scheme.

    * Butterfly plans (or no plan): invalid ranks fetch the reduced value
      from donors (:func:`replica_fetch`).
    * Coded plans (:class:`~repro_torch.collective.coded.CodedPlan`): the
      erased contributions were already reconstructed from parity inside
      the collective and the broadcast reached every data rank, so nothing
      is left to fetch.  An invalid data rank here means the erasure budget
      was exceeded; parity is not a replica, so that raises ``ValueError``.
    """
    from .coded import CodedPlan  # local: coded imports this module

    if isinstance(plan, CodedPlan):
        valid = np.asarray(valid, dtype=bool)
        if not valid[: plan.n_data].all():
            raise ValueError(
                "recover_payload: coded recovery happens in-collective; "
                "invalid data ranks after a coded reduce mean the erasure "
                "budget was exceeded and no donor path exists"
            )
        return x
    return replica_fetch(x, comm, valid)


def ft_allreduce(
    x,
    comm: Comm,
    *,
    op: Combiner | str = "sum",
    variant: str = "redundant",
    fault_spec: FaultSpec | None = None,
    plan: Plan | None = None,
    fast: bool | None = None,
):
    """Fault-tolerant all-reduce over the paper's butterfly.

    Returns ``(value, valid)``: ``value`` is the finalized reduction (a tree
    like ``x``), ``valid`` the per-rank validity bit.  Invalid ranks hold
    poisoned (NaN) payloads.
    """
    if plan is None:
        plan = make_plan(variant, comm.n_ranks, fault_spec)
    combiner = get_combiner(op)
    val, valid = execute_plan(x, comm, plan, combiner, fast=fast)
    return combiner.tree_finalize(val, plan.n_ranks), valid


def _check_mesh(comm: DistComm, mesh) -> None:
    """The reference's checks of ``mesh=`` against a ShardMapComm."""
    if mesh is None:
        raise ValueError(
            "ft_allreduce_jit on ShardMapComm needs mesh= (the Mesh "
            "whose axis the comm permutes over) to build the enclosing "
            "shard_map program"
        )
    if comm.axis not in mesh.axis_names:
        raise ValueError(
            f"mesh axes {mesh.axis_names} do not include comm axis "
            f"{comm.axis!r}"
        )
    if mesh.shape[comm.axis] != comm.n_ranks:
        raise ValueError(
            f"mesh axis {comm.axis!r} has {mesh.shape[comm.axis]} "
            f"devices but comm.n_ranks={comm.n_ranks}"
        )


def ft_allreduce_jit(
    x,
    comm: Comm,
    *,
    op: Combiner | str = "sum",
    variant: str = "redundant",
    fault_spec: FaultSpec | None = None,
    plan: Plan | None = None,
    fast: bool | None = None,
    mesh=None,
):
    """:func:`ft_allreduce` as a cached program.  A repeat call with the same
    statics builds nothing: ``trace_count("ft_allreduce")`` stays put, and
    each call counts one ``ft_allreduce`` dispatch.

    * :class:`~repro_torch.collective.comm.SimComm` — ``x`` carries the
      leading ``(P,)`` axis; one program per (comm, plan, combiner, payload
      structure) and the payload's shapes, dtypes and device
      (:mod:`repro_torch.replay`; a CUDA graph on the card), its result
      equal to :func:`ft_allreduce`'s bit for bit.  ``mesh`` is ignored.
    * :class:`~repro_torch.collective.comm.DistComm` (``ShardMapComm``) —
      pass ``mesh=`` (a :class:`~repro_torch.collective.dist.RankMesh`),
      checked as the reference checks it.  ``x`` is this rank's ``(1, …)``
      slice of the reference's ``(P, …)``-leading payload, and so is the
      result: concatenated over the ranks, the reference's.  One program
      per (mesh, comm, plan, combiner, fast) and payload signature
      (:mod:`repro_torch.replay`), run eagerly: a host-staged exchange
      cannot be captured in a CUDA graph.
    """
    if plan is None:
        plan = make_plan(variant, comm.n_ranks, fault_spec)
    combiner = get_combiner(op)
    check_device(x, comm)
    struct = structure(x)
    if isinstance(comm, SimComm):
        def body(*flat):
            return ft_allreduce(unflatten(struct, flat), comm, op=combiner, plan=plan, fast=fast)

        _dispatch.note_dispatch("ft_allreduce")
        return replay.run("ft_allreduce", (comm, plan, combiner, fast), body, tuple(leaves(x)),
                          layout=struct)
    if not isinstance(comm, DistComm):
        raise ValueError(
            f"ft_allreduce_jit supports SimComm and ShardMapComm, got "
            f"{type(comm).__name__}"
        )
    _check_mesh(comm, mesh)
    for leaf in leaves(x):
        if leaf.ndim == 0 or leaf.shape[0] != 1:
            raise ValueError(
                f"ft_allreduce_jit(mesh=...) takes this rank's (1, ...) slice of the "
                f"(P, ...)-leading payload; got a leaf of shape {tuple(leaf.shape)}"
            )

    def shard_body(*flat):
        local = tree_map(lambda leaf: leaf[0], unflatten(struct, flat))
        val, ok = ft_allreduce(local, comm, op=combiner, plan=plan, fast=fast)
        return tree_map(lambda leaf: leaf[None], val), ok[None]

    _dispatch.note_dispatch("ft_allreduce")
    return replay.run("ft_allreduce_shard", (mesh, comm, plan, combiner, fast), shard_body,
                      tuple(leaves(x)), layout=struct, trace="ft_allreduce", capture=False)
