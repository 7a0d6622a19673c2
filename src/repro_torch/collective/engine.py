"""The plan-driven, fault-tolerant butterfly-collective engine.

:func:`execute_plan` runs any :class:`~repro_torch.collective.plan.Plan`
(tree / redundant / replace / selfhealing) with any
:class:`~repro_torch.collective.combiners.Combiner`, threading validity bits
alongside every payload and performing the Self-Healing restore rounds.
:func:`ft_allreduce` is the entry point for arithmetic reductions over the
same butterfly, and :func:`ft_allreduce_jit` the same reduction as a cached
program (:mod:`repro_torch.replay`: a CUDA graph on the card).

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
from .comm import Comm, SimComm, check_device
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

    ``x`` is a tree of per-rank payloads with a leading (P,) axis.
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
    """:func:`ft_allreduce` as a cached program: one per (comm, plan,
    combiner, payload structure) and the payload's shapes, dtypes and
    device (:mod:`repro_torch.replay`; a CUDA graph on the card).  A repeat
    call with the same statics builds nothing: ``trace_count("ft_allreduce")``
    stays put, and each call counts one ``ft_allreduce`` dispatch.  Its
    result equals :func:`ft_allreduce`'s bit for bit.  SimComm only: a mesh
    runs the ranks as separate processes, which waits for DistComm."""
    if mesh is not None:
        raise NotImplementedError(
            "ft_allreduce_jit(mesh=...) runs the butterfly across processes, which "
            "waits for DistComm (ROADMAP A.3b); pass a SimComm"
        )
    if not isinstance(comm, SimComm):
        raise ValueError(
            f"ft_allreduce_jit builds a standalone program, which only the SimComm "
            f"backend supports; got {type(comm).__name__}"
        )
    if plan is None:
        plan = make_plan(variant, comm.n_ranks, fault_spec)
    combiner = get_combiner(op)
    check_device(x, comm)
    struct = structure(x)

    def body(*flat):
        return ft_allreduce(unflatten(struct, flat), comm, op=combiner, plan=plan, fast=fast)

    _dispatch.note_dispatch("ft_allreduce")
    return replay.run("ft_allreduce", (comm, plan, combiner, fast), body, tuple(leaves(x)),
                      layout=struct)
