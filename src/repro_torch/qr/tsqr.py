"""Fault-tolerant, communication-avoiding TSQR (Coti 2015) on simulated ranks.

The tall-and-skinny workload of the paper: one panel — the whole matrix —
factored by the collective engine with the QR combiner under one of the
four variants:

  * ``tree``        — Alg. 1, the baseline reduction tree (zero redundancy);
  * ``redundant``   — Alg. 2, butterfly *exchange*: both buddies combine, so
                      every intermediate R̃ exists in ``2^s`` copies;
  * ``replace``     — Alg. 3, reroutes to a replica of a dead buddy;
  * ``selfhealing`` — Alg. 4–6, additionally respawns dead ranks from a
                      replica at every level.

On simulated ranks all P ranks live on one device with a leading (P,)
axis (:class:`~repro_torch.collective.comm.SimComm`), so each CholeskyQR2
sweep is one kernel launch for every rank.  Under ``mesh=`` each rank is a
process (:class:`~repro_torch.collective.comm.DistComm`) factoring its own
``(m_local, n)`` block, and the exchanges cross processes: the
reference's production path, with the Gram-butterfly TSQR
(``gram=True``) beside it.  Each mesh route is one cached per-rank program
(:mod:`repro_torch.qr._shard`) per statics, counted as the reference's
``tsqr_shard_map`` / ``tsqr_gram_shard_map`` traces and dispatches.

``redundancy="coded"`` replaces the butterfly by the checksum-coded
reduction (:mod:`repro_torch.collective.coded`): ``parity`` checksum ranks
join the P data ranks, and up to ``parity`` dead, straggling or corrupted
contributions are reconstructed from parity inside the collective, with
declared corruptions verified (``detected``).

The batched TSQR is one cached program per (P, canonical config) and input
shape (:mod:`repro_torch.replay`): a CUDA graph on the card, counted as the
``tsqr_batched`` trace and dispatch.  The coded TSQR counts its program per
(canonical config, coded plan) under ``tsqr_coded``, as the reference's
jitted one does, and runs eagerly, like every coded and faulted call.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import replay
from repro_torch.collective.coded import CodedPlan, execute_coded, make_coded_plan
from repro_torch.collective.comm import Comm, DistComm, SimComm
from repro_torch.collective.engine import ft_allreduce
from repro_torch.collective.faults import FaultSpec
from repro_torch.collective.plan import Plan, make_plan
from repro_torch.kernels import dispatch as _dispatch

from ._shard import dummy_q
from .api import (
    QRConfig,
    Redundancy,
    _as_tensor,
    _mesh_block,
    resolve_device,
    warn_deprecated_entry,
)
from .panel import chol_r, chunked_gram, form_q

__all__ = ["TSQRResult", "tsqr_gram_shard_map", "tsqr_shard_map", "tsqr_sim"]


@dataclasses.dataclass
class TSQRResult:
    """Per-rank outcome of a fault-tolerant TSQR.

    ``r``        — (P, n, n), (B, P, n, n) for a batch, or under ``mesh=``
                   this rank's (1, n, n).
    ``valid``    — who holds a correct final R (the paper's semantics):
                   (P,), (B, P), or this rank's (1,).
    ``q``        — optional per-rank (m_local, n) orthonormal factor.
    ``plan``     — the communication plan that was executed: a butterfly
                   :class:`~repro_torch.collective.plan.Plan` or a
                   :class:`~repro_torch.collective.coded.CodedPlan`.
    ``detected`` — coded runs only: (P,) device bool flagging ranks whose
                   payload failed checksum verification.
    """

    r: torch.Tensor
    valid: torch.Tensor
    q: torch.Tensor | None
    plan: Plan | CodedPlan
    detected: torch.Tensor | None = None


def _check_compute_q(config: QRConfig, plan: Plan) -> None:
    if config.compute_q and not plan.final_valid.all():
        raise ValueError(
            "compute_q requires an all-valid plan (fault-free, or "
            "self-healing within tolerance); got final_valid="
            f"{plan.final_valid}"
        )


def _factorize_sim_coded(a_blocks: torch.Tensor, config: QRConfig, fault_spec,
                         observed) -> TSQRResult:
    """Checksum-coded TSQR: ``config.parity`` checksum ranks beside the P
    data blocks; the local QR runs on the P data blocks in one launch per
    sweep (``observed`` adds a second one: its blocks are what the data
    ranks contribute, while parity encodes ``a_blocks``)."""
    p = a_blocks.shape[0]
    plan = make_coded_plan(p, config.parity, fault_spec)
    if config.compute_q and not plan.final_valid[:p].all():
        raise ValueError(
            "compute_q requires every data rank to end valid; this fault "
            f"spec exceeds the coded erasure budget (c={config.parity}) — "
            f"final_valid={plan.final_valid[:p]}"
        )
    pf = config.factorizer()
    world = SimComm(plan.n_ranks, a_blocks.device)
    if observed is not None:
        observed = _as_tensor(observed, a_blocks.device)

    def body(a, observed):
        val, fv, det = execute_coded(a, world, plan, pf.combiner(), observed=observed)
        r, valid, detected = val[:p], fv[:p], det[:p]
        q = None
        if config.compute_q:
            q, r = pf.form_q(a, r, SimComm(p, a.device))
        return r, valid, q, detected

    _dispatch.note_dispatch("tsqr_coded")
    with replay.eager():
        r, valid, q, detected = replay.run("tsqr_coded", (config.canonical(), plan), body,
                                           (a_blocks, observed))
    return TSQRResult(r=r, valid=valid, q=q, plan=plan, detected=detected)


def _factorize_sim(a_blocks: torch.Tensor, config: QRConfig, *,
                   fault_spec: FaultSpec | None = None, observed=None) -> TSQRResult:
    """``a_blocks`` is (P, m_local, n) on the target device.

    ``observed`` (coded runs only) is what the data ranks hold now: parity
    is encoded from ``a_blocks``, the distribution-time truth, so silent
    corruption is injected by perturbing ``observed`` and the checksum
    verification catches the divergence.
    """
    if config.redundancy is Redundancy.CODED:
        return _factorize_sim_coded(a_blocks, config, fault_spec, observed)
    if observed is not None:
        raise ValueError(
            "observed= models silently-corrupted payloads, which only the "
            "coded scheme can act on; use redundancy='coded'"
        )
    p = a_blocks.shape[0]
    plan = make_plan(config.variant, p, fault_spec)
    _check_compute_q(config, plan)
    comm = SimComm(p, a_blocks.device)
    pf = config.factorizer()
    r, valid = pf.reduce_r(a_blocks, comm, plan)
    q = None
    if config.compute_q:
        q, r = pf.form_q(a_blocks, r, comm)
    return TSQRResult(r=r, valid=valid, q=q, plan=plan)


def _factorize_batched(a_batch: torch.Tensor, config: QRConfig) -> TSQRResult:
    """B independent fault-free TSQRs of a (B, P, m_local, n) stack in one
    cached program.

    The rank axis is moved to the front inside it (one copy of the stack),
    so the engine sees (P, B, m_local, n) payloads and every kernel sweep
    covers all B·P blocks in one launch.
    """
    b, p = a_batch.shape[:2]
    plan = make_plan(config.variant, p)
    _check_compute_q(config, plan)
    comm = SimComm(p, a_batch.device)
    pf = config.factorizer()

    def body(a):
        ranks_first = a.transpose(0, 1).contiguous()
        r, valid = pf.reduce_r(ranks_first, comm, plan)
        q = None
        if config.compute_q:
            q, r = pf.form_q(ranks_first, r, comm)
            q = q.transpose(0, 1).contiguous()
        return r.transpose(0, 1).contiguous(), valid.expand(b, p).clone(), q

    _dispatch.note_dispatch("tsqr_batched")
    r, valid, q = replay.run("tsqr_batched", (p, config.canonical()), body, (a_batch,))
    return TSQRResult(r=r, valid=valid, q=q, plan=plan)


def _mesh_comm(mesh, axis: str, block: torch.Tensor) -> tuple[int, DistComm]:
    p = mesh.shape[axis]
    return p, DistComm(p, axis, mesh.group, block.device)


def _factorize_shard(block: torch.Tensor, config: QRConfig, *, mesh, axis: str,
                     fault_spec: FaultSpec | None = None) -> TSQRResult:
    """The production path: ``block`` is this rank's (m_local, n) rows of A,
    row-distributed over ``mesh`` axis ``axis``.

    Returns this rank's r (1, n, n) (a copy of R where valid), valid (1,)
    and q (m_local, n) or None.  The plan is host-computed from
    ``fault_spec`` on every rank alike."""
    p, comm = _mesh_comm(mesh, axis, block)
    plan = make_plan(config.variant, p, fault_spec)
    if config.compute_q and not plan.final_valid.all():
        raise ValueError(
            "compute_q requires an all-valid plan (fault-free, or "
            "self-healing within tolerance)"
        )
    pf = config.factorizer()
    want_q = config.compute_q

    def body(a_blk):
        r, valid = pf.reduce_r(a_blk, comm, plan)
        q = None
        if want_q:
            q, r = pf.form_q(a_blk, r, comm)
        return r[None], valid[None], q if want_q else dummy_q(a_blk)

    _dispatch.note_dispatch("tsqr_shard_map")
    r, valid, q = replay.run("tsqr_shard_map", (mesh, axis, plan, pf, want_q), body, (block,),
                             capture=False)
    return TSQRResult(r=r, valid=valid, q=q if want_q else None, plan=plan)


def gram_tsqr(a: torch.Tensor, comm: Comm, reorth: int = 1):
    """The Gram butterfly on either backend: the float32 Gram of each
    rank's rows (:func:`~repro_torch.qr.panel.chunked_gram`), a
    ``gram_sum`` all-reduce over the redundant butterfly, the Cholesky R
    with a positive diagonal, then ``reorth`` CholeskyQR polish passes in
    :func:`~repro_torch.qr.panel.form_q`.  Returns ``(r, q)``.

    Per level the combine is an n×n add instead of a QR of a stacked 2n×n
    pair, and the wire carries the n(n+1)/2 triangle.  κ(A)² enters the
    Gram, so the polish pass is what makes Q orthonormal; certified for
    κ(A) ≲ 1/√ε, like CholeskyQR2."""
    g, _ = ft_allreduce(chunked_gram(a), comm, op="gram_sum")
    q, r = form_q(a, chol_r(g), comm, reorth)
    return r, q


def _factorize_gram_shard(block: torch.Tensor, config: QRConfig, *, mesh,
                          axis: str) -> TSQRResult:
    """The Gram-butterfly TSQR on this rank's (m_local, n) block
    (:func:`gram_tsqr`), fault-free by construction: valid (1,) is true and
    the plan is the redundant one the all-reduce rides."""
    p, comm = _mesh_comm(mesh, axis, block)

    def body(a_blk):
        r, q = gram_tsqr(a_blk, comm, config.reorth)
        return r[None], q

    _dispatch.note_dispatch("tsqr_gram_shard_map")
    r, q = replay.run("tsqr_gram_shard_map", (mesh, axis, p, config.reorth), body,
                      (block,), capture=False)
    return TSQRResult(r=r, valid=torch.ones((1,), dtype=torch.bool, device=block.device), q=q,
                      plan=make_plan("redundant", p))


# ---------------------------------------------------------------------------
# Legacy kwarg entry points (deprecated shims over the implementations)
# ---------------------------------------------------------------------------

def tsqr_sim(a_blocks, *, variant: str = "redundant", fault_spec: FaultSpec | None = None,
             compute_q: bool = False, reorth: int = 1, local_qr="jnp",
             device=None) -> TSQRResult:
    """Deprecated kwarg shim — build a :class:`~repro_torch.qr.api.QRConfig`
    (``panel_width=None`` selects TSQR) and call
    :func:`repro_torch.qr.api.factorize` on the (P, m_local, n) row blocks
    instead; the results are bit for bit the same (this delegates to the
    same implementation).  ``a_blocks`` is a numpy array or a tensor, moved
    to ``device`` (``None``: the card)."""
    warn_deprecated_entry("tsqr_sim")
    config = QRConfig(panel_width=None, variant=variant, local_r=local_qr, reorth=reorth,
                      compute_q=compute_q)
    return _factorize_sim(_as_tensor(a_blocks, resolve_device(device)), config,
                          fault_spec=fault_spec)


def tsqr_gram_shard_map(a_local, *, mesh, axis: str, reorth: int = 1, device=None) -> TSQRResult:
    """Deprecated kwarg shim — build a :class:`~repro_torch.qr.api.QRConfig`
    with ``gram=True`` and call :func:`repro_torch.qr.api.factorize` with
    ``mesh=`` instead (the same driver, the same bits).  ``a_local`` is this
    rank's (m_local, n) block."""
    warn_deprecated_entry("tsqr_gram_shard_map")
    config = QRConfig(panel_width=None, gram=True, reorth=reorth)
    return _factorize_gram_shard(_mesh_block(a_local, mesh, device), config, mesh=mesh, axis=axis)


def tsqr_shard_map(a_local, *, mesh, axis: str, variant: str = "redundant",
                   fault_spec: FaultSpec | None = None, compute_q: bool = False, reorth: int = 1,
                   local_qr="jnp", device=None) -> TSQRResult:
    """Deprecated kwarg shim — build a :class:`~repro_torch.qr.api.QRConfig`
    (``panel_width=None``) and call :func:`repro_torch.qr.api.factorize`
    with ``mesh=``/``axis=`` instead (the same driver, the same bits).
    ``a_local`` is this rank's (m_local, n) block."""
    warn_deprecated_entry("tsqr_shard_map")
    config = QRConfig(panel_width=None, variant=variant, local_r=local_qr, reorth=reorth,
                      compute_q=compute_q)
    return _factorize_shard(_mesh_block(a_local, mesh, device), config, mesh=mesh, axis=axis,
                            fault_spec=fault_spec)
