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

All P ranks live on one device with a leading (P,) axis
(:class:`~repro_torch.collective.comm.SimComm`), so each CholeskyQR2 sweep
is one kernel launch for every rank.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.collective.comm import SimComm
from repro_torch.collective.faults import FaultSpec
from repro_torch.collective.plan import Plan, make_plan

from .api import QRConfig

__all__ = ["TSQRResult"]


@dataclasses.dataclass
class TSQRResult:
    """Per-rank outcome of a fault-tolerant TSQR.

    ``r``        — (P, n, n), or (B, P, n, n) for a batch.
    ``valid``    — who holds a correct final R (the paper's semantics).
    ``q``        — optional per-rank (m_local, n) orthonormal factor.
    ``plan``     — the communication plan that was executed.
    """

    r: torch.Tensor
    valid: torch.Tensor
    q: torch.Tensor | None
    plan: Plan


def _check_compute_q(config: QRConfig, plan: Plan) -> None:
    if config.compute_q and not plan.final_valid.all():
        raise ValueError(
            "compute_q requires an all-valid plan (fault-free, or "
            "self-healing within tolerance); got final_valid="
            f"{plan.final_valid}"
        )


def _factorize_sim(a_blocks: torch.Tensor, config: QRConfig, *,
                   fault_spec: FaultSpec | None = None) -> TSQRResult:
    """``a_blocks`` is (P, m_local, n) on the target device."""
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
    """B independent fault-free TSQRs of a (B, P, m_local, n) stack.

    The rank axis is moved to the front (one copy of the stack), so the
    engine sees (P, B, m_local, n) payloads and every kernel sweep covers
    all B·P blocks in one launch.
    """
    b, p = a_batch.shape[:2]
    plan = make_plan(config.variant, p)
    _check_compute_q(config, plan)
    ranks_first = a_batch.transpose(0, 1).contiguous()
    comm = SimComm(p, a_batch.device)
    pf = config.factorizer()
    r, valid = pf.reduce_r(ranks_first, comm, plan)
    q = None
    if config.compute_q:
        q, r = pf.form_q(ranks_first, r, comm)
        q = q.transpose(0, 1).contiguous()
    return TSQRResult(
        r=r.transpose(0, 1).contiguous(), valid=valid.expand(b, p).clone(),
        q=q, plan=plan,
    )
