"""PowerSGD gradient compression with fault-tolerant TSQR orthogonalization.

The port of :mod:`repro.optim.powersgd`.  For a 2D gradient block G (rows
spread over the *model* ranks, distinct values per *data* replica), one
compression round:

  1. ``P_loc = G @ Q``                       (m_loc × r, per replica)
  2. ``P̄ = psum_data(P_loc) / D``            — r columns on the data axis
     instead of n
  3. ``P̂, _ = FT-TSQR(P̄)`` over the model ranks — the redundant butterfly
     gives every rank the same R and tolerates 2^s − 1 deaths; Q̂ = P̄·R⁻¹
     locally, polished by a Gram all-reduce on the same butterfly
  4. ``S̄ = psum_data(psum_model(Gᵀ @ P̂)) / D``
  5. ``Ĝ = P̂ @ S̄ᵀ`` — rank-r approximation of the data-mean gradient
  6. error feedback: ``e ← G − Ĝ`` folded into the next step's G.

Data-axis bytes per step: r·(m+n)·4 instead of m·n·4.

Written against :class:`~repro_torch.collective.comm.Comm`: on a
:class:`SimComm` the ranks are a leading (P,) axis, on the gradient's
device; across processes each rank passes its own block,
``ShardMapComm(M, "model")`` over its model line and the axis sums of a
data × model mesh (:func:`repro_torch.collective.dist.psum`), as the
reference runs it under ``shard_map`` (``python -m
repro_torch.launch.powersgd_dp``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.collective import (
    Comm,
    FaultSpec,
    QRCombiner,
    SimComm,
    execute_plan,
    ft_allreduce,
    make_plan,
)
from repro_torch.collective.comm import resolve_device
from repro_torch.qr.panel import form_q, local_qr_fns

from .lowrank import gram_cqr2_q

__all__ = ["PowerSGDConfig", "init_state", "compress_grad", "compress_mean_grad"]


@dataclasses.dataclass(frozen=True)
class PowerSGDConfig:
    rank: int = 8
    error_feedback: bool = True
    variant: str = "redundant"          # which FT-TSQR drives step 3
    reorth: int = 1


def init_state(generator: torch.Generator, shape, cfg: PowerSGDConfig, leading=(), *,
               device=None):
    """Q (n, r) start basis + error buffer for a (m, n) gradient, on
    ``device`` (``None``: the card), Q drawn from ``generator`` (a
    generator on that device).

    ``leading`` adds SimComm rank axes; the basis is *broadcast* (every
    rank must start from the identical Q — a per-rank random basis makes
    P̄ = G·Q meaningless)."""
    device = resolve_device(device)
    m, n = shape
    q = torch.randn((n, cfg.rank), generator=generator, dtype=torch.float32, device=device)
    q = q.expand(*leading, n, cfg.rank) if leading else q
    e = (torch.zeros((*leading, m, n), dtype=torch.float32, device=device)
         if cfg.error_feedback else None)
    return {"q": q, "e": e}


def _ft_tsqr_q(p_bar, comm: Comm, cfg: PowerSGDConfig, fault_spec):
    """Orthonormalize the row-distributed P̄ via the paper's butterfly
    (plan → execute with the QR combiner → form_q)."""
    plan = make_plan(cfg.variant, comm.n_ranks, fault_spec)
    r, valid = execute_plan(p_bar, comm, plan, QRCombiner(local_qr_fns["jnp"]))
    q, _ = form_q(p_bar, r, comm, cfg.reorth)
    return q, valid


def compress_grad(
    g, state, comm_model: Comm, *,
    cfg: PowerSGDConfig,
    psum_data,
    psum_model,
    n_data: int,
    fault_spec: FaultSpec | None = None,
):
    """One PowerSGD round.  ``g``: per-rank (P, m_loc, n) blocks on a
    SimComm, or this rank's (m_loc, n) block on a ``DistComm`` over the
    model line; distinct per data replica.  ``psum_data`` / ``psum_model``:
    axis sums (``dist.psum(v, "data", mesh)`` across processes, which every
    rank of a line gets as the same bits, so ĝ is the same on every data
    replica).  Returns (ĝ, new_state, stats) with ĝ the decompressed mean
    gradient and ``stats["valid"]`` the butterfly's validity bits (this
    rank's across processes).
    """
    gf = g.to(torch.float32)
    if cfg.error_feedback and state["e"] is not None:
        gf = gf + state["e"]
    p_loc = gf @ state["q"]                       # (m_loc, r)
    p_bar = psum_data(p_loc) / n_data
    q_hat, valid = _ft_tsqr_q(p_bar, comm_model, cfg, fault_spec)
    s_loc = gf.mT @ q_hat                         # (n, r), partial over rows
    s_bar = psum_data(psum_model(s_loc)) / n_data  # full data+model reduction
    g_hat = q_hat @ s_bar.mT                      # (m_loc, n)
    new_e = gf - g_hat if cfg.error_feedback else None
    new_state = {"q": s_bar, "e": new_e}
    m, n = g.shape[-2], g.shape[-1]
    stats = {
        "data_bytes_compressed": 4 * cfg.rank * (m * comm_model.n_ranks + n),
        "data_bytes_dense": 4 * m * comm_model.n_ranks * n,
        "valid": valid,
    }
    return g_hat.to(g.dtype), new_state, stats


def compress_mean_grad(
    g_rep, q, *, cfg: PowerSGDConfig, comm: Comm | None = None,
    plan=None, n_live=None, ft: bool = True,
):
    """One PowerSGD round over an explicit *replica* axis.

    ``g_rep`` is the (R, m, n) stack of per-replica (masked) gradients,
    ``q`` the shared (n, r) basis.  With ``ft`` every reduction over the
    replica axis — P̄, S̄, and the TSQR butterfly that orthogonalizes P̄ —
    rides :func:`~repro_torch.collective.engine.ft_allreduce` /
    :func:`~repro_torch.collective.engine.execute_plan` on a SimComm(R) on
    ``g_rep``'s device (the paper's 2^s − 1 tolerance at each), and P̄ is
    row-distributed over the R slots (zero-padded) so the butterfly
    replicas double as the TSQR ranks; ``plan`` injects deaths into the
    two means and raises ``ValueError`` when no slot holds the mean.
    ``ft=False`` is the dense baseline (plain axis sums, CQR2).  Returns
    ``(ĝ, new_q)`` with ĝ the (m, n) rank-r approximation of the
    live-replica mean gradient — exact when that mean has rank ≤ r and the
    basis spans its row space.  No error feedback.
    """
    R, m, n = g_rep.shape
    gf = g_rep.to(torch.float32)
    if n_live is None:
        n_live = float(R)
    if ft:
        if comm is None:
            comm = SimComm(R, g_rep.device)
        if plan is None:
            plan = make_plan(cfg.variant, R, None)
        if not plan.final_valid.any():
            raise ValueError(
                "plan exceeds the butterfly's tolerance: no replica slot "
                f"holds the mean (final_valid={plan.final_valid})"
            )
        slot = int(np.argmax(plan.final_valid))

        def rep_mean(x):
            s, _ = ft_allreduce(x, comm, op="sum", plan=plan)
            return s[slot] / n_live
    else:

        def rep_mean(x):
            return x.sum(0) / n_live

    r = q.shape[-1]
    p_bar = rep_mean(gf @ q)                      # (m, r) mean left factor
    if ft:
        pad = (-m) % R
        p_pad = torch.cat([p_bar, p_bar.new_zeros((pad, r))]) if pad else p_bar
        p_dist = p_pad.reshape(R, (m + pad) // R, r)
        q_dist, _ = _ft_tsqr_q(p_dist, comm, cfg, None)
        q_hat = q_dist.reshape(m + pad, r)[:m]
    else:
        q_hat = gram_cqr2_q(p_bar)
    s_bar = rep_mean(gf.mT @ q_hat)               # (n, r)
    g_hat = q_hat @ s_bar.mT                      # (m, n)
    return g_hat.to(g_rep.dtype), s_bar
