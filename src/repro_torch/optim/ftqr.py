"""In-step fault-tolerant CholeskyQR2 for the optimizers.

The port of :mod:`repro.optim.ftqr`: the same CQR2 numerics as
:func:`repro_torch.optim.lowrank.gram_cqr2_q`, but every Gram sum rides
the collective engine's redundant butterfly
(:func:`~repro_torch.collective.engine.ft_allreduce`, ``gram_sum``
combiner) over an explicit shard axis on a :class:`SimComm` on the input's
device, so each of the two orthogonalization rounds inherits the 2^s − 1
mid-reduce tolerance.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.collective import SimComm, ft_allreduce, make_plan

from .lowrank import _cqr_round, _gram, gram_cqr2_q

__all__ = ["ft_cqr2_q"]


def _distribute_rows(x, shards: int):
    """(…, m, n) → (shards, …, m_loc, n) with zero-row padding.  Exact for
    CQR2: zero rows contribute nothing to the Gram and Q = A·R⁻¹ maps them
    back to zero rows."""
    *lead, m, n = x.shape
    pad = (-m) % shards
    if pad:
        x = torch.cat([x, x.new_zeros((*lead, pad, n))], dim=-2)
    x = x.reshape(*lead, shards, (m + pad) // shards, n)
    return torch.movedim(x, -3, 0)


def ft_cqr2_q(a, shards: int, plan=None):
    """CholeskyQR2 Q factor of ``a`` (…, m, n); Gram sums on the butterfly.

    Rows are split into ``shards`` contiguous blocks (the SimComm rank
    axis); each round's n×n Gram is combined with
    ``ft_allreduce(op="gram_sum")`` and read from a plan-certified slot.
    ``plan`` defaults to the fault-free redundant plan; an injected
    :class:`~repro_torch.collective.plan.Plan` exercises mid-reduce deaths
    and raises ``ValueError`` when no slot holds the sum.  ``shards <= 1``
    is :func:`gram_cqr2_q`.
    """
    if shards <= 1:
        return gram_cqr2_q(a)
    comm = SimComm(shards, a.device)
    if plan is None:
        plan = make_plan("redundant", shards, None)
    if not plan.final_valid.any():
        raise ValueError(
            "plan exceeds the butterfly's tolerance: no shard slot holds "
            f"the Gram sum (final_valid={plan.final_valid})"
        )
    slot = int(np.argmax(plan.final_valid))

    def round_(x):
        xd = _distribute_rows(x, shards)
        g_sum, _ = ft_allreduce(_gram(xd), comm, op="gram_sum", plan=plan)
        return _cqr_round(x, g_sum[slot])

    return round_(round_(a.to(torch.float32)))
