"""Core library: fault-tolerant communication-avoiding TSQR (Coti 2015), the
back-compat facade of the port (the reference's :mod:`repro.core`).

The plan, route and validity machinery lives in
:mod:`repro_torch.collective`, the TSQR drivers in :mod:`repro_torch.qr`;
this package re-exports their names as the reference's ``repro.core`` does,
and keeps the numpy ground truth:

  * :mod:`repro_torch.core.tsqr` — a thin facade over :mod:`repro_torch.qr`
    (the TSQR result, the local QR functions, ``form_q``, the deprecated
    ``tsqr_sim``, ``tsqr_shard_map`` and ``tsqr_gram_shard_map`` shims);
  * :mod:`repro_torch.core.ref`  — numpy ground truth.

``ShardMapComm`` is :class:`~repro_torch.collective.comm.DistComm`: one
process a rank.
"""
from repro_torch.collective import (
    NEVER,
    FaultSpec,
    Plan,
    ShardMapComm,
    SimComm,
    Step,
    ft_allreduce,
    make_plan,
    tolerance,
    total_tolerance,
    within_tolerance,
)

from .tsqr import TSQRResult, form_q, tsqr_gram_shard_map, tsqr_shard_map, tsqr_sim

__all__ = [
    "NEVER",
    "FaultSpec",
    "Plan",
    "Step",
    "ShardMapComm",
    "SimComm",
    "TSQRResult",
    "form_q",
    "ft_allreduce",
    "make_plan",
    "tolerance",
    "total_tolerance",
    "tsqr_gram_shard_map",
    "tsqr_shard_map",
    "tsqr_sim",
    "within_tolerance",
]
