"""QR on the collective engine: :mod:`.panel` (local QR choice, butterfly R
reduction, explicit Q), :mod:`.tsqr` (the paper's tall-and-skinny workload),
:mod:`.blocked` (the fault-tolerant blocked QR of general matrices) and the
:mod:`.api` facade (:class:`QRConfig` + :func:`factorize`).  The reference's kwarg entry
points ``tsqr_sim``, ``blocked_qr_sim``, ``blocked_qr_batched`` and the
mesh shims ``tsqr_shard_map``, ``tsqr_gram_shard_map`` and
``blocked_qr_shard_map`` (one process a rank,
:class:`~repro_torch.collective.comm.DistComm`) remain as deprecated
shims."""
from .api import Fuse, Pipeline, QRConfig, Recover, Redundancy, factorize
from .blocked import (
    BlockedQRResult,
    PanelFaultSchedule,
    PanelReport,
    blocked_qr_batched,
    blocked_qr_shard_map,
    blocked_qr_sim,
    panel_widths,
)
from .panel import PanelFactorizer, chol_r, form_q, local_qr_fns
from .tsqr import TSQRResult, tsqr_gram_shard_map, tsqr_shard_map, tsqr_sim

__all__ = [
    "BlockedQRResult",
    "Fuse",
    "PanelFactorizer",
    "PanelFaultSchedule",
    "PanelReport",
    "Pipeline",
    "QRConfig",
    "Recover",
    "Redundancy",
    "TSQRResult",
    "blocked_qr_batched",
    "blocked_qr_shard_map",
    "blocked_qr_sim",
    "chol_r",
    "factorize",
    "form_q",
    "local_qr_fns",
    "panel_widths",
    "tsqr_gram_shard_map",
    "tsqr_shard_map",
    "tsqr_sim",
]
