"""QR on the collective engine: :mod:`.panel` (local QR choice, butterfly R
reduction, explicit Q), :mod:`.tsqr` (the paper's tall-and-skinny workload),
:mod:`.blocked` (the fault-tolerant blocked QR of general matrices) and the
:mod:`.api` facade (:class:`QRConfig` + :func:`factorize`)."""
from .api import Fuse, Pipeline, QRConfig, Recover, Redundancy, factorize
from .blocked import BlockedQRResult, PanelFaultSchedule, PanelReport, panel_widths
from .panel import PanelFactorizer, chol_r, form_q, local_qr_fns
from .tsqr import TSQRResult

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
    "chol_r",
    "factorize",
    "form_q",
    "local_qr_fns",
    "panel_widths",
]
