"""TSQR on the collective engine: :mod:`.panel` (local QR choice, butterfly R
reduction, explicit Q), :mod:`.tsqr` (the paper's tall-and-skinny workload)
and the :mod:`.api` facade (:class:`QRConfig` + :func:`factorize`)."""
from .api import Fuse, Pipeline, QRConfig, Recover, Redundancy, factorize
from .panel import PanelFactorizer, chol_r, form_q, local_qr_fns
from .tsqr import TSQRResult

__all__ = [
    "Fuse",
    "PanelFactorizer",
    "Pipeline",
    "QRConfig",
    "Recover",
    "Redundancy",
    "TSQRResult",
    "chol_r",
    "factorize",
    "form_q",
    "local_qr_fns",
]
