"""Back-compat facade (the reference's :mod:`repro.core.tsqr`): the TSQR
implementation lives in :mod:`repro_torch.qr`.

The panel-local machinery (local QR functions, ``form_q``) is
:mod:`repro_torch.qr.panel`'s, the TSQR entry points
:mod:`repro_torch.qr.tsqr`'s.  Import from :mod:`repro_torch.qr` in new
code; the names the reference's facade exports are re-exported below, but
for its mesh shims, which wait for DistComm (ROADMAP A.3b).
"""
from repro_torch.collective.combiners import qr_r as qr_r_jnp  # noqa: F401
from repro_torch.qr.panel import (  # noqa: F401
    form_q,
    local_qr_fns,
    qr_r_cqr2,
    qr_r_cqr2_pallas,
    resolve_local_qr as _resolve_local_qr,
)
from repro_torch.qr.tsqr import TSQRResult, tsqr_sim  # noqa: F401

__all__ = [
    "TSQRResult",
    "tsqr_sim",
    "form_q",
    "local_qr_fns",
]
