"""Back-compat facade (the reference's :mod:`repro.core.tsqr`): the TSQR
implementation lives in :mod:`repro_torch.qr`.

The panel-local machinery (local QR functions, ``form_q``) is
:mod:`repro_torch.qr.panel`'s, the TSQR entry points
:mod:`repro_torch.qr.tsqr`'s.  Import from :mod:`repro_torch.qr` in new
code; every name the reference's facade exports is re-exported below.
"""
from repro_torch.collective.combiners import qr_r as qr_r_jnp  # noqa: F401
from repro_torch.qr.panel import (  # noqa: F401
    form_q,
    local_qr_fns,
    qr_r_cqr2,
    qr_r_cqr2_pallas,
    resolve_local_qr as _resolve_local_qr,
)
from repro_torch.qr.tsqr import (  # noqa: F401
    TSQRResult,
    tsqr_gram_shard_map,
    tsqr_shard_map,
    tsqr_sim,
)

__all__ = [
    "TSQRResult",
    "tsqr_sim",
    "tsqr_shard_map",
    "tsqr_gram_shard_map",
    "form_q",
    "local_qr_fns",
]
