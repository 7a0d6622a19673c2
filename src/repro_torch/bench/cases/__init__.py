"""Registered benchmark cases on the port (the port of
:mod:`repro.bench.cases`).

Importing this package registers every case of the reference's registry —
the fourteen case modules, ``tsqr_local_qr`` (registered by
``tsqr_scaling``) and the fault-scenario sweep — in
:data:`repro_torch.bench.registry.REGISTRY`.  Every case takes ``device``
(``None``: the card).
"""
from .. import scenarios  # noqa: F401  — registers fault_scenarios
from . import (  # noqa: F401
    autotune,
    coded,
    comm_volume,
    dispatch,
    general_qr,
    kernels,
    overlap,
    powersgd,
    robustness,
    roofline,
    semantics,
    serving,
    training,
    tsqr_scaling,
)
