"""Registered benchmark cases on the port (the first half of
:mod:`repro.bench.cases`).

Importing this package registers every ported case, the fault-scenario
sweep included, in :data:`repro_torch.bench.registry.REGISTRY`.  Every
case takes ``device`` (``None``: the card).
"""
from .. import scenarios  # noqa: F401  — registers fault_scenarios
from . import (  # noqa: F401
    autotune,
    coded,
    comm_volume,
    kernels,
    robustness,
    semantics,
    tsqr_scaling,
)
