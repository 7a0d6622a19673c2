"""Fault-tolerant butterfly collectives on PyTorch tensors.

The port of :mod:`repro.collective`: the fail-stop fault model and the
paper's 2^s − 1 tolerance accounting (:mod:`.faults`), host-side routing
for the four variants (:mod:`.plan`), the combine algebra
(:mod:`.combiners`), the simulated-ranks and one-process-per-rank backends
(:mod:`.comm`; the rank world of the latter in :mod:`.dist`), and the
plan executor with validity threading and self-healing restores
(:mod:`.engine`), and checksum-coded redundancy (:mod:`.coded`); each
all-reduce also as a cached program (``ft_allreduce_jit``,
``coded_allreduce_jit``).
"""
from .combiners import (
    COMBINERS,
    Combiner,
    GramSumCombiner,
    MaxCombiner,
    MeanCombiner,
    QRCombiner,
    StackedCombiner,
    SumCombiner,
    get_combiner,
    posdiag,
    qr_r,
    stacked,
)
from .coded import (
    CodedCombiner,
    CodedPlan,
    coded_allreduce,
    coded_allreduce_jit,
    coded_weights,
    encode_parity,
    execute_coded,
    make_coded_plan,
    reconstruction_tol,
)
from .comm import Comm, DistComm, ShardMapComm, SimComm
from .engine import (
    execute_plan,
    ft_allreduce,
    ft_allreduce_jit,
    recover_payload,
    replica_fetch,
)
from .faults import (
    NEVER,
    FaultSpec,
    sample_within_tolerance,
    tolerance,
    total_tolerance,
    within_tolerance,
)
from .instrument import CommStats, InstrumentedComm
from .packing import pack_sym, unpack_sym
from .plan import VARIANTS, Plan, Step, ilog2, leaf_bytes, make_plan, payload_numel

__all__ = [
    "COMBINERS",
    "CodedCombiner",
    "CodedPlan",
    "Comm",
    "CommStats",
    "Combiner",
    "DistComm",
    "FaultSpec",
    "GramSumCombiner",
    "InstrumentedComm",
    "MaxCombiner",
    "MeanCombiner",
    "NEVER",
    "Plan",
    "QRCombiner",
    "ShardMapComm",
    "SimComm",
    "StackedCombiner",
    "Step",
    "SumCombiner",
    "VARIANTS",
    "coded_allreduce",
    "coded_allreduce_jit",
    "coded_weights",
    "encode_parity",
    "execute_coded",
    "execute_plan",
    "ft_allreduce",
    "ft_allreduce_jit",
    "get_combiner",
    "ilog2",
    "leaf_bytes",
    "make_coded_plan",
    "make_plan",
    "pack_sym",
    "payload_numel",
    "posdiag",
    "qr_r",
    "reconstruction_tol",
    "recover_payload",
    "replica_fetch",
    "sample_within_tolerance",
    "stacked",
    "tolerance",
    "total_tolerance",
    "unpack_sym",
    "within_tolerance",
]
