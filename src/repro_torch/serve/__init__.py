"""QR-as-a-service on the port: shape-bucketed continuous batching over the
fault-tolerant factorization pipelines (the reference's :mod:`repro.serve`).

  * :mod:`repro_torch.serve.buckets`  — shape buckets (program classes) and
    the identity-extension request padding (numpy only).
  * :mod:`repro_torch.serve.planner`  — the deterministic cost model picking
    panel width, local-R variant and max batch size per bucket.
  * :mod:`repro_torch.serve.frontend` — :class:`QRServer`: async intake,
    continuous batching, pre-warm, and fault re-serve (requests whose
    batch hits an injected mid-flight death are re-served through the
    replica-recovering eager driver, never dropped).

On the card a bucket's drain is one CUDA-graph replay of the batched
pipeline (:mod:`repro_torch.replay`), and warm serving builds nothing.
"""
from .buckets import (
    BucketSpec,
    bucket_for,
    default_buckets,
    extract_r,
    filler_matrix,
    pad_request,
)
from .frontend import (
    PeriodicFaultInjector,
    QRRequest,
    QRResponse,
    QRServer,
    ServerStats,
)
from .planner import BucketPlan, CostModel, plan_bucket

__all__ = [
    "BucketPlan",
    "BucketSpec",
    "CostModel",
    "PeriodicFaultInjector",
    "QRRequest",
    "QRResponse",
    "QRServer",
    "ServerStats",
    "bucket_for",
    "default_buckets",
    "extract_r",
    "filler_matrix",
    "pad_request",
    "plan_bucket",
]
