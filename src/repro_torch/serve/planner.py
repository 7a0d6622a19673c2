"""Cost-aware bucket planning: panel width, local-R variant, batch size
(the port's :mod:`repro.serve.planner`, arithmetic unchanged).

The dispatcher's knobs should come from a model, not from hardcoded
defaults — the same shape-wise planning idea as torchrec's
``EmbeddingPerfEstimator`` (perf = comms + compute + HBM sweeps per
shard), instantiated on this repo's own accounting:

  * **Device-memory bytes** mirror ``repro_torch.qr.blocked._note_pipeline``
    exactly — the prime sweep (``pad_cross``) plus ``K − 1`` fused trailing
    sweeps at the padded maximal width.
  * **Collective rounds** mirror ``repro_torch.kernels.dispatch.note_rounds``:
    the fused schedule ships ONE stacked butterfly per panel, so a
    factorization costs ``K · log₂P`` serial rounds (Langou's
    single-reduce ideal per panel).
  * **Dispatch overhead** is amortized by continuous batching: the
    fixed-shape pipeline runs one program per *drain*, so per matrix it
    costs ``overhead / B``.

Every quantity is a pure function of ``(bucket, P, CostModel)`` — no
clocks, no measurements — so planning is deterministic and the decision
table (:meth:`BucketPlan.as_dict`, candidates included) is auditable after
the fact.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.qr.blocked import panel_widths

from .buckets import BucketSpec

__all__ = [
    "BucketPlan",
    "CostModel",
    "plan_bucket",
]

_F32 = 4  # serving payload itemsize


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Machine constants the planner prices against (defaults are
    order-of-magnitude host-CPU figures; a deployment would calibrate them
    from the roofline report, which measures exactly these quantities)."""

    mem_bw_bytes_per_s: float = 4.0e10
    flops_per_s: float = 2.0e11
    dispatch_overhead_s: float = 5.0e-5
    round_latency_s: float = 5.0e-6
    # Continuous-batching limits: padded payload bytes a drain may occupy,
    # and a cap keeping per-request queueing latency bounded.
    batch_bytes_budget: int = 1 << 28
    max_batch_cap: int = 16
    panel_width_candidates: tuple[int, ...] = (8, 16, 32, 64, 128)

    @classmethod
    def tuned(cls, **overrides) -> "CostModel":
        """A model fed from the installed autotune table's measured machine
        constants (the copy bandwidth and f32 rate of the tuner's probes,
        :func:`repro_torch.kernels.autotune.machine_constants`) instead of
        the static defaults.  With no table installed this is exactly
        ``CostModel()``.  Scheduling knobs keep their defaults unless
        overridden."""
        from repro_torch.kernels import autotune as _autotune

        mc = _autotune.machine_constants() or {}
        kw = {}
        if mc.get("mem_bw_bytes_per_s"):
            kw["mem_bw_bytes_per_s"] = float(mc["mem_bw_bytes_per_s"])
        if mc.get("flops_per_s"):
            kw["flops_per_s"] = float(mc["flops_per_s"])
        kw.update(overrides)
        return cls(**kw)


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """The planner's decision for one bucket, with its audit trail."""

    spec: BucketSpec
    panel_width: int
    local_r: str
    max_batch: int
    predicted_matrix_s: float     # per-matrix service time at full batch
    predicted_drain_s: float      # one drained batch, dispatch included
    candidates: tuple[tuple[int, str, float, bool], ...]
    # ^ every (panel_width, local_r, predicted_matrix_s, admissible) scored

    def as_dict(self) -> dict:
        return {
            "bucket": [self.spec.m_pad, self.spec.n_pad],
            "panel_width": self.panel_width,
            "local_r": self.local_r,
            "max_batch": self.max_batch,
            "predicted_matrix_s": self.predicted_matrix_s,
            "predicted_drain_s": self.predicted_drain_s,
            "candidates": [list(c) for c in self.candidates],
        }


def _pipeline_bytes(
    p: int, m_local: int, n: int, widths: tuple[int, ...]
) -> int:
    """HBM bytes of one scan-pipeline factorization — the same per-sweep
    formulas ``_note_pipeline`` records (prime + K−1 trailing sweeps at the
    padded maximal trailing width)."""
    b, k_panels = widths[0], len(widths)
    n_pad = b * k_panels
    total = p * m_local * n * _F32                      # prime read
    total += p * (m_local * n_pad * _F32 + b * n_pad * _F32)  # prime write
    nt = n_pad - b
    per_sweep = p * (
        m_local * nt * _F32 + m_local * b * _F32 + b * nt * _F32  # reads
        + m_local * nt * _F32 + b * nt * _F32                     # writes
    )
    return total + (k_panels - 1) * per_sweep


def _pipeline_flops(m: int, n: int, widths: tuple[int, ...]) -> float:
    """Leading-order flop count: the trailing GEMM pair (2mn² form W +
    2mn² apply) dominates; panel-local work is O(mnb)."""
    b = widths[0]
    return 4.0 * m * n * n + 2.0 * m * n * b


def _local_r_extra_bytes(
    local_r: str, p: int, m_local: int, widths: tuple[int, ...]
) -> int:
    """``chol`` derives every panel R from the lookahead Gram accumulated
    inside the trailing sweep — zero extra bytes.  A Householder local QR
    (``jnp``) re-reads each m×b panel once more."""
    if local_r == "chol":
        return 0
    return sum(p * m_local * b * _F32 for b in widths)


def _score(
    spec: BucketSpec,
    p: int,
    panel_width: int,
    local_r: str,
    max_batch: int,
    model: CostModel,
) -> float:
    """Predicted per-matrix service time for one (width, local-R) choice."""
    m_local = spec.m_pad // p
    widths = panel_widths(spec.n_pad, panel_width)
    hbm = _pipeline_bytes(p, m_local, spec.n_pad, widths)
    hbm += _local_r_extra_bytes(local_r, p, m_local, widths)
    flops = _pipeline_flops(spec.m_pad, spec.n_pad, widths)
    # Roofline: sweeps and math overlap on real hardware — take the max —
    # while the K·log₂P serial butterfly rounds are latency-bound and
    # additive (they sit on the critical path between sweeps).
    t_roof = max(hbm / model.mem_bw_bytes_per_s, flops / model.flops_per_s)
    t_rounds = len(widths) * math.ceil(math.log2(p)) * model.round_latency_s
    return t_roof + t_rounds + model.dispatch_overhead_s / max_batch


def plan_bucket(
    spec: BucketSpec,
    p: int,
    model: CostModel | None = None,
    *,
    rank_deficient_inputs: bool = True,
) -> BucketPlan:
    """Pick ``(panel_width, local_r, max_batch)`` for one bucket.

    ``max_batch`` is budget-driven (padded payload bytes per drain, capped
    for latency); width and local-R minimize the predicted per-matrix time
    over the candidate grid, ties broken toward the wider panel (fewer
    butterflies).  Deterministic: equal inputs always produce the equal
    plan.

    ``rank_deficient_inputs`` (the serving default) marks the Cholesky
    local factorizations *inadmissible*: identity-extension padding leaves
    a request's pad columns exactly zero on most ranks, so a per-rank
    local Gram is singular and its Cholesky NaN.  The Householder local QR
    is safe — rank-deficient local R factors still carry the exact local
    Gram, which the butterfly's stacked combines sum back to the
    (nonsingular) global Gram.  Inadmissible candidates stay in the audit
    table (``admissible=False``) so the cost comparison remains visible.
    """
    model = model or CostModel.tuned()
    matrix_bytes = spec.area * _F32
    max_batch = max(
        1, min(model.max_batch_cap, model.batch_bytes_budget // matrix_bytes)
    )
    m_local = spec.m_pad // p
    cand_widths = [
        b for b in model.panel_width_candidates
        if b <= spec.n_pad and b <= m_local
    ] or [min(spec.n_pad, m_local)]
    scored = []
    for b in cand_widths:
        for local_r in ("chol", "jnp"):
            admissible = not (rank_deficient_inputs and local_r == "chol")
            scored.append((
                b, local_r,
                _score(spec, p, b, local_r, max_batch, model), admissible,
            ))
    best = min(
        (c for c in scored if c[3]), key=lambda c: (c[2], -c[0])
    )
    t_matrix = best[2]
    return BucketPlan(
        spec=spec,
        panel_width=best[0],
        local_r=best[1],
        max_batch=max_batch,
        predicted_matrix_s=t_matrix,
        predicted_drain_s=t_matrix * max_batch,
        candidates=tuple(scored),
    )
