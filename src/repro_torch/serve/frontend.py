"""The QR serving front-end: continuous batching with fault re-serve (the
port's :mod:`repro.serve.frontend`).

``QRServer`` serves through the :func:`repro_torch.qr.api.factorize` facade.
The request lifecycle:

  1. **Bucket** — an ``(m, n)`` request routes to the cheapest configured
     :class:`~repro.serve.buckets.BucketSpec` admitting it and queues
     there (identity-extension padding, see :mod:`repro_torch.serve.buckets`).
  2. **Drain** — when a bucket's queue reaches its planned ``max_batch``
     (or on :meth:`QRServer.flush`), the batch is topped up to exactly
     ``max_batch`` with identity fillers, row-blocked with numpy, copied
     to the device once and shipped through the batched fixed-shape
     pipeline: B factorizations, ONE program dispatch (one CUDA-graph
     replay on the card).
  3. **Re-serve on fault** — if the fault injector strikes a drain
     mid-flight, the batched result is treated as lost and every real
     request of that batch is *re-served*, matrix-by-matrix, through the
     eager general driver with the actual death schedule; the butterfly's
     replica copies restore the lost factors
     (:func:`~repro_torch.collective.engine.replica_fetch`), so the
     re-served factors are bit-identical to a fault-free re-run of the same
     padded request.  Requests are never dropped.
  4. **Pre-warm** — :meth:`QRServer.prewarm` drains one filler batch per
     bucket through the batched pipeline and runs one eager fallback
     factorization per bucket, so warm serving performs ZERO new traces
     across the whole bucket set.

Per-bucket panel width, local-R variant and ``max_batch`` come from the
deterministic cost model in :mod:`repro_torch.serve.planner`; the decisions
are exposed via :meth:`QRServer.planner_decisions`.

**Device.**  ``device=None`` means the card, as in ``factorize``.  On the
CPU a bucket's :class:`~repro_torch.qr.api.QRConfig` equals the
reference's field by field (``use_pallas=False``, the reference's XLA
route).  On the card it sets ``use_pallas=True``, so the drains run the
hand-written ``panel_cross``/``pad_cross`` and ``trailing_update`` kernels
instead of their plain versions; the planner's decisions do not depend on
it.  Latencies are read after a device synchronisation, and each
:class:`QRResponse` carries its R as a numpy array.
"""
from __future__ import annotations

import asyncio
import dataclasses
import math
import time
from collections.abc import Iterable, Sequence

import numpy as np
import torch

from repro_torch.collective.comm import resolve_device
from repro_torch.collective.faults import sample_within_tolerance
from repro_torch.kernels import dispatch as _dispatch
from repro_torch.qr.api import Pipeline, QRConfig, factorize
from repro_torch.qr.blocked import PIPELINE_NAME, PanelFaultSchedule

from .buckets import (
    BucketSpec,
    block_rows,
    bucket_for,
    default_buckets,
    extract_r,
    filler_matrix,
    pad_request,
    validate_buckets,
)
from .planner import BucketPlan, CostModel, plan_bucket

__all__ = [
    "PeriodicFaultInjector",
    "QRRequest",
    "QRResponse",
    "QRServer",
    "ServerStats",
]


@dataclasses.dataclass(frozen=True)
class QRRequest:
    """One factorization request: a single (m, n) matrix."""

    rid: int
    a: np.ndarray


@dataclasses.dataclass
class QRResponse:
    """The served factor and its provenance.

    ``served_via`` — ``"batched"`` (rode a one-dispatch bucket drain) or
    ``"reserved"`` (its drain hit an injected fault and it was re-served
    through the eager general driver with replica recovery).
    """

    rid: int
    r: np.ndarray
    bucket: BucketSpec
    served_via: str
    drain_index: int
    latency_s: float


@dataclasses.dataclass
class ServerStats:
    """Serving-run counters."""

    served: int = 0
    reserved: int = 0
    drains: int = 0
    faulted_drains: int = 0
    filler_slots: int = 0
    dispatches_per_drain: list = dataclasses.field(default_factory=list)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class PeriodicFaultInjector:
    """Deterministic mid-flight death source: strikes every ``period``-th
    drain with a within-tolerance single-rank death (drawn once from
    :func:`repro_torch.collective.faults.sample_within_tolerance`, so the batch
    is always re-servable from replicas)."""

    def __init__(
        self,
        period: int,
        schedule: PanelFaultSchedule,
    ):
        if period <= 0:
            raise ValueError(f"period must be positive, got {period}")
        if not schedule:
            raise ValueError("injector needs a non-empty fault schedule")
        self.period = period
        self.schedule = schedule

    @classmethod
    def sampled(
        cls, period: int, *, variant: str, p: int, panel: int = 0, seed: int = 0
    ) -> "PeriodicFaultInjector":
        """Death sampled within ``variant``'s tolerance for a P-rank
        butterfly, scheduled into panel ``panel``'s reduction."""
        spec = sample_within_tolerance(
            variant, p, int(math.log2(p)), np.random.default_rng(seed)
        )
        return cls(period, PanelFaultSchedule.of(panel={panel: spec}))

    def __call__(
        self, spec: BucketSpec, drain_index: int
    ) -> PanelFaultSchedule | None:
        if (drain_index + 1) % self.period == 0:
            return self.schedule
        return None


@dataclasses.dataclass
class _Entry:
    request: QRRequest
    t_submit: float
    future: asyncio.Future | None = None


class QRServer:
    """Shape-bucketed continuous batching over the batched QR pipeline.

    ``fault_injector`` is any ``(bucket, drain_index) ->
    PanelFaultSchedule | None`` callable (see
    :class:`PeriodicFaultInjector`); ``None`` serves fault-free.
    ``device=None`` serves on the card (see the module docstring).
    """

    def __init__(
        self,
        buckets: Iterable[BucketSpec] | None = None,
        *,
        p: int = 4,
        variant: str = "redundant",
        reorth: int = 1,
        model: CostModel | None = None,
        fault_injector=None,
        device=None,
    ):
        self.buckets = tuple(sorted(buckets or default_buckets()))
        validate_buckets(self.buckets, p)
        self.p = p
        self.device = resolve_device(device)
        self.fault_injector = fault_injector
        self.plans: dict[BucketSpec, BucketPlan] = {
            spec: plan_bucket(spec, p, model) for spec in self.buckets
        }
        self.configs: dict[BucketSpec, QRConfig] = {
            spec: QRConfig(
                panel_width=plan.panel_width,
                local_r=plan.local_r,
                variant=variant,
                reorth=reorth,
                use_pallas=self.device.type == "cuda",
            )
            for spec, plan in self.plans.items()
        }
        self._queues: dict[BucketSpec, list[_Entry]] = {
            spec: [] for spec in self.buckets
        }
        self._drain_index = 0
        self._next_rid = 0
        self.stats = ServerStats()
        self.prewarm_traces: dict | None = None

    # -- planning surface ---------------------------------------------------

    def bucket_of(self, m: int, n: int) -> BucketSpec:
        return bucket_for(self.buckets, m, n)

    def planner_decisions(self) -> list[dict]:
        """The cost model's per-bucket choices."""
        return [self.plans[spec].as_dict() for spec in self.buckets]

    # -- warmup -------------------------------------------------------------

    def prewarm(self) -> dict:
        """Compile every warm-path program up front: one filler drain per
        bucket through the batched pipeline plus one eager general-driver
        run per bucket (the re-serve fallback's kernel shapes are fixed by
        the bucket geometry, so this covers the fault path too).  Returns
        the per-phase trace counts; after this, serving any stream over
        the bucket set performs zero new traces."""
        t0 = _dispatch.trace_count()
        for spec in self.buckets:
            self._factorize(self._filler_batch(spec), self.configs[spec])
        t_batched = _dispatch.trace_count()
        for spec in self.buckets:
            blocks = block_rows(filler_matrix(spec), self.p)
            cfg = dataclasses.replace(
                self.configs[spec], pipeline=Pipeline.OFF
            )
            self._factorize(blocks, cfg)
        t_end = _dispatch.trace_count()
        self.prewarm_traces = {
            "batched_pipeline": t_batched - t0,
            "eager_fallback": t_end - t_batched,
        }
        return self.prewarm_traces

    def _factorize(self, blocks: np.ndarray, config: QRConfig, faults=None):
        """``factorize`` of host blocks, copied to the device once, and
        finished on the device before it returns."""
        res = factorize(torch.from_numpy(blocks).to(self.device), config,
                        faults=faults, device=self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return res

    def _filler_batch(self, spec: BucketSpec) -> np.ndarray:
        fill = block_rows(filler_matrix(spec), self.p)
        return np.broadcast_to(
            fill, (self.plans[spec].max_batch,) + fill.shape
        ).copy()

    # -- request intake -----------------------------------------------------

    def submit(self, a: np.ndarray, *, rid: int | None = None,
               future: asyncio.Future | None = None) -> list[QRResponse]:
        """Queue one request; returns the responses (for the whole batch)
        if this submission filled its bucket and triggered a drain, else
        an empty list.  Continuous batching: callers keep submitting and
        collect completions as they come, then :meth:`flush` the tail."""
        a = np.asarray(a, dtype=np.float32)
        if a.ndim != 2:
            raise ValueError(
                f"a request is one (m, n) matrix, got shape {a.shape}"
            )
        if rid is None:
            rid = self._next_rid
        self._next_rid = max(self._next_rid, rid + 1)
        spec = self.bucket_of(*a.shape)
        entry = _Entry(
            QRRequest(rid=rid, a=a), t_submit=time.perf_counter(),
            future=future,
        )
        queue = self._queues[spec]
        queue.append(entry)
        if len(queue) >= self.plans[spec].max_batch:
            return self._drain(spec)
        return []

    async def submit_async(self, a: np.ndarray) -> QRResponse:
        """Async intake: resolves with this request's own response when its
        bucket drains (batch completion resolves every rider's future)."""
        fut = asyncio.get_running_loop().create_future()
        self.submit(a, future=fut)
        return await fut

    def flush(self) -> list[QRResponse]:
        """Drain every non-empty bucket queue (short batches are topped up
        with fillers — the drained program is always the same shape)."""
        out: list[QRResponse] = []
        for spec in self.buckets:
            if self._queues[spec]:
                out.extend(self._drain(spec))
        return out

    # -- the drain ----------------------------------------------------------

    def _drain(self, spec: BucketSpec) -> list[QRResponse]:
        entries = self._queues[spec]
        self._queues[spec] = []
        plan, config = self.plans[spec], self.configs[spec]
        idx = self._drain_index
        self._drain_index += 1
        fill = plan.max_batch - len(entries)
        mats = [pad_request(e.request.a, spec) for e in entries]
        mats += [filler_matrix(spec)] * fill
        batch = np.stack([block_rows(m, self.p) for m in mats])
        fault = (
            self.fault_injector(spec, idx) if self.fault_injector else None
        )
        with _dispatch.track_dispatch() as d:
            res = self._factorize(batch, config)
        self.stats.drains += 1
        self.stats.filler_slots += fill
        self.stats.dispatches_per_drain.append(
            int(d.dispatches[PIPELINE_NAME])
        )
        if fault:
            # Mid-flight death: the batched program has no validity
            # machinery, so the whole drain is lost — re-serve every real
            # request through the replica-recovering general driver.
            self.stats.faulted_drains += 1
            responses = [
                self._reserve(e, spec, config, fault, idx) for e in entries
            ]
        else:
            r_batch = res.r.cpu().numpy()
            done = time.perf_counter()
            responses = [
                QRResponse(
                    rid=e.request.rid,
                    r=extract_r(r_batch[i, 0], e.request.a.shape[1]),
                    bucket=spec,
                    served_via="batched",
                    drain_index=idx,
                    latency_s=done - e.t_submit,
                )
                for i, e in enumerate(entries)
            ]
        self.stats.served += len(responses)
        for e, resp in zip(entries, responses):
            if e.future is not None and not e.future.done():
                e.future.set_result(resp)
        return responses

    def _reserve(
        self,
        entry: _Entry,
        spec: BucketSpec,
        config: QRConfig,
        fault: PanelFaultSchedule,
        idx: int,
    ) -> QRResponse:
        """Serve one request of a faulted batch through the eager general
        driver, injecting the actual death; replica recovery makes the
        result bit-identical to a fault-free run of the same padded
        request (within-tolerance survivors compute identical arithmetic
        and ``replica_fetch`` copies exact values)."""
        blocks = block_rows(pad_request(entry.request.a, spec), self.p)
        res = self._factorize(blocks, config, faults=fault)
        if not res.recoverable:
            raise RuntimeError(
                f"injected fault {fault} exceeded tolerance on {spec}; "
                "the injector must sample within-tolerance deaths"
            )
        self.stats.reserved += 1
        return QRResponse(
            rid=entry.request.rid,
            r=extract_r(res.r[0].cpu().numpy(), entry.request.a.shape[1]),
            bucket=spec,
            served_via="reserved",
            drain_index=idx,
            latency_s=time.perf_counter() - entry.t_submit,
        )

    # -- convenience --------------------------------------------------------

    def serve(self, matrices: Sequence[np.ndarray]) -> list[QRResponse]:
        """Serve a whole stream synchronously (submit all + flush), returning
        responses sorted by request id (submission order)."""
        out: list[QRResponse] = []
        for a in matrices:
            out.extend(self.submit(a))
        out.extend(self.flush())
        return sorted(out, key=lambda r: r.rid)
