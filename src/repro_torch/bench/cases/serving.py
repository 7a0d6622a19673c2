"""QR-as-a-service under load — throughput, latency, fault re-serve;
hard-gated (the port of :mod:`repro.bench.cases.serving`), on ``device``
(``None``: the card, where each drain is one replay of the batched pipeline
on the Hopper kernels; the CPU serves the reference's configs exactly).

The serving claims are *numbers*:

  * every drained bucket runs exactly **one** batched program
    (``blocked_qr_batched`` under the hood);
  * warm serving builds **zero** new programs across the whole bucket set
    after :meth:`~repro_torch.serve.QRServer.prewarm` (the shape buckets are
    the program classes; a mixed-shape stream must never retrace);
  * a request whose batch hits an injected mid-flight death is re-served —
    never dropped — through the replica-recovering eager driver, and its
    factor is **bit for bit** a fault-free re-run of the same padded
    request;
  * the cost model's per-bucket decisions (panel width, local R, max batch)
    are deterministic — recorded as hard-gated metrics.

Sustained throughput and p50/p99 service latency over the mixed-shape
stream ride along warn-gated.
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.bench.registry import BenchFailure, bench_case
from repro_torch.bench.schema import Metric

__all__ = ["case", "main", "run"]


def _stream(buckets, p, n_requests: int, seed: int) -> list[np.ndarray]:
    """A deterministic mixed-shape request stream: shapes cycle over the
    buckets and jitter within each bucket's admission region."""
    rng = np.random.default_rng(seed)
    mats = []
    for i in range(n_requests):
        spec = buckets[i % len(buckets)]
        n = int(rng.integers(max(2, spec.n_pad // 2), spec.n_pad + 1))
        k = spec.n_pad - n
        m = int(rng.integers(n, spec.m_pad - k + 1))
        mats.append(rng.standard_normal((m, n)).astype(np.float32))
    return mats


def run(p: int = 4, n_requests: int = 24, fault_period: int = 3, max_batch_cap: int = 6,
        seed: int = 0, device=None) -> dict:
    """Serve a mixed-shape stream with periodic mid-flight deaths; return
    the raw serving numbers."""
    import dataclasses

    from repro_torch.kernels import dispatch as disp
    from repro_torch.qr.api import Pipeline, factorize
    from repro_torch.serve import BucketSpec, CostModel, PeriodicFaultInjector, QRServer
    from repro_torch.serve.buckets import block_rows, extract_r, pad_request

    buckets = (BucketSpec(256, 32), BucketSpec(512, 64))
    model = CostModel(max_batch_cap=max_batch_cap)
    injector = PeriodicFaultInjector.sampled(fault_period, variant="redundant", p=p, seed=seed)
    server = QRServer(buckets, p=p, model=model, fault_injector=injector, device=device)

    prewarm = server.prewarm()
    mats = _stream(buckets, p, n_requests, seed)

    t0_traces = disp.trace_count()
    t0 = time.perf_counter()
    responses = server.serve(mats)          # returns after the card has finished
    wall_s = time.perf_counter() - t0
    warm_traces = disp.trace_count() - t0_traces

    # -- numerics: every response reproduces numpy's R (sign-normalized) ----
    max_rel_err = 0.0
    for resp, a in zip(responses, mats):
        r_np = np.linalg.qr(a, mode="r")
        sign = np.sign(np.diag(r_np))
        sign[sign == 0] = 1.0
        r_ref = (r_np.T * sign).T
        err = float(np.abs(resp.r - r_ref).max() / max(1.0, np.abs(r_ref).max()))
        max_rel_err = max(max_rel_err, err)

    # -- fault re-serve fidelity: bit for bit a fault-free re-run -----------
    reserved = [r for r in responses if r.served_via == "reserved"]
    reserve_bitwise = True
    for resp in reserved:
        a = mats[resp.rid]
        cfg = dataclasses.replace(server.configs[resp.bucket], pipeline=Pipeline.OFF)
        ref = factorize(block_rows(pad_request(a, resp.bucket), p), cfg, device=server.device)
        r_ref = extract_r(ref.r[0].cpu().numpy(), a.shape[1])
        reserve_bitwise &= bool(np.array_equal(resp.r, r_ref))

    lat_us = np.array([r.latency_s for r in responses]) * 1e6
    stats = server.stats
    per_bucket = {spec: sum(1 for r in responses if r.bucket == spec)
                  for spec in server.buckets}
    return {
        "p": p,
        "n_requests": n_requests,
        "responses": len(responses),
        "prewarm_traces": sum(prewarm.values()),
        "warm_traces": int(warm_traces),
        "drains": stats.drains,
        "faulted_drains": stats.faulted_drains,
        "reserved": stats.reserved,
        "filler_slots": stats.filler_slots,
        "dispatches_per_drain_max": max(stats.dispatches_per_drain),
        "dispatches_per_drain_min": min(stats.dispatches_per_drain),
        "requests_per_bucket": [per_bucket[s] for s in server.buckets],
        "reserve_bitwise": reserve_bitwise,
        "max_rel_err": max_rel_err,
        "throughput_req_per_s": len(responses) / wall_s,
        "latency_p50_us": float(np.percentile(lat_us, 50)),
        "latency_p99_us": float(np.percentile(lat_us, 99)),
        "planner": server.planner_decisions(),
    }


def case(p: int = 4, n_requests: int = 24, fault_period: int = 3, max_batch_cap: int = 6,
         seed: int = 0, device=None):
    rows = run(p=p, n_requests=n_requests, fault_period=fault_period,
               max_batch_cap=max_batch_cap, seed=seed, device=device)
    if rows["responses"] != rows["n_requests"]:
        raise BenchFailure(
            f"served {rows['responses']} of {rows['n_requests']} requests — "
            "the serving contract is that no request is ever dropped"
        )
    if rows["warm_traces"] != 0:
        raise BenchFailure(
            f"{rows['warm_traces']} new trace(s) while serving a warm mixed-shape "
            "stream — the bucket set must be the complete set of program "
            "classes after prewarm"
        )
    if rows["dispatches_per_drain_max"] != 1 or rows["dispatches_per_drain_min"] != 1:
        raise BenchFailure(
            f"a drained bucket ran {rows['dispatches_per_drain_max']} batched "
            "program(s) — continuous batching must cost exactly one program per drain"
        )
    if rows["faulted_drains"] < 1 or rows["reserved"] < 1:
        raise BenchFailure(
            f"the injected-fault path never fired (faulted_drains="
            f"{rows['faulted_drains']}) — the re-serve contract was not exercised"
        )
    if not rows["reserve_bitwise"]:
        raise BenchFailure(
            "a re-served request's factor differs bitwise from a fault-free "
            "re-run — replica recovery must be exact"
        )
    if rows["max_rel_err"] > 1e-3:
        raise BenchFailure(
            f"served factors deviate from numpy QR by {rows['max_rel_err']:.2e} rel "
            "(tolerance 1e-3)"
        )
    hard = dict(gate="hard", direction="exact")
    out = {
        # THE serving claims
        "warm_traces": Metric(rows["warm_traces"], **hard),
        "dispatches_per_drain_max": Metric(rows["dispatches_per_drain_max"], **hard),
        "reserve_bitwise": Metric(rows["reserve_bitwise"], **hard),
        "responses": Metric(rows["responses"], **hard),
        # deterministic serving-run shape (seeded stream + injector)
        "drains": Metric(rows["drains"], **hard),
        "faulted_drains": Metric(rows["faulted_drains"], **hard),
        "reserved": Metric(rows["reserved"], **hard),
        "filler_slots": Metric(rows["filler_slots"], **hard),
        # numerics + timings (platform-dependent → warn)
        "max_rel_err": Metric(rows["max_rel_err"], gate="warn", direction="lower"),
        "prewarm_traces": Metric(rows["prewarm_traces"], gate="warn", direction="lower"),
        "throughput_req_per_s": Metric(rows["throughput_req_per_s"], gate="warn",
                                       direction="higher", unit="req/s"),
        "latency_p50_us": Metric(rows["latency_p50_us"], gate="warn", direction="lower",
                                 unit="us"),
        "latency_p99_us": Metric(rows["latency_p99_us"], gate="warn", direction="lower",
                                 unit="us"),
    }
    # bucket routing and the cost model's audited decisions, hard-gated so
    # neither the router nor the planner can drift silently
    for i, count in enumerate(rows["requests_per_bucket"]):
        out[f"bucket{i}_requests"] = Metric(count, **hard)
    for i, plan in enumerate(rows["planner"]):
        out[f"planner_b{i}_panel_width"] = Metric(plan["panel_width"], **hard)
        out[f"planner_b{i}_max_batch"] = Metric(plan["max_batch"], **hard)
        out[f"planner_b{i}_local_r_householder"] = Metric(plan["local_r"] == "jnp", **hard)
    return out


bench_case(
    "serving",
    tags=("qr", "serving", "throughput", "faults"),
    params={
        "smoke": {"p": 4, "n_requests": 24, "fault_period": 3, "max_batch_cap": 6},
        # heavy stream: more riders per drain, more faulted drains
        "full": {"p": 4, "n_requests": 96, "fault_period": 4, "max_batch_cap": 8},
    },
)(case)


def main(argv: list[str] | None = None) -> int:
    print("# QR serving: bucketed continuous batching with fault re-serve")
    rows = run()
    planner = rows.pop("planner")
    for k, v in rows.items():
        print(f"{k}: {v}")
    print("planner decisions:")
    for plan in planner:
        print(f"  {plan}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
