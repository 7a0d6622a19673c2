"""Serving launcher: QR-as-a-service over the port (the ``--mode qr`` route of
the reference's :mod:`repro.launch.serve`, with its flags and output lines).

Shape-bucketed continuous batching over the batched fault-tolerant
pipeline, on the card unless ``--device`` names another::

  PYTHONPATH=src python -m repro_torch.launch.serve --mode qr \\
      --requests 24 --fault-period 3
  PYTHONPATH=src python -m repro_torch.launch.serve --mode qr --device cpu

``--mode model`` (batched prefill and decode of a model) waits for the
port's model zoo (ROADMAP A.12).
"""
from __future__ import annotations

import argparse
import time

import numpy as np

BUCKETS = ((256, 32), (512, 64))


def synthetic_stream(buckets, n_requests: int, seed: int) -> list[np.ndarray]:
    """The reference launcher's request stream: requests cycle the buckets,
    each with random (m, n) that the bucket admits, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    mats = []
    for i in range(n_requests):
        spec = buckets[i % len(buckets)]
        n = int(rng.integers(max(2, spec.n_pad // 2), spec.n_pad + 1))
        m = int(rng.integers(n, spec.m_pad - (spec.n_pad - n) + 1))
        mats.append(rng.standard_normal((m, n)).astype(np.float32))
    return mats


def _serve_qr(args) -> None:
    from repro_torch.serve import (
        BucketSpec,
        CostModel,
        PeriodicFaultInjector,
        QRServer,
    )

    buckets = tuple(BucketSpec(*b) for b in BUCKETS)
    injector = None
    if args.fault_period:
        injector = PeriodicFaultInjector.sampled(
            args.fault_period, variant="redundant", p=args.p, seed=args.seed
        )
    server = QRServer(
        buckets, p=args.p,
        model=CostModel(max_batch_cap=args.max_batch),
        fault_injector=injector,
        device=args.device,
    )
    print("planner decisions:")
    for plan in server.planner_decisions():
        print(f"  bucket {plan['bucket']}: panel_width={plan['panel_width']} "
              f"local_r={plan['local_r']} max_batch={plan['max_batch']}")
    t0 = time.perf_counter()
    traces = server.prewarm()
    print(f"prewarm: {sum(traces.values())} trace(s) "
          f"in {time.perf_counter() - t0:.2f}s {traces}")

    mats = synthetic_stream(buckets, args.requests, args.seed)
    t0 = time.perf_counter()
    responses = server.serve(mats)
    wall = time.perf_counter() - t0
    lat_us = np.array([r.latency_s for r in responses]) * 1e6
    s = server.stats
    print(f"served {s.served} requests in {wall:.2f}s "
          f"({s.served / wall:.1f} req/s), {s.drains} drains "
          f"({s.faulted_drains} faulted, {s.reserved} re-served, "
          f"{s.filler_slots} filler slots)")
    print(f"dispatches/drain: {sorted(set(s.dispatches_per_drain))} "
          f"latency p50={np.percentile(lat_us, 50) / 1e3:.1f}ms "
          f"p99={np.percentile(lat_us, 99) / 1e3:.1f}ms")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=("model", "qr"), default="model")
    # QR serving
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--fault-period", type=int, default=3,
                    help="strike every Nth drain (0 disables injection)")
    ap.add_argument("--p", type=int, default=4)
    ap.add_argument("--max-batch", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device to serve on (default: the card)")
    args = ap.parse_args(argv)

    if args.mode == "qr":
        _serve_qr(args)
    else:
        raise NotImplementedError(
            "--mode model serves a model, which waits for the port's model zoo "
            "(ROADMAP A.12); use --mode qr"
        )


if __name__ == "__main__":
    main()
