"""Serving launcher — the port of the reference's :mod:`repro.launch.serve`:
two serving paths behind one entry point, with the reference's flags and
output lines, on the card unless ``--device`` names another.

Model serving (batched prefill + greedy decode loop; ``--smoke``, the
default, at the reduced config, ``--full`` at the published one)::

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
      --batch 4 --prompt-len 32 --gen 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b --full
  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b --device cpu

Every registered architecture serves: the transformers, Mamba2, Zamba2 and
Whisper (whose batch carries synthetic audio ``frames``, encoded before the
prefill).

QR-as-a-service (shape-bucketed continuous batching over the batched
fault-tolerant pipeline)::

  PYTHONPATH=src python -m repro_torch.launch.serve --mode qr \\
      --requests 24 --fault-period 3
  PYTHONPATH=src python -m repro_torch.launch.serve --mode qr --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
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


@dataclasses.dataclass
class ModelRun:
    """One model serving run: the greedy ids (B, gen), the last step's
    logits (B, V) and the host-clock times of the prefill and of the whole
    decode loop, each ending in a synchronize."""

    arch: str
    ids: "torch.Tensor"
    logits: "torch.Tensor"
    t_prefill: float
    t_decode: float


def generate(params, batch, cfg, gen: int, s_max: int) -> ModelRun:
    """Prefill ``batch`` into caches of ``s_max`` positions, then decode
    ``gen`` greedy tokens one step at a time (the reference launcher's
    loop), without autograd."""
    import torch

    from repro_torch.models import api

    device = batch["tokens"].device

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    with torch.inference_mode():
        t0 = time.perf_counter()
        logits, cache = api.prefill(params, batch, cfg, s_max=s_max)
        sync()
        t_prefill = time.perf_counter() - t0

        toks = []
        tok = logits.argmax(-1)[:, None].to(torch.int32)
        t0 = time.perf_counter()
        for _ in range(gen):
            toks.append(tok)
            logits, cache = api.decode_step(params, cache, tok, cfg)
            tok = logits.argmax(-1)[:, None].to(torch.int32)
        sync()
        t_decode = time.perf_counter() - t0
    return ModelRun(cfg.name, torch.cat(toks, dim=1), logits, t_prefill, t_decode)


def run_model(args) -> ModelRun:
    """``--mode model``: the architecture's config (reduced unless
    ``--full``), parameters drawn from seed 0 and a prefill batch drawn from
    seed 0 on the device, served by :func:`generate`."""
    from repro_torch.collective.comm import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.models import api

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    params = api.init(0, cfg, device)
    batch = api.synth_batch(0, cfg, "prefill", args.batch, args.prompt_len, device)
    return generate(params, batch, cfg, args.gen, s_max=args.prompt_len + args.gen)


def _serve_model(args) -> None:
    run = run_model(args)
    print(f"arch={run.arch} prefill({args.batch}x{args.prompt_len})="
          f"{run.t_prefill*1e3:.1f}ms decode {args.gen} steps="
          f"{run.t_decode*1e3:.1f}ms ({run.t_decode/args.gen*1e3:.2f} ms/tok)")
    print("generated ids[0]:", run.ids[0].tolist())


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


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=("model", "qr"), default="model")
    # model serving
    ap.add_argument("--arch")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    # QR serving
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--fault-period", type=int, default=3,
                    help="strike every Nth drain (0 disables injection)")
    ap.add_argument("--p", type=int, default=4)
    ap.add_argument("--max-batch", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device to serve on (default: the card)")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    if args.mode == "qr":
        _serve_qr(args)
    else:
        if not args.arch:
            raise SystemExit("--arch is required for --mode model")
        _serve_model(args)


if __name__ == "__main__":
    main()
