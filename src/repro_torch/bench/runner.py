"""Benchmark runner: execute registered cases, time them, emit the document
(the port of :mod:`repro.bench.runner`).

``run_cases`` resolves each case's tier parameters, performs ``warmup``
discarded calls plus ``repeats`` timed calls (each ending in a
``torch.cuda.synchronize`` inside the clock on the card), folds the
percentile timing summary into the case's metrics as warn-gated ``time_*``
entries, and returns a schema-validated document stamped with the git SHA,
the torch version, the backend and the card's ``nvidia-smi`` name and power
limit.  ``write_doc`` writes it as ``results/bench_torch/BENCH_<UTC
timestamp>.json``.  Case outcomes:

* returns metrics          → ``status: ok``
* raises ``SkipCase``      → ``status: skipped`` (never fails the run)
* raises ``BenchFailure``  → ``status: error`` **and** the run exits
  non-zero — measured-invariant violations are loud
* any other exception      → ``status: error`` + non-zero exit

``device`` (``None``: the card) reaches every case as its ``device``
keyword; the document's ``params`` hold the tier's kwargs only.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

from . import schema
from .registry import BenchCase, BenchFailure, SkipCase, cases_for

__all__ = ["DEFAULT_OUT_DIR", "card", "git_sha", "run_cases", "write_doc"]

DEFAULT_OUT_DIR = os.path.join("results", "bench_torch")


def git_sha() -> str | None:
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=10,
            cwd=os.path.dirname(os.path.abspath(__file__)),
        )
        return out.stdout.strip() or None if out.returncode == 0 else None
    except OSError:
        return None


def card() -> str | None:
    """The card's name and power limit as ``nvidia-smi`` gives them, or None
    where it cannot be run."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else None


def _environment(tier: str, device) -> dict:
    import platform

    import torch

    cuda = device is None or str(device).startswith("cuda")
    return {
        "schema_version": schema.SCHEMA_VERSION,
        "created": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "git_sha": git_sha(),
        "torch_version": torch.__version__,
        "backend": "cuda" if cuda else "cpu",
        "card": card() if cuda else None,
        "platform": platform.platform(),
        "python": platform.python_version(),
        "n_devices": max(1, torch.cuda.device_count()) if cuda else 1,
        "tier": tier,
    }


def _timing_metrics(samples_s: list[float]) -> dict:
    us = np.asarray(samples_s) * 1e6
    out = {
        "time_mean_us": float(us.mean()),
        "time_p50_us": float(np.percentile(us, 50)),
        "time_p90_us": float(np.percentile(us, 90)),
        "time_min_us": float(us.min()),
    }
    return {k: schema.Metric(v, gate="warn", direction="lower", unit="us")
            for k, v in out.items()}


def _run_one(case: BenchCase, tier: str, device, verbose: bool = True) -> dict:
    import torch

    kwargs = case.kwargs(tier)
    entry: dict = {"params": kwargs}
    call = dict(kwargs, device=device)
    cuda = (device is None or str(device).startswith("cuda")) and torch.cuda.is_available()

    def sync():
        if cuda:
            torch.cuda.synchronize()

    if verbose:
        print(f"[bench] {case.name} "
              f"({', '.join(f'{k}={v}' for k, v in kwargs.items()) or 'no params'})",
              flush=True)
    try:
        for _ in range(case.warmup):
            case.fn(**call)
        samples, result = [], None
        for _ in range(case.repeats):
            sync()
            t0 = time.perf_counter()
            result = case.fn(**call)
            sync()
            samples.append(time.perf_counter() - t0)
    except SkipCase as e:
        entry.update(status="skipped", skip_reason=str(e) or "skipped")
        if verbose:
            print(f"[bench]   skipped: {e}", flush=True)
        return entry
    except BenchFailure as e:
        entry.update(status="error", error=f"invariant violated: {e}")
        print(f"[bench]   FAILED: {e}", file=sys.stderr, flush=True)
        return entry
    except Exception as e:  # noqa: BLE001 — recorded, fails the run
        entry.update(status="error", error=f"{type(e).__name__}: {e}")
        print(f"[bench]   ERROR: {entry['error']}", file=sys.stderr, flush=True)
        return entry
    metrics = {name: schema.metric_to_json(m) for name, m in dict(result).items()}
    metrics.update({k: schema.metric_to_json(m) for k, m in _timing_metrics(samples).items()})
    entry.update(status="ok", metrics=metrics)
    if verbose:
        print(f"[bench]   ok: {len(metrics)} metrics, mean {np.mean(samples) * 1e3:.1f} ms "
              f"over {case.repeats} repeat(s)", flush=True)
    return entry


def run_cases(tier: str, *, only: tuple[str, ...] | None = None, registry=None,
              verbose: bool = True, device=None) -> dict:
    """Run all cases for ``tier`` on ``device`` (the card unless ``"cpu"``);
    return the (validated) document."""
    cases = cases_for(tier, only=only, registry=registry)
    if not cases:
        raise ValueError(f"no bench cases registered for tier {tier!r}")
    doc = _environment(tier, device)
    doc["cases"] = {c.name: _run_one(c, tier, device, verbose=verbose) for c in cases}
    return schema.validate(doc)


def write_doc(doc: dict, *, out: str | None = None, out_dir: str = DEFAULT_OUT_DIR) -> str:
    """Write ``doc`` to ``out`` or ``out_dir/BENCH_<timestamp>.json``."""
    if out is None:
        stamp = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
        out = os.path.join(out_dir, f"BENCH_{stamp}.json")
    parent = os.path.dirname(out)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(out, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    return out
