"""TSQR wall-clock microbenchmark (the port of
:mod:`repro.bench.cases.tsqr_scaling`): variant × P × local-QR
implementation on simulated ranks, on ``device`` (``None``: the card).

Two registered cases: ``tsqr_scaling`` sweeps variant × P, and
``tsqr_local_qr`` sweeps the local-QR implementations (``"jnp"``:
Householder, ``"cqr2"``: CholeskyQR2 in plain PyTorch, ``"cqr2_pallas"``:
CholeskyQR2 on the Hopper kernels; the port's ``QRConfig`` spells them as
the reference does).  Every call ends in a synchronize inside the clock.
All timing metrics are warn-gated.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.bench.registry import bench_case
from repro_torch.bench.schema import Metric
from repro_torch.collective.comm import resolve_device
from repro_torch.core import ref
from repro_torch.qr import QRConfig, factorize

__all__ = ["bench_one", "case_local_qr", "case_scaling"]


def bench_one(variant: str, p: int, m_loc: int, n: int, local_qr: str, iters: int = 5,
              device=None) -> float:
    device = resolve_device(device)
    rng = np.random.default_rng(0)
    blocks = torch.from_numpy(ref.random_tall_skinny(rng, p, m_loc, n)).to(device)
    cfg = QRConfig(variant=variant, local_r=local_qr)

    def call():
        out = factorize(blocks, cfg, device=device).r
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return out

    call()
    t0 = time.perf_counter()
    for _ in range(iters):
        call()
    return (time.perf_counter() - t0) / iters * 1e6


def case_scaling(ps=(4, 16, 64), m_loc: int = 256, n: int = 32, iters: int = 5, device=None):
    metrics = {}
    for p in ps:
        us = {}
        for variant in ("tree", "redundant"):
            us[variant] = bench_one(variant, p, m_loc, n, "jnp", iters=iters, device=device)
            metrics[f"us_{variant}_P{p}"] = Metric(
                us[variant], gate="warn", direction="lower", unit="us")
        metrics[f"redundant_overhead_P{p}"] = Metric(
            us["redundant"] / us["tree"], gate="warn", direction="lower")
    return metrics


def case_local_qr(p: int = 16, m_loc: int = 512, n: int = 64, iters: int = 5,
                  impls=("jnp", "cqr2", "cqr2_pallas"), device=None):
    metrics = {}
    for lq in impls:
        us = bench_one("redundant", p, m_loc, n, lq, iters=iters, device=device)
        metrics[f"us_{lq}"] = Metric(us, gate="warn", direction="lower", unit="us")
    return metrics


bench_case(
    "tsqr_scaling",
    tags=("timing", "tsqr"),
    params={
        "smoke": {"ps": (4, 16), "m_loc": 128, "n": 16, "iters": 2},
        "full": {"ps": (4, 16, 64), "m_loc": 256, "n": 32, "iters": 5},
    },
)(case_scaling)

bench_case(
    "tsqr_local_qr",
    tags=("timing", "tsqr", "kernels"),
    params={
        "smoke": {"p": 16, "m_loc": 256, "n": 32, "iters": 2},
        "full": {"p": 16, "m_loc": 512, "n": 64, "iters": 5},
    },
)(case_local_qr)
